"""The per-layer metric ``amg.select_graph_replays_per_image`` (the
program's counter ``amg.select_graph_replays`` over the window's steps,
None where the program counted none or has no counters at all), and the
greedy NMS kernel's ``kernels/greedy_nms.json``: its expressions find the
kernel's device events by the names its source gives them, once a launch,
and nothing of the other kernels."""

import json
import re
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from pbcore import program, runner, spans, trace

NAME = "amg.select_graph_replays_per_image"
SOURCE = Path(__file__).resolve().parents[2] / "llmseg_tpu_torch" / "csrc" / "greedy_nms.cu"


@pytest.fixture(autouse=True)
def _empty_store():
    from llmseg_tpu_torch.utils import profiling
    profiling.reset()
    yield
    profiling.reset()


@pytest.mark.parametrize("counters,steps,want", [
    ({"amg.select_graph_replays": 7}, 7, 1.0), ({"amg.select_graph_replays": 21}, 7, 3.0),
    ({"amg.select_graph_captures": 1}, 7, None), ({"sam.encoder_graph_replays": 7}, 7, None),
    (None, 7, None)])
def test_select_graph_replays_reader(counters, steps, want, amg_cell, monkeypatch):
    """The replays counter over the steps; None where the counter is absent,
    and where the program has no spans at all."""
    snap = None if counters is None else {"spans": {}, "counters": counters}
    monkeypatch.setattr(spans, "snapshot", lambda: snap)
    reader = amg_cell.metric_reader(NAME)
    assert reader.read(SimpleNamespace(steps=steps)) == want


def test_the_metric_is_in_the_manifest(amg_cell):
    entry = [m for m in amg_cell.per_layer if m["name"] == NAME]
    assert len(entry) == 1 and entry[0]["workloads"] == ["sam_vit_h.amg_k50"]
    assert entry[0]["source"] == "program_counter" and entry[0]["moves"] == "amg_img_per_s"


def test_nms_kernel_spec_matches_its_kernels():
    """The source's two kernels, as the profiler names them: the count
    expression finds the sweep alone (one a launch), the time expression
    both, and neither finds kernel G's or another kernel's events."""
    names = re.findall(r"__global__ void (\w+)\(", SOURCE.read_text())
    assert sorted(names) == ["greedy_nms_mask", "greedy_nms_sweep"]
    spec = trace.kernel_specs()["greedy_nms"]
    assert spec["per_launch"] == 1
    events = [f"(anonymous namespace)::{n}(unsigned long long const*, float const*, int)"
              for n in names]
    assert [bool(spec["count_re"].search(e)) for e in events] == [
        n == "greedy_nms_sweep" for n in names]
    assert all(spec["time_re"].search(e) for e in events)
    others = ["void (anonymous namespace)::fd_upscale(CUtensorMap, CUtensorMap)",
              "void (anonymous namespace)::fd_gemm_mma<1, 1>(GemmArgs)",
              "void at::native::(anonymous namespace)::radixSortKVInPlace<long>(x)",
              "void relpos_window_bf16<80>(CUtensorMap)"]
    assert not any(spec["time_re"].search(e) or spec["count_re"].search(e) for e in others)
    assert json.loads((trace.KERNELS_DIR / "greedy_nms.json").read_text())["count"] == \
        spec["count"]


def test_the_harness_counts_the_nms_kernel():
    """The harness's launch counters see the kernel (ops/twoway_kernel.py
    names it beside kernel G), so a traced run holds its events to them."""
    assert "greedy_nms" in program.launches()


def test_cpu_traced_run_leaves_the_metric_out(amg_cell):
    """A traced CPU run selects eagerly: no replay, so the line leaves the
    metric out, and the NMS kernel neither launches nor faults the trace."""
    res = runner.run_cell(amg_cell.name, 2**31 + 11, 0.3, True, t_start=time.perf_counter(),
                          device="cpu", cell=amg_cell, log=lambda _: None)
    assert res["correct"], res["checks"]
    assert spans.snapshot()["counters"].get("amg.select_graph_replays", 0) == 0
    assert NAME not in res["metrics"] and res["metrics"]["amg.submit_ms"]["value"] > 0
