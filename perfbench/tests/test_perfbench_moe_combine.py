"""The per-layer metric ``moe.combine_kernel_share`` (the program's counter
``moe.combine_kernels`` over the MoE blocks run, ``moe.grouped_gemms`` / 2;
None where the program counted no combine through the kernel or has no
counters at all), its manifest entry, and a traced CPU run of the cell,
whose combines take the plain version, leaving it out."""

import time
from types import SimpleNamespace

import pytest

from pbcore import manifest, program, runner, spans

CELL = "llmseg_kimivl_a3b.predict_b4q3"
NAME = "moe.combine_kernel_share"


@pytest.fixture(autouse=True)
def _empty_store():
    from llmseg_tpu_torch.utils import profiling
    profiling.reset()
    yield
    profiling.reset()


@pytest.mark.parametrize("counters,want", [
    ({"moe.combine_kernels": 26 * 5, "moe.grouped_gemms": 52 * 5}, 1.0),
    ({"moe.combine_kernels": 26, "moe.grouped_gemms": 52}, 1.0),
    ({"moe.combine_kernels": 13, "moe.grouped_gemms": 52}, 0.5),
    ({"moe.grouped_gemms": 52}, None), ({"moe.combine_kernels": 26}, None),
    ({}, None), (None, None)])
def test_combine_kernel_share_reader(counters, want, monkeypatch):
    """Combines through the kernel over the blocks run, whatever the window's
    steps; None where either counter is absent, and where the program has
    no counters at all."""
    snap = None if counters is None else {"spans": {}, "counters": counters}
    monkeypatch.setattr(spans, "snapshot", lambda: snap)
    reader = manifest.load(CELL).metric_reader(NAME)
    assert reader.read(SimpleNamespace(steps=5)) == want


def test_the_metric_is_in_the_manifest():
    entry = [m for m in manifest.load(CELL).per_layer if m["name"] == NAME]
    assert len(entry) == 1 and entry[0]["workloads"] == [CELL]
    assert entry[0]["source"] == "program_counter" and entry[0]["moves"] == "predict_img_per_s"
    assert entry[0]["layer"] == "MoE: models/deepseek_v3.py"
    assert not any(m["name"] == NAME for m in manifest.load("llmseg_mistral7b.predict_b4").per_layer)


def test_the_harness_does_not_check_the_combine_kernel():
    """The combine's launcher lives in ``ops/moe.py``, outside the modules
    whose kernels the trace check holds to their device events, and no
    kernel specification names it."""
    from pbcore import trace
    assert "moe_combine" not in program.kernels()
    assert "moe_combine" not in trace.kernel_specs()


def test_cpu_traced_run_leaves_the_metric_out():
    """A traced CPU run of the cell at a tiny size: every combine takes the
    plain version, so the counter stays 0 and the line leaves the metric
    out, while the grouped products are counted."""
    from conftest import PREDICT_TINY
    from test_perfbench_mla_moe import _tiny_doc
    cell = manifest.load(CELL)
    cell.config = _tiny_doc()
    cell.work = dict(cell.work, traffic=dict(PREDICT_TINY, rows_per_image=3))
    res = runner.run_cell(cell.name, 2**31 + 23, 0.3, True, t_start=time.perf_counter(),
                          device="cpu", cell=cell, log=lambda _: None)
    assert res["correct"], res["checks"]
    counters = spans.snapshot()["counters"]
    assert counters.get("moe.combine_kernels", 0) == 0 and counters["moe.grouped_gemms"] > 0
    assert NAME not in res["metrics"]
