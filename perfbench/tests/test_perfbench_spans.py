"""The per-layer metrics that read the program's spans and counters
(``pbcore/spans.py``), from a traced CPU run of each tiny cell: host times
and counts read a number, the device times None; an untraced window
records nothing."""

import json
import time
from types import SimpleNamespace

import pytest

from pbcore import manifest, runner, spans

ROOT = manifest.ROOT


def _span_metrics(cell: str):
    """The cell's per-layer metrics whose readers use ``pbcore.spans``."""
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = ROOT / b["paths"][0]
    return [m["name"] for m in b["per_layer"] if cell in m.get("workloads", [cell])
            and "pbcore.spans" in (bench / "metrics" / f"{m['name']}.py").read_text()]


@pytest.fixture(autouse=True)
def _empty_store():
    from llmseg_tpu_torch.utils import profiling
    profiling.reset()
    yield
    profiling.reset()


def _run(cell, traced):
    return runner.run_cell(cell.name, 2**31 + 7, 0.3, traced, t_start=time.perf_counter(),
                           device="cpu", cell=cell, log=lambda _: None)


@pytest.mark.parametrize("which", ["predict", "amg"])
def test_traced_run_reads_every_span_metric(which, predict_cell, amg_cell):
    cell = predict_cell if which == "predict" else amg_cell
    names = _span_metrics(cell.name)
    assert len(names) == (4 if which == "predict" else 5)
    res = _run(cell, True)
    assert res["correct"], res["checks"]
    snap = spans.snapshot()
    steps = cell.work["trace_steps"] + (which == "amg")   # AMG finishes the image in flight
    ctx = SimpleNamespace(steps=steps)
    got = {n: cell.metric_reader(n).read(ctx) for n in names}
    if which == "predict":
        assert got == dict.fromkeys(names) and not set(names) & set(res["metrics"])
        for stage in ("llmseg.dino", "llmseg.clip", "llmseg.llm", "llmseg.head"):
            assert snap["spans"][stage]["n"] == steps
            assert spans.span_ms(ctx, [stage], "host_ms") > 0
    else:
        assert snap["spans"]["amg.submit"]["n"] == steps
        assert {n: res["metrics"][n]["value"] for n in names} == got
        assert got["amg.submit_ms"] > got["amg.host_wait_ms"] > 0 and got["amg.rle_ms"] > 0
        assert 0 <= got["amg.rle_overflow_pct"] <= 100
        assert got["amg.g_records_per_image"] == 0    # the CPU decodes by the plain path
        assert snap["counters"]["amg.survivors"] > 0


@pytest.mark.parametrize("which", ["predict", "amg"])
def test_untraced_window_records_nothing(which, predict_cell, amg_cell):
    res = _run(predict_cell if which == "predict" else amg_cell, False)
    assert res["correct"] and "breakdown" not in res
    assert spans.snapshot() == {"spans": {}, "counters": {}}
