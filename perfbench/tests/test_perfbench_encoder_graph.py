"""The per-layer metric ``amg.encoder_graph_replays_per_image``: the
program's counter ``sam.encoder_graph_replays`` over the window's steps,
None where the program counted none (the CPU encodes eagerly) or has no
counters at all."""

import time
from types import SimpleNamespace

import pytest

from pbcore import runner, spans

NAME = "amg.encoder_graph_replays_per_image"


@pytest.fixture(autouse=True)
def _empty_store():
    from llmseg_tpu_torch.utils import profiling
    profiling.reset()
    yield
    profiling.reset()


@pytest.mark.parametrize("counters,steps,want", [
    ({"sam.encoder_graph_replays": 7}, 7, 1.0), ({"sam.encoder_graph_replays": 14}, 7, 2.0),
    ({"sam.encoder_graph_captures": 1}, 7, None), (None, 7, None)])
def test_encoder_graph_replays_reader(counters, steps, want, amg_cell, monkeypatch):
    """The replays counter over the steps; None where the counter is absent,
    and where the program has no spans at all."""
    snap = None if counters is None else {"spans": {}, "counters": counters}
    monkeypatch.setattr(spans, "snapshot", lambda: snap)
    reader = amg_cell.metric_reader(NAME)
    assert reader.read(SimpleNamespace(steps=steps)) == want


def test_cpu_traced_run_leaves_the_metric_out(amg_cell):
    """A traced CPU run counts no replay, so the line leaves the metric out."""
    res = runner.run_cell(amg_cell.name, 2**31 + 7, 0.3, True, t_start=time.perf_counter(),
                          device="cpu", cell=amg_cell, log=lambda _: None)
    assert res["correct"], res["checks"]
    assert spans.snapshot()["counters"].get("sam.encoder_graph_replays", 0) == 0
    assert NAME not in res["metrics"] and res["metrics"]["amg.submit_ms"]["value"] > 0
