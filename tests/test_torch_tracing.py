"""``llmseg_tpu_torch.utils.profiling``'s spans and counters, on the CPU:
off unless a ``torch.profiler`` session records, their sums, nesting and
request ids, the profiler's Chrome trace, the bounded store, and the
spans the program records in ``predict`` and in AMG."""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from llmseg_tpu_torch import config as TC
from llmseg_tpu_torch import serving
from llmseg_tpu_torch.data.synthetic import make_batch
from llmseg_tpu_torch.models import llmseg
from llmseg_tpu_torch.models.sam import amg as tamg
from llmseg_tpu_torch.models.sam import sam as tsam
from llmseg_tpu_torch.utils import profiling as P

torch.set_num_threads(1)

AMG_SPANS = ("amg.submit", "amg.encode", "amg.decode", "amg.select", "nms", "amg.prefetch",
             "amg.pull", "amg.upscale", "amg.finish", "amg.download", "amg.rle")
AMG_PARENTS = {"amg.submit": None, "amg.encode": "amg.submit", "amg.decode": "amg.submit",
               "amg.select": "amg.submit", "nms": "amg.select", "amg.pull": "amg.prefetch",
               "amg.upscale": "amg.prefetch", "amg.download": "amg.finish",
               "amg.rle": "amg.finish", "amg.overflow_path": "amg.rle"}
# the uploads that wait for the stream: the image and the grid in submit,
# one span before the encoder (the filters' fill is a scalar, no upload)
UPLOADS = {"amg.submit": 1}
STAGES = ("llmseg.dino", "llmseg.clip", "llmseg.llm", "llmseg.head")


@pytest.fixture(autouse=True)
def _empty_store():
    P.reset()
    yield
    P.reset()


def _recording():
    return profile(activities=[ProfilerActivity.CPU])


def _busy(us):
    """Spin for ``us`` microseconds on the host's clock."""
    t = time.perf_counter_ns() + us * 1000
    while time.perf_counter_ns() < t:
        pass


def test_off_is_the_shared_no_op():
    a, b = P.span("a"), P.span("b", device=True, request=3)
    assert a is b
    with a as got:
        P.count("c", 5)
    assert got is a
    assert P.snapshot() == {"spans": {}, "counters": {}} and P.records() == []


def test_nesting_self_time_parents_and_requests():
    with _recording():
        with P.span("outer", request=7):
            _busy(2000)
            for _ in range(2):
                with P.span("inner"):
                    _busy(3000)
                    with P.span("leaf"):
                        _busy(1000)
        with P.span("alone"):
            pass
    snap = P.snapshot()["spans"]
    assert {k: v["n"] for k, v in snap.items()} == {"outer": 1, "inner": 2, "leaf": 2,
                                                     "alone": 1}
    assert all(v["stream_ms"] is None for v in snap.values())
    o, i, leaf = snap["outer"], snap["inner"], snap["leaf"]
    assert o["host_ms"] >= 2 + 2 * 4 and i["host_ms"] >= 2 * 4 and leaf["host_ms"] >= 2
    assert o["self_ms"] == pytest.approx(o["host_ms"] - i["host_ms"], abs=1e-6)
    assert i["self_ms"] == pytest.approx(i["host_ms"] - leaf["host_ms"], abs=1e-6)
    assert leaf["self_ms"] == leaf["host_ms"]
    recs = P.records()
    assert [(r.name, r.parent, r.request) for r in recs] == [
        ("leaf", "inner", 7), ("inner", "outer", 7), ("leaf", "inner", 7),
        ("inner", "outer", 7), ("outer", None, 7), ("alone", None, None)]
    assert all(r.start_ns <= r.end_ns and 0 <= r.self_ns <= r.end_ns - r.start_ns
               for r in recs)


def test_chrome_trace_has_a_user_annotation_a_span(tmp_path):
    """``trace()``'s Chrome trace carries every span on the thread that
    opened it, beside the operators it ran."""
    with P.trace(str(tmp_path)):
        with P.span("stage.a"):
            with P.span("stage.b"):
                torch.ones(4) + 1
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    op_tid = {e["tid"] for e in events if e.get("name") == "aten::add"}
    for name in ("stage.a", "stage.b"):
        got = [e for e in events if e.get("name") == name and e.get("ph") == "X"]
        assert len(got) == 1 and got[0]["cat"] == "user_annotation", got
        assert {got[0]["tid"]} == op_tid
    assert P.snapshot()["spans"]["stage.b"]["n"] == 1


@pytest.mark.parametrize("on", [False, True])
def test_count_only_while_on(on):
    if on:
        with _recording():
            P.count("x")
            P.count("x", 4)
    else:
        P.count("x", 4)
    assert P.snapshot()["counters"] == ({"x": 5} if on else {})


class _Event:
    """A stand-in for a CUDA event pair's end: elapsed 2 ms."""

    def __init__(self):
        self.synced = False

    def synchronize(self):
        self.synced = True

    def elapsed_time(self, end):
        return 2.0


@pytest.mark.parametrize("store", ["records", "pending"])
def test_store_keeps_its_bound(monkeypatch, store):
    monkeypatch.setattr(P, "MAX_RECORDS", 8)
    monkeypatch.setattr(P, "MAX_PENDING", 4)
    P.reset()
    n = 20
    if store == "records":
        with _recording():
            for i in range(n):
                with P.span("s", request=i):
                    pass
        recs = P.records()
        assert len(recs) == 8 and [r.request for r in recs] == list(range(n - 8, n))
        assert P.snapshot()["spans"]["s"]["n"] == n
    else:
        pairs = [(_Event(), _Event()) for _ in range(n)]
        for ev in pairs:
            P._STORE.add(P.Record("d", None, None, 0, 1, 1), ev)
            assert len(P._STORE.pending) <= 4
        assert sum(e1.synced for _, e1 in pairs) == n - 4
        snap = P.snapshot()["spans"]["d"]
        assert snap["n"] == n and snap["stream_ms"] == pytest.approx(2.0 * n)
        assert not P._STORE.pending


def test_export_under_the_profiler_holds_no_profiler_op():
    model = llmseg.init(TC.llmseg_tiny(), device="cpu")
    with _recording():
        ep = serving.export_predict(model, num_images=1, rows=1, text_len=32,
                                    dtype=torch.float32)
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]
    assert P.snapshot() == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("pool", ["adjoint", "unfused"])
def test_predict_records_four_stages_a_call(pool):
    cfg = TC.llmseg_tiny()
    model = llmseg.init(cfg, device="cpu")
    batch = make_batch(cfg, num_images=2, rows_per_image=1, text_len=32, seed=1, device="cpu")
    calls = 3
    with _recording():
        for _ in range(calls):
            llmseg.predict(model, batch, device="cpu", pool=pool)
    snap = P.snapshot()["spans"]
    assert set(snap) == {"llmseg.predict", *STAGES}
    for name in ("llmseg.predict",) + STAGES:
        assert snap[name]["n"] == calls and snap[name]["stream_ms"] is None, name
    recs = P.records()
    call_ids = [r.request for r in recs if r.name == "llmseg.predict"]
    assert len(set(call_ids)) == calls
    for r in recs:
        if r.name in STAGES:
            assert r.parent == "llmseg.predict" and r.request in call_ids
    for rid in call_ids:
        assert [r.name for r in recs if r.request == rid] == list(STAGES) + ["llmseg.predict"]


@pytest.mark.parametrize("runs_per_col", [64, 1])
@pytest.mark.parametrize("flow", ["generate", "pipelined"])
def test_amg_records_each_span_once_an_image(monkeypatch, flow, runs_per_col):
    """sam_tiny, the filters opened; the device RLE keeps ``runs_per_col``
    run starts a column: 64 (the input's height) overflows none, 1 sends
    survivors down the bit-packed path."""
    monkeypatch.setattr(tamg, "MAX_RUNS_PER_COL", runs_per_col)
    model = tsam.init(TC.sam_tiny(), seed=2, device="cpu")
    amg = TC.AMGConfig(points_per_side=4, points_per_batch=8, pred_iou_thresh=-1e9,
                       stability_score_thresh=-1.0, box_nms_thresh=1.1, max_masks=6)
    gen = tamg.AutomaticMaskGenerator(model, amg=amg, device="cpu")
    rng = np.random.RandomState(0)
    images = [rng.randint(0, 255, hw + (3,), np.uint8) for hw in ((64, 48), (40, 64), (64, 64))]
    decoded = []
    real = tamg.device_rle.annotations_from_rle_payload

    def payload(*a, **k):
        out = real(*a, **k)
        decoded.extend(out)
        return out

    monkeypatch.setattr(tamg.device_rle, "annotations_from_rle_payload", payload)
    pulled, handles = 0, []
    with _recording():
        if flow == "generate":
            for img in images:
                gen.generate(img)
        else:
            pending = None
            for img in images + [None]:
                if pending is not None:
                    gen.prefetch(pending)
                    pulled += pending["n"]
                handle = gen.submit(img) if img is not None else None
                if pending is not None:
                    gen.finish(pending)
                    handles.append(pending)
                pending = handle
    snap = P.snapshot()
    spans, counters = snap["spans"], snap["counters"]
    overflowed = sum(d is None for d in decoded)
    assert len(decoded) == counters["amg.survivors"] > 0
    if flow == "pipelined":
        assert counters["amg.survivors"] == pulled
    assert counters["amg.rle_overflow"] == overflowed
    assert (overflowed > 0) == (runs_per_col == 1)
    assert set(spans) == set(AMG_SPANS) | {"amg.upload"} | (
        {"amg.overflow_path"} if overflowed else set())
    for name in AMG_SPANS:
        assert spans[name]["n"] == len(images), name
    assert spans["amg.upload"]["n"] == sum(UPLOADS.values()) * len(images)
    recs = P.records()
    ids = {r.request for r in recs if r.name == "amg.submit"}
    assert len(ids) == len(images)
    if handles:
        assert {h["request"] for h in handles} == ids
    for rid in ids:
        names = [r.name for r in recs if r.request == rid]
        assert sorted(n for n in names if n not in ("amg.overflow_path", "amg.upload")) == \
            sorted(AMG_SPANS)
        assert names.count("amg.overflow_path") <= 1
        uploads = [r.parent for r in recs if r.request == rid and r.name == "amg.upload"]
        assert {p: uploads.count(p) for p in uploads} == UPLOADS
    for r in recs:
        assert r.request in ids
        if r.name in AMG_PARENTS:
            assert r.parent == AMG_PARENTS[r.name], r
    prefetch_parent = {r.parent for r in recs if r.name == "amg.prefetch"}
    assert prefetch_parent == ({"amg.finish"} if flow == "generate" else {None})
