"""The bookkeeping that the port's CUDA graphs and kernel plans share
(``ops/kernels.py``): the one stamp of what recorded work was made from, the
graph on static inputs (``StaticGraph``) looked up one a key by
``replay_or_capture``, which replays a current graph and captures anew where
a weight moved, and the tensors a warm-up's result marks as used.  The
graphs themselves run only on the card (``tests/test_torch_cuda.py``); this
is their host side, with the capture standing in."""

import gc
import types
import weakref

import pytest
import torch

from llmseg_tpu_torch.ops import kernels as K


@pytest.mark.parametrize("versions", [False, True])
def test_stamp_reads_the_storage_and_with_versions_in_place_changes(versions):
    w = torch.nn.Parameter(torch.ones(3))
    before = K.stamp([w], versions=versions)
    with torch.no_grad():
        w.add_(1.0)                          # in place: the same storage
    assert (K.stamp([w], versions=versions) != before) == versions
    before = K.stamp([w], versions=versions)
    w.data = w.data.clone()                  # moved to other storage
    assert K.stamp([w], versions=versions) != before


@pytest.mark.parametrize("versions", [False, True])
def test_stamp_of_an_inference_tensor_sees_its_storage_dtype_shape_and_stride(versions):
    """An inference tensor has no version counter: its stamp does not raise,
    with or without versions, and still changes where it moves to other
    storage or takes another dtype, shape or stride."""
    with torch.inference_mode():
        w = torch.ones(4, 6)
        before = K.stamp([w], versions=versions)
        assert K.stamp([w], versions=versions) == before
        w.add_(1.0)                          # unseen: no version counter
        assert K.stamp([w], versions=versions) == before
        # other storage; then on w's storage another dtype, shape, stride
        for other in (w.clone(), w.view(torch.int32), w.view(6, 4),
                      w.as_strided((4, 6), (1, 4))):
            assert K.stamp([other], versions=versions) != before


class _Owner:
    """Stands in for a module: weak-referenceable, one weight."""

    def __init__(self):
        self.w = torch.ones(2)


@pytest.fixture
def cpu_capture(monkeypatch):
    """A capture that runs its function once and whose replay runs it again
    into the captured output's storage, counting a launch of a kernel each
    time; a warm-up that runs its function."""
    kernel = K.Kernel("stand_in")

    def capture(fn, pool=None):
        out = fn()
        graph = types.SimpleNamespace(replay=lambda: out.copy_(fn()))
        return graph, out, {kernel: 1}

    monkeypatch.setattr(K, "capture", capture)
    monkeypatch.setattr(K, "warm_up", lambda fn, device: fn())
    monkeypatch.setattr(K.profiling, "count", lambda name, n=1: counts.update(
        {name: counts.get(name, 0) + n}))
    counts = {}
    yield kernel, counts
    K._INSTANCES.remove(kernel)


def test_replay_or_capture_keeps_one_graph_a_key_and_captures_where_a_weight_moved(
        cpu_capture):
    """One graph a key: the first call's result is the warm-up's and the
    graph keeps no caller's tensor; a replay copies its input into the
    static buffer and returns the static output; the capture's ``keep`` is
    the graph's; a moved weight, or with versions an in-place change,
    captures anew; the table is dropped with its owner."""
    kernel, counts = cpu_capture
    graphs, owner = weakref.WeakKeyDictionary(), _Owner()
    kept = []

    def fn(keep, x):
        keep["seen"] = x
        kept.append(keep)
        return x * owner.w

    def call(key, x, versions=False):
        return K.replay_or_capture(graphs, owner, key, lambda x: K.StaticGraph(
            fn, x, tensors=[owner.w], counter="t.graph", versions=versions), x)

    x, y = torch.arange(2.0), torch.arange(2.0) + 5
    assert torch.equal(call("a", x), x)             # the warm-up's result
    g = graphs[owner]["a"]
    assert g.first is None and g.keep is kept[-1] and len(kept) == 2
    assert g.keep["seen"] is g.inputs[0] and g.inputs[0] is not x
    out = call("a", y)
    assert out is g.out and torch.equal(out, y) and torch.equal(g.inputs[0], y)
    assert counts == {"t.graph_captures": 1, "t.graph_replays": 1}
    assert kernel.launches == 1                     # the replay's; the capture's taken back
    call("b", x)                                    # another key: a graph of its own
    assert set(graphs[owner]) == {"a", "b"} and counts["t.graph_captures"] == 2
    owner.w.add_(1.0)                               # in place: read by the replay
    assert call("a", y) is g.out and torch.equal(g.out, 2 * y)
    owner.w.data = owner.w.data.clone()             # moved to other storage
    call("a", x)
    assert graphs[owner]["a"] is not g and counts["t.graph_captures"] == 3
    call("v", x, versions=True)
    owner.w.add_(1.0)                               # with versions: captures anew
    call("v", x, versions=True)
    assert counts["t.graph_captures"] == 5
    del owner, g
    gc.collect()
    assert len(graphs) == 0                         # dropped with the owner


def test_a_warm_up_marks_every_tensor_of_its_result():
    a, b, c = torch.zeros(1), torch.ones(1), torch.full((1,), 2.0)
    out = {"x": a, "rest": [(object(), b), (c,)], "n": 3}
    assert [id(t) for t in K._tensors(out)] == [id(a), id(b), id(c)]
    assert K._tensors(a) == [a] and K._tensors(None) == []
