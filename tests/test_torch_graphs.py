"""The bookkeeping that the port's CUDA graphs share (``ops/kernels.py``):
the stamp of the weights a graph was captured on, the lookup of one graph
a key that replays a current graph and captures anew where a weight moved,
and the tensors a warm-up's result marks as used.  The graphs themselves
run only on the card (``tests/test_torch_cuda.py``); this is their host
side, with a stand-in graph."""

import gc
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


class _Owner:
    """Stands in for a module: weak-referenceable, one weight."""

    def __init__(self):
        self.w = torch.ones(2)


class _Graph:
    """Stands in for a captured graph: its warm-up result, a replay that
    counts, the owner's weight stamped (read through a weak reference, as
    the port's graphs keep the weights and not their module)."""
    made = 0

    def __init__(self, owner, x):
        self.owner, self.stamp = weakref.ref(owner), K.stamp([owner.w])
        self.first, self.replays = x * 2, 0
        _Graph.made += 1

    def current(self):
        return self.stamp == K.stamp([self.owner().w])

    def replay(self, x):
        self.replays += 1
        return x * 2


def test_replay_or_capture_keeps_one_graph_a_key_and_captures_where_a_weight_moved():
    graphs, owner, x = weakref.WeakKeyDictionary(), _Owner(), torch.arange(3.0)
    _Graph.made = 0

    def call(key):
        return K.replay_or_capture(graphs, owner, key, lambda x: _Graph(owner, x), x)

    assert torch.equal(call("a"), x * 2)            # the warm-up's result
    g = graphs[owner]["a"]
    assert g.first is None and g.replays == 0 and _Graph.made == 1
    assert torch.equal(call("a"), x * 2) and g.replays == 1 and _Graph.made == 1
    call("b")                                       # another key: a graph of its own
    assert _Graph.made == 2 and set(graphs[owner]) == {"a", "b"}
    owner.w = owner.w.clone()                       # a moved weight
    call("a")
    assert _Graph.made == 3 and graphs[owner]["a"] is not g
    del owner, g
    gc.collect()
    assert len(graphs) == 0                         # dropped with the owner


def test_a_warm_up_marks_every_tensor_of_its_result():
    a, b, c = torch.zeros(1), torch.ones(1), torch.full((1,), 2.0)
    out = {"x": a, "rest": [(object(), b), (c,)], "n": 3}
    assert [id(t) for t in K._tensors(out)] == [id(a), id(b), id(c)]
    assert K._tensors(a) == [a] and K._tensors(None) == []
