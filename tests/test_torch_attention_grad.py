"""Gradients of the port's flash attention against the JAX package's.

On the CPU :class:`FlashAttentionFn` runs kernel A's plain forward with lse
and the plain backward of kernels C and D, so these tests hold the
Function's wiring (pre-scale, head padding, permutes, the 1/log2(e)
correction) and the backward's math.  float32 throughout, inputs from numpy
seeds.  Tolerances: 1e-4 against ``jax.grad`` of ``attention_xla`` (the same
gradient with another summation order; entries are O(1)); 5e-3 against
``jax.grad`` of the Pallas ``flash_attention`` in interpret mode, that
comparison's own bound in ``tests/test_attention.py`` (its CPU-interpret
products are less precise); 2e-5 for the plain backward against
``_flash_bwd`` on the same inputs and lse."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmseg_tpu.ops import attention as JA
from llmseg_tpu_torch.ops import attention as TA

torch.set_num_threads(1)


def _qkv(B, T, S, H, D, seed):
    r = np.random.RandomState(seed)
    return tuple(r.randn(B, L, H, D).astype(np.float32) for L in (T, S, S))


def _port_grads(q, k, v, causal):
    q, k, v = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    torch.sin(TA.flash_attention(q, k, v, causal=causal)).sum().backward()
    return [x.grad.numpy() for x in (q, k, v)]


def _jax_grads(fn, q, k, v):
    return jax.grad(lambda q, k, v: jnp.sum(jnp.sin(fn(q, k, v))), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))


@pytest.mark.parametrize("causal,T,S,D", [(True, 96, 96, 32), (False, 96, 96, 64),
                                          (False, 80, 50, 32), (True, 70, 70, 128)])
def test_flash_attention_grads_match_attention_xla(causal, T, S, D):
    q, k, v = _qkv(2, T, S, 2, D, seed=T + D)
    ref = _jax_grads(lambda q, k, v: JA.attention_xla(q, k, v, causal=causal), q, k, v)
    for got, r in zip(_port_grads(q, k, v, causal), ref):
        np.testing.assert_allclose(got, np.asarray(r), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("causal,S", [(False, 64), (True, 64), (False, 50)])
def test_flash_attention_grads_match_jax_flash(causal, S):
    """At tests/test_attention.py's grad shapes, blocks of 32, and a ragged S."""
    q, k, v = _qkv(1, 64, S, 2, 32, seed=S + int(causal))
    ref = _jax_grads(lambda q, k, v: JA.flash_attention(q, k, v, causal=causal,
                                                        block_q=32, block_k=32), q, k, v)
    for got, r in zip(_port_grads(q, k, v, causal), ref):
        np.testing.assert_allclose(got, np.asarray(r), atol=5e-3, rtol=5e-3)


def _heads(x, L_pad):
    B, L, H, D = x.shape
    x = x.transpose(0, 2, 1, 3).reshape(B * H, L, D)
    return np.pad(x, ((0, 0), (0, L_pad - L), (0, 0)))


@pytest.mark.parametrize("causal,T,S,D", [(True, 256, 256, 64), (False, 200, 256, 32),
                                          (False, 256, 200, 64),
                                          # the edges of the card kernels' 64- and
                                          # 128-row tiles
                                          (False, 65, 129, 64), (False, 129, 65, 32),
                                          (True, 200, 200, 128)])
def test_flash_bwd_plain_matches_flash_bwd(causal, T, S, D):
    """flash_bwd_plain against the TPU backward kernels (_bwd_dq_kernel,
    _bwd_dkv_kernel via _flash_bwd) on the same pre-scaled q, o and lse.
    JAX runs on inputs padded to 128-row blocks with zero do on the padded
    rows, which add nothing to dk and dv."""
    q, k, v = _qkv(1, T, S, 2, D, seed=11)
    do = np.random.RandomState(12).randn(2, T, D).astype(np.float32)
    Tp = Sp = 256
    qh = _heads(q, Tp) * np.float32(JA.LOG2E / np.sqrt(D))
    kh, vh = _heads(k, Sp), _heads(v, Sp)
    kw = dict(causal=causal, block_q=128, block_k=128, s_real=S)
    o, lse = JA._flash_fwd(*map(jnp.asarray, (qh, kh, vh)), **kw)
    res = tuple(map(jnp.asarray, (qh, kh, vh))) + (o, lse)
    jdq, jdk, jdv = JA._flash_bwd(res, jnp.asarray(np.pad(do, ((0, 0), (0, Tp - T), (0, 0)))),
                                  **kw)
    dq, dk, dv = TA.flash_bwd_plain(
        torch.tensor(qh[:, :T]), torch.tensor(kh[:, :S]), torch.tensor(vh[:, :S]),
        torch.tensor(np.asarray(o)[:, :T]), torch.tensor(do),
        torch.tensor(np.asarray(lse)[:, :T, 0]), causal=causal)
    for got, r in ((dq, np.asarray(jdq)[:, :T]), (dk, np.asarray(jdk)[:, :S]),
                   (dv, np.asarray(jdv)[:, :S])):
        np.testing.assert_allclose(got.numpy(), r, atol=2e-5, rtol=2e-5)


def _graph_nodes(fn):
    seen, stack = set(), [fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        stack.extend(nxt for nxt, _ in node.next_functions)
    return {type(n).__name__ for n in seen}


def test_grad_path_runs_the_function_and_the_backward_wrappers(monkeypatch):
    """Under autograd the output hangs off FlashAttentionFn and the backward
    calls the kernel C and D wrappers; without autograd the inference
    primal runs and nothing is recorded."""
    calls = {"dq": 0, "dkv": 0}
    dq_fn, dkv_fn = TA.flash_bwd_dq, TA.flash_bwd_dkv

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(TA, "flash_bwd_dq", count("dq", dq_fn))
    monkeypatch.setattr(TA, "flash_bwd_dkv", count("dkv", dkv_fn))
    q, k, v = (torch.tensor(x, requires_grad=True) for x in _qkv(1, 64, 64, 2, 64, seed=3))
    o = TA.flash_attention(q, k, v, causal=True)
    assert "FlashAttentionFnBackward" in _graph_nodes(o.grad_fn)
    o.sum().backward()
    assert calls == {"dq": 1, "dkv": 1}
    assert all(x.grad is not None and bool(torch.isfinite(x.grad).all()) for x in (q, k, v))
    with torch.inference_mode():
        assert TA.flash_attention(q, k, v, causal=True).grad_fn is None
    with torch.no_grad():
        assert TA.flash_attention(q, k, v).grad_fn is None
    assert calls == {"dq": 1, "dkv": 1}


def test_backward_wrappers_check_cuda_inputs():
    """On the card the wrappers check o, do, lse and delta before a launch;
    on the CPU they never get there.  The checks themselves are plain."""
    q = torch.zeros(2, 64, 64)
    with pytest.raises(ValueError, match="do must be"):
        TA._check_rows("do", torch.zeros(2, 64, 32), q)
    with pytest.raises(ValueError, match="lse must be"):
        TA._check_stat("lse", torch.zeros(2, 64, 1), q)
