"""The plain versions of kernels H and I (the materialised two-way decode
and transformer) and their routing, against the JAX package's.

JAX initialises the decoder at a test size (dim 64, 8 heads, depth 2);
every leaf is jittered with seeded numpy noise, converted with
``import_weights.from_jax`` and run through both.  JAX's
``fused_decode_apply`` and ``fused_twoway_apply`` run ``_decode_kernel``
and ``_kernel`` in Pallas interpret mode.  float32, JAX at highest matmul
precision.  Tolerance 1e-5, as the JAX package's own tests of these
kernels: the same operations summed in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmseg_tpu.config import SamDecoderConfig as JDC
from llmseg_tpu.models.sam import mask_decoder as jmd
from llmseg_tpu.models.sam import two_way_transformer as jtwt
from llmseg_tpu.ops import twoway_kernel as jtk
from llmseg_tpu_torch.config import SamDecoderConfig as TDC
from llmseg_tpu_torch.import_weights.from_jax import load_
from llmseg_tpu_torch.models.sam.mask_decoder import MaskDecoder
from llmseg_tpu_torch.models.sam.two_way_transformer import TwoWayTransformer
from llmseg_tpu_torch.ops import twoway_kernel as tk

torch.set_num_threads(1)
DIMS = dict(transformer_dim=64, transformer_depth=2, transformer_num_heads=8,
            transformer_mlp_dim=128, iou_head_hidden_dim=32)
NH = 8
TOL = 1e-5


def _jitter(params, seed, amp=0.1):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + amp * rng.randn(*np.shape(x))).astype(np.float32), params)


@pytest.fixture(scope="module")
def decoders():
    p = _jitter(jmd.init(jax.random.PRNGKey(0), JDC(**DIMS)), 1)
    return p, load_(MaskDecoder(TDC(**DIMS)), p)


def _inputs(B, Bi, seed, S=8, d=64, n_sparse=2):
    rng = np.random.RandomState(seed)
    emb = (rng.randn(Bi, S, S, d) * 0.5).astype(np.float32)
    pe = (rng.randn(S, S, d) * 0.5).astype(np.float32)
    sparse = (rng.randn(B, n_sparse, d) * 0.5).astype(np.float32)
    dense = (rng.randn(B, S, S, d) * 0.1).astype(np.float32)
    return emb, pe, sparse, dense


def _tokens(p, sparse):
    B = sparse.shape[0]
    out_tok = np.concatenate([p["iou_token"], p["mask_tokens"]], 0)
    return np.concatenate([np.broadcast_to(out_tok[None], (B,) + out_tok.shape), sparse], 1)


def _close(ref, got, atol=TOL):
    np.testing.assert_allclose(np.asarray(ref), got.detach().numpy(), atol=atol, rtol=0)


def test_fused_twoway_plain_matches_kernel():
    """``fused_twoway_plain`` and its wrapper on the CPU against the
    interpret-mode ``_kernel`` (the case of the JAX package's own test)."""
    p = _jitter(jtwt.init(jax.random.PRNGKey(0), 2, 64, 4, 128), 2)
    m = load_(TwoWayTransformer(2, 64, 4, 128), p)
    rng = np.random.RandomState(3)
    emb, pe, pts = (rng.randn(*s).astype(np.float32) * 0.5
                    for s in ((3, 8, 8, 64), (8, 8, 64), (3, 7, 64)))
    qj, kj = jtk.fused_twoway_apply(p, jnp.asarray(emb), jnp.asarray(pe), jnp.asarray(pts), 4)
    args = (m, torch.tensor(emb), torch.tensor(pe), torch.tensor(pts), 4)
    with torch.no_grad():
        for fn in (tk.fused_twoway_plain, tk.fused_twoway_apply):
            qt, kt = fn(*args)
            assert qt.shape == (3, 7, 64) and kt.shape == (3, 64, 64)
            _close(qj, qt)
            _close(kj, kt)


@pytest.mark.parametrize("B,n_sparse", [(4, 2), (1, 1)])
def test_fused_decode_plain_per_prompt_base_matches_kernel(decoders, B, n_sparse):
    """A base per prompt: ``fused_decode_plain`` and ``fused_decode_apply``
    (kernel H's wrapper, the plain version on the CPU) against the
    interpret-mode ``_decode_kernel``."""
    p, m = decoders
    emb, pe, sparse, dense = _inputs(B, B, seed=4, n_sparse=n_sparse)
    base, tokens = emb + dense, _tokens(p, sparse)
    mj, ij = jtk.fused_decode_apply(p["transformer"], p, jnp.asarray(base), jnp.asarray(pe),
                                    jnp.asarray(tokens), NH)
    args = (m.transformer, m, torch.tensor(base), torch.tensor(pe), torch.tensor(tokens), NH)
    with torch.no_grad():
        for fn in (tk.fused_decode_plain, tk.fused_decode_apply):
            mt, it = fn(*args)
            assert mt.shape == (B, 4, 32, 32) and it.shape == (B, 4)
            _close(mj, mt)
            _close(ij, it)


def test_fused_decode_plain_shared_base_unfactored_matches_kernel(decoders):
    """A shared base with ``factored=False``: layer 0's keys-side
    projections computed once from the base, on both sides; the same masks
    as the base broadcast to every prompt."""
    p, m = decoders
    emb, pe, sparse, _ = _inputs(5, 1, seed=5)
    tokens = _tokens(p, sparse)
    mj, ij = jtk.fused_decode_apply(p["transformer"], p, jnp.asarray(emb), jnp.asarray(pe),
                                    jnp.asarray(tokens), NH, factored=False)
    targs = (torch.tensor(pe), torch.tensor(tokens), NH)
    with torch.no_grad():
        mt, it = tk.fused_decode_apply(m.transformer, m, torch.tensor(emb), *targs,
                                       factored=False)
        mb, ib = tk.fused_decode_plain(m.transformer, m, torch.tensor(emb).expand(5, 8, 8, 64),
                                       *targs)
    _close(mj, mt)
    _close(ij, it)
    torch.testing.assert_close(mt, mb, atol=TOL, rtol=0)
    torch.testing.assert_close(it, ib, atol=TOL, rtol=0)


def test_predict_masks_fused_per_prompt_base_matches_jax(decoders):
    """``predict_masks(impl="fused")`` with a dense prompt per prompt: the
    route that reaches ``_decode_kernel`` on the TPU and kernel H on the
    card (here its plain version), against JAX's."""
    p, m = decoders
    emb, pe, sparse, dense = _inputs(4, 1, seed=6)
    mj, ij = jmd.predict_masks(p, JDC(**DIMS), jnp.asarray(emb), jnp.asarray(pe),
                               jnp.asarray(sparse), jnp.asarray(dense), impl="fused")
    with torch.no_grad():
        mt, it = m.predict_masks(torch.tensor(emb), torch.tensor(pe), torch.tensor(sparse),
                                 torch.tensor(dense), impl="fused")
    _close(mj, mt)
    _close(ij, it)


def test_fused_route_under_autograd_is_the_plain_tail(decoders):
    """Under autograd ``impl="fused"`` takes the plain tail, as JAX's
    ``custom_vjp`` computes value and gradient with ``_xla_tail``: the
    value and every gradient equal ``impl="xla"``'s, and the value JAX's."""
    p, m = decoders
    emb, pe, sparse, _ = _inputs(9, 1, seed=7)
    dense = np.broadcast_to((np.random.RandomState(8).randn(1, 8, 8, 64) * 0.1)
                            .astype(np.float32), (9, 8, 8, 64))
    targs = (torch.tensor(emb), torch.tensor(pe), torch.tensor(sparse), torch.tensor(dense))

    def loss(impl):
        mk, ik = m.predict_masks(*targs, impl=impl)
        val = mk.float().square().mean() + ik.float().mean()
        val.backward()
        grads = {n: q.grad.clone() for n, q in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        return val.item(), grads

    v_fused, g_fused = loss("fused")
    v_xla, g_xla = loss("xla")
    assert v_fused == v_xla
    for n in g_xla:
        torch.testing.assert_close(g_fused[n], g_xla[n], atol=0, rtol=0)
    mj, ij = jmd.predict_masks(p, JDC(**DIMS), *map(jnp.asarray, (emb, pe, sparse, dense)),
                               impl="fused")
    v_jax = float(jnp.mean(mj.astype(jnp.float32) ** 2) + jnp.mean(ij.astype(jnp.float32)))
    assert abs(v_jax - v_fused) < 1e-5


def test_two_way_transformer_fused_matches_jax():
    """``TwoWayTransformer(impl="fused")`` (kernel I's wrapper, its plain
    version on the CPU) against JAX's ``apply(impl="fused")``; under
    autograd the fused route falls back to the differentiable plain one."""
    p = _jitter(jtwt.init(jax.random.PRNGKey(4), 2, 64, 8, 128), 5)
    m = load_(TwoWayTransformer(2, 64, 8, 128), p)
    rng = np.random.RandomState(6)
    emb, pe, pts = (rng.randn(*s).astype(np.float32) * 0.5
                    for s in ((2, 8, 8, 64), (1, 8, 8, 64), (2, 6, 64)))
    qj, kj = jtwt.apply(p, jnp.asarray(emb), jnp.asarray(pe), jnp.asarray(pts), 8, impl="fused")
    targs = (torch.tensor(emb), torch.tensor(pe), torch.tensor(pts))
    with torch.no_grad():
        qt, kt = m(*targs, impl="fused")
    _close(qj, qt)
    _close(kj, kt)
    qg, kg = m(*targs, impl="fused")
    assert qg.grad_fn is not None
    qx, kx = m(*targs, impl="xla")
    torch.testing.assert_close(qg, qx, atol=0, rtol=0)
    with pytest.raises(ValueError):
        m(*targs, impl="pallas")


def test_routing_on_the_cpu_never_reaches_a_kernel(decoders):
    """On the CPU ``should_fuse`` is false, so ``impl="auto"`` takes the
    plain routes, and no kernel counts a launch."""
    p, m = decoders
    emb, pe, sparse, dense = _inputs(9, 9, seed=9)
    before = [kern.launches for kern in tk.KERNELS]
    with torch.no_grad():
        got = m.predict_masks(torch.tensor(emb), torch.tensor(pe), torch.tensor(sparse),
                              torch.tensor(dense))
        want = m.plain_tail(torch.tensor(emb + dense), torch.tensor(pe), torch.tensor(
            _tokens(p, sparse)))
    assert [kern.launches for kern in tk.KERNELS] == before
    torch.testing.assert_close(got, want)
