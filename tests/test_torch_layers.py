"""llmseg_tpu_torch.models.layers against llmseg_tpu.models.layers.

Same numpy inputs through both, float32 on the CPU (JAX at highest matmul
precision).  Tolerance 1e-5 abs: single ops whose only difference is the
order of float32 sums."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmseg_tpu.models import layers as JL
from llmseg_tpu_torch.import_weights.from_jax import load_
from llmseg_tpu_torch.models import layers as TL

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _rng(seed=0):
    return np.random.RandomState(seed)


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), **(tol or TOL))


def _tree(p):
    return jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_layernorm(eps):
    r = _rng(1)
    x = r.randn(3, 5, 16).astype(np.float32) * 3 + 1
    p = {"scale": r.randn(16).astype(np.float32), "bias": r.randn(16).astype(np.float32)}
    m = load_(TL.LayerNorm(16, eps), p)
    _close(JL.layernorm(p, jnp.asarray(x), eps=eps), m(torch.tensor(x)))


def test_layernorm_default_eps_matches():
    assert TL.LayerNorm(4).eps == 1e-6


def test_rmsnorm():
    r = _rng(2)
    x = r.randn(2, 7, 32).astype(np.float32)
    p = {"scale": r.randn(32).astype(np.float32)}
    m = load_(TL.RMSNorm(32, 1e-6), p)
    _close(JL.rmsnorm(p, jnp.asarray(x), 1e-6), m(torch.tensor(x)))


def test_quick_gelu():
    x = _rng(3).randn(100).astype(np.float32) * 4
    _close(JL.quick_gelu(jnp.asarray(x)), TL.quick_gelu(torch.tensor(x)))


def test_dense():
    p = _tree(JL.dense_init(jax.random.PRNGKey(0), 12, 20))
    p["b"] = _rng(4).randn(20).astype(np.float32)
    x = _rng(5).randn(3, 12).astype(np.float32)
    m = load_(torch.nn.Linear(12, 20), p)
    _close(JL.dense(p, jnp.asarray(x)), m(torch.tensor(x)))


@pytest.mark.parametrize("act", ["default", "quick_gelu", "relu"])
def test_mlp(act):
    """The default activation on both sides is tanh-GELU (jax.nn.gelu's
    default), not the exact erf form."""
    p = _tree(JL.mlp_init(jax.random.PRNGKey(1), 16, 40))
    x = _rng(6).randn(4, 16).astype(np.float32) * 2
    jact = {"default": jax.nn.gelu, "quick_gelu": JL.quick_gelu, "relu": jax.nn.relu}[act]
    tact = {"default": TL.gelu_tanh, "quick_gelu": TL.quick_gelu, "relu": torch.relu}[act]
    m = load_(TL.MLP(16, 40) if act == "default" else TL.MLP(16, 40, act=tact), p)
    _close(JL.mlp(p, jnp.asarray(x)) if act == "default" else JL.mlp(p, jnp.asarray(x), act=jact),
           m(torch.tensor(x)))


def test_mlp_default_is_tanh_gelu():
    x = torch.linspace(-4, 4, 101)
    exact = torch.nn.functional.gelu(x)
    assert (TL.gelu_tanh(x) - exact).abs().max() > 1e-4
    _close(jax.nn.gelu(jnp.asarray(x.numpy())), TL.gelu_tanh(x))


@pytest.mark.parametrize("final", [None, "sigmoid"])
def test_mlp_stack(final):
    p = _tree(JL.mlp_stack_init(jax.random.PRNGKey(2), [16, 8, 3]))
    for lp in p["layers"]:
        lp["b"] = _rng(7).randn(*lp["b"].shape).astype(np.float32)
    x = _rng(8).randn(5, 16).astype(np.float32)
    m = load_(TL.MLPStack([16, 8, 3], final_act=torch.sigmoid if final else None), p)
    ref = JL.mlp_stack(p, jnp.asarray(x), final_act=jax.nn.sigmoid if final else None)
    _close(ref, m(torch.tensor(x)))


@pytest.mark.parametrize("bias", [True, False])
def test_patch_embed(bias):
    p = _tree(JL.patch_embed_init(jax.random.PRNGKey(3), 7, 3, 24, bias=bias))
    if bias:
        p["b"] = _rng(9).randn(24).astype(np.float32)
    x = _rng(10).randn(2, 28, 21, 3).astype(np.float32)
    m = load_(TL.PatchEmbed(7, 3, 24, bias=bias), p)
    _close(JL.patch_embed(p, jnp.asarray(x), 7), m(torch.tensor(x)))


def test_rope_frequencies():
    jc, js = JL.rope_frequencies(16, 40, 10000.0)
    tc, ts = TL.rope_frequencies(16, 40, 10000.0)
    _close(jc, tc)
    _close(js, ts)


@pytest.mark.parametrize("positions", [False, True])
def test_apply_rope(positions):
    x = _rng(11).randn(2, 9, 3, 16).astype(np.float32)
    pos = np.stack([np.arange(9), np.arange(9)[::-1] + 3]).astype(np.int32)
    jc, js = JL.rope_frequencies(16, 32)
    tc, ts = TL.rope_frequencies(16, 32)
    ref = JL.apply_rope(jnp.asarray(x), jc, js, jnp.asarray(pos) if positions else None)
    got = TL.apply_rope(torch.tensor(x), tc, ts,
                        torch.tensor(pos, dtype=torch.long) if positions else None)
    _close(ref, got)
