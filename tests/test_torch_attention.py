"""llmseg_tpu_torch.ops.attention against llmseg_tpu.ops.attention.

On the CPU the port's kernel wrappers run their plain versions; the JAX side
runs its Pallas kernels in interpret mode (shapes kept at T <= 300, since
interpret mode is slow).  float32 throughout.  Tolerances: 2e-5 abs where
the two compute the same softmax with another summation order (the TPU
kernels' own tests use the same bound against attention_xla), 5e-5 for the
near-orthogonal large-norm rescue case, as its JAX test states."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmseg_tpu.ops import attention as JA
from llmseg_tpu_torch.ops import attention as TA

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(B=1, T=128, S=128, H=2, D=32, seed=0):
    r = np.random.RandomState(seed)
    return tuple(r.randn(B, L, H, D).astype(np.float32) for L in (T, S, S))


def _t(*xs):
    return tuple(torch.tensor(x) for x in xs)


def _heads(x, L_pad=None):
    """(B, L, H, D) numpy -> (B*H, L, D), zero-padded to L_pad rows."""
    B, L, H, D = x.shape
    x = x.transpose(0, 2, 1, 3).reshape(B * H, L, D)
    if L_pad is not None:
        x = np.pad(x, ((0, 0), (0, L_pad - L), (0, 0)))
    return x


@pytest.mark.parametrize("causal,T,S,D", [
    (False, 256, 256, 64), (True, 256, 256, 64), (True, 256, 256, 32),
    (False, 256, 200, 32), (False, 128, 100, 64)])
def test_kernel_a_plain_matches_fwd_kernel(causal, T, S, D):
    """Kernel A's plain version (o and log2 lse) against the TPU kernel
    _fwd_kernel with several 128-wide k-blocks and ragged key padding."""
    q, k, v = _qkv(T=T, S=S, D=D, seed=1)
    scale = 1.0 / np.sqrt(D) * JA.LOG2E
    qh, kh, vh = _heads(q) * np.float32(scale), _heads(k), _heads(v)
    Tp, Sp = 256, 256
    jo, jlse = JA._flash_fwd(jnp.asarray(np.pad(qh, ((0, 0), (0, Tp - T), (0, 0)))),
                             jnp.asarray(_heads(k, Sp)), jnp.asarray(_heads(v, Sp)),
                             causal=causal, block_q=128, block_k=128, s_real=S)
    to, tlse = TA.flash_fwd(*_t(qh, kh, vh), causal=causal, with_lse=True)
    np.testing.assert_allclose(np.asarray(jo)[:, :T], to.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(jlse)[:, :T, 0], tlse.numpy(), **TOL)


@pytest.mark.parametrize("D", [32, 64])
def test_flash_attention_causal_matches_jax(D):
    """The public causal entry (kernel A's path) against JAX
    flash_attention; D=32 is zero-padded on both sides."""
    q, k, v = _qkv(B=2, T=256, S=256, D=D, seed=2)
    ref = JA.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                             block_q=128, block_k=128)
    got = TA.flash_attention(*_t(q, k, v), causal=True)
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), **TOL)


def test_kernel_a_plain_bias_matches_flash_attention_bias():
    q, k, v = _qkv(B=1, T=64, S=96, H=2, D=32, seed=3)
    bias = np.random.RandomState(4).randn(2, 64, 96).astype(np.float32)
    ref = JA.flash_attention_bias(*map(jnp.asarray, (q, k, v, bias)))
    scale = 1.0 / np.sqrt(32) * JA.LOG2E
    qh, kh, vh, bh = _t(_heads(q) * np.float32(scale), _heads(k), _heads(v),
                        bias * np.float32(JA.LOG2E))
    o, _ = TA.flash_fwd(qh, kh, vh, causal=False, bias=bh)
    got = o.reshape(1, 2, 64, 32).permute(0, 2, 1, 3)
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), **TOL)


def test_kernel_b_plain_matches_fwd1_kernel():
    """Non-causal single-k-block shape: JAX routes it to _fwd1_kernel."""
    q, k, v = _qkv(B=1, T=200, S=300, D=64, seed=7)
    ref = JA.flash_attention(*map(jnp.asarray, (q, k, v)))
    got = TA.flash_attention(*_t(q, k, v))
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), **TOL)


@pytest.mark.parametrize("T,S", [(65, 129), (129, 65)])
def test_kernel_b_plain_matches_fwd1_kernel_off_the_tiles(T, S):
    """Kernel B's plain version against the interpret-mode ``_fwd1_kernel``
    at lengths off the 128-row tiles, S != T both ways."""
    q, k, v = _qkv(B=1, T=T, S=S, D=64, seed=10)
    scale = np.float32(1.0 / np.sqrt(64) * JA.LOG2E)
    qh, kh, vh = _heads(q) * scale, _heads(k), _heads(v)
    Tp, Sp = -(-T // 128) * 128, -(-S // 128) * 128
    ref = JA._flash_fwd_1pass(jnp.asarray(np.pad(qh, ((0, 0), (0, Tp - T), (0, 0)))),
                              jnp.asarray(_heads(k, Sp)), jnp.asarray(_heads(v, Sp)),
                              block_q=128, s_real=S)
    got = TA.flash_fwd_1pass_plain(*_t(qh, kh, vh), TA.key_norm_max(torch.tensor(kh)))
    np.testing.assert_allclose(np.asarray(ref)[:, :T], got.numpy(), **TOL)


def test_kernel_b_wrapper_on_the_cpu_is_the_plain_path_with_key_norm_max():
    """On the CPU kernel B's wrapper launches nothing and computes the plain
    version with ``key_norm_max`` (on the card its C call computes it)."""
    q, k, v = _t(*(_heads(x) for x in _qkv(B=1, T=65, S=129, D=64, seed=11)))
    before = TA.FLASH_FWD_1PASS.launches
    got = TA.flash_fwd_1pass(q, k, v)
    assert TA.FLASH_FWD_1PASS.launches == before
    assert torch.equal(got, TA.flash_fwd_1pass_plain(q, k, v, TA.key_norm_max(k)))


def _adversarial(seed):
    """Near-orthogonal, large-norm q and k (tests/test_attention.py's
    construction): the Cauchy bound overshoots the row max and the
    bound-shifted sum underflows, firing the rescue."""
    rng = np.random.RandomState(seed)
    B, T, S, H, D = 1, 200, 300, 2, 64
    q = np.zeros((B, T, H, D), np.float32)
    k = np.zeros((B, S, H, D), np.float32)
    q[..., :32] = rng.randn(B, T, H, 32) * 30.0
    k[..., 32:] = rng.randn(B, S, H, 32) * 30.0
    q[..., 32] = rng.randn(B, T, H) * 0.3
    v = rng.randn(B, S, H, D).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_b_plain_rescue_matches_jax(seed):
    q, k, v = _adversarial(seed)
    # the rescue does fire: the bound-shifted sums underflow
    scale = np.float32(1.0 / np.sqrt(64) * JA.LOG2E)
    qh, kh = torch.tensor(_heads(q) * scale), torch.tensor(_heads(k))
    b = torch.clamp_min(qh.norm(dim=-1, keepdim=True)
                        * TA.key_norm_max(kh)[:, None, None], 1.0)
    l = torch.exp2(qh @ kh.transpose(1, 2) - b).sum(-1)
    assert (l <= TA.RESCUE_L).any()
    ref = JA.flash_attention(*map(jnp.asarray, (q, k, v)))
    got = TA.flash_attention(*_t(q, k, v))
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_attention_matches_attention_xla(causal, with_bias):
    q, k, v = _qkv(B=2, T=48, S=48, H=2, D=16, seed=5)
    bias = None
    if with_bias:
        bias = np.where(np.arange(48)[None, None, None, :] < 30, 0.0,
                        JA.NEG_INF).astype(np.float32)
    ref = JA.attention_xla(*map(jnp.asarray, (q, k, v)), causal=causal,
                           bias=None if bias is None else jnp.asarray(bias))
    got = TA.attention(*_t(q, k, v), causal=causal,
                       bias=None if bias is None else torch.tensor(bias))
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), atol=1e-5, rtol=1e-5)


def test_attention_on_cpu_takes_the_plain_path():
    """CPU tensors never reach a kernel, whatever their length."""
    q, k, v = _t(*_qkv(B=1, T=300, S=300, H=1, D=64, seed=6))
    before = [kern.launches for kern in TA.KERNELS]
    out = TA.attention(q, k, v, causal=True)
    assert [kern.launches for kern in TA.KERNELS] == before
    torch.testing.assert_close(out, TA.attention_plain(q, k, v, causal=True))


@pytest.mark.parametrize("shapes", [((2, 64, 64), (2, 64, 32), (2, 64, 32)),
                                    ((2, 64, 64), (3, 64, 64), (3, 64, 64)),
                                    ((2, 64, 64), (2, 64, 64), (2, 60, 64)),
                                    ((1, 2, 64, 64), (2, 64, 64), (2, 64, 64))])
def test_kernel_wrappers_reject_mismatched_shapes(shapes):
    """The CUDA wrappers check shapes before anything reaches a kernel."""
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError, match="expected q"):
        TA._check_cuda(q, k, v)


@pytest.mark.parametrize("adversarial", [False, True])
def test_kernel_j_plain_matches_fwd1t_kernel(adversarial):
    """Kernel J's plain version (o^T, the rescue decided per column) against
    the interpret-mode ``_fwd1t_kernel`` (decided per block); the
    adversarial norms fire the rescue."""
    q, k, v = _adversarial(3) if adversarial else _qkv(B=1, T=200, S=300, D=64, seed=8)
    T, S = 200, 300
    scale = np.float32(1.0 / np.sqrt(64) * JA.LOG2E)
    qh, kh, vh = _heads(q) * scale, _heads(k), _heads(v)
    if adversarial:
        qt, kt = torch.tensor(qh), torch.tensor(kh)
        b = torch.clamp_min(qt.norm(dim=-1) * TA.key_norm_max(kt)[:, None], 1.0)
        l = torch.exp2(kt @ qt.transpose(1, 2) - b[:, None, :]).sum(1)
        assert (l <= TA.RESCUE_L).any()
    ref = JA._flash_fwd_1pass_t(jnp.asarray(np.pad(qh, ((0, 0), (0, 56), (0, 0)))),
                                jnp.asarray(_heads(k, 384)), jnp.asarray(_heads(v, 384)),
                                block_q=128, s_real=S)
    got = TA.flash_fwd_1pass_t(*_t(qh, kh, vh))
    assert got.shape == (2, 64, T)
    np.testing.assert_allclose(np.asarray(ref)[:, :T], got.transpose(1, 2).numpy(), **TOL)


@pytest.mark.parametrize("onepass,onepass_t", [(True, True), (False, False), (False, True)])
def test_flash_attention_follows_the_onepass_flags(monkeypatch, onepass, onepass_t):
    """The non-causal inference forward under the JAX module's flags (the
    port reads ``LLMSEG_ATTN_ONEPASS`` and ``LLMSEG_ATTN_ONEPASS_T`` at
    import into the same names): kernel J's path, and kernel A's."""
    for mod in (JA, TA):
        monkeypatch.setattr(mod, "ONEPASS", onepass)
        monkeypatch.setattr(mod, "ONEPASS_T", onepass_t)
    q, k, v = _qkv(B=1, T=200, S=300, D=64, seed=9)
    ref = JA.flash_attention(*map(jnp.asarray, (q, k, v)))
    got = TA.flash_attention(*_t(q, k, v))
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), **TOL)
