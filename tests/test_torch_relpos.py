"""The port's rel-pos attention against the JAX package's.

Inputs from numpy seeds go through both.  JAX's ``relpos_flash_attention``
runs its Pallas kernels in interpret mode on the CPU (``_kernel`` for
G = 32, T = 1024 > 512; ``_window_kernel`` for G = 14), the port's runs the
plain versions of kernels E and F.  float32, JAX at highest matmul
precision; tolerance 2e-5, as the JAX package's own rel-pos test."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmseg_tpu.models.sam import image_encoder as jie
from llmseg_tpu.ops.attention import attention_xla
from llmseg_tpu.ops.relpos_attention import relpos_flash_attention as jax_relpos
from llmseg_tpu_torch.ops import relpos_attention as R

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(G, H, D, seed, B=1):
    rng = np.random.RandomState(seed)
    T = G * G
    q, k, v = (rng.randn(B, T, H, D).astype(np.float32) for _ in range(3))
    rel_h, rel_w = ((0.1 * rng.randn(2 * G - 1, D)).astype(np.float32) for _ in range(2))
    return q, k, v, rel_h, rel_w


@pytest.mark.parametrize("G,H,D,block_q", [(32, 2, 16, 512), (14, 3, 16, 512), (4, 2, 8, 512)])
def test_relpos_flash_attention_matches_jax(G, H, D, block_q):
    """G = 32 reaches JAX's ``_kernel`` and the port's kernel E plain path;
    G = 14 and 4 reach ``_window_kernel`` and kernel F's."""
    q, k, v, rh, rw = _inputs(G, H, D, seed=G)
    ref = jax_relpos(*(jnp.asarray(x) for x in (q, k, v, rh, rw)), G, block_q=block_q)
    got = R.relpos_flash_attention(*(torch.tensor(x) for x in (q, k, v, rh, rw)), G)
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), **TOL)


def test_kernel_f_plain_matches_window_kernel_on_padded_windows():
    """Kernel F's plain path against the interpret-mode ``_window_kernel`` at
    ViT-H's head width D = 80, on windows that ``window_partition`` cuts from
    a 64-wide token grid: the last column's window holds 6 zero-padded
    columns, the corner window 6 rows and 6 columns; in both the zero tokens
    are real keys."""
    from llmseg_tpu_torch.models.sam.image_encoder import window_partition
    rng = np.random.RandomState(12)
    G, H, D = 14, 2, 80
    wins = [window_partition(torch.tensor(rng.randn(1, 64, 64, H * D).astype(np.float32)), G)[0]
            for _ in range(3)]                                  # (25, 14, 14, H*D) each
    q, k, v = (w[[4, 24]].reshape(2, G * G, H, D) for w in wins)
    assert bool((q[0].reshape(G, G, H * D)[:, 8:] == 0).all())
    assert bool((k[1].reshape(G, G, H * D)[8:] == 0).all())
    rh, rw = ((0.1 * rng.randn(2 * G - 1, D)).astype(np.float32) for _ in range(2))
    ref = jax_relpos(*(jnp.asarray(x.numpy()) for x in (q, k, v)), jnp.asarray(rh),
                     jnp.asarray(rw), G)
    got = R.relpos_flash_attention(q, k, v, torch.tensor(rh), torch.tensor(rw), G)
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), **TOL)


def test_decomposed_bias_and_table_match_jax():
    G, H, D = 6, 2, 8
    q, _, _, rh, rw = _inputs(G, H, D, seed=3, B=2)
    qh = q.transpose(0, 2, 1, 3)
    ref = jie.decomposed_rel_pos_bias(jnp.asarray(qh), jnp.asarray(rh), jnp.asarray(rw), G)
    got = R.decomposed_rel_pos_bias(torch.tensor(qh), torch.tensor(rh), torch.tensor(rw), G)
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), **TOL)
    np.testing.assert_array_equal(np.asarray(jie._rel_pos_table(jnp.asarray(rh), G, G)),
                                  R.rel_pos_table(torch.tensor(rh), G, G).numpy())


@pytest.mark.parametrize("window", [True, False])
def test_kernel_plain_versions_match_bias_attention(window):
    """Kernel E's and F's plain versions on the tables equal plain attention
    with the materialised bias (the off-TPU path of attn_apply), at ViT-H's
    head width D = 80."""
    G, H, D = (14, 2, 80) if window else (24, 1, 80)
    q, k, v, rh, rw = _inputs(G, H, D, seed=5)
    bias = jie.decomposed_rel_pos_bias(jnp.asarray(q.transpose(0, 2, 1, 3)), jnp.asarray(rh),
                                       jnp.asarray(rw), G)
    ref = attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=bias)
    qt, kt, vt = (torch.tensor(x) for x in (q, k, v))
    th, tw = R.relpos_tables(qt, torch.tensor(rh), torch.tensor(rw), G)
    qs = qt * (R.LOG2E / np.sqrt(D))

    def prep(x):
        return x.permute(0, 2, 1, 3).reshape(H, G * G, D)

    plain = R.relpos_window_plain if window else R.relpos_fwd_plain
    got = plain(prep(qs), prep(kt), prep(vt), th, tw).reshape(1, H, G * G, D).permute(0, 2, 1, 3)
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), **TOL)


def test_bf16_tables_are_rounded_like_jax():
    """rh/rw are scaled by log2(e) and rounded to q's dtype, as in JAX."""
    G, H, D = 8, 2, 16
    q, _, _, rh, rw = _inputs(G, H, D, seed=9)
    qb = torch.tensor(q).bfloat16()
    th, tw = R.relpos_tables(qb, torch.tensor(rh), torch.tensor(rw), G)
    assert th.dtype == torch.bfloat16 and th.shape == (H, G * G, G)
    ref = jie._rel_pos_table(jnp.asarray(rh), G, G).astype(jnp.bfloat16)
    qg = jnp.asarray(qb.float().numpy()).astype(jnp.bfloat16).reshape(1, G, G, H, D)
    jrh = jnp.einsum("bhwnd,hkd->bnhwk", qg, ref, preferred_element_type=jnp.float32)
    jrh = (jrh.reshape(H, G * G, G) * R.LOG2E).astype(jnp.bfloat16)
    np.testing.assert_array_equal(np.asarray(jrh.astype(jnp.float32)), th.float().numpy())


def test_wrappers_take_the_plain_version_on_the_cpu():
    G, H, D = 4, 1, 16
    q, k, v, rh, rw = (torch.tensor(x) for x in _inputs(G, H, D, seed=1))
    prep = [x.permute(0, 2, 1, 3).reshape(H, G * G, D) for x in (q, k, v)]
    th, tw = R.relpos_tables(q, rh, rw, G)
    before = (R.RELPOS_FWD.launches, R.RELPOS_WINDOW.launches)
    torch.testing.assert_close(R.relpos_fwd(*prep, th, tw), R.relpos_fwd_plain(*prep, th, tw))
    torch.testing.assert_close(R.relpos_window(*prep, th, tw),
                               R.relpos_window_plain(*prep, th, tw))
    assert (R.RELPOS_FWD.launches, R.RELPOS_WINDOW.launches) == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [16, 64, 80])
def test_q_times_the_rounded_scale_equals_the_tensor_product(dtype, D):
    """q times the scale rounded to q's dtype as a Python float (no copy to
    the card) equals, to the bit, q times a 0-dim tensor of the scale in
    q's dtype, the product the kernels were held to before."""
    q = torch.tensor(np.random.RandomState(D).randn(2, 196, 3, D) * 4).to(dtype)
    scale = D ** -0.5 * R.LOG2E
    old = q * torch.tensor(scale, dtype=dtype, device=q.device)
    new = q * R.in_dtype(scale, dtype)
    assert new.dtype == dtype
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(new.view(bits), old.view(bits))


@pytest.mark.parametrize("size", [3, 7, 14, 64])
def test_rel_pos_table_index_is_made_on_the_tables_device_once(size):
    """The index rel_pos_table takes is the one the host used to build and
    copy (the same integers), made on the table's device and kept there."""
    q_coords = torch.arange(size)[:, None] * 1.0
    k_coords = torch.arange(size)[None, :] * 1.0
    old = ((q_coords - k_coords) + (size - 1) * 1.0).long()
    table = torch.tensor(np.random.RandomState(size).randn(2 * size - 1, 8).astype(np.float32))
    idx = R._table_index(size, size, table.device)
    assert idx.dtype == torch.int64 and idx.device == table.device
    assert torch.equal(idx, old) and R._table_index(size, size, table.device) is idx
    assert torch.equal(R.rel_pos_table(table, size, size), table[old])
    with torch.inference_mode():   # kept as a normal tensor, usable under autograd
        assert not R._table_index(size, size, table.device).is_inference()
