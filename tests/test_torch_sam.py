"""The port's SAM modules against the JAX package's, on the same weights.

JAX initialises ``sam_tiny``; every leaf is jittered with seeded numpy noise
(so the zero rel-pos tables and position embedding, zero biases and unit
scales all carry signal), converted with ``import_weights.from_jax`` (a
strict load) and run through both.  float32 on the CPU, JAX at highest
matmul precision.  Tolerances: single modules 1e-5; the whole encoder's
embedding and the masks decoded from it 1e-4 (the float32 rounding
differences of the blocks, the neck and the decoder compound)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmseg_tpu import config as JC
from llmseg_tpu.models import layers as jl
from llmseg_tpu.models.sam import image_encoder as jie
from llmseg_tpu.models.sam import prompt_encoder as jpe
from llmseg_tpu.models.sam import sam as jsam
from llmseg_tpu_torch import config as TC
from llmseg_tpu_torch.import_weights.from_jax import flatten, load_
from llmseg_tpu_torch.models import layers as tl
from llmseg_tpu_torch.models.sam import image_encoder as tie
from llmseg_tpu_torch.models.sam import sam as tsam

torch.set_num_threads(1)


def _jitter(params, seed, amp=0.1):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + amp * rng.randn(*np.shape(x))).astype(np.float32), params)


@pytest.fixture(scope="module")
def tiny():
    p = _jitter(jsam.init(jax.random.PRNGKey(0), JC.sam_tiny()), 1)
    return p, load_(tsam.build(TC.sam_tiny(), device="cpu"), p)


def _close(ref, got, atol=1e-5):
    np.testing.assert_allclose(np.asarray(ref), got.detach().numpy(), atol=atol, rtol=0)


@pytest.mark.parametrize("stride,padding,k", [(1, "SAME", 3), (2, "VALID", 2), (1, "SAME", 1)])
def test_conv2d_nhwc_hwio(stride, padding, k):
    p = _jitter(jl.conv2d_init(jax.random.PRNGKey(0), 3, 5, k), 2)
    x = np.random.RandomState(3).randn(2, 8, 8, 3).astype(np.float32)
    conv = load_(tl.Conv2d(3, 5, k), p)
    _close(jl.conv2d(p, jnp.asarray(x), stride=stride, padding=padding),
           conv(torch.tensor(x), stride=stride, padding=padding))


def test_layernorm2d_and_position_embeddings():
    rng = np.random.RandomState(4)
    ln = _jitter(jl.layernorm2d_init(6), 5)
    x = rng.randn(2, 4, 4, 6).astype(np.float32)
    _close(jl.layernorm2d(ln, jnp.asarray(x)), load_(tl.LayerNorm2d(6), ln)(torch.tensor(x)))
    pe = jl.position_embedding_random_init(jax.random.PRNGKey(1), 8)
    m = load_(tl.PositionEmbeddingRandom(8), pe)
    coords = rng.rand(3, 5, 2).astype(np.float32)
    _close(jl.position_embedding_random(pe, jnp.asarray(coords)), m(torch.tensor(coords)))
    _close(jl.position_grid(pe, 7), tl.position_grid(m, 7))


def test_window_partition_roundtrip_matches_jax():
    x = np.random.RandomState(6).randn(2, 10, 10, 8).astype(np.float32)
    wj, hp = jie.window_partition(jnp.asarray(x), 4)
    wt, hpt = tie.window_partition(torch.tensor(x), 4)
    assert hp == hpt
    _close(wj, wt, 0)
    _close(jie.window_unpartition(wj, 4, hp, (10, 10)),
           tie.window_unpartition(wt, 4, hpt, (10, 10)), 0)


def test_image_encoder_matches_jax(tiny):
    p, m = tiny
    x = np.random.RandomState(7).randn(2, 64, 64, 3).astype(np.float32)
    ref = jsam.encode_image(p, jnp.asarray(x), JC.sam_tiny())
    got = tsam.encode_image(m, torch.tensor(x))
    assert got.shape == (2, 4, 4, 16)
    _close(ref, got, 1e-4)


def test_encoder_block_with_window_padding_matches_jax():
    """A 5 x 5 grid in 2 x 2 windows: the zero tokens that pad each window
    take part in the attention, as in JAX."""
    jcfg = JC.replace(JC.sam_tiny().encoder, img_size=80)
    tcfg = TC.replace(TC.sam_tiny().encoder, img_size=80)
    p = _jitter(jie.block_init(jax.random.PRNGKey(2), jcfg, 0), 8)
    blk = load_(tie.Block(tcfg, 0), p)
    x = np.random.RandomState(9).randn(1, 5, 5, 32).astype(np.float32)
    _close(jie.block_apply(p, jnp.asarray(x), jcfg, 0), blk(torch.tensor(x)), 1e-5)


def test_prompt_encoder_matches_jax(tiny):
    p, m = tiny
    cfg = JC.sam_tiny().prompt
    pp = p["prompt_encoder"]
    rng = np.random.RandomState(10)
    pts = (rng.rand(3, 2, 2) * 64).astype(np.float32)
    labels = np.array([[1, 0], [1, -10], [0, 1]], np.int32)
    boxes = (rng.rand(3, 4) * 64).astype(np.float32)
    masks = rng.randn(3, 16, 16, 1).astype(np.float32)
    text = rng.randn(3, 1, 16).astype(np.float32)
    pe = m.prompt_encoder
    for kw in (dict(points=pts, labels=labels), dict(boxes=boxes),
               dict(points=pts, labels=labels, boxes=boxes, masks=masks, text_embeds=text)):
        sj, dj = jpe.apply(pp, cfg, **{k: jnp.asarray(v) for k, v in kw.items()})
        st, dt = pe(**{k: torch.tensor(v) for k, v in kw.items()})
        _close(sj, st)
        _close(dj, dt)
    _close(jpe.dense_pe(pp, 4), pe.dense_pe(4))


def test_weight_bridge_is_strict_and_decode_masks_matches(tiny):
    """A sam_tiny JAX tree loads into ``sam.build`` leaf for leaf, and
    decode_masks agrees: this holds the upscale's transposed-conv weights,
    which JAX applies spatially flipped."""
    p, m = tiny
    assert set(flatten(p)) == {n for n, _ in m.named_parameters()}
    x = np.random.RandomState(11).randn(1, 64, 64, 3).astype(np.float32)
    emb_j = jsam.encode_image(p, jnp.asarray(x), JC.sam_tiny())
    pts = (np.random.RandomState(12).rand(5, 1, 2) * 64).astype(np.float32)
    labels = np.ones((5, 1), np.int32)
    mj, ij = jsam.decode_masks(p, JC.sam_tiny(), emb_j, points=jnp.asarray(pts),
                               labels=jnp.asarray(labels))
    with torch.no_grad():
        mt, it = tsam.decode_masks(m, torch.tensor(np.asarray(emb_j)), points=torch.tensor(pts),
                                   labels=torch.tensor(labels))
    assert mt.shape == (5, 3, 16, 16)
    _close(mj, mt)
    _close(ij, it)
    bad = jax.tree.map(lambda a: a, p)
    del bad["mask_decoder"]["iou_token"]
    with pytest.raises(KeyError):
        load_(tsam.build(TC.sam_tiny(), device="cpu"), bad)


@pytest.mark.parametrize("original_hw", [(300, 400), (20, 30)])
def test_postprocess_masks_matches_jax(original_hw):
    """Upsampling, and downsampling where jax.image.resize antialiases."""
    masks = np.random.RandomState(13).randn(2, 3, 16, 16).astype(np.float32)
    ref = jsam.postprocess_masks(jnp.asarray(masks), (48, 64), original_hw, JC.sam_tiny())
    got = tsam.postprocess_masks(torch.tensor(masks), (48, 64), original_hw, TC.sam_tiny())
    _close(ref, got)


def test_forward_and_init_follow_jax_conventions(tiny):
    p, m = tiny
    img = np.random.RandomState(14).rand(1, 48, 64, 3).astype(np.float32) * 255
    pts = np.array([[[10.0, 20.0]], [[30.0, 8.0]]], np.float32)
    labels = np.ones((2, 1), np.int32)
    mj, ij = jsam.forward(p, JC.sam_tiny(), jnp.asarray(img), points=jnp.asarray(pts),
                          labels=jnp.asarray(labels))
    with torch.no_grad():
        mt, it = tsam.forward(m, torch.tensor(img), points=torch.tensor(pts),
                              labels=torch.tensor(labels))
    _close(mj, mt, 1e-4)
    _close(ij, it, 1e-4)
    with torch.no_grad():
        enc = tsam.init(TC.sam_tiny(), seed=0, device="cpu").image_encoder
        assert float(enc.pos_embed.abs().max()) == 0.0
        assert float(enc.blocks[0].attn.rel_pos_h.abs().max()) == 0.0
        assert float(enc.blocks[0].norm1.weight.min()) == 1.0


def test_init_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tsam.init(TC.sam_tiny())
