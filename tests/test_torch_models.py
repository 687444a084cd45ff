"""The port's modules against the JAX package's, on the same weights.

JAX initialises each tiny module; every leaf is then jittered with seeded
numpy noise (so zero biases, unit scales, LayerScale 1e-5 and LoRA's zero B
all carry signal and a wrong mapping shows), converted with
``import_weights.from_jax`` and run through both.  float32 on the CPU, JAX at
highest matmul precision.  Tolerance 1e-5 abs: a few layers of float32 sums
in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmseg_tpu import config as JC
from llmseg_tpu.models import llama as jllama
from llmseg_tpu.models import llava as jllava
from llmseg_tpu.models import selection_head as jsel
from llmseg_tpu.models import vit as jvit
from llmseg_tpu_torch import config as TC
from llmseg_tpu_torch.import_weights.from_jax import load_
from llmseg_tpu_torch.models import llama as tllama
from llmseg_tpu_torch.models import llava as tllava
from llmseg_tpu_torch.models import selection_head as tsel
from llmseg_tpu_torch.models import vit as tvit

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _jitter(params, seed, amp=0.1):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + amp * rng.randn(*np.shape(x))).astype(np.float32),
        params)


def _close(ref, got, **tol):
    np.testing.assert_allclose(np.asarray(ref), got.detach().numpy(), **(tol or TOL))


def _images(n, size, seed):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(np.float32)


def _dino_cfgs():
    kw = dict(layernorm_pre=False, layerscale=True, use_quick_gelu=False, ln_eps=1e-6)
    return (JC.replace(JC.vit_tiny(56, 14), **kw), TC.replace(TC.vit_tiny(56, 14), **kw))


def test_clip_features():
    jcfg, tcfg = JC.vit_tiny(), TC.vit_tiny()
    p = _jitter(jvit.init(jax.random.PRNGKey(0), jcfg), 1)
    x = _images(2, 28, 2)
    m = load_(tvit.ViT(tcfg), p)
    _close(jvit.clip_features(p, jnp.asarray(x), jcfg, select_layer=-2),
           tvit.clip_features(m, torch.tensor(x), select_layer=-2))


@pytest.mark.parametrize("fold", ["none", "port", "jax"])
def test_dino_patch_features(fold):
    """Unfolded; folded by the port after loading; folded by JAX before."""
    jcfg, tcfg = _dino_cfgs()
    p = _jitter(jvit.init(jax.random.PRNGKey(3), jcfg), 4)
    x = _images(2, 56, 5)
    ref = jvit.dino_patch_features(p, jnp.asarray(x), jcfg)
    if fold == "jax":
        p = jvit.fold_layerscale_inplace(jax.tree.map(np.asarray, p))
        assert "ls1" not in p["blocks"][0]
    m = load_(tvit.ViT(tcfg), p)
    if fold == "port":
        tvit.fold_layerscale_inplace(m)
    if fold != "none":
        assert m.blocks[0].ls1 is None and m.blocks[0].ls2 is None
    _close(ref, tvit.dino_patch_features(m, torch.tensor(x)), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("with_lora", [False, True])
def test_llama_apply(with_lora):
    jcfg, tcfg = JC.llama_tiny(), TC.llama_tiny()
    p = _jitter(jllama.init(jax.random.PRNGKey(6), jcfg), 7)
    ids = np.random.RandomState(8).randint(0, jcfg.vocab_size, size=(2, 40))
    lora_j = lora_t = jlcfg = tlcfg = None
    if with_lora:
        jlcfg, tlcfg = JC.LoraConfig(), TC.LoraConfig()
        lora_j = _jitter(jllama.lora_init(jax.random.PRNGKey(9), jcfg, jlcfg), 10)
        lora_t = load_(tllama.LlamaLora(tcfg, tlcfg), lora_j)
    ref = jllama.apply(p, jcfg, input_ids=jnp.asarray(ids), lora=lora_j, lora_cfg=jlcfg)
    m = load_(tllama.Llama(tcfg), p)
    got = m(input_ids=torch.tensor(ids), lora=lora_t, lora_cfg=tlcfg)
    _close(ref, got)
    if with_lora:   # the overlay is live
        assert (got - m(input_ids=torch.tensor(ids))).abs().max() > 1e-3


def test_llama_grouped_kv_heads():
    jcfg = JC.replace(JC.llama_tiny(), num_kv_heads=2)
    tcfg = TC.replace(TC.llama_tiny(), num_kv_heads=2)
    p = _jitter(jllama.init(jax.random.PRNGKey(11), jcfg), 12)
    ids = np.random.RandomState(13).randint(0, jcfg.vocab_size, size=(1, 20))
    m = load_(tllama.Llama(tcfg), p)
    _close(jllama.apply(p, jcfg, input_ids=jnp.asarray(ids)),
           m(input_ids=torch.tensor(ids)))


@pytest.mark.parametrize("pos", [[1, 1], [0, 5], [3, 9]])
def test_splice_image_tokens(pos):
    r = np.random.RandomState(14)
    text = r.randn(2, 10, 8).astype(np.float32)
    img = r.randn(2, 4, 8).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    ref = jllava.splice_image_tokens(jnp.asarray(text), jnp.asarray(img), jnp.asarray(pos))
    got = tllava.splice_image_tokens(torch.tensor(text), torch.tensor(img), torch.tensor(pos))
    assert got.shape == (2, 13, 8)
    _close(ref, got, atol=0, rtol=0)


def test_llava_forward():
    jcfg, tcfg = JC.llava_tiny(), TC.llava_tiny()
    p = _jitter(jllava.init(jax.random.PRNGKey(15), jcfg), 16)
    r = np.random.RandomState(17)
    ids = r.randint(0, jcfg.llm.vocab_size, size=(2, 30))
    pos = np.asarray([1, 4], np.int32)
    x = _images(2, 28, 18)
    ref = jllava.forward(p, jcfg, input_ids=jnp.asarray(ids), image_pos=jnp.asarray(pos),
                         images=jnp.asarray(x))
    m = load_(tllava.Llava(tcfg), p)
    got = m(input_ids=torch.tensor(ids), image_pos=torch.tensor(pos), images=torch.tensor(x))
    assert got.shape == (2, 30 + jcfg.num_image_tokens - 1, jcfg.llm.hidden_size)
    _close(ref, got, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_selection_head_apply(masked):
    jcfg, tcfg = JC.selection_head_tiny(), TC.selection_head_tiny()
    p = _jitter(jsel.init(jax.random.PRNGKey(19), jcfg), 20)
    r = np.random.RandomState(21)
    props = r.randn(3, 6, jcfg.dim).astype(np.float32)
    text = r.randn(3, jcfg.dim).astype(np.float32)
    valid = np.arange(6)[None, :] < np.asarray([[6], [4], [1]]) if masked else None
    ref = jsel.apply(p, jcfg, jnp.asarray(props), jnp.asarray(text),
                     None if valid is None else jnp.asarray(valid))
    m = load_(tsel.SelectionHead(tcfg), p)
    got = m(torch.tensor(props), torch.tensor(text),
            None if valid is None else torch.tensor(valid))
    for a, b in zip(ref, got):
        _close(a, b)
    # the projections around the head
    hid = r.randn(3, jcfg.llm_dim).astype(np.float32)
    _close(jsel.project_text(p, jnp.asarray(hid)), m.project_text(torch.tensor(hid)))
    feats = r.randn(2, 5, jcfg.dino_dim).astype(np.float32)
    _close(jsel.project_dino(p, jnp.asarray(feats)), m.project_dino(torch.tensor(feats)))


def test_mask_pooling():
    r = np.random.RandomState(22)
    feats = r.randn(2, 16, 8).astype(np.float32)
    w = (r.rand(2, 5, 16) < 0.3).astype(np.float32)
    _close(jsel.mask_pooling(jnp.asarray(feats), jnp.asarray(w)),
           tsel.mask_pooling(torch.tensor(feats), torch.tensor(w)))
