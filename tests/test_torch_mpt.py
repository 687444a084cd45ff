"""The port's MPT (``models/mpt.py``, ``Llava.forward_mpt``,
``torch_import.import_mpt``) against the JAX package's, float32 on the
CPU: the ALiBi slopes and bias exactly; the hidden states and logits of
``mpt_tiny``-sized models within 1e-5 relative (a few layers in float32
with other summation orders) from the same weights (a JAX ``mpt.init``
tree, every leaf jittered from a numpy seed, through ``from_jax``) for
each variant (ALiBi with 6 heads, MultiQueryAttention, ``qk_ln``,
``clip_qkv``, a learned ``wpe`` without ALiBi, biases), with a padding
mask; an HF ``MptForCausalLM`` built from a config (no download) imported
by both packages, tree for tree and logit for logit; and the LLaVA splice
in front of MPT (``forward_mpt``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmseg_tpu import config as JC
from llmseg_tpu.import_weights import torch_import as JTI
from llmseg_tpu.models import llava as jllava
from llmseg_tpu.models import mpt as jmpt
from llmseg_tpu_torch import config as TC
from llmseg_tpu_torch.import_weights import torch_import as TTI
from llmseg_tpu_torch.import_weights.from_jax import flatten, load_
from llmseg_tpu_torch.models import mpt as tmpt
from llmseg_tpu_torch.models.llava import Llava

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
VARIANTS = {
    "alibi": dict(),
    "alibi_6_heads": dict(d_model=48, n_heads=6, kv_n_heads=6),
    "mqa": dict(kv_n_heads=1),
    "qk_ln": dict(qk_ln=True),
    "clip_qkv": dict(clip_qkv=0.5),
    "wpe": dict(alibi=False, learned_pos_emb=True),
    "bias": dict(no_bias=False, qk_ln=True),
}


def _cfgs(**kw):
    return dataclasses.replace(JC.mpt_tiny(), **kw), dataclasses.replace(TC.mpt_tiny(), **kw)


def _jittered(tree, seed=0):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.1 * rng.randn(*np.shape(x))).astype(np.float32), tree)


@pytest.mark.parametrize("n_heads", [4, 6, 16, 32])
def test_alibi_matches_jax(n_heads):
    np.testing.assert_array_equal(tmpt.gen_slopes(n_heads), jmpt.gen_slopes(n_heads))
    np.testing.assert_array_equal(tmpt.build_alibi_bias(n_heads, 12).numpy(),
                                  np.asarray(jmpt.build_alibi_bias(n_heads, 12)))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mpt_matches_jax(variant, masked):
    jcfg, tcfg = _cfgs(**VARIANTS[variant])
    params = _jittered(jmpt.init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.RandomState(1)
    ids = rng.randint(0, jcfg.vocab_size, size=(2, 13))
    mask = np.ones((2, 13), bool)
    mask[0, -4:] = False
    jm = jnp.asarray(mask) if masked else None
    jh = jmpt.apply(params, jcfg, input_ids=jnp.asarray(ids), attention_mask=jm)
    jl = np.asarray(jmpt.logits(params, jcfg, jh))

    model = load_(tmpt.Mpt(tcfg, device="cpu"), params)
    with torch.no_grad():
        th = model(input_ids=torch.tensor(ids),
                   attention_mask=torch.tensor(mask) if masked else None)
        tl = tmpt.logits(model, th).numpy()
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tl, jl, **TOL)
    if variant == "clip_qkv":      # the clamp bites on these weights
        with torch.no_grad():
            qkv = model.blocks[0].attn.wqkv(model.blocks[0].norm_1(model.wte[torch.tensor(ids)]))
        assert qkv.abs().max() > 0.5


def _hf_tiny(**kw):
    from transformers import MptConfig, MptForCausalLM

    torch.manual_seed(0)
    m = MptForCausalLM(MptConfig(d_model=64, n_heads=4, n_layers=2, vocab_size=256,
                                 max_seq_len=128, **kw)).float().eval()
    with torch.no_grad():   # HF leaves some weights near zero: give them signal
        for p in m.parameters():
            if p.ndim == 2 and p.abs().max() < 1e-6:
                p.normal_(0, 0.02)
    return m


def test_import_mpt_matches_jax():
    """An HF MPT through both importers: the same tree, the same logits,
    and both within 3e-4 of HF's own (JAX's tests/test_mpt.py bound)."""
    m = _hf_tiny()
    # HF fixes the FFN expansion at 4
    jcfg, tcfg = _cfgs(expansion_ratio=4)
    sd = m.state_dict()
    jtree = JTI.import_mpt({k: v.numpy() for k, v in sd.items()}, jcfg)
    ttree = TTI.import_mpt(dict(sd), tcfg)
    jflat, tflat = flatten(jtree), flatten(ttree)
    assert set(jflat) == set(tflat)
    for k in jflat:
        np.testing.assert_array_equal(tflat[k].numpy(), jflat[k], err_msg=k)

    model = load_(tmpt.Mpt(tcfg, device="cpu"), ttree)
    ids = np.random.RandomState(1).randint(0, 256, size=(2, 17))
    with torch.no_grad():
        ref = m(input_ids=torch.tensor(ids)).logits.numpy()
        got = tmpt.logits(model, model(input_ids=torch.tensor(ids))).numpy()
    jl = np.asarray(jmpt.logits(jtree, jcfg, jmpt.apply(jtree, jcfg, input_ids=jnp.asarray(ids))))
    np.testing.assert_allclose(got, jl, **TOL)
    np.testing.assert_allclose(got, ref, atol=3e-4)


def test_forward_mpt_matches_jax():
    """LLaVA's tower, projector and splice in front of MPT."""
    cfg_l = JC.llava_tiny()
    kw = dict(vocab_size=cfg_l.llm.vocab_size, d_model=cfg_l.llm.hidden_size, n_layers=2,
              n_heads=4, kv_n_heads=4, expansion_ratio=2, max_seq_len=256)
    jm, tm = JC.MptConfig(**kw), TC.MptConfig(**kw)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    params = jllava.init(k1, cfg_l)
    params["llm"] = jmpt.init(k2, jm)
    params = _jittered(params, seed=2)
    rng = np.random.RandomState(5)
    ids = rng.randint(4, 200, size=(2, 10))
    images = rng.randn(2, 28, 28, 3).astype(np.float32)
    pos = np.array([1, 2], np.int32)
    jh = jllava.forward_mpt(params, cfg_l, jm, input_ids=jnp.asarray(ids),
                            image_pos=jnp.asarray(pos), images=jnp.asarray(images))
    model = load_(Llava(TC.llava_tiny(), mpt_cfg=tm, device="cpu"), params)
    with torch.no_grad():
        th = model.forward_mpt(input_ids=torch.tensor(ids), image_pos=torch.tensor(pos),
                               images=torch.tensor(images))
    assert th.shape == (2, 10 + cfg_l.num_image_tokens - 1, tm.d_model)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
