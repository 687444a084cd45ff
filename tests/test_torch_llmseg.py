"""The slice as a whole: llmseg_tpu_torch ``predict`` against JAX ``predict``
on ``llmseg_tiny``, same weights (through ``from_jax``) and same batch
(``make_batch`` with one seed).  float32 on the CPU; tolerance 1e-4 abs on
similarity and IoP: the whole model (two towers, LLaMA, the head) in float32
with other summation orders, and cosine / sigmoid outputs of O(1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmseg_tpu import config as JC
from llmseg_tpu.data.synthetic import make_batch as jmake_batch
from llmseg_tpu.models import llmseg as jllmseg
from llmseg_tpu_torch import config as TC
from llmseg_tpu_torch.data.synthetic import make_batch as tmake_batch
from llmseg_tpu_torch.import_weights.from_jax import load_
from llmseg_tpu_torch.models import llmseg as tllmseg

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=0)


def _params(with_lora=False):
    jcfg = JC.llmseg_tiny()
    lcfg = JC.LoraConfig() if with_lora else None
    p = jllmseg.init(jax.random.PRNGKey(0), jcfg, lora_cfg=lcfg)
    rng = np.random.RandomState(1)
    # jitter every leaf so zero biases, unit scales, LayerScale and LoRA's
    # zero B carry signal
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.randn(*np.shape(x))).astype(np.float32), p)


def _port(params, with_lora=False):
    m = tllmseg.build(TC.llmseg_tiny(), device="cpu",
                      lora_cfg=TC.LoraConfig() if with_lora else None)
    return load_(m, params)


def _batches(seed=2, num_images=2, rows_per_image=2):
    kw = dict(num_images=num_images, rows_per_image=rows_per_image, text_len=32, seed=seed)
    return (jmake_batch(JC.llmseg_tiny(), **kw),
            tmake_batch(TC.llmseg_tiny(), device="cpu", **kw))


def _compare(jout, tout):
    for k in ("pred_similarity", "pred_iou"):
        np.testing.assert_allclose(np.asarray(jout[k]), tout[k].numpy(), **TOL)
    for k in ("prop_valid", "row_valid"):
        np.testing.assert_array_equal(np.asarray(jout[k]), tout[k].numpy())


@pytest.mark.parametrize("pool", ["adjoint", "unfused"])
def test_predict_matches_jax(pool, monkeypatch):
    monkeypatch.setenv("LLMSEG_POOL_ADJOINT", "1" if pool == "adjoint" else "0")
    params = _params()
    jb, tb = _batches()
    jout = jllmseg.predict(params, JC.llmseg_tiny(), jb)
    tout = tllmseg.predict(_port(params), tb, device="cpu", pool=pool)
    assert tout["pred_similarity"].shape == (4, TC.llmseg_tiny().max_proposals)
    _compare(jout, tout)


def test_predict_with_lora_matches_jax():
    params = _params(with_lora=True)
    jb, tb = _batches(seed=3)
    jout = jllmseg.predict(params, JC.llmseg_tiny(), jb, lora_cfg=JC.LoraConfig())
    tout = tllmseg.predict(_port(params, with_lora=True), tb, device="cpu",
                           lora_cfg=TC.LoraConfig())
    _compare(jout, tout)


def test_predict_folded_matches_jax():
    """fold_frozen_inplace on both sides (DINOv2 LayerScale into the
    projections); the tiny DINO gets LayerScale for this."""
    kw = dict(layerscale=True, use_quick_gelu=False, ln_eps=1e-6, layernorm_pre=False)
    jcfg = JC.replace(JC.llmseg_tiny(), dino=JC.replace(JC.llmseg_tiny().dino, **kw))
    tcfg = TC.replace(TC.llmseg_tiny(), dino=TC.replace(TC.llmseg_tiny().dino, **kw))
    rng = np.random.RandomState(4)
    params = jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.randn(*np.shape(x))).astype(np.float32),
        jllmseg.init(jax.random.PRNGKey(5), jcfg))
    bkw = dict(num_images=1, rows_per_image=2, text_len=32, seed=6)
    m = load_(tllmseg.build(tcfg, device="cpu"), params)
    unfolded = tllmseg.predict(m, tmake_batch(tcfg, device="cpu", **bkw), device="cpu")
    jllmseg.fold_frozen_inplace(params)
    tllmseg.fold_frozen_inplace(m)
    jout = jllmseg.predict(params, jcfg, jmake_batch(jcfg, **bkw))
    tout = tllmseg.predict(m, tmake_batch(tcfg, device="cpu", **bkw), device="cpu")
    _compare(jout, tout)
    np.testing.assert_allclose(unfolded["pred_similarity"].numpy(),
                               tout["pred_similarity"].numpy(), **TOL)


def test_seg_hidden_index_matches_jax():
    """First [SEG] of each row; a row without one reports has_seg False."""
    cfg = JC.llmseg_tiny()
    s = cfg.seg_token_id
    ids = np.array([[5, 6, s, 7, 8],
                    [5, 6, 7, 8, 9],        # no [SEG]
                    [5, s, 7, s, 9],        # two: the first counts
                    [s, 6, 7, 8, 9]], np.int32)
    jidx, jhas = jllmseg.seg_hidden_index(jnp.asarray(ids), cfg)
    tidx, thas = tllmseg.seg_hidden_index(torch.tensor(ids), TC.llmseg_tiny())
    np.testing.assert_array_equal(np.asarray(jidx), tidx.numpy())
    np.testing.assert_array_equal(np.asarray(jhas), thas.numpy())
    n = cfg.llava.num_image_tokens
    assert tidx.tolist()[0] == 2 - 1 + n - 1 and tidx.tolist()[2] == 1 - 1 + n - 1
    assert thas.tolist() == [True, False, True, True]


@pytest.mark.parametrize("seed", [0, 7])
def test_make_batch_matches_jax(seed):
    jb, tb = _batches(seed=seed, num_images=3, rows_per_image=2)
    assert set(jb) == set(tb)
    for k in jb:
        np.testing.assert_array_equal(np.asarray(jb[k]), tb[k].numpy(), err_msg=k)


def test_interp_matrix_matches_jax():
    for n_in, n_out in ((4, 16), (64, 256), (5, 7)):
        np.testing.assert_array_equal(np.asarray(jllmseg._interp_matrix(n_in, n_out)),
                                      tllmseg._interp_matrix(n_in, n_out))


def test_entry_points_default_to_cuda():
    """Without device=, init / make_batch / predict ask for the card and
    raise when there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = TC.llmseg_tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        tllmseg.init(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmake_batch(cfg)
    m = tllmseg.init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tllmseg.predict(m, tmake_batch(cfg, device="cpu"))
