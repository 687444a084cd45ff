"""The port's loss pieces against the JAX package's: ``splice_labels``,
``causal_lm_loss`` (with a batch that has no valid target), the two
selection-head losses with validity masks (JAX ``vmap``-ed over rows, the
port batched), and LLaMA's float32 ``logits``.  Inputs from numpy seeds,
float32; tolerance 1e-5 relative (one reduction over at most a few hundred
terms with another summation order); labels exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmseg_tpu import config as JC
from llmseg_tpu import losses as JLS
from llmseg_tpu.models import llama as jllama
from llmseg_tpu.models import llava as jllava
from llmseg_tpu_torch import config as TC
from llmseg_tpu_torch import losses as TLS
from llmseg_tpu_torch.import_weights.from_jax import load_
from llmseg_tpu_torch.models import llama as tllama
from llmseg_tpu_torch.models import llava as tllava

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)


def test_splice_labels_matches_jax():
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 50, size=(3, 12)).astype(np.int32)
    labels[:, :4] = -100
    pos = np.array([1, 0, 5], np.int32)
    ref = jllava.splice_labels(jnp.asarray(labels), jnp.asarray(pos), 7)
    got = tllava.splice_labels(torch.tensor(labels), torch.tensor(pos), 7)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 12 + 7 - 1)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("no_valid", [False, True])
def test_causal_lm_loss_matches_jax(no_valid):
    rng = np.random.RandomState(1)
    logits = rng.randn(2, 10, 31).astype(np.float32) * 3
    labels = rng.randint(0, 31, size=(2, 10)).astype(np.int32)
    labels[0, :6] = -100
    if no_valid:
        labels[:, 1:] = -100
    ref = float(jllava.causal_lm_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = tllava.causal_lm_loss(torch.tensor(logits), torch.tensor(labels))
    if no_valid:
        assert ref == 0.0 and got.item() == 0.0
    np.testing.assert_allclose(got.item(), ref, **TOL)


def _row_inputs(seed, R=3, K=7, D=16):
    rng = np.random.RandomState(seed)
    valid = rng.rand(R, K) < 0.7
    valid[:, 0] = True
    return (rng.randn(R, K, D).astype(np.float32), rng.randn(R, D).astype(np.float32),
            rng.rand(R, K).astype(np.float32), rng.rand(R, K).astype(np.float32), valid)


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_align_loss_matches_jax(masked):
    props, target, gt, _, valid = _row_inputs(2)
    v = valid if masked else None
    ref = jax.vmap(lambda p, t, g, m: JLS.softmax_align_loss(p, t, g, m, 0.05))(
        props, target, gt, valid) if masked else jax.vmap(
        lambda p, t, g: JLS.softmax_align_loss(p, t, g, None, 0.05))(props, target, gt)
    got = TLS.softmax_align_loss(torch.tensor(props), torch.tensor(target), torch.tensor(gt),
                                 None if v is None else torch.tensor(v), 0.05)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("masked,weighted", [(False, True), (True, True), (True, False)])
def test_iou_regression_loss_matches_jax(masked, weighted):
    _, _, _, pred, valid = _row_inputs(3)
    gt = np.random.RandomState(4).rand(*pred.shape).astype(np.float32)
    fn = lambda p, g, m: JLS.iou_regression_loss(p, g, m, weighted=weighted, scale=50.0)
    if masked:
        ref = jax.vmap(fn)(pred, gt, valid)
    else:
        ref = jax.vmap(lambda p, g: fn(p, g, None))(pred, gt)
    got = TLS.iou_regression_loss(torch.tensor(pred), torch.tensor(gt),
                                  torch.tensor(valid) if masked else None,
                                  weighted=weighted, scale=50.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("tie", [False, True])
def test_logits_match_jax(tie):
    cfg = JC.replace(JC.llama_tiny(), num_layers=1, tie_embeddings=tie)
    params = jax.tree.map(np.asarray, jllama.init(jax.random.PRNGKey(0), cfg))
    hidden = np.random.RandomState(5).randn(2, 9, cfg.hidden_size).astype(np.float32)
    ref = jllama.logits(params, cfg, jnp.asarray(hidden))
    tcfg = TC.replace(TC.llama_tiny(), num_layers=1, tie_embeddings=tie)
    model = load_(tllama.Llama(tcfg), params)
    got = tllama.logits(model, torch.tensor(hidden))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 9, cfg.vocab_size)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


def test_logits_are_float32_for_bf16_weights():
    """bf16 weights and hidden states give float32 logits on every device."""
    model = tllama.Llama(TC.replace(TC.llama_tiny(), num_layers=1), dtype=torch.bfloat16)
    hidden = torch.randn(1, 5, 64, dtype=torch.bfloat16)
    out = tllama.logits(model, hidden)
    assert out.dtype == torch.float32
    ref = hidden.float() @ model.lm_head.weight.float().t()
    torch.testing.assert_close(out, ref)
