"""The port's loss pieces against the JAX package's: ``splice_labels``,
``causal_lm_loss`` (with a batch that has no valid target), the two
selection-head losses with validity masks (JAX ``vmap``-ed over rows, the
port batched), the legacy ones (``sigmoid_align_loss``, ``dice_loss``,
``sigmoid_ce_loss``), and LLaMA's float32 ``logits``.  Inputs from numpy seeds,
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


@pytest.mark.parametrize("masked,temperature,bias", [(False, 0.0, 0.0), (True, 2.3, -1.5),
                                                     (True, -1.0, 4.0)])
def test_sigmoid_align_loss_matches_jax(masked, temperature, bias):
    """The legacy SigLIP-style alignment: log-scale temperature, the 1e-8
    floor inside the log."""
    props, target, gt, _, valid = _row_inputs(5)
    fn = lambda p, t, g, m: JLS.sigmoid_align_loss(p, t, g, jnp.float32(temperature),
                                                   jnp.float32(bias), m)
    if masked:
        ref = jax.vmap(fn)(props, target, gt, valid)
    else:
        ref = jax.vmap(lambda p, t, g: fn(p, t, g, None))(props, target, gt)
    got = TLS.sigmoid_align_loss(torch.tensor(props), torch.tensor(target), torch.tensor(gt),
                                 torch.tensor(temperature), torch.tensor(bias),
                                 torch.tensor(valid) if masked else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("fn", ["dice_loss", "sigmoid_ce_loss"])
@pytest.mark.parametrize("n,hw,num_masks", [(3, 64, 3.0), (1, 4096, 1.0), (5, 100, 2.0)])
def test_legacy_mask_losses_match_jax(fn, n, hw, num_masks):
    """The legacy pixel decoder's DICE and BCE on mask logits, large
    logits of both signs included."""
    rng = np.random.RandomState(n + hw)
    logits = (rng.randn(n, hw) * 6).astype(np.float32)
    targets = (rng.rand(n, hw) > 0.6).astype(np.float32)
    ref = getattr(JLS, fn)(jnp.asarray(logits), jnp.asarray(targets), jnp.float32(num_masks))
    got = getattr(TLS, fn)(torch.tensor(logits), torch.tensor(targets), num_masks)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
