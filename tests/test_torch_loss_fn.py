"""The port's ``loss_fn`` and its gradients against ``jax.grad`` of
``llmseg.loss_fn`` at ``llmseg_tiny`` with LoRA rank 2, both pooling routes,
same weights (``from_jax``) and same batch (``make_batch``, one seed).
float32 on the CPU.  Tolerances: 1e-5 on the four loss terms (the whole
model in float32 with other summation orders; terms of O(1-10)); 1e-4 on
every trainable gradient (entries up to O(1), each the sum of a whole
backward pass); remat "full" and "dots" against "none" within 1e-6 (the
recompute runs the same operations)."""

import jax
import numpy as np
import pytest
import torch

from llmseg_tpu import config as JC
from llmseg_tpu.data.synthetic import make_batch as jmake_batch
from llmseg_tpu.models import llmseg as jllmseg
from llmseg_tpu_torch import config as TC
from llmseg_tpu_torch.data.synthetic import make_batch as tmake_batch
from llmseg_tpu_torch.import_weights.from_jax import flatten, load_
from llmseg_tpu_torch.models import llmseg as tllmseg
from llmseg_tpu_torch.train import optim

torch.set_num_threads(1)
JLORA, TLORA = JC.LoraConfig(rank=2), TC.LoraConfig(rank=2)
TERMS = ("loss", "ce_loss", "align_loss", "regression_loss")


def jittered_params(seed=1):
    p = jllmseg.init(jax.random.PRNGKey(0), JC.llmseg_tiny(), lora_cfg=JLORA)
    rng = np.random.RandomState(seed)
    # lora_init draws from hash(name), which changes with the process's hash
    # seed: redraw LoRA from numpy so that every run has the same weights
    p["lora"] = jax.tree.map(
        lambda x: rng.randn(*np.shape(x)) / np.sqrt(np.shape(x)[0]), p["lora"])
    # every leaf jittered: zero biases, unit scales and LoRA's zero B carry signal
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.randn(*np.shape(x))).astype(np.float32), p)


def port_model(params):
    return load_(tllmseg.build(TC.llmseg_tiny(), device="cpu", lora_cfg=TLORA), params)


def port_grads(model, batch, pool, remat):
    loss, aux = tllmseg.loss_fn(model, batch, pool=pool, lora_cfg=TLORA, remat=remat)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return {k: v.item() for k, v in aux.items()}, grads


@pytest.fixture(scope="module", params=["adjoint", "unfused"])
def case(request):
    """One JAX value_and_grad per pooling route, and the port's loss and
    gradients with remat "none" on the same inputs."""
    pool = request.param
    params = jittered_params()
    kw = dict(num_images=2, rows_per_image=2, text_len=32, seed=2)
    jb = jmake_batch(JC.llmseg_tiny(), **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LLMSEG_POOL_ADJOINT", "1" if pool == "adjoint" else "0")
        (_, jaux), jgrads = jax.jit(jax.value_and_grad(
            lambda p: jllmseg.loss_fn(p, JC.llmseg_tiny(), jb, lora_cfg=JLORA),
            has_aux=True))(params)
    model = port_model(params)
    trainable = optim.partition(model)
    tb = tmake_batch(TC.llmseg_tiny(), device="cpu", **kw)
    taux, tgrads = port_grads(model, tb, pool, "none")
    return dict(pool=pool, model=model, batch=tb, trainable=trainable,
                jaux={k: float(v) for k, v in jaux.items()}, jgrads=flatten(jgrads),
                taux=taux, tgrads=tgrads)


def test_loss_terms_match_jax(case):
    for k in TERMS:
        np.testing.assert_allclose(case["taux"][k], case["jaux"][k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert case["taux"]["loss"] == pytest.approx(
        sum(case["taux"][k] for k in TERMS[1:]), rel=1e-6)


def test_trainable_grads_match_jax(case):
    """Every trainable parameter gets a gradient, and it is JAX's; the
    frozen ones get none."""
    assert set(case["tgrads"]) == set(case["trainable"])
    for name, g in case["tgrads"].items():
        np.testing.assert_allclose(g.numpy(), case["jgrads"][name], atol=1e-4, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_same_grads(case, remat):
    aux, grads = port_grads(case["model"], case["batch"], case["pool"], remat)
    assert aux == pytest.approx(case["taux"], rel=1e-6)
    assert set(grads) == set(case["tgrads"])
    for name, g in grads.items():
        torch.testing.assert_close(g, case["tgrads"][name], atol=1e-6, rtol=0, msg=name)


def test_towers_get_no_gradient():
    """With nothing frozen, the DINOv2 and CLIP towers and the projector
    still get no gradient (the JAX package's stop_gradients), while the
    DINOv2 projection after the tower does."""
    model = port_model(jittered_params(seed=3))
    batch = tmake_batch(TC.llmseg_tiny(), device="cpu", num_images=1, rows_per_image=2,
                        text_len=32, seed=4)
    tllmseg.loss_fn(model, batch, lora_cfg=TLORA)[0].backward()
    for name, p in model.named_parameters():
        frozen_tower = name.startswith(("dino.", "llava.vision_tower.", "llava.mm_projector."))
        assert (p.grad is None) == frozen_tower, name
