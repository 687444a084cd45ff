"""The port's training path against the JAX package's at ``llmseg_tiny``
with LoRA rank 2: the trainable partition, the warmup-decay schedule, and
optimizer steps (clip, AdamW, grad accumulation) against the jitted
``make_partitioned_train_step`` from the same weights and batches; then the
Trainer and a checkpoint round trip on the CPU.  float32.  Tolerances:
the loss terms within 1e-5 relative; grad_norm within 1e-4, the gradients'
own bound (it is their norm); each trainable tensor within 1e-5 relative in
the Frobenius norm (the gradients agree to about 1e-5 of their scale, and
AdamW normalises each entry, so an entry whose gradient is near its
rounding noise steps differently; the norm keeps such single entries from
deciding); frozen parameters bit-identical.  The selection head's attention
key biases are the exception: their exact gradient is zero (a key bias adds
the same amount to every logit of a softmax row), so both packages step on
rounding noise alone.  They are held to moving no more than 2 lr per
update."""

import jax
import numpy as np
import pytest
import torch

from llmseg_tpu import config as JC
from llmseg_tpu.data.synthetic import make_batch as jmake_batch
from llmseg_tpu.train import optim as joptim
from llmseg_tpu.train import train_step as jtrain_step
from llmseg_tpu_torch import config as TC
from llmseg_tpu_torch.data.synthetic import make_batch as tmake_batch
from llmseg_tpu_torch.import_weights.from_jax import flatten_paths
from llmseg_tpu_torch.train import checkpoint as ckpt_lib
from llmseg_tpu_torch.train import optim
from llmseg_tpu_torch.train import trainer as ttrainer
from llmseg_tpu_torch.train.train_step import train_step

from test_torch_loss_fn import JLORA, TERMS, TLORA, jittered_params, port_model

torch.set_num_threads(1)
METRICS = TERMS + ("grad_norm",)


def _cfgs(**kw):
    """Both packages' TrainConfig at the default lr 1e-4, no warmup, a
    4-update decay, and the given overrides."""
    kw = {**dict(epochs=1, steps_per_epoch=4, warmup_steps=0), **kw}
    return JC.TrainConfig(**kw), TC.TrainConfig(**kw)


def _batches(n):
    kw = dict(num_images=1, rows_per_image=2, text_len=32)
    return ([jmake_batch(JC.llmseg_tiny(), seed=10 + i, **kw) for i in range(n)],
            [tmake_batch(TC.llmseg_tiny(), device="cpu", seed=10 + i, **kw) for i in range(n)])


def _rel(got, ref):
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def run_steps(accum):
    """grad_accum_steps 1: 3 optimizer steps; 2: 4 micro-steps (2 updates),
    each micro-step on its own batch.  JAX jitted once per setting."""
    n = 3 if accum == 1 else 4
    jcfg, tcfg = _cfgs(grad_accum_steps=accum)
    params = jittered_params()
    jbs, tbs = _batches(n)

    trainable, skeleton = joptim.partition(params)
    tx = joptim.make_trainable_optimizer(jcfg)
    opt_state = tx.init(trainable)
    step = jax.jit(jtrain_step.make_partitioned_train_step(
        JC.llmseg_tiny(), tx, lora_cfg=JLORA, remat="dots"))
    jmetrics = []
    for b in jbs:
        trainable, opt_state, m = step(trainable, skeleton, opt_state, b)
        jmetrics.append({k: float(m[k]) for k in METRICS})

    model = port_model(params)
    frozen_before = {n: p.detach().clone() for n, p in model.named_parameters()
                     if not optim.is_trainable(n)}
    opt = optim.make_trainable_optimizer(tcfg, optim.partition(model))
    tmetrics = [{k: float(v) for k, v in train_step(model, opt, b, lora_cfg=TLORA).items()}
                for b in tbs]
    return dict(model=model, frozen_before=frozen_before, jmetrics=jmetrics,
                tmetrics=tmetrics, jparams=flatten_paths(jax.tree.map(np.asarray, trainable)),
                params=params, updates=n // accum)


@pytest.fixture(scope="module", params=[1, 2])
def steps(request):
    return run_steps(request.param)


def test_trainable_set_matches_jax_partition():
    params = jittered_params()
    trainable, _ = joptim.partition(params)
    model = port_model(params)
    names = set(optim.partition(model))
    assert names == set(flatten_paths(trainable))
    assert names == {n for n, t in optim.trainable_mask(model).items() if t}
    assert all(p.requires_grad == (n in names) for n, p in model.named_parameters())


def test_warmup_decay_schedule_matches_jax():
    jcfg, tcfg = _cfgs(warmup_steps=10)
    jcfg, tcfg = (JC.replace(jcfg, steps_per_epoch=100), TC.replace(tcfg, steps_per_epoch=100))
    sched = joptim.warmup_decay_schedule(jcfg)
    opt = torch.optim.AdamW([torch.nn.Parameter(torch.zeros(1))], lr=tcfg.lr)
    lrs = optim.warmup_decay_schedule(opt, tcfg)
    got = []
    for _ in range(101):
        got.append(opt.param_groups[0]["lr"])
        opt.step()
        lrs.step()
    for count in (0, 5, 10, 55, 100):
        np.testing.assert_allclose(got[count], float(sched(count)), rtol=1e-6, atol=1e-12,
                                   err_msg=str(count))
    assert got[0] == 0.0 and got[100] == pytest.approx(0.0, abs=1e-12)


def test_train_steps_match_jax(steps):
    for j, t in zip(steps["jmetrics"], steps["tmetrics"]):
        for k in METRICS:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4 if k == "grad_norm" else 1e-5,
                                       err_msg=k)
    start = flatten_paths(joptim.partition(steps["params"])[0])
    for name, p in steps["model"].named_parameters():
        got = p.detach().numpy()
        if not optim.is_trainable(name):
            assert torch.equal(p, steps["frozen_before"][name]), name
        elif name.startswith("select.") and name.endswith(".k.bias"):
            assert np.abs(got - start[name]).max() <= 2 * steps["updates"] * 1e-4, name
        else:
            assert _rel(got, steps["jparams"][name]) <= 1e-5, name


def test_grad_accumulation_holds_parameters_between_updates():
    """With grad_accum_steps=2 the first micro-step leaves every parameter
    as it was, and the second updates the trainable ones."""
    _, tcfg = _cfgs(grad_accum_steps=2)
    model = port_model(jittered_params())
    opt = optim.make_trainable_optimizer(tcfg, optim.partition(model))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    _, tbs = _batches(2)
    train_step(model, opt, tbs[0], lora_cfg=TLORA)
    assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())
    train_step(model, opt, tbs[1], lora_cfg=TLORA)
    changed = {n for n, p in model.named_parameters() if not torch.equal(p, before[n])}
    assert changed <= set(opt.params)
    assert {"lora.layers.0.q.a.weight", "lora.layers.1.v.b.weight", "select.text_fc1.weight",
            "llava.llm.embed_tokens.weight", "llava.llm.lm_head.weight"} <= changed


def _experiment(tmp_path, **train):
    return TC.ExperimentConfig(model=TC.llmseg_tiny(), train=TC.TrainConfig(
        grad_accum_steps=2, epochs=1, steps_per_epoch=1, warmup_steps=0, lr=1e-3,
        precision="fp32", log_dir=str(tmp_path), lora=TLORA, **train))


def test_trainer_epoch_and_checkpoint_roundtrip(tmp_path):
    cfg = _experiment(tmp_path)
    trainer = ttrainer.Trainer(cfg, device="cpu")
    _, tbs = _batches(2)
    metrics = trainer.train_epoch(tbs, epoch=0)
    assert trainer.global_step == 1
    assert set(metrics) == set(TERMS) and all(np.isfinite(v) for v in metrics.values())
    ckpt_lib.save(str(tmp_path), trainer.global_step, trainer.trainable,
                  trainer.opt.state_dict())
    saved = {n: p.detach().clone() for n, p in trainer.trainable.items()}
    saved_opt = trainer.opt.state_dict()

    fresh = ttrainer.Trainer(cfg, device="cpu")
    assert not all(torch.equal(p, saved[n]) for n, p in fresh.trainable.items())
    assert fresh.maybe_resume()
    assert fresh.global_step == 1
    assert all(torch.equal(p, saved[n]) for n, p in fresh.trainable.items())
    st = fresh.opt.state_dict()
    assert st["schedule"]["last_epoch"] == saved_opt["schedule"]["last_epoch"] == 1
    for k, v in saved_opt["adamw"]["state"].items():
        assert torch.equal(st["adamw"]["state"][k]["exp_avg"], v["exp_avg"])
        assert torch.equal(st["adamw"]["state"][k]["exp_avg_sq"], v["exp_avg_sq"])
    # the resumed run takes the same next step as the original
    t_next = trainer.train_epoch(tbs, epoch=1)
    f_next = fresh.train_epoch(tbs, epoch=1)
    assert t_next == f_next
    assert all(torch.equal(p, trainer.trainable[n]) for n, p in fresh.trainable.items())


def test_trainer_refuses_what_the_port_lacks(tmp_path):
    """A mesh wider than the world (one process here: the two-process runs
    are tests/test_torch_ddp.py and tests/test_torch_mesh.py), on the data
    axis or a sharded one, and a card that is not there.  QLoRA, validate
    and save_best work now (tests/test_torch_qlora.py)."""
    with pytest.raises(ValueError, match="data=4, fsdp=1, tp=1: dp x fsdp x tp must be the "
                                         "world size 1"):
        TC.TrainConfig(mesh=TC.MeshConfig(data=4))
    with pytest.raises(ValueError, match="data=-1, fsdp=2, tp=1: dp x fsdp x tp must be the "
                                         "world size 1"):
        TC.TrainConfig(mesh=TC.MeshConfig(fsdp=2))
    trainer = ttrainer.Trainer(_experiment(tmp_path), device="cpu")
    assert not trainer.maybe_resume()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ttrainer.Trainer(_experiment(tmp_path))
