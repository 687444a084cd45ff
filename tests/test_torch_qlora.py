"""QLoRA (the int8 / int4 frozen LLaMA base under autograd) and the
best-checkpoint policy, the port against the JAX package at ``llmseg_tiny``
with LoRA rank 2, float32 on the CPU, same weights (``from_jax``) and
batches (``make_batch``, one seed).

* ``qdense``'s gradient to its input, int8 and int4, against ``jax.grad``
  of ``quant.qdense``: within 1e-5 of the largest entry (one product in
  float32, other summation orders); the quantized buffers get none.
* ``optim.quantize_skeleton`` quantizes exactly the JAX skeleton's leaves,
  to the same integers and scales; ``lm_head`` and ``embed_tokens`` (JAX's
  holes) stay full-precision parameters.
* Two optimizer steps at bits 8 and 4 against the jitted
  ``make_partitioned_train_step`` on ``quantize_skeleton``'s output: the
  loss terms within 1e-4 relative, every trainable tensor within 1e-4
  relative in the Frobenius norm (``test_torch_train.py`` explains the norm
  and the selection head's key biases, whose exact gradient is zero and
  which are held to moving at most 2 lr an update); the quantized buffers
  bit-identical.  Remat "full" and "dots" give the steps of "none" within
  1e-6 (the recompute runs the same operations), and "dots" keeps every
  projection product of the quantized layers.
* ``BestKeeper``, and a quantized ``Trainer``'s ``validate`` /
  ``save_best`` / resume round trip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmseg_tpu import config as JC
from llmseg_tpu.data.synthetic import make_batch as jmake_batch
from llmseg_tpu.ops import quant as jquant
from llmseg_tpu.train import optim as joptim
from llmseg_tpu.train import train_step as jtrain_step
from llmseg_tpu_torch import config as TC
from llmseg_tpu_torch.data.synthetic import make_batch as tmake_batch
from llmseg_tpu_torch.import_weights.from_jax import flatten, flatten_paths, load_
from llmseg_tpu_torch.models import layers as TL
from llmseg_tpu_torch.models import llama as tllama
from llmseg_tpu_torch.models import llmseg as tllmseg
from llmseg_tpu_torch.ops import quant as tquant
from llmseg_tpu_torch.train import checkpoint as ckpt_lib
from llmseg_tpu_torch.train import optim
from llmseg_tpu_torch.train import trainer as ttrainer
from llmseg_tpu_torch.train.train_step import train_step

from test_torch_loss_fn import JLORA, TERMS, TLORA, jittered_params, port_model

torch.set_num_threads(1)
GRAD_TOL = 1e-5
STEP_RTOL = 1e-4
REMAT_TOL = 1e-6
QUANT_CLS = {8: TL.Int8Linear, 4: TL.Int4Linear}


# ---------------------------------------------------------------------------
# the quantized products' gradients
# ---------------------------------------------------------------------------


def _holder(jleaf):
    m = torch.nn.Module()
    m.lin = torch.nn.Linear(1, 1)
    return load_(m, {"lin": jax.tree.map(np.asarray, jleaf)}).lin


@pytest.mark.parametrize("bits,in_dim", [(8, 64), (4, 300), (4, 256)])
def test_qdense_gradient_matches_jax(bits, in_dim):
    rs = np.random.RandomState(bits + in_dim)
    w = (rs.randn(in_dim, 48) * 0.1).astype(np.float32)
    b = (rs.randn(48) * 0.01).astype(np.float32)
    x = rs.randn(2, 7, in_dim).astype(np.float32)
    r = rs.randn(2, 7, 48).astype(np.float32)        # the cotangent
    qfn = jquant.quantize_dense if bits == 8 else jquant.quantize_dense4
    jq = qfn({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    ref = np.asarray(jax.grad(lambda v: jnp.sum(jquant.qdense(jq, v) * r))(jnp.asarray(x)))

    mod = _holder(jq)
    assert isinstance(mod, QUANT_CLS[bits])
    xt = torch.tensor(x, requires_grad=True)
    y = mod(xt)
    (y * torch.tensor(r)).sum().backward()
    assert np.abs(xt.grad.numpy() - ref).max() <= GRAD_TOL * np.abs(ref).max()
    assert all(not t.requires_grad and t.grad is None for t in mod.buffers())
    # the forward is the inference path's
    with torch.no_grad():
        torch.testing.assert_close(mod(torch.tensor(x)), y.detach(), atol=0, rtol=0)


def test_int8_product_backward_rounds_to_the_input_type():
    """bf16 input: dx is bf16, equal to (dy * w_scale) in bf16 times the
    bf16-cast int8 weight, accumulated in float32."""
    rs = np.random.RandomState(0)
    lin = torch.nn.Linear(64, 32, bias=False)
    q = tquant.quantize_dense(lin)
    x = torch.tensor(rs.randn(5, 64), dtype=torch.bfloat16, requires_grad=True)
    g = torch.tensor(rs.randn(5, 32), dtype=torch.bfloat16)
    q(x).backward(g)
    gs = (g.float() * q.w_scale).to(torch.bfloat16).float()
    ref = (gs @ q.w_q.float()).to(torch.bfloat16)
    assert x.grad.dtype == torch.bfloat16
    torch.testing.assert_close(x.grad, ref, atol=0, rtol=0)


def test_dots_policy_keeps_the_quantized_products():
    from torch.utils.checkpoint import CheckpointPolicy
    for op in (torch.ops.aten.mm.default, torch.ops.aten.mm.dtype):
        assert tllama._save_dots(None, op) == CheckpointPolicy.MUST_SAVE
    assert tllama._save_dots(None, torch.ops.aten.bmm.default) == \
        CheckpointPolicy.PREFER_RECOMPUTE


# ---------------------------------------------------------------------------
# quantize_skeleton
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_skeleton_matches_jax(bits):
    params = jittered_params()
    _, skeleton = joptim.partition(params)
    jq = joptim.quantize_skeleton(skeleton, bits=bits)
    assert jq["llava"]["llm"]["lm_head"]["w"] is None
    jflat = {k: v for k, v in flatten(jax.tree.map(
        lambda x: None if x is None else np.asarray(x), jq["llava"]["llm"],
        is_leaf=lambda x: x is None), "llava.llm.").items() if v.dtype != object}

    model = port_model(params)
    optim.partition(model)
    lm_head, embed = model.llava.llm.lm_head.weight, model.llava.llm.embed_tokens.weight
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    optim.quantize_skeleton(model, bits=bits)
    llm = model.llava.llm
    quantized = {n for n, m in llm.named_modules() if tquant.is_quantized(m)}
    jquantized = {n.rpartition(".")[0][len("llava.llm."):] for n in jflat
                  if n.endswith((".w_q", ".w_q4"))}
    assert quantized == jquantized and len(quantized) == 7 * len(llm.layers)
    assert all(isinstance(llm.get_submodule(n), QUANT_CLS[bits]) for n in quantized)
    for n in quantized:
        for name, buf in llm.get_submodule(n).named_buffers():
            if buf is not None:
                np.testing.assert_array_equal(buf.numpy(), jflat[f"llava.llm.{n}.{name}"],
                                              err_msg=f"{n}.{name}")
    # JAX's holes: full-precision trainable parameters, untouched
    assert llm.lm_head.weight is lm_head and llm.embed_tokens.weight is embed
    assert isinstance(llm.lm_head, torch.nn.Linear) and lm_head.requires_grad
    for name, p in model.named_parameters():
        assert torch.equal(p, before[name]), name
    assert set(dict(model.named_parameters())) <= set(before)


# ---------------------------------------------------------------------------
# QLoRA steps against JAX
# ---------------------------------------------------------------------------


def _batches(n):
    kw = dict(num_images=1, rows_per_image=2, text_len=32)
    return ([jmake_batch(JC.llmseg_tiny(), seed=20 + i, **kw) for i in range(n)],
            [tmake_batch(TC.llmseg_tiny(), device="cpu", seed=20 + i, **kw) for i in range(n)])


def _rel(got, ref):
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _port_steps(params, bits, remat, tbs, tcfg):
    model = port_model(params)
    opt = optim.make_trainable_optimizer(tcfg, optim.partition(model))
    optim.quantize_skeleton(model, bits=bits)
    frozen = {n: b.clone() for n, b in model.named_buffers()}
    metrics = [{k: float(v) for k, v in train_step(model, opt, b, lora_cfg=TLORA,
                                                     remat=remat).items()}
               for b in tbs]
    return model, frozen, metrics


@pytest.fixture(scope="module", params=[8, 4])
def qlora(request):
    bits = request.param
    kw = dict(epochs=1, steps_per_epoch=4, warmup_steps=0, grad_accum_steps=1)
    jcfg, tcfg = JC.TrainConfig(**kw), TC.TrainConfig(**kw)
    params = jittered_params()
    jbs, tbs = _batches(2)

    trainable, skeleton = joptim.partition(params)
    skeleton = joptim.quantize_skeleton(skeleton, bits=bits)
    tx = joptim.make_trainable_optimizer(jcfg)
    opt_state = tx.init(trainable)
    step = jax.jit(jtrain_step.make_partitioned_train_step(
        JC.llmseg_tiny(), tx, lora_cfg=JLORA, remat="dots"))
    jmetrics = []
    for b in jbs:
        trainable, opt_state, m = step(trainable, skeleton, opt_state, b)
        jmetrics.append({k: float(m[k]) for k in TERMS + ("grad_norm",)})
    runs = {remat: _port_steps(params, bits, remat, tbs, tcfg)
            for remat in ("none", "full", "dots")}
    return dict(bits=bits, params=params, runs=runs, jmetrics=jmetrics,
                jparams=flatten_paths(jax.tree.map(np.asarray, trainable)), tbs=tbs)


def test_qlora_steps_match_jax(qlora):
    model, frozen, tmetrics = qlora["runs"]["none"]
    for j, t in zip(qlora["jmetrics"], tmetrics):
        for k in TERMS + ("grad_norm",):
            np.testing.assert_allclose(t[k], j[k], rtol=STEP_RTOL, err_msg=k)
    start = flatten_paths(joptim.partition(qlora["params"])[0])
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        got = p.detach().numpy()
        if name.startswith("select.") and name.endswith(".k.bias"):
            assert np.abs(got - start[name]).max() <= 2 * 2 * 1e-4, name
        else:
            assert _rel(got, qlora["jparams"][name]) <= STEP_RTOL, name
    for name, b in model.named_buffers():
        assert torch.equal(b, frozen[name]), name
    assert sum(tquant.is_quantized(m) for m in model.modules()) == 7 * 2


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_qlora_remat_gives_the_same_steps(qlora, remat):
    ref_model, _, ref_metrics = qlora["runs"]["none"]
    model, _, metrics = qlora["runs"][remat]
    for r, m in zip(ref_metrics, metrics):
        assert m == pytest.approx(r, rel=REMAT_TOL)
    ref = dict(ref_model.named_parameters())
    for name, p in model.named_parameters():
        torch.testing.assert_close(p, ref[name], atol=REMAT_TOL, rtol=0, msg=name)


def test_qlora_dots_saves_every_projection_product(qlora, monkeypatch):
    """Remat "dots" keeps, per quantized layer, the outputs of its seven
    base products and LoRA's four (q and v, A and B); the recompute takes
    them from the cache."""
    from torch.utils.checkpoint import CheckpointPolicy
    saved = []
    policy = tllama._save_dots

    def recording(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if decision == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            saved.append(tuple(args[1].shape))
        return decision

    monkeypatch.setattr(tllama, "_save_dots", recording)
    model, _, _ = qlora["runs"]["dots"]
    loss, _ = tllmseg.loss_fn(model, qlora["tbs"][0], lora_cfg=TLORA, remat="dots")
    loss.backward()
    cfg = TC.llmseg_tiny().llava.llm
    layers = cfg.num_layers
    assert len(saved) == 11 * layers, saved
    widths = {(cfg.hidden_size, cfg.num_heads * cfg.head_dim),
              (cfg.intermediate_size, cfg.hidden_size), (cfg.hidden_size, TLORA.rank)}
    assert widths <= set(saved)


# ---------------------------------------------------------------------------
# checkpoints: the best-metric policy and the Trainer under QLoRA
# ---------------------------------------------------------------------------


def test_best_keeper(tmp_path):
    params = {"a": torch.arange(4.0), "b": torch.ones(2, 3)}
    keeper = ckpt_lib.BestKeeper(str(tmp_path), "giou")
    assert keeper.update(8, {"giou": 0.6, "ciou": 0.1}, params, {"x": 1})
    assert not keeper.update(9, {"giou": 0.4, "ciou": 0.2}, params)
    assert not keeper.update(10, {"giou": 0.6, "ciou": 0.3}, params)    # strictly greater
    assert not keeper.update(11, {"ciou": 0.9}, params)
    assert ckpt_lib.latest_step(str(tmp_path)) == 8
    again = ckpt_lib.BestKeeper(str(tmp_path), "giou")
    assert again.best == 0.6
    import json
    with open(tmp_path / "ckpt" / "8" / "meta.json") as f:
        assert json.load(f) == {"step": 8, "giou": 0.6, "ciou": 0.1}
    with open(tmp_path / "best_meta.json") as f:
        assert json.load(f) == {"step": 8, "giou": 0.6, "ciou": 0.1}
    got, opt_state, step = ckpt_lib.restore(str(tmp_path))
    assert step == 8 and opt_state == {"x": 1}
    assert all(torch.equal(got[k], v) for k, v in params.items())
    assert again.update(12, {"giou": 0.7}, params)


class _Writer:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, value, step))


def _val_batches(n=2, bsz=2, seed=0):
    cfg = TC.llmseg_tiny()
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        batch = tmake_batch(cfg, device="cpu", num_images=bsz, rows_per_image=1,
                            text_len=32, seed=30 + i)
        out.append((batch, {
            "segs_origin": [(rng.rand(24, 32, cfg.max_proposals) < 0.4).astype(np.uint8)
                            for _ in range(bsz)],
            "masks_list": [[(rng.rand(24, 32) < 0.4).astype(np.float32)] for _ in range(bsz)],
            "image_paths": [None] * bsz, "conversations": [[""]] * bsz}))
    return out


@pytest.mark.parametrize("bits", [8, 4])
def test_trainer_validate_save_best_and_resume_under_qlora(tmp_path, bits):
    cfg = TC.ExperimentConfig(model=TC.llmseg_tiny(), train=TC.TrainConfig(
        grad_accum_steps=1, epochs=1, steps_per_epoch=2, warmup_steps=0, lr=1e-3,
        precision="fp32", log_dir=str(tmp_path), lora=TLORA, quantize_frozen=True,
        quantize_bits=bits))
    writer = _Writer()
    trainer = ttrainer.Trainer(cfg, device="cpu", writer=writer)
    llm = trainer.model.llava.llm
    assert sum(isinstance(m, QUANT_CLS[bits]) for m in llm.modules()) == 7 * len(llm.layers)
    assert isinstance(llm.lm_head, torch.nn.Linear) and llm.lm_head.weight.requires_grad
    buffers = {n: b.clone() for n, b in trainer.model.named_buffers()}
    _, tbs = _batches(2)
    trainer.train_epoch(tbs, epoch=0)
    assert trainer.global_step == 2
    assert all(torch.equal(b, buffers[n]) for n, b in trainer.model.named_buffers())

    res = trainer.validate(_val_batches())
    assert set(res) == {"giou", "ciou"} and all(np.isfinite(v) for v in res.values())
    assert [t for t, _, _ in writer.scalars[-2:]] == ["val/giou", "val/ciou"]
    assert writer.scalars[-1][2] == 2
    assert trainer.save_best(res)
    assert not trainer.save_best(res)
    saved = {n: p.detach().clone() for n, p in trainer.trainable.items()}

    fresh = ttrainer.Trainer(cfg, device="cpu")
    assert fresh.best.best == res["giou"]
    assert all(torch.equal(b, buffers[n]) for n, b in fresh.model.named_buffers())
    assert fresh.maybe_resume()
    assert fresh.global_step == 2
    assert all(torch.equal(p, saved[n]) for n, p in fresh.trainable.items())
    assert fresh.validate(_val_batches()) == res
    assert trainer.train_epoch(tbs[:1], epoch=1) == fresh.train_epoch(tbs[:1], epoch=1)
    assert all(torch.equal(p, trainer.trainable[n]) for n, p in fresh.trainable.items())
