"""A quantized LLaMA on the port's (dp, fsdp, tp) mesh against the JAX
package's on the same mesh shape, at ``llmseg_tiny`` with LoRA rank 2,
float32 on the CPU.

The port runs in processes on gloo (``tests/torch_qmesh_worker.py``) at
tp=2 and fsdp=2 (in turn, in 2 processes), dp=2 x tp=2 and fsdp=2 x tp=2
(in turn, in 4), while JAX runs the same mesh shapes over conftest's 8 CPU devices and the
port's one-process references run here, all from the same numpy weights.

  * Every quantized leaf (int8, int4, W8A8; lm_head included), gathered
    whole, equals the port's one-process leaf to the bit, and JAX's leaf
    on its mesh as ``tests/test_torch_quant.py`` holds the one-process
    quantizers to JAX's: the scales within one unit in the last place
    (XLA rounds the division by 127 or 7 otherwise than IEEE division in a
    few elements), the codes equal but for ties that such a scale puts on
    the other side of .5 (one code, at most 1e-3 of them).  Each rank's block has the
    shape of JAX's shard of it (the codes as the bf16 weight, the scales
    along the output axis's mesh axis, int4's packed codes and group
    scales along the output axis alone).
  * QLoRA, int8 at tp=2 and int4 at fsdp=2 x tp=2 (down's one group of
    128 inputs cut in half at tp=2): the loss terms and ``grad_norm``
    within 1e-5 relative of JAX's partitioned step, the trainables after
    two steps within ``tests/test_torch_mesh.py``'s bounds (1e-5
    relative; the selection head's key biases, whose exact gradient is
    zero, within 2 lr an update), the
    frozen codes untouched, and the tp=2 checkpoint resumed by a
    one-process QLoRA ``Trainer`` to the bit.
  * W8A8 ``predict`` at tp=2 equals the port's one-process W8A8 ``predict``
    to the bit (the row split's scale shared by a MAX over tp, its int32
    partial sums summed over tp before the rescale), also with the opt-in
    outlier decomposition (``LLMSEG_W8A8_OUTLIER_K``: the row split's input
    and codes gathered over tp), and JAX's on the same mesh within 2e-4;
    weight-only int8 and int4 ``predict`` within 2e-4 of JAX's.
  * SmoothQuant's statistics from the mesh (each data rank on its rows,
    the o and down columns gathered over tp, the maxima taken over the
    data group): one process's on the global batch to the bit where tp is
    1, within STATS_RTOL where the float32 forward sums the row split's
    partial products over tp (another summation order; the W8A8 forward,
    whose row sums are int32, stays bitwise).  From the same statistics
    the folded and quantized tree (LoRA compensated), gathered, equals one
    process's to the bit, in W8A8 and int4, and so does the folded W8A8
    ``predict`` at tp=2.
  * The plain versions of Q1's split forms and of Q2's int32 output
    against JAX's ``quantize_activation`` / ``qdense_act``, on the whole K
    and on its tp blocks.

Each worker's ``init_process_group`` times out after 60 s, and the test
kills the workers after 300 s."""

import contextlib
import copy
import os
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmseg_tpu import config as JC
from llmseg_tpu.data.synthetic import make_batch as jmake_batch
from llmseg_tpu.models import llmseg as jllmseg
from llmseg_tpu.ops import quant as jquant
from llmseg_tpu.parallel import mesh as JM
from llmseg_tpu.train.trainer import Trainer as JTrainer
from llmseg_tpu_torch import config as TC
from llmseg_tpu_torch.import_weights.from_jax import flatten, flatten_paths
from llmseg_tpu_torch.models import llmseg as tllmseg
from llmseg_tpu_torch.ops import quant as tquant
from llmseg_tpu_torch.parallel import mesh as M
from llmseg_tpu_torch.train import trainer as ttrainer

from test_torch_ddp import TRAIN, _batch, _rel, _shard
from test_torch_loss_fn import JLORA, TERMS, TLORA, jittered_params, port_model
from test_torch_mesh import _by_images, _launch, _wait
from torch_qmesh_worker import OUTLIER_K

WORKER = os.path.join(os.path.dirname(__file__), "torch_qmesh_worker.py")
CASES = {"tp2": dict(mesh=(1, 1, 2), runs=("leaves", "fold", "qlora8"), predict=True),
         "fsdp2": dict(mesh=(1, 2, 1), runs=("leaves", "fold")),
         "dp2_tp2": dict(mesh=(2, 1, 2), runs=("leaves", "fold")),
         "fsdp2_tp2": dict(mesh=(1, 2, 2), runs=("qlora4",))}
LEAF_CASES = [c for c, s in CASES.items() if "leaves" in s["runs"]]
QLORA = {"qlora8": ("tp2", 8), "qlora4": ("fsdp2_tp2", 4)}
MODES = {"int8": (8, False), "int4": (4, False), "w8a8": (8, True)}
FOLDS = {"w8a8": (8, True), "int4": (4, False)}
METRICS = TERMS + ("grad_norm",)
PREDICT_TOL = 2e-4
KEYS = ("pred_similarity", "pred_iou")
QUANT_BUFFERS = ("w_q", "w_q8a", "w_scale", "w_q4", "w_scale4")
STATS_RTOL = 1e-5             # the calibration statistics at tp > 1 against one process
HEAD_DIM = TC.llmseg_tiny().llava.llm.head_dim


def _images(b, n):
    """``n`` data ranks' shares of a batch of one row an image."""
    k = b["images_dino"].shape[0] // n
    return [_by_images(b, range(d * k, d * k + k), 1) for d in range(n)]


def _jmesh(shape):
    dp, fsdp, tp = shape
    return JM.make_mesh(JC.MeshConfig(data=dp, fsdp=fsdp, tensor=tp))


def _jax_quantized(params, shape, bits, w8a8):
    """JAX's quantized tree on ``shape``'s mesh: {port name: whole leaf},
    {port name: the shape of one device's shard}, in the port's layout."""
    mesh = _jmesh(shape)
    with mesh:
        p = JM.shard_params(jax.tree.map(jnp.asarray, params), mesh)
        jquant.quantize_llama_inplace(p["llava"]["llm"], bits=bits, w8a8=w8a8)
    llm = {"llava": {"llm": p["llava"]["llm"]}}
    shards = jax.tree.map(lambda a: np.empty(a.sharding.shard_shape(a.shape), np.int8), llm)
    whole, blocks = flatten(llm), flatten(shards)
    keep = [n for n in whole if n.rsplit(".", 1)[1] in QUANT_BUFFERS]
    return p, {n: whole[n] for n in keep}, {n: blocks[n].shape for n in keep}


def _jax_qlora(params, batches, shape, bits, log_dir):
    """JAX's Trainer with a quantized frozen base on ``shape``'s mesh: the
    partitioned step's metrics each step and the trainable tree after."""
    dp, fsdp, tp = shape
    cfg = JC.ExperimentConfig(model=JC.llmseg_tiny(), train=JC.TrainConfig(
        **TRAIN, mesh=JC.MeshConfig(data=dp, fsdp=fsdp, tensor=tp), lora=JLORA,
        quantize_frozen=True, quantize_bits=bits, log_dir=log_dir))
    trainer = JTrainer(cfg, lora_cfg=JLORA, params=params)
    metrics = []
    for b in batches:
        with trainer.mesh:
            trainer.trainable, trainer.opt_state, m = trainer.train_step(
                trainer.trainable, trainer.skeleton, trainer.opt_state,
                JM.shard_batch(b, trainer.mesh))
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(metrics=metrics, params=flatten_paths(jax.tree.map(np.asarray,
                                                                    trainer.trainable)))


@contextlib.contextmanager
def _outliers():
    """LLMSEG_W8A8_OUTLIER_K at the worker's value, for one block."""
    tquant.W8A8_OUTLIER_K = OUTLIER_K
    try:
        yield
    finally:
        tquant.W8A8_OUTLIER_K = 0


def _port_one(params, batch, mode, stats=None, lora=False):
    """The port's one-process quantization: the model, its quantized
    buffers and its predict."""
    bits, w8a8 = MODES[mode]
    model = port_model(params)
    tquant.quantize_llama_inplace(model.llava.llm, bits=bits, w8a8=w8a8, smooth_stats=stats,
                                  lora=model.lora if lora else None, head_dim=HEAD_DIM)
    out = tllmseg.predict(model, {k: torch.from_numpy(v) for k, v in batch.items()},
                          device="cpu")
    return model, {k: out[k].clone() for k in KEYS}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("qmesh")
    params = jittered_params()
    batches = [_batch(20), _batch(21)]
    pb, cb = ({k: np.asarray(v) for k, v in jmake_batch(
        JC.llmseg_tiny(), num_images=4, rows_per_image=1, text_len=32, seed=s).items()}
        for s in (5, 9))
    stats = tllmseg.calibrate_quant_stats(port_model(params), {k: torch.from_numpy(v)
                                                               for k, v in cb.items()})
    with open(root / "inputs.pkl", "wb") as f:
        pickle.dump({"params": params, "train": TRAIN, "cases": CASES, "stats": stats,
                     "shards": {1: [[b] for b in batches],
                                2: [[_shard(b, r) for r in range(2)] for b in batches]},
                     "predict": {n: _images(pb, n) for n in (1, 2)},
                     "calib": {n: _images(cb, n) for n in (1, 2)}}, f)
    t0 = time.time()
    # one process group a world size, its cases in turn: 6 processes, not 12
    worlds = {}
    for case, spec in CASES.items():
        worlds.setdefault(int(np.prod(spec["mesh"])), []).append(case)
    procs = [_launch(str(root), ",".join(cases), world, WORKER)
             for world, cases in worlds.items()]

    # meanwhile: JAX on each mesh shape, and the port in one process
    jleaves, jpred = {}, {}
    for case in LEAF_CASES:
        for mode, (bits, w8a8) in MODES.items():
            p, whole, blocks = _jax_quantized(params, CASES[case]["mesh"], bits, w8a8)
            jleaves[case, mode] = (whole, blocks)
            if CASES[case].get("predict"):
                mesh = _jmesh(CASES[case]["mesh"])
                with mesh:
                    out = jax.jit(lambda p_, b_: jllmseg.predict(p_, JC.llmseg_tiny(), b_))(
                        p, JM.shard_batch(pb, mesh))
                jpred[mode] = {k: np.asarray(out[k]) for k in KEYS}
    jqlora = {run_: _jax_qlora(params, batches, CASES[case]["mesh"], bits,
                               str(root / f"jax_{run_}")) for run_, (case, bits) in QLORA.items()}
    one = {}
    for mode in MODES:
        model, pred = _port_one(params, pb, mode)
        one[mode] = {"leaves": {n: t.clone() for n, t in M._named_tensors(model).items()
                                if n.rsplit(".", 1)[1] in QUANT_BUFFERS},
                     "predict": pred}
        if mode == "w8a8":
            with _outliers():
                out = tllmseg.predict(model, {k: torch.from_numpy(v) for k, v in pb.items()},
                                      device="cpu")
            one[mode]["predict_outlier"] = {k: out[k].clone() for k in KEYS}
    folds = {}
    for mode in FOLDS:
        model, pred = _port_one(params, pb, mode, stats=stats, lora=True)
        folds[mode] = {"tensors": {n: t.detach().clone() for n, t in
                                   M._named_tensors(model).items()}, "predict": pred}

    for p in procs:
        _wait(p)
    seconds = time.time() - t0
    ranks = {case: [torch.load(root / f"{case}_rank{r}.pt", weights_only=False)
                    for r in range(int(np.prod(s["mesh"])))] for case, s in CASES.items()}
    return dict(root=root, ranks=ranks, jleaves=jleaves, jpred=jpred, jqlora=jqlora, one=one,
                stats=stats, folds=folds, params=params, seconds=seconds, start=flatten(params))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", LEAF_CASES)
def test_quantized_leaves_equal_jax_and_one_process(run, case, mode):
    print(f"workers and references: {run['seconds']:.1f} s")
    jwhole, jblocks = run["jleaves"][case, mode]
    ref = run["one"][mode]["leaves"]
    llm = TC.llmseg_tiny().llava.llm
    # q, k, v, o, gate, up, down a layer and lm_head, two buffers each
    assert len(ref) == 2 * (7 * llm.num_layers + 1)
    assert set(jwhole) == set(ref)
    for r in run["ranks"][case]:
        got = r["leaves"][mode]
        assert set(got["leaves"]) == set(ref)
        for name, t in got["leaves"].items():
            assert t.dtype == ref[name].dtype and torch.equal(t, ref[name]), name
            assert got["blocks"][name] == jblocks[name], (name, got["blocks"][name])
            _assert_close_to_jax(name, t, jwhole[name])


def _assert_close_to_jax(name, t, arr):
    if t.dtype == torch.float32:
        ulps = (t.view(torch.int32).long() - torch.from_numpy(arr).view(torch.int32).long())
        assert ulps.abs().max() <= 1 and bool((t > 0).all()), (name, ulps.abs().max())
        return
    got, want = t, torch.from_numpy(np.ascontiguousarray(arr))
    if name.endswith("w_q4"):
        got, want = tquant._unpack4(got), tquant._unpack4(want)
    d = (got.int() - want.int()).abs()
    assert d.max() <= 1 and (d > 0).float().mean() <= 1e-3, (name, d.max(), (d > 0).sum())


def test_block_shapes_follow_the_table(run):
    """At tp=2 the column split's codes are (out/2, in), its scales
    (out/2,); the row split's codes (out, in/2), scales (out,); int4's
    packed codes and group scales are split on the output axis alone."""
    llm = TC.llmseg_tiny().llava.llm
    D, I = llm.hidden_size, llm.intermediate_size
    (r0,) = run["ranks"]["tp2"][:1]
    b = {m: r0["leaves"][m]["blocks"] for m in MODES}
    pre = "llava.llm.layers.0."
    assert b["int8"][pre + "mlp.up.w_q"] == (I // 2, D)
    assert b["w8a8"][pre + "mlp.down.w_q8a"] == (D, I // 2)
    assert b["w8a8"][pre + "mlp.up.w_scale"] == (I // 2,)
    assert b["int8"][pre + "mlp.down.w_scale"] == (D,)
    assert b["int4"][pre + "mlp.down.w_q4"] == (D, -(-I // 128) * 64)
    assert b["int4"][pre + "mlp.up.w_scale4"] == (I // 2, -(-D // 128))
    assert b["int4"][pre + "mlp.down.w_scale4"] == (D, -(-I // 128))


@pytest.mark.parametrize("run_", list(QLORA))
def test_qlora_steps_match_jax_on_the_same_mesh(run, run_):
    case, bits = QLORA[run_]
    ref = run["jqlora"][run_]
    ranks = [r[run_] for r in run["ranks"][case]]
    r0 = ranks[0]
    for step in range(2):
        for k in METRICS:
            np.testing.assert_allclose(r0["metrics"][step][k], ref["metrics"][step][k],
                                       rtol=1e-5, atol=0, err_msg=f"{run_} {step} {k}")
    for name, p in r0["params"].items():
        if name.startswith("select.") and name.endswith(".k.bias"):
            assert np.abs(p.numpy() - run["start"][name]).max() <= 2 * 2 * TRAIN["lr"], name
        else:
            assert _rel(p.numpy(), ref["params"][name]) <= 1e-5, (run_, name)
    llm = TC.llmseg_tiny().llava.llm
    for r in ranks:
        assert r["frozen_kept"] and r["specs_cover_buffers"]
        assert r["quantized"] == 7 * llm.num_layers        # lm_head trains: full precision
        assert r["metrics"] == r0["metrics"]
        for name, p in r0["params"].items():
            assert torch.equal(p, r["params"][name]), name


def test_qlora_tp2_checkpoint_loads_into_one_process_trainer(run):
    """The tp=2 QLoRA run's checkpoint, whole tensors from rank 0, resumed
    by a one-process QLoRA Trainer: its trainables equal the run's to the
    bit, its frozen base is its own quantization of the same weights."""
    ranks = [r["qlora8"] for r in run["ranks"]["tp2"]]
    assert all(r["saved"] for r in ranks)
    log0 = run["root"] / "tp2_q8_log0"
    assert (log0 / "best_meta.json").exists()
    assert not (run["root"] / "tp2_q8_log1" / "ckpt").exists()
    cfg = TC.ExperimentConfig(model=TC.llmseg_tiny(), train=TC.TrainConfig(
        **TRAIN, lora=TLORA, quantize_frozen=True, quantize_bits=8, log_dir=str(log0)))
    fresh = ttrainer.Trainer(cfg, lora_cfg=TLORA, device="cpu", model=port_model(run["params"]))
    assert fresh.maybe_resume()
    for name, p in fresh.trainable.items():
        assert torch.equal(p, ranks[0]["params"][name]), name
    for name, t in M._named_tensors(fresh.model).items():
        if name in run["one"]["int8"]["leaves"]:
            assert torch.equal(t, run["one"]["int8"]["leaves"][name]), name


def test_w8a8_predict_tp2_equals_one_process_to_the_bit(run):
    ranks = run["ranks"]["tp2"]
    for r in ranks:
        for k in KEYS:
            got, one = r["leaves"]["w8a8"]["predict"][k], run["one"]["w8a8"]["predict"][k]
            assert torch.equal(got, one), k
            np.testing.assert_allclose(got.numpy(), run["jpred"]["w8a8"][k], rtol=PREDICT_TOL,
                                       atol=PREDICT_TOL, err_msg=k)
        # the CPU takes the plain versions: no kernel is launched here
        assert set(r["leaves"]["w8a8"]["launches"].values()) == {0}
        # the opt-in outlier decomposition gathers the row split over tp
        for k in KEYS:
            got, one = (x["predict_outlier"][k] for x in (r["leaves"]["w8a8"],
                                                         run["one"]["w8a8"]))
            assert torch.equal(got, one), k
            assert not torch.equal(got, r["leaves"]["w8a8"]["predict"][k]), k


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_weight_only_predict_tp2_matches_jax(run, mode):
    for r in run["ranks"]["tp2"]:
        for k in KEYS:
            got = r["leaves"][mode]["predict"][k]
            np.testing.assert_allclose(got.numpy(), run["jpred"][mode][k], rtol=PREDICT_TOL,
                                       atol=PREDICT_TOL, err_msg=k)
            np.testing.assert_allclose(got.numpy(), run["one"][mode]["predict"][k].numpy(),
                                       rtol=PREDICT_TOL, atol=PREDICT_TOL, err_msg=k)


@pytest.mark.parametrize("mode", list(FOLDS))
@pytest.mark.parametrize("case", LEAF_CASES)
def test_fold_on_the_mesh_equals_one_process(run, case, mode):
    """The statistics every rank holds are one process's on the global
    calibration batch (to the bit without tp, within STATS_RTOL with it);
    from one process's statistics the folded, quantized tree (the gammas,
    the codes and scales, LoRA compensated), gathered, is one process's to
    the bit; at tp=2 the folded W8A8 predict too."""
    ref = run["folds"][mode]
    for r in run["ranks"][case]:
        assert len(r["fold"]["stats"]) == len(run["stats"])
        for g, f in zip(r["fold"]["stats"], run["stats"]):
            assert set(g) == set(f) == {"attn_in", "o_in", "mlp_in", "down_in"}
            for k in f:
                if CASES[case]["mesh"][2] == 1:
                    assert torch.equal(g[k], f[k]), k
                else:
                    torch.testing.assert_close(g[k], f[k], rtol=STATS_RTOL, atol=0)
        got = r["fold"][mode]
        assert set(got["tensors"]) == set(ref["tensors"])
        for name, t in got["tensors"].items():
            assert torch.equal(t, ref["tensors"][name]), name
        if "predict" in got:
            for k in KEYS:
                assert torch.equal(got["predict"][k], ref["predict"][k]), k


def test_param_spec_names_the_quantized_buffers():
    """``param_spec`` gives every quantized buffer its rule: int4's packed
    codes and group scales on the output axis alone, the int8 codes as the
    weight, the scales along the output axis's mesh axis."""
    model = port_model(jittered_params())
    tquant.quantize_llama_inplace(model.llava.llm, bits=4)
    assert sum(tquant.is_quantized(m) for m in model.modules()) == 7 * 2 + 1
    specs = M.param_spec(model)
    assert specs["llava.llm.layers.1.attn.o.w_q4"] == ("fsdp", None)
    assert specs["llava.llm.layers.1.attn.v.w_scale4"] == ("tp", None)
    assert specs["llava.llm.lm_head.w_scale4"] == ("tp", None)
    model = port_model(jittered_params())
    tquant.quantize_llama_inplace(model.llava.llm, bits=8, w8a8=True)
    specs = M.param_spec(model)
    assert specs["llava.llm.layers.0.mlp.gate.w_q8a"] == ("tp", "fsdp")
    assert specs["llava.llm.layers.0.mlp.down.w_q8a"] == ("fsdp", "tp")
    assert specs["llava.llm.layers.0.attn.o.w_scale"] == ("fsdp",)
    assert specs["llava.llm.layers.0.attn.k.w_scale"] == ("tp",)
    assert set(specs) == set(M._named_tensors(model))


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("K", [64, 256])
def test_split_forms_match_jax_on_the_whole_k_and_its_blocks(tp, K):
    """Q1's form (a) per block, max over the blocks, then form (b) with
    the shared scale give JAX's ``quantize_activation`` codes and scale on
    the whole K (exact ties included); Q2's int32 output of each block,
    summed, then the rescale, gives JAX's ``qdense_act`` on the whole K
    to the bit (bias, float32 and bf16 outputs)."""
    rng = np.random.RandomState(K + tp)
    x = (rng.randn(17, K) * 3).astype(np.float32)
    x[0, :4] = [127.0, 2.5, -3.5, 0.5]
    x[1] = 0.0
    w = (rng.randn(K, 24) * 0.05).astype(np.float32)
    bias = rng.randn(24).astype(np.float32)
    jp = jquant.quantize_dense_w8a8({"w": jnp.asarray(w), "b": jnp.asarray(bias)})
    qa = jquant.quantize_activation(jnp.asarray(x), k=0)
    xt, wq = torch.from_numpy(x), torch.from_numpy(np.asarray(jp["w_q8a"]).T.copy())
    blocks = xt.chunk(tp, -1)
    amax = torch.stack([tquant.row_absmax_plain(b) for b in blocks]).amax(0)
    assert torch.equal(amax, tquant.row_absmax_plain(xt))
    sc = tquant._div(amax.clamp_min(1e-6), 127.0)
    np.testing.assert_array_equal(sc.numpy(), np.asarray(qa["sc"]))
    xq = torch.cat([tquant.quantize_rows_scaled_plain(b, sc) for b in blocks], -1)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(qa["xq"]))
    acc = sum(tquant._int_mm(q, wb) for q, wb in zip(xq.chunk(tp, -1), wq.chunk(tp, -1)))
    assert acc.dtype == torch.int32 and torch.equal(acc, tquant._int_mm(xq, wq))
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        jb = {**jp, "b": jp["b"].astype(jdtype)}
        ref = jquant.qdense_act(jb, qa, jdtype)
        got = tquant.w8a8_epilogue(acc, sc, torch.from_numpy(np.asarray(jp["w_scale"])),
                                   torch.from_numpy(bias).to(dtype), dtype)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 2, 4)])
def test_7b_quantized_layout_divides_production_mesh(mode, shape):
    """The quantized 7B tree (vocab 32004, MLP 11008: down's int4 codes
    (4096, 86 x 64) and 86 group scales) on the meta device, sharded after
    quantization: every rank's block of every quantized buffer is the whole
    divided by the mesh axes of ``quant_spec`` (at tp = 4 the row split's
    int8 codes are (4096 / 2, 11008 / 4), int4's whole on the input axis)."""
    bits, w8a8 = MODES[mode]
    cfg = TC.llmseg_7b()

    source = tllmseg.LLMSeg(cfg, TC.LoraConfig(rank=8), device="meta")
    tquant.quantize_llama_inplace(source.llava.llm, bits=bits, w8a8=w8a8)
    whole = {n: tuple(t.shape) for n, t in M._named_tensors(source).items()}
    dp, fsdp, tp = shape
    for rank in (0, dp * fsdp * tp - 1):
        model = copy.deepcopy(source)
        mesh = M.Mesh(dp, fsdp, tp, rank=rank)
        specs = M.shard_params(model, mesh)
        checked = 0
        for name, t in M._named_tensors(model).items():
            if name.rsplit(".", 1)[1] not in QUANT_BUFFERS:
                continue
            want = tuple(n // (mesh.size(a) if a else 1) for n, a in zip(whole[name], specs[name]))
            assert tuple(t.shape) == want, name
            checked += 1
        assert checked == 2 * (7 * cfg.llava.llm.num_layers + 1)
        down = "llava.llm.layers.3.mlp.down." + ("w_q4" if bits == 4 else
                                                  "w_q8a" if w8a8 else "w_q")
        assert model.get_buffer(down).shape == ((4096 // fsdp, 43 * 128) if bits == 4
                                                else (4096 // fsdp, 11008 // tp))
