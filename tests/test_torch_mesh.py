"""The port's (dp, fsdp, tp) mesh (``parallel/mesh.py``) against the JAX
package's, at ``llmseg_tiny`` (4 heads, vocab 256, MLP 128) with LoRA rank
2, float32 on the CPU.

``param_spec`` gives JAX's rule for every port parameter, and the 7B
layout divides (dp 2, fsdp 2, tp 2) on the meta device
(``test_multichip.py``'s ``test_7b_layout_divides_production_mesh``).
Then the port's ``Trainer`` runs in processes on gloo
(``tests/torch_mesh_worker.py``) at tp=2, fsdp=2 (2 processes each) and
dp=2 x tp=2 (4), each on the same global batches as JAX's ``Trainer`` on
the same mesh shape over conftest's 8 CPU devices, from the same numpy
weights.  Each run: ``predict`` on its data rank's rows, two steps,
``validate``, ``save_best``.  Bounds: the loss terms and ``grad_norm``
within 1e-5 relative of JAX's partitioned step; every trainable gradient,
gathered to its whole shape, within 1e-4 (absolute and relative) of
``jax.grad`` of the global batch's loss (``test_torch_loss_fn.py``'s bound
against JAX), and the first step's within 1e-5 (relative Frobenius, per
tensor) of the port's own step in one process.  At tp > 1 the selection
head's attention q and k projections are held to 1e-4 there instead: their
gradients carry the softmax's cancellation (the logits' gradient sums to
zero over each row, so the k bias's exact gradient is zero and q's and k's
are small differences), and float32 rounding of the tp split's partial sums
moves them by up to 5.9e-5 (measured), less than the one-process step's own
distance from JAX on the same tensors (up to 1.7e-4); the rest stay within
1e-5 (in float64 the split moves every gradient by under 3e-7, the float32
logits' rounding).  The trainable parameters
after both steps within 1e-5 of JAX's (relative Frobenius; the selection
head's key biases, whose exact gradient is zero, within 2 lr an update, as
in ``test_torch_ddp.py``), equal on every rank; the trainable embed_tokens
and its AdamW moments held as (V/tp, D/fsdp) blocks; LLaMA's attention at
H/tp heads; ``predict`` at dp=2 x tp=2 within 2e-4 of JAX's single-device
``predict`` (``test_multichip.py``'s bound); the mesh's gIoU / cIoU equal
to one process's; the tp=2 run's checkpoint loaded into a one-process
``Trainer`` equal to the run's parameters to the bit.  Each worker's
``init_process_group`` times out after 60 s, and the test kills the
workers after 300 s."""

import os
import pickle
import re
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from llmseg_tpu import config as JC
from llmseg_tpu.data.synthetic import make_batch as jmake_batch
from llmseg_tpu.models import llmseg as jllmseg
from llmseg_tpu.parallel import mesh as JM
from llmseg_tpu.train.trainer import Trainer as JTrainer
from llmseg_tpu_torch import config as TC
from llmseg_tpu_torch.import_weights.from_jax import flatten, flatten_paths
from llmseg_tpu_torch.models import llmseg as tllmseg
from llmseg_tpu_torch.parallel import mesh as M
from llmseg_tpu_torch.train import trainer as ttrainer

from test_torch_ddp import TRAIN, _batch, _rel, _shard, port_grads
from test_torch_loss_fn import JLORA, TERMS, TLORA, jittered_params

WORKER = os.path.join(os.path.dirname(__file__), "torch_mesh_worker.py")
CASES = {"tp2": (1, 1, 2), "fsdp2": (1, 2, 1), "dp2_tp2": (2, 1, 2)}
METRICS = TERMS + ("grad_norm",)
WAIT_S = 300


def _jax_spec_by_port_name(tree) -> dict:
    """JAX's ``param_spec`` of a tree, keyed by the port's names, in JAX's
    layout: {port name: (spec tuple, transposed)}."""
    spec = JM.param_spec(tree)
    flat = jax.tree_util.tree_flatten_with_path(
        spec, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    out = {}
    for path, s in flat:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        leaf = keys[-1]
        if leaf in ("w", "a", "b") and len(tuple(s)) == 2:
            name, transposed = ".".join(keys[:-1]) + ("" if leaf == "w" else "." + leaf) \
                + ".weight", True
        elif leaf == "embed_tokens":
            name, transposed = ".".join(keys) + ".weight", False
        elif leaf in ("scale", "w"):
            name, transposed = ".".join(keys[:-1]) + ".weight", False
        elif leaf == "b":
            name, transposed = ".".join(keys[:-1]) + ".bias", False
        else:
            name, transposed = ".".join(keys), False
        out[name] = (tuple(s), transposed)
    return out


def test_param_spec_matches_jax():
    """Every port parameter's rule is JAX's on the same leaf, mapped through
    the port's (out, in) layout."""
    jtree = jax.eval_shape(lambda k: jllmseg.init(k, JC.llmseg_tiny(), lora_cfg=JLORA),
                           jax.random.PRNGKey(0))
    jspec = _jax_spec_by_port_name(jtree)
    model = tllmseg.LLMSeg(TC.llmseg_tiny(), TLORA, device="meta")
    tspec = M.param_spec(model)
    assert set(tspec) == set(jspec)
    sharded = 0
    for name, (s, transposed) in jspec.items():
        s = s + (None,) * (len(tspec[name]) - len(s))
        want = s[::-1] if transposed else s
        assert tspec[name] == want, name
        sharded += any(want)
    # every LLaMA matrix and LoRA leaf: q, k, v, o, gate, up, down and A, B a layer
    cfg = TC.llmseg_tiny().llava.llm
    assert sharded == 2 + cfg.num_layers * (7 + 4)


def test_7b_layout_divides_production_mesh():
    """The 7B tree (vocab 32004, 32 heads, MLP 11008, hidden 4096, LoRA r8)
    on the meta device: every rank's block of every sharded dim is the
    whole divided by its axis under (dp 2, fsdp 2, tp 2)."""
    cfg = TC.llmseg_7b()
    whole = {n: tuple(p.shape) for n, p in
             tllmseg.LLMSeg(cfg, TC.LoraConfig(rank=8), device="meta").named_parameters()}
    for rank in range(8):
        model = tllmseg.LLMSeg(cfg, TC.LoraConfig(rank=8), device="meta")
        mesh = M.Mesh(2, 2, 2, rank=rank)
        specs = M.shard_params(model, mesh)
        checked = 0
        for name, p in model.named_parameters():
            want = tuple(n // (mesh.size(a) if a else 1) for n, a in zip(whole[name], specs[name]))
            assert tuple(p.shape) == want, name
            checked += sum(a is not None for a in specs[name])
        assert checked > 100, checked
        assert model.llava.llm.layers[0].mesh is mesh and model.mesh is mesh


def test_mesh_coordinates_and_groups_follow_jax_order():
    """Rank r at (d, f, t) with r = (d * fsdp + f) * tp + t, the order in
    which JAX reshapes its devices; the data rank is d * fsdp + f."""
    devs = np.arange(8)
    jmesh = np.asarray(devs).reshape(2, 2, 2)
    for r in range(8):
        m = M.Mesh(2, 2, 2, rank=r)
        d, f, t = (int(i) for i in np.argwhere(jmesh == r)[0])
        assert (m.coord("dp"), m.coord("fsdp"), m.coord("tp")) == (d, f, t)
        assert m.data_rank == d * 2 + f and m.data_size == 4
    assert M._members("tp", 2, 2, 2)[1] == [2, 3]
    assert M._members("fsdp", 2, 2, 2)[1] == [1, 3]
    assert M._members("data", 2, 2, 2)[0] == [0, 2, 4, 6]
    assert M._members("dp", 2, 2, 2)[3] == [3, 7]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(root, case, world, worker=WORKER):
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, worker, root, case], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    return procs


def _wait(procs):
    deadline = time.time() + WAIT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.time(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p in procs:
        log = p.stdout.read()
        assert p.returncode == 0, log[-4000:]


def _by_images(b, images, rows_per_image):
    """The rows of ``images`` (a range) of a batch with ``rows_per_image``."""
    rows = slice(images.start * rows_per_image, images.stop * rows_per_image)
    out = {}
    for k, v in b.items():
        if k in ("images_dino", "images_clip", "sam_segs", "prop_valid"):
            out[k] = v[images.start:images.stop].copy()
        else:
            out[k] = v[rows].copy()
    out["row_to_image"] = out["row_to_image"] - images.start
    return out


def _val_batches():
    cfg = JC.llmseg_tiny()
    rng = np.random.RandomState(3)
    out = []
    for i in range(2):
        b = {k: np.asarray(v) for k, v in jmake_batch(cfg, num_images=2, rows_per_image=1,
                                                       text_len=32, seed=40 + i).items()}
        out.append((b, {"segs_origin": [(rng.rand(24, 32, cfg.max_proposals) < 0.4)
                                        .astype(np.uint8) for _ in range(2)],
                        "masks_list": [[(rng.rand(24, 32) < 0.4).astype(np.float32)]
                                       for _ in range(2)],
                        "image_paths": [None] * 2, "conversations": [[""]] * 2}))
    return out


def _jax_run(params, batches, mesh, log_dir):
    """JAX's Trainer on ``mesh`` (dp, fsdp, tp): the partitioned step's
    metrics each step and the trainable tree after."""
    dp, fsdp, tp = mesh
    cfg = JC.ExperimentConfig(model=JC.llmseg_tiny(), train=JC.TrainConfig(
        **TRAIN, mesh=JC.MeshConfig(data=dp, fsdp=fsdp, tensor=tp), lora=JLORA,
        log_dir=log_dir))
    trainer = JTrainer(cfg, lora_cfg=JLORA, params=params)
    metrics, starts = [], []
    for b in batches:
        starts.append(jax.tree.map(np.asarray, trainer.params))
        with trainer.mesh:
            trainer.trainable, trainer.opt_state, m = trainer.train_step(
                trainer.trainable, trainer.skeleton, trainer.opt_state,
                JM.shard_batch(b, trainer.mesh))
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(metrics=metrics, starts=starts,
                params=flatten_paths(jax.tree.map(np.asarray, trainer.trainable)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh")
    params = jittered_params()
    batches = [_batch(20), _batch(21)]
    pb = {k: np.asarray(v) for k, v in jmake_batch(JC.llmseg_tiny(), num_images=4,
                                                    rows_per_image=1, text_len=32,
                                                    seed=5).items()}
    val = _val_batches()
    with open(root / "inputs.pkl", "wb") as f:
        pickle.dump({"params": params, "train": TRAIN, "cases": CASES,
                     "shards": {1: [[b] for b in batches],
                                2: [[_shard(b, r) for r in range(2)] for b in batches]},
                     "predict": {1: [pb], 2: [_by_images(pb, range(2 * d, 2 * d + 2), 1)
                                              for d in range(2)]},
                     "val": {1: [val], 2: [[v] for v in val]}}, f)
    t0 = time.time()
    procs = {case: _launch(str(root), case, int(np.prod(shape))) for case, shape in CASES.items()}

    # meanwhile, JAX: its Trainer on each mesh shape, jax.grad of the global
    # batch's loss at each step's starting weights, single-device predict
    jgrad = jax.jit(jax.grad(lambda p, b: jllmseg.loss_fn(p, JC.llmseg_tiny(), b,
                                                          lora_cfg=JLORA)[0]))
    jax_runs = {}
    for case, shape in CASES.items():
        r = _jax_run(params, batches, shape, str(root / f"jax_{case}"))
        r["grads"] = [flatten(jax.tree.map(np.asarray, jgrad(s, b)))
                      for s, b in zip(r.pop("starts"), batches)]
        jax_runs[case] = r
    jpred = jllmseg.predict(params, JC.llmseg_tiny(), pb)
    tgrads = port_grads(params, batches[0])
    one = ttrainer.Trainer(TC.ExperimentConfig(model=TC.llmseg_tiny(), train=TC.TrainConfig(
        **TRAIN, lora=TLORA, log_dir=str(root / "one"))), lora_cfg=TLORA, device="cpu",
        model=_port_model(params))
    one_val = one.validate(val, strategy="argmax")

    for p in procs.values():
        _wait(p)
    seconds = time.time() - t0
    ranks = {case: [torch.load(root / f"{case}_rank{r}.pt", weights_only=False)
                    for r in range(int(np.prod(shape)))] for case, shape in CASES.items()}
    return dict(root=root, ranks=ranks, jax=jax_runs, tgrads=tgrads, seconds=seconds,
                jpred={k: np.asarray(jpred[k]) for k in ("pred_similarity", "pred_iou")},
                one_val=one_val, start=flatten(params), params=params)


def _logit_side(name):
    """The selection head's attention q and k projections."""
    return bool(re.match(r"select\..*\.(q|k)\.(weight|bias)$", name))


def _port_model(params):
    from test_torch_loss_fn import port_model

    return port_model(params)


@pytest.mark.parametrize("case", list(CASES))
def test_steps_match_jax_on_the_same_mesh(run, case):
    print(f"workers and JAX: {run['seconds']:.1f} s")
    ranks, ref = run["ranks"][case], run["jax"][case]
    r0 = ranks[0]
    for step in range(2):
        for k in METRICS:
            np.testing.assert_allclose(r0["metrics"][step][k], ref["metrics"][step][k],
                                       rtol=1e-5, atol=0, err_msg=f"{case} {step} {k}")
        assert set(r0["grads"][step]) <= set(ref["grads"][step])
        for name, g in r0["grads"][step].items():
            np.testing.assert_allclose(g.numpy(), ref["grads"][step][name], atol=1e-4,
                                       rtol=1e-4, err_msg=f"{case} {step} {name}")
            if step == 0 and not name.endswith(".k.bias"):    # k.bias: zero up to rounding
                bound = 1e-4 if CASES[case][2] > 1 and _logit_side(name) else 1e-5
                assert _rel(g.numpy(), run["tgrads"][name]) <= bound, name
    for name, p in r0["params"].items():
        if name.startswith("select.") and name.endswith(".k.bias"):
            assert np.abs(p.numpy() - run["start"][name]).max() <= 2 * 2 * TRAIN["lr"], name
        else:
            assert _rel(p.numpy(), ref["params"][name]) <= 1e-5, (case, name)


@pytest.mark.parametrize("case", list(CASES))
def test_every_rank_ends_with_the_same_parameters(run, case):
    """The whole parameters (gathered over fsdp and tp) and the loss terms
    are the same on every rank, to the bit: the replicated leaves took the
    same updates everywhere."""
    ranks = run["ranks"][case]
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
        for name, p in ranks[0]["params"].items():
            assert torch.equal(p, r["params"][name]), (case, name)


@pytest.mark.parametrize("case", list(CASES))
def test_embed_tokens_and_its_moments_are_blocks(run, case):
    """embed_tokens (V, D) and its AdamW moments live as (V/tp, D/fsdp)
    blocks, JAX's P("tp", "fsdp")."""
    _, fsdp, tp = CASES[case]
    cfg = TC.llmseg_tiny().llava.llm
    block = (cfg.vocab_size // tp, cfg.hidden_size // fsdp)
    for r in run["ranks"][case]:
        assert r["embed_block"] == [block] * 3


@pytest.mark.parametrize("case", list(CASES))
def test_attention_runs_at_the_local_head_count(run, case):
    cfg = TC.llmseg_tiny().llava.llm
    tp = CASES[case][2]
    for r in run["ranks"][case]:
        assert r["heads"] == [(cfg.num_heads // tp, cfg.num_kv_heads // tp)]


@pytest.mark.parametrize("case", list(CASES))
def test_data_ranks_follow_the_mesh(run, case):
    """Each rank's data rank is d * fsdp + f; the tp ranks of one data rank
    share it (and so their rows)."""
    dp, fsdp, tp = CASES[case]
    for rank, r in enumerate(run["ranks"][case]):
        c = r["coords"]
        assert rank == (c["dp"] * fsdp + c["fsdp"]) * tp + c["tp"]
        assert r["data_rank"] == c["dp"] * fsdp + c["fsdp"] and r["data_size"] == dp * fsdp


def test_predict_dp2_tp2_matches_single_device_jax(run):
    ranks = run["ranks"]["dp2_tp2"]
    for k in ("pred_similarity", "pred_iou"):
        got = np.concatenate([ranks[0]["predict"][k].numpy(), ranks[2]["predict"][k].numpy()])
        np.testing.assert_allclose(got, run["jpred"][k], rtol=2e-4, atol=2e-4, err_msg=k)
        # the two tp ranks of a data rank give the same scores
        assert torch.equal(ranks[0]["predict"][k], ranks[1]["predict"][k])


@pytest.mark.parametrize("case", list(CASES))
def test_validate_on_the_mesh_equals_one_process(run, case):
    for r in run["ranks"][case]:
        assert r["val"] == pytest.approx(run["one_val"], rel=1e-9, abs=0)


def test_tp2_checkpoint_loads_into_one_process_trainer(run):
    """save_best on the tp=2 mesh writes whole tensors (rank 0 alone); a
    one-process Trainer resumes them, parameters and AdamW state, to the
    bit."""
    ranks = run["ranks"]["tp2"]
    assert all(r["saved"] for r in ranks)
    log0 = run["root"] / "tp2_log0"
    assert (log0 / "best_meta.json").exists() and not (run["root"] / "tp2_log1" / "ckpt").exists()
    cfg = TC.ExperimentConfig(model=TC.llmseg_tiny(), train=TC.TrainConfig(
        **TRAIN, lora=TLORA, log_dir=str(log0)))
    fresh = ttrainer.Trainer(cfg, lora_cfg=TLORA, device="cpu", model=_port_model(run["params"]))
    assert fresh.maybe_resume()
    for name, p in fresh.trainable.items():
        assert torch.equal(p, ranks[0]["params"][name]), name
    state = fresh.opt.adamw.state[fresh.trainable["llava.llm.embed_tokens.weight"]]
    cfg_llm = TC.llmseg_tiny().llava.llm
    assert tuple(state["exp_avg"].shape) == (cfg_llm.vocab_size, cfg_llm.hidden_size)


def test_a_data_parallel_mesh_keeps_a_quantized_model():
    """A data-parallel mesh shards nothing: a quantized model keeps every
    buffer whole and takes the single-device path (the quantized model on
    a mesh with fsdp or tp above 1: ``tests/test_torch_qmesh.py``)."""
    from llmseg_tpu_torch.ops import quant

    model = tllmseg.build(TC.llmseg_tiny(), device="cpu", lora_cfg=TLORA)
    quant.quantize_llama_inplace(model.llava.llm, bits=8)
    before = {n: b.shape for n, b in model.named_buffers()}
    assert M.shard_params(model, M.Mesh(2, 1, 1, rank=1)) == M.param_spec(model)
    assert {n: b.shape for n, b in model.named_buffers()} == before
    assert model.llava.llm.mesh is None


def test_generation_refuses_a_sharded_llama():
    """The pixel decoder's greedy generation calls LLaMA's layers piece by
    piece, so a LLaMA sharded over tp would give partial products: it
    raises instead (generation is not on the mesh's path, as in JAX's
    Trainer)."""
    from llmseg_tpu_torch.models import generate

    model = tllmseg.build(TC.llmseg_tiny(), device="cpu")
    M.shard_params(model, M.Mesh(1, 1, 2, rank=0))
    x = torch.zeros(1, 4, TC.llmseg_tiny().llava.llm.hidden_size)
    with pytest.raises(NotImplementedError, match="whole LLaMA"):
        generate.greedy_generate(model.llava.llm, x, 2)
