"""The port's data parallelism (``parallel/ddp.py``) in two processes on the
CPU (gloo), at ``llmseg_tiny`` with LoRA rank 2, against the JAX package's
``Trainer`` at ``MeshConfig(data=2)`` (conftest's 8 CPU devices) on the
whole batch.

Two steps; each global batch of 4 images (2 rows each) is split 2 + 2 by
image, with unequal valid counts per rank: rank 1 supervises fewer label
tokens, and its last image has no valid row (2 valid images on rank 0, 1
on rank 1).  Checked, float32: the summed gradients of each step within
1e-4 of ``jax.grad`` of the whole batch's loss (absolute and relative,
``tests/test_torch_loss_fn.py``'s bound: the two libraries' float32
gradients of one batch differ by up to 1.7e-4 relative in a selection-head
tensor), and the first step's within 1e-5 (relative Frobenius, per tensor)
of the port's own in one process on the whole batch (measured: 1.2e-6;
the key biases' exact gradient is zero, so they are left out); the
trainable parameters after both steps within 1e-5 of JAX's
(relative Frobenius; the selection head's key biases, whose exact gradient
is zero, within 2 lr an update, as in ``tests/test_torch_train.py``), equal
to the bit on both ranks, the epoch's loss terms within 1e-5 of JAX's; the
meters' ``all_reduce``; disjoint loader shards; only rank 0 prints and
writes its checkpoint; a mesh whose product is not the world size refused
(the sharded axes themselves run in ``tests/test_torch_mesh.py``).  ``init_process_group`` times out after 60 s and the test
kills both workers after 300 s."""

import os
import pickle
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
from llmseg_tpu.train.trainer import Trainer as JTrainer
from llmseg_tpu_torch import config as TC
from llmseg_tpu_torch.import_weights.from_jax import flatten, flatten_paths

from test_torch_loss_fn import JLORA, TERMS, jittered_params

WORKER = os.path.join(os.path.dirname(__file__), "torch_ddp_worker.py")
TRAIN = dict(lr=1e-4, epochs=1, steps_per_epoch=2, warmup_steps=0, grad_accum_steps=1,
             batch_size=4, precision="fp32", print_freq=1)
WAIT_S = 300


def _batch(seed):
    """4 images x 2 rows; rank 1's rows (4-7) supervise fewer tokens and
    its last image's rows are invalid."""
    b = {k: np.asarray(v) for k, v in jmake_batch(JC.llmseg_tiny(), num_images=4,
                                                   rows_per_image=2, text_len=32,
                                                   seed=seed).items()}
    b["labels"] = b["labels"].copy()
    b["labels"][4:, :26] = -100
    b["row_valid"] = b["row_valid"].copy()
    b["row_valid"][6:] = False
    return b


def _shard(b, rank):
    imgs, rows = slice(2 * rank, 2 * rank + 2), slice(4 * rank, 4 * rank + 4)
    out = {}
    for k, v in b.items():
        if k in ("images_dino", "images_clip", "sam_segs", "prop_valid"):
            out[k] = v[imgs].copy()
        else:
            out[k] = v[rows].copy()
    out["row_to_image"] = out["row_to_image"] - 2 * rank
    return out


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(root):
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, WORKER, root], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
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
    logs = [p.stdout.read() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return logs


def port_grads(params, batch):
    from llmseg_tpu_torch.models import llmseg as tllmseg
    from llmseg_tpu_torch.train import optim
    from test_torch_loss_fn import TLORA, port_model

    model = port_model(params)
    trainable = optim.partition(model)
    loss, _ = tllmseg.loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()},
                              lora_cfg=TLORA, remat="dots")
    loss.backward()
    return {n: p.grad.numpy() for n, p in trainable.items()}


def _rel(got, ref):
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp")
    params = jittered_params()
    batches = [_batch(20), _batch(21)]
    with open(root / "inputs.pkl", "wb") as f:
        pickle.dump({"params": params, "train": TRAIN,
                     "shards": [[_shard(b, r) for b in batches] for r in range(2)]}, f)
    t0 = time.time()
    logs = _run_workers(str(root))
    seconds = time.time() - t0
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(2)]

    # JAX: gradients of the whole batch at the starting weights of each
    # step, and its Trainer's two steps on the data=2 mesh
    cfg = JC.ExperimentConfig(model=JC.llmseg_tiny(), train=JC.TrainConfig(
        **TRAIN, mesh=JC.MeshConfig(data=2), lora=JLORA, log_dir=str(root / "jax")))
    trainer = JTrainer(cfg, lora_cfg=JLORA, params=params)
    jgrads = []

    def grad_of(p, b):
        return jax.grad(lambda q: jllmseg.loss_fn(q, JC.llmseg_tiny(), b, lora_cfg=JLORA)[0])(p)

    jmetrics = None
    for i, b in enumerate(batches):
        g = grad_of(trainer.params, b)
        jgrads.append(flatten(jax.tree.map(np.asarray, g)))
        m = trainer.train_epoch([b], epoch=i)
        jmetrics = m if jmetrics is None else {k: (jmetrics[k] + m[k]) / 2 for k in m}
    # the port in one process on each whole batch, from the same weights as
    # the workers' steps (the first step's; the second's from JAX's step 1)
    tgrads = [port_grads(params, batches[0])]
    return dict(root=root, ranks=ranks, logs=logs, seconds=seconds, jgrads=jgrads,
                tgrads=tgrads,
                jparams=flatten_paths(jax.tree.map(np.asarray, trainer.trainable)),
                jmetrics=jmetrics, start=flatten(params))


def test_gradients_and_parameters_match_jax(run):
    r0, r1 = run["ranks"]
    print(f"two-process gloo run: {run['seconds']:.1f} s")
    for step in range(2):
        assert set(r0["grads"][step]) <= set(run["jgrads"][step])
        for name, g in r0["grads"][step].items():
            assert torch.equal(g, r1["grads"][step][name]), name
            np.testing.assert_allclose(g.numpy(), run["jgrads"][step][name], atol=1e-4,
                                       rtol=1e-4, err_msg=f"{step} {name}")
            if step == 0 and not name.endswith(".k.bias"):    # k.bias: zero up to rounding
                assert _rel(g.numpy(), run["tgrads"][0][name]) <= 1e-5, name
    for name, p in r0["params"].items():
        assert torch.equal(p, r1["params"][name]), name
        if name.startswith("select.") and name.endswith(".k.bias"):
            assert np.abs(p.numpy() - run["start"][name]).max() <= 2 * 2 * TRAIN["lr"], name
        else:
            assert _rel(p.numpy(), run["jparams"][name]) <= 1e-5, name
    for k in TERMS:
        np.testing.assert_allclose(r0["metrics"][k], run["jmetrics"][k], rtol=1e-5, atol=1e-6)
        assert r0["metrics"][k] == r1["metrics"][k]


def test_the_ranks_counts_differ():
    """The split is the one the normaliser matters for."""
    b = _batch(20)
    counts = [(_shard(b, r)["labels"][:, 1:] != -100).sum() for r in range(2)]
    imgs = [len(set(_shard(b, r)["row_to_image"][_shard(b, r)["row_valid"]])) for r in range(2)]
    assert counts[0] != counts[1] and imgs == [2, 1]


def test_meters_loader_and_writes(run):
    r0, r1 = run["ranks"]
    # rank 0 adds [0, 0] once; rank 1 adds [0, 0] and [1, 2], each with n=2
    for r in (r0, r1):
        s, count, avg = r["meter"]
        np.testing.assert_array_equal(s, [2.0, 4.0])
        assert count == 5 and np.allclose(avg, [0.4, 0.8])
        assert r["scalar"] == (0.25 * 3 + 0.5 * 3, 6.0)
        assert r["batch_size"] == 2
    assert not set(r0["indices"]) & set(r1["indices"])
    assert set(r0["indices"]) | set(r1["indices"]) <= set(range(11))
    assert r0["indices"] == [0, 2, 4, 6, 8, 10] and r1["indices"] == [1, 3, 5, 7, 9, 1]
    assert r0["saved"] and r1["saved"]
    assert os.path.exists(run["root"] / "log0" / "best_meta.json")
    assert not os.path.exists(run["root"] / "log1")  or not os.listdir(run["root"] / "log1")
    assert "Epoch: [0]" in r0["stdout"] and r1["stdout"] == ""
    for r in (r0, r1):
        assert "data=3, fsdp=1, tp=1: dp x fsdp x tp must be the world size 2" in r["refused"]
    assert all("multihost: process" in log for log in run["logs"])


def test_sharded_axes_are_refused():
    """Outside a process group the world is one process: a mesh of two
    devices on any axis does not fit it and raises ``ValueError`` naming
    the world size (inside a group of two, fsdp and tp run:
    ``tests/test_torch_mesh.py``)."""
    for mesh in (TC.MeshConfig(fsdp=2), TC.MeshConfig(tensor=2), TC.MeshConfig(data=2)):
        with pytest.raises(ValueError, match="must be the world size 1"):
            TC.TrainConfig(mesh=mesh)
