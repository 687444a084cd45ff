"""One process of ``tests/test_torch_ddp.py``'s two-process data-parallel
run on the CPU (gloo): ``python tests/torch_ddp_worker.py <dir>`` with
``torchrun``'s environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT).  It reads ``<dir>/inputs.pt`` (the JAX parameter tree as
numpy, this rank's batch shards, the train config's fields), trains the
port's ``Trainer`` through the DDP path, and writes what the test checks
to ``<dir>/rank<r>.pt``.  It imports the port and torch only."""

import contextlib
import datetime
import io
import os
import pickle
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from llmseg_tpu_torch import config as C  # noqa: E402
from llmseg_tpu_torch.import_weights.from_jax import load_  # noqa: E402
from llmseg_tpu_torch.models import llmseg  # noqa: E402
from llmseg_tpu_torch.parallel import ddp  # noqa: E402
from llmseg_tpu_torch.train.trainer import Trainer  # noqa: E402
from llmseg_tpu_torch.utils.metrics import AverageMeter  # noqa: E402


class _Range:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i


def main(root: str) -> None:
    torch.set_num_threads(1)
    ddp.init_from_env("cpu", timeout=datetime.timedelta(seconds=60))
    rank, world = ddp.rank(), ddp.world_size()
    with open(os.path.join(root, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    lora = C.LoraConfig(rank=2)
    tcfg = C.TrainConfig(**inputs["train"], mesh=C.MeshConfig(data=world), lora=lora,
                         log_dir=os.path.join(root, f"log{rank}"))
    cfg = C.ExperimentConfig(model=C.llmseg_tiny(), train=tcfg)
    model = load_(llmseg.build(C.llmseg_tiny(), device="cpu", lora_cfg=lora), inputs["params"])
    trainer = Trainer(cfg, lora_cfg=lora, model=model, device="cpu")

    grads = []
    step = trainer.opt.step

    def recording_step(norm=None):
        grads.append({n: p.grad.detach().clone() for n, p in trainer.trainable.items()})
        return step(norm)

    trainer.opt.step = recording_step
    shards = [{k: torch.from_numpy(v) for k, v in b.items()} for b in inputs["shards"][rank]]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        metrics = trainer.train_epoch(shards, epoch=0)

    meter = AverageMeter("m")
    for v in range(rank + 1):                       # rank 0: 0; rank 1: 0, 1
        meter.update(np.array([v, 2.0 * v]), n=1 + rank)
    meter.all_reduce()
    scalar = AverageMeter("s")
    scalar.update(0.25 * (rank + 1), n=3)
    scalar.all_reduce()

    loader = trainer.batch_loader(_Range(11), lambda s: list(s), steps=3, num_threads=1)
    indices = [i for batch in loader.epoch(0) for i in batch]
    saved = trainer.save_best({"giou": 0.5})

    try:
        C.TrainConfig(mesh=C.MeshConfig(data=3))
        refused = None
    except ValueError as e:
        refused = str(e)

    torch.save({"grads": grads, "metrics": metrics, "stdout": out.getvalue(),
                "params": {n: p.detach().clone() for n, p in trainer.trainable.items()},
                "meter": (meter.sum, meter.count, meter.avg),
                "scalar": (scalar.sum, scalar.count), "indices": indices, "saved": saved,
                "refused": refused, "batch_size": trainer.cfg.train.batch_size // world},
               os.path.join(root, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
