"""Data parallelism, the dp axis of the JAX package's ``parallel/mesh.py``:
one process per device, each on its own shard of the global batch.

Start-up (:func:`init_from_env`) reads ``torchrun``'s environment (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), as the JAX CLI's
``--multihost`` calls ``jax.distributed.initialize()``: nccl on the card
(``cuda:LOCAL_RANK``), gloo on the CPU.

The JAX package computes one program over the global batch, so its loss
divides by global counts: the cross entropy by the valid targets of the
whole batch, the alignment and regression terms by its images with a valid
row.  Here each process sums its own rows' terms and divides by those
global counts (:func:`global_sum` of the local counts, in the loss), so
each process's loss is its share of the global one; :func:`all_reduce_grads`
then sums the trainable gradients over the processes (one all-reduce of a
flat buffer per dtype, after backward), and the sum is the gradient of the
global loss on every process, equal counts per rank or not.  One
all-reduce after backward, rather than ``DistributedDataParallel``: the
loss is a function of the model's parts (``llmseg.loss_fn``), not one
module's ``forward`` for DDP's wrapper to hook, the layers are
recomputed under remat, and the gradient is wanted as a sum, not DDP's
mean.  Outside a process group every function here is the identity.

Only the dp axis exists: ``fsdp`` and ``tp`` above 1 are refused
(:func:`check_mesh`).
"""

from __future__ import annotations

import datetime
import os
from typing import Iterable

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=600)
SHARDED_AXES = "ROADMAP queue 1 item 19: FSDP2 and tensor parallelism"


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def init_from_env(device: str = "cuda", timeout: datetime.timedelta = TIMEOUT
                  ) -> torch.device:
    """Join the process group ``torchrun`` describes in the environment and
    return this process's device: ``cuda:LOCAL_RANK`` (nccl) for a CUDA
    ``device``, the CPU (gloo) otherwise."""
    from llmseg_tpu_torch.device import require

    dev = require(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not active():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://", timeout=timeout,
                                **({"device_id": dev} if dev.type == "cuda" else {}))
    print(f"multihost: process {rank()}/{world_size()}, device {dev}", flush=True)
    return dev


def check_mesh(data: int, fsdp: int, tensor: int) -> None:
    """The mesh a run asks for: ``data`` -1 or the world size; ``fsdp`` and
    ``tensor`` 1."""
    if fsdp != 1 or tensor != 1:
        raise NotImplementedError(
            f"mesh fsdp={fsdp}, tp={tensor}: the port has only the data axis; "
            f"sharded parameters are {SHARDED_AXES}")
    if data not in (-1, world_size()):
        raise ValueError(f"mesh data={data}: must be -1 or the world size {world_size()} "
                         "(one device a process)")


def collective_device() -> torch.device:
    """Where a host value goes for a collective: the current card under
    nccl, the CPU under gloo."""
    if active() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the processes, without gradient (a count)."""
    if not active():
        return x
    y = x.detach().clone()
    dist.all_reduce(y)
    return y


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Sum every parameter's gradient over the processes, in place; a
    parameter without one takes part with zeros (and keeps the sum)."""
    if not active():
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    for dtype in sorted({p.grad.dtype for p in params}, key=str):
        grads = [p.grad for p in params if p.grad.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

