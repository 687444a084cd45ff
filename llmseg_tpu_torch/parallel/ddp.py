"""The process group and data parallelism: one process per device, each on
its own shard of the global batch.  ``parallel/mesh.py`` lays the (dp,
fsdp, tp) mesh over this group; its data axes (dp x fsdp) are the ones this
module's sums run over.

Start-up (:func:`init_from_env`) reads ``torchrun``'s environment (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), as the JAX CLI's
``--multihost`` calls ``jax.distributed.initialize()``: nccl on the card
(``cuda:LOCAL_RANK``), gloo on the CPU, or the backend the caller names.

The JAX package computes one program over the global batch, so its loss
divides by global counts: the cross entropy by the valid targets of the
whole batch, the alignment and regression terms by its images with a valid
row.  Here each process sums its own rows' terms and divides by those
global counts (:func:`global_sum` of the local counts over the data group, in the loss),
so each process's loss is its share of the global one;
:func:`all_reduce_grads` then sums the trainable gradients over the data
group (one all-reduce of a flat buffer per dtype, after backward), and the
sum is the gradient of the global loss on every process, equal counts per
rank or not.  The tp ranks of one data rank see the same rows, so a sum
over the world would count them tp times: with tp or fsdp above 1 the
callers pass the mesh's data group (``mesh.Mesh.data``).  One
all-reduce after backward, rather than ``DistributedDataParallel``: the
loss is a function of the model's parts (``llmseg.loss_fn``), not one
module's ``forward`` for DDP's wrapper to hook, the layers are
recomputed under remat, and the gradient is wanted as a sum, not DDP's
mean.  Outside a process group every function here is the identity.
"""

from __future__ import annotations

import datetime
import os
from typing import Iterable, Optional

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=600)


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def init_from_env(device: str = "cuda", timeout: datetime.timedelta = TIMEOUT,
                  backend: Optional[str] = None) -> torch.device:
    """Join the process group ``torchrun`` describes in the environment and
    return this process's device: ``cuda:LOCAL_RANK`` (nccl unless
    ``backend`` says otherwise) for a CUDA ``device``, the CPU (gloo)
    otherwise.  Two ranks on one card need gloo: nccl refuses them."""
    from llmseg_tpu_torch.device import require

    dev = require(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not active():
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        dist.init_process_group(backend, init_method="env://", timeout=timeout,
                                **({"device_id": dev} if backend == "nccl" else {}))
    print(f"multihost: process {rank()}/{world_size()}, device {dev}", flush=True)
    return dev


def check_mesh(data: int, fsdp: int, tensor: int) -> None:
    """The mesh a run asks for: dp x fsdp x tp must be the world size
    (``data`` -1 takes what fsdp and tp leave); ``ValueError`` otherwise."""
    from llmseg_tpu_torch.parallel.mesh import mesh_shape

    mesh_shape(data, fsdp, tensor, world_size())


def collective_device() -> torch.device:
    """Where a host value goes for a collective: the current card under
    nccl, the CPU under gloo."""
    if active() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (the world when None), without
    gradient (a count)."""
    if not active():
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=group)
    return y


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.nn.Parameter], group=None) -> None:
    """Sum every parameter's gradient over ``group`` (the world when None),
    in place; a parameter without one takes part with zeros (and keeps the
    sum)."""
    if not active():
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    for dtype in sorted({p.grad.dtype for p in params}, key=str):
        grads = [p.grad for p in params if p.grad.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

