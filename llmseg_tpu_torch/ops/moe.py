"""The MoE block's combine: each token's k routed expert rows, weighted in
float32 and summed, plus the shared experts' row, rounded once to the
model's dtype (the port's own: the JAX package has no routed experts).

The routed experts leave their down products' rows in expert order
(:class:`Routed`); :func:`combine` reads them back per token through the
inverse of the sort's order, one scatter on the device and no sync.  On
the card it is one launch of ``csrc/moe_combine.cu`` (:func:`moe_combine`,
which raises on what the kernel does not take); on the CPU its plain
version, :func:`combine_plain`, the same arithmetic in the same order, so
that the two agree bit for bit on the card."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from llmseg_tpu_torch.ops.kernels import Kernel

MOE_COMBINE = Kernel("moe_combine")   # csrc/moe_combine.cu
MAX_K = 8                             # experts a token the kernel takes
VEC = 8                               # d a multiple of this: 16-byte rows in bf16


class Routed(NamedTuple):
    """The routed experts' output before the combine: ``y`` (N k, d), the
    down products' rows in expert order; ``order`` (N k,) int64, the pair
    t k + i (token t, its i-th expert) of each row; ``w`` (N, k) float32,
    the pairs' weights."""
    y: torch.Tensor
    order: torch.Tensor
    w: torch.Tensor


def inverse(order: torch.Tensor) -> torch.Tensor:
    """The inverse of a permutation of 0..P-1, on its device: ``inv[order[j]]
    = j``, one scatter."""
    ramp = torch.arange(order.numel(), dtype=order.dtype, device=order.device)
    return torch.empty_like(order).scatter_(0, order, ramp)


def combine_plain(y: torch.Tensor, inv: torch.Tensor, w: torch.Tensor,
                  shared: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function: out[t] = sum_i float(y[inv[t k + i]]) w[t, i]
    (+ float(shared[t])) in y's dtype, the products and sums in float32, in
    order i = 0..k-1 from the first product, the shared row last."""
    N, k = w.shape
    rows = y.index_select(0, inv).view(N, k, -1)
    acc = rows[:, 0].float() * w[:, :1]
    for i in range(1, k):
        acc = acc + rows[:, i].float() * w[:, i:i + 1]
    if shared is not None:
        acc = acc + shared.float()
    return acc.to(y.dtype)


def moe_combine(y: torch.Tensor, inv: torch.Tensor, w: torch.Tensor,
                shared: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`combine_plain` on CUDA tensors, one launch of
    ``csrc/moe_combine.cu`` on the current stream.  Takes y (N k, d) and
    shared (N, d) contiguous in bf16 or float32, d a multiple of 8, rows
    16-byte aligned; inv (N k,) int64; w (N, k) float32 with 1 <= k <= 8;
    raises on anything else."""
    N, k = w.shape
    d = y.shape[-1]
    tensors = (y, inv, w) if shared is None else (y, inv, w, shared)
    problems = [
        (y.dtype not in (torch.bfloat16, torch.float32), f"y is {y.dtype}"),
        (not 1 <= k <= MAX_K, f"k = {k} (1 to {MAX_K})"),
        (y.dim() != 2 or y.shape[0] != N * k, f"y {tuple(y.shape)} for w {tuple(w.shape)}"),
        (d % VEC != 0, f"d = {d} (a multiple of {VEC})"),
        (inv.dtype != torch.int64 or inv.shape != (N * k,), f"inv {inv.dtype} {tuple(inv.shape)}"),
        (w.dtype != torch.float32, f"w is {w.dtype}"),
        (shared is not None and (shared.dtype != y.dtype or shared.shape != (N, d)),
         "shared is not (N, d) in y's dtype"),
        (any(not t.is_cuda or t.device != y.device for t in tensors), "not all on one card"),
        (any(not t.is_contiguous() for t in tensors), "not contiguous"),
        (any(t.data_ptr() % 16 for t in (y, shared) if t is not None), "rows not 16-byte aligned"),
        (N * d >= 2 ** 31, f"N d = {N * d} (below 2^31)")]
    bad = [why for fault, why in problems if fault]
    if bad:
        raise ValueError("moe_combine does not take: " + "; ".join(bad))
    out = torch.empty(N, d, dtype=y.dtype, device=y.device)
    if N:
        MOE_COMBINE.launch(y.data_ptr(), inv.data_ptr(), w.data_ptr(),
                           None if shared is None else shared.data_ptr(), out.data_ptr(),
                           N, k, d, int(y.dtype == torch.float32))
    return out


def combine(routed: Routed, shared: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each token's weighted sum of its k expert rows plus ``shared`` (N, d)
    where given, in y's dtype, rounded once: the kernel on the card, the
    plain version on the CPU."""
    y, order, w = routed
    fn = moe_combine if y.is_cuda else combine_plain
    return fn(y, inverse(order), w, shared)
