"""Plain PyTorch pieces shared by the references: float32 arithmetic on
weights handed over as a dict, with one switch of precision.

``Prec("fp32")`` is the reference: every product in float32, TF32 off.
``Prec("fp8")`` is the control: the inputs of every linear layer (the
activation per row, the weight per output channel) rounded to float8 e4m3
with an absmax scale, then multiplied in float32.  It is the step below the
bfloat16 that the configurations state, the one a later change might take.

Nothing here imports the program under test.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

PRECISIONS = ("fp32", "fp8")
E4M3_MAX = 448.0


def no_tf32() -> None:
    """Float32 products in full float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one absmax scale per row (last axis)."""
    scale = x.abs().amax(-1, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Prec:
    def __init__(self, name: str):
        if name not in PRECISIONS:
            raise ValueError(f"precision {name!r} not in {PRECISIONS}")
        self.name = name

    def linear(self, x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
        x, w = x.float(), w.float()
        if self.name == "fp8":
            x, w = round_fp8(x), round_fp8(w)
        return F.linear(x, w, None if b is None else b.float())


class Weights:
    """Read-only view of a {name: tensor} dict that hands out float32."""

    def __init__(self, tensors: dict, prefix: str = ""):
        self.t = tensors
        self.prefix = prefix

    def __call__(self, name: str) -> torch.Tensor:
        return self.t[self.prefix + name].float()

    def has(self, name: str) -> bool:
        return self.prefix + name in self.t

    def sub(self, prefix: str) -> "Weights":
        return Weights(self.t, self.prefix + prefix)


def layer_norm(x, W: Weights, name: str, eps: float):
    return F.layer_norm(x.float(), x.shape[-1:], W(name + ".weight"), W(name + ".bias"), eps)


def rms_norm(x, W: Weights, name: str, eps: float):
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * W(name + ".weight")


def dense(x, W: Weights, name: str, P: Prec, bias: bool = True):
    return P.linear(x, W(name + ".weight"), W(name + ".bias") if bias else None)


ACTS = {
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "gelu": F.gelu,
    "relu": torch.relu,
    "silu": F.silu,
}


def attend(q, k, v, *, causal: bool = False, bias=None, key_mask=None, rows: int = 1024):
    """Softmax attention in float32.  q (B, T, H, D), k/v (B, S, H, D);
    ``bias(b, t0, t1)`` gives an additive (H, t1 - t0, S) term; key_mask
    (B, S) True = valid.  Query rows go ``rows`` at a time, one batch entry
    at a time, so that the (H, rows, S) logits stay small."""
    B, T, H, D = q.shape
    S = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    if bias is None and B * H * T * S <= 2 ** 27:      # small enough for one product
        s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
        if key_mask is not None:
            s = s.masked_fill(~key_mask[:, None, None, :], -1e9)
        if causal:
            s = s.masked_fill(torch.ones(T, S, dtype=torch.bool, device=q.device).triu(1),
                              float("-inf"))
        return torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1), v.float())
    out = torch.empty(B, T, H, D, dtype=torch.float32, device=q.device)
    for b in range(B):
        kb = k[b].float().transpose(0, 1)                  # (H, S, D)
        vb = v[b].float().transpose(0, 1)
        for t0 in range(0, T, rows):
            t1 = min(T, t0 + rows)
            qb = q[b, t0:t1].float().transpose(0, 1)       # (H, t, D)
            s = torch.matmul(qb, kb.transpose(1, 2)) * scale
            if bias is not None:
                s = s + bias(b, t0, t1)
            if key_mask is not None:
                s = s.masked_fill(~key_mask[b][None, None, :], -1e9)
            if causal:
                i = torch.arange(t0, t1, device=q.device)[:, None]
                j = torch.arange(S, device=q.device)[None, :]
                s = s.masked_fill(j > i, float("-inf"))
            out[b, t0:t1] = torch.matmul(torch.softmax(s, -1), vb).transpose(0, 1)
    return out


def bilinear_matrix(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_out, n_in) bilinear weights with half-pixel centres, for an
    upsample (n_out >= n_in): a triangle of width one input pixel, the rows
    at the edges renormalised to sum to one."""
    if n_out < n_in:
        raise ValueError("upsample only")
    x = (torch.arange(n_out, dtype=torch.float64) + 0.5) * (n_in / n_out) - 0.5
    i = torch.arange(n_in, dtype=torch.float64)
    w = (1.0 - (x[:, None] - i[None, :]).abs()).clamp_min(0.0)
    return (w / w.sum(-1, keepdim=True)).float().to(device)


def patchify(images: torch.Tensor, p: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/p * W/p, C*p*p), each patch ordered (c, y, x)
    as a convolution's OIHW weight flattens."""
    B, H, W, C = images.shape
    x = images.float().reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(B, (H // p) * (W // p), C * p * p)
