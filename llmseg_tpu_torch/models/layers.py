"""Neural-net building blocks, the counterpart of ``llmseg_tpu.models.layers``.

Modules keep PyTorch's layouts (``nn.Linear.weight`` is ``(out, in)``, the
patch convolution is OIHW); the functions keep the JAX package's tensor
layouts at their boundary (tokens ``(B, T, C)``, images ``(B, H, W, C)``,
heads ``(B, T, H, D)``).  Norm statistics are float32 whatever the input
type, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm(nn.Module):
    """``layers.layernorm``: float32 statistics, result cast back."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device=None,
                 dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


class RMSNorm(nn.Module):
    """``layers.rmsnorm``: float32 statistics, result cast back."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device=None,
                 dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (y * self.weight.float()).to(x.dtype)


class _QuantLinear(nn.Module):
    """A quantized ``nn.Linear`` (``layers.dense``'s quantized branch): the
    weight in (out, in) as ``nn.Linear`` keeps it, its scales and the
    optional bias held as buffers, since a quantized base is frozen.  The
    forward is ``ops.quant.qdense``."""

    def __init__(self, names, weight: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer(names[0], weight)
        self.register_buffer(names[1], scale)
        self.register_buffer("bias", bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from llmseg_tpu_torch.ops import quant
        return quant.qdense(self, x)


class Int8Linear(_QuantLinear):
    """Weight-only int8: ``w_q`` (out, in) int8, ``w_scale`` (out,) float32."""

    def __init__(self, w_q, w_scale, bias=None):
        super().__init__(("w_q", "w_scale"), w_q, w_scale, bias)


class W8A8Linear(_QuantLinear):
    """W8A8: ``w_q8a`` (out, in) int8, ``w_scale`` (out,) float32; the
    activations are quantized per row at apply time."""

    def __init__(self, w_q8a, w_scale, bias=None):
        super().__init__(("w_q8a", "w_scale"), w_q8a, w_scale, bias)


class Int4Linear(_QuantLinear):
    """int4: ``w_q4`` (out, padded_in / 2) int8, two nibbles a byte along
    ``in`` (the low one first), ``w_scale4`` (out, n_groups) float32, one
    scale per group of 128 inputs."""

    def __init__(self, w_q4, w_scale4, bias=None):
        super().__init__(("w_q4", "w_scale4"), w_q4, w_scale4, bias)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class MLP(nn.Module):
    """``layers.mlp``: fc1 -> act -> fc2; the default act is tanh-GELU."""

    def __init__(self, dim: int, hidden: int, out_dim: Optional[int] = None,
                 act: Callable = gelu_tanh, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.fc1 = nn.Linear(dim, hidden, **kw)
        self.fc2 = nn.Linear(hidden, dim if out_dim is None else out_dim, **kw)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class MLPStack(nn.Module):
    """``layers.mlp_stack``: N linears with ReLU between them."""

    def __init__(self, dims: Sequence[int], final_act: Optional[Callable] = None,
                 *, device=None, dtype=None):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1], device=device, dtype=dtype)
            for i in range(len(dims) - 1))
        self.final_act = final_act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.layers)
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < n - 1:
                x = torch.relu(x)
        if self.final_act is not None:
            x = self.final_act(x)
        return x


class PatchEmbed(nn.Module):
    """``layers.patch_embed``: non-overlapping patch convolution,
    (B, H, W, C) -> (B, H/p, W/p, dim).  The weight is OIHW."""

    def __init__(self, patch: int, in_ch: int, dim: int, bias: bool = True,
                 *, device=None, dtype=None):
        super().__init__()
        self.patch = patch
        self.weight = nn.Parameter(torch.empty(dim, in_ch, patch, patch,
                                               device=device, dtype=dtype))
        self.bias = (nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias,
                     stride=self.patch)
        return y.permute(0, 2, 3, 1)


class Conv2d(nn.Module):
    """``layers.conv2d``: NHWC in and out; the weight is OIHW (the bridge
    transposes the JAX package's HWIO kernel).  ``padding`` is "SAME" (stride
    1, odd kernel) or "VALID"."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, bias: bool = True,
                 *, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel,
                                               device=device, dtype=dtype))
        self.bias = (nn.Parameter(torch.zeros(out_ch, device=device, dtype=dtype))
                     if bias else None)

    def forward(self, x: torch.Tensor, stride: int = 1,
                padding: str = "SAME") -> torch.Tensor:
        if padding == "SAME":
            if stride != 1 or self.weight.shape[-1] % 2 == 0:
                raise ValueError("SAME padding needs stride 1 and an odd kernel")
            pad = self.weight.shape[-1] // 2
        elif padding == "VALID":
            pad = 0
        else:
            raise ValueError(f"padding {padding!r}")
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias,
                     stride=stride, padding=pad)
        return y.permute(0, 2, 3, 1)


# ``layers.layernorm2d``: LayerNorm over the channels of an NHWC map
LayerNorm2d = LayerNorm


class PositionEmbeddingRandom(nn.Module):
    """``layers.position_embedding_random``: random Fourier features of
    coordinates in [0, 1]; the (2, F) ``gaussian`` leaf keeps its name."""

    def __init__(self, num_pos_feats: int = 64, *, device=None, dtype=None):
        super().__init__()
        self.gaussian = nn.Parameter(torch.empty(2, num_pos_feats, device=device,
                                                 dtype=dtype))

    def forward(self, coords: torch.Tensor) -> torch.Tensor:
        """(..., 2) -> (..., 2F) float32."""
        c = 2.0 * coords.float() - 1.0
        c = 2.0 * math.pi * (c @ self.gaussian.float())
        return torch.cat([torch.sin(c), torch.cos(c)], -1)


def position_grid(pe: PositionEmbeddingRandom, size: int) -> torch.Tensor:
    """``layers.position_grid``: (size, size, 2F) over cell centres, x fastest."""
    t = (torch.arange(size, dtype=torch.float32, device=pe.gaussian.device) + 0.5) / size
    y, x = torch.meshgrid(t, t, indexing="ij")
    return pe(torch.stack([x, y], -1))


def rope_frequencies(head_dim: int, max_len: int, theta: float = 10000.0,
                     device=None):
    """float32 (cos, sin), each (max_len, head_dim / 2)."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, T, H, D), HF-LLaMA half rotation: rotate_half(x) = [-x2, x1]."""
    T = x.shape[1]
    if positions is None:
        c, s = cos[:T][None, :, None, :], sin[:T][None, :, None, :]
    else:
        c, s = cos[positions][:, :, None, :], sin[positions][:, :, None, :]
    c = torch.cat([c, c], -1)
    s = torch.cat([s, s], -1)
    x1, x2 = x.chunk(2, dim=-1)
    rotated = torch.cat([-x2, x1], -1)
    return (x.float() * c + rotated.float() * s).to(x.dtype)
