"""Weight-only int8 / int4 and W8A8 quantization, the counterpart of
``llmseg_tpu.ops.quant``, with the port's kernels Q1 and Q2 around the int8
products.

A quantized leaf is a module of ``models.layers`` (``Int8Linear``,
``W8A8Linear``, ``Int4Linear``) in place of an ``nn.Linear``; its weight is
(out, in), as ``nn.Linear`` keeps it, so ``w.t()`` is the column-major
operand of the int8 product.

* int8: symmetric per-output-channel scales, dequantized after a product
  with float32 accumulation and a float32 result.
* int4: symmetric per-(group of 128 inputs, output channel) scales, two
  nibbles packed per byte along the input, unpacked and dequantized in the
  activations' type before the product.
* W8A8: activations quantized per row (:func:`quantize_activation`, or
  :func:`rms_quantize_activation` with the RMSNorm folded in), then an
  s8 x s8 -> s32 product rescaled by the outer product of the scales
  (:func:`qdense_act`).  SmoothQuant's static fold
  (:func:`fold_smooth_llama_inplace`) runs on the bf16 model before it is
  quantized.

Kernels, each with its plain version beside it: :func:`quantize_rows` (Q1,
``csrc/quant.cu``, the per-row quantization of both activation forms) and
:func:`w8a8_linear` (Q2, ``csrc/w8a8_gemm.cu``, the int8 product on
``wgmma`` with the rescale applied to its accumulators in registers).

On a mesh with tp above 1 (``parallel/mesh.py``) the row-split W8A8
products (o, down) see this rank's block of the input: Q1's two split
forms, :func:`row_absmax` (the rows' max |x|) and
:func:`quantize_rows_scaled` (the int8 values for a row scale the caller
gives: the max over tp's, which every rank then shares), Q2's int32 form
:func:`w8a8_int_mm` (the product of this rank's K block, summed over tp in
int32), then :func:`w8a8_epilogue` (the rescale alone, ``csrc/quant.cu``)
after that sum (:func:`qdense_rows`).  The result equals one process's
W8A8 product to the bit.

A CUDA tensor launches the kernel or raises; only a tensor on the CPU
takes the plain version.  Q1 and Q2 are custom ops (``torch.ops.llmseg.
quantize_rows``, ``w8a8_linear``; ``ops.kernels.kernel_op``), so that an
exported W8A8 ``predict`` holds them as nodes that launch the kernels.
Weight-only int8 and int4 are plain PyTorch on every device, as they are
XLA code in the JAX package.
"""

from __future__ import annotations

import copy
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from llmseg_tpu_torch.config import require_ported
from llmseg_tpu_torch.models import layers as L
from llmseg_tpu_torch.ops.kernels import Kernel, kernel_op
from llmseg_tpu_torch.parallel import mesh as M

# The JAX package's knobs, same names and defaults (llmseg_tpu/ops/quant.py):
# the opt-in LLM.int8-style outlier decomposition (K columns a product kept
# out of the int8 operand), SmoothQuant's migration strength for W8A8, and
# the weaker AWQ-style strength of the same fold for weight-only int4.
W8A8_OUTLIER_K = int(os.environ.get("LLMSEG_W8A8_OUTLIER_K", "0"))
W8A8_SMOOTH_ALPHA = float(os.environ.get("LLMSEG_W8A8_SMOOTH_ALPHA", "0.5"))
W4_SMOOTH_ALPHA = float(os.environ.get("LLMSEG_W4_SMOOTH_ALPHA", "0.25"))

QUANTIZE_ROWS = Kernel("quantize_rows", source="quant")      # Q1, csrc/quant.cu
W8A8_LINEAR = Kernel("w8a8_linear", source="w8a8_gemm")      # Q2, csrc/w8a8_gemm.cu
KERNELS = (QUANTIZE_ROWS, W8A8_LINEAR)      # the W8A8 path's
W8A8_EPILOGUE = Kernel("w8a8_epilogue", source="quant")      # the rescale alone
ROW_ABSMAX = Kernel("row_absmax", source="quant")            # Q1's form (a)
QUANTIZE_ROWS_SCALED = Kernel("quantize_rows_scaled", source="quant")   # Q1's form (b)
W8A8_INT32 = Kernel("w8a8_int32", source="w8a8_gemm")       # Q2's int32 output
# the row split's on a mesh with tp above 1 (qdense_rows)
MESH_KERNELS = (ROW_ABSMAX, QUANTIZE_ROWS_SCALED, W8A8_INT32, W8A8_EPILOGUE)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}   # csrc/quant.cu, w8a8_gemm.cu
_INT32_CODE = 2                                         # w8a8_gemm.cu's int32 output
_INT_MM_MIN_ROWS = 17    # torch._int_mm on CUDA takes more than 16 rows
W8A8_MAX_K = 133144      # |acc| <= K * 127^2 stays inside int32
_HAS_MM_OUT_DTYPE = hasattr(torch.ops.aten.mm, "dtype")


def _div(num, den) -> torch.Tensor:
    """num / den rounded once, as XLA divides.  A Python number is made a
    tensor first: PyTorch's CUDA division by a number multiplies by its
    reciprocal, and a number over a tensor is the tensor's reciprocal times
    the number, each two roundings."""
    if not torch.is_tensor(num):
        num = torch.full_like(den, num)
    if not torch.is_tensor(den):
        den = torch.full_like(num, den)
    return num / den


# ---------------------------------------------------------------------------
# Kernel Q1: per-row int8 quantization, plain form and RMS form
# ---------------------------------------------------------------------------


def quantize_rows_plain(x: torch.Tensor, gamma: Optional[torch.Tensor] = None,
                        eps: float = 1e-6):
    """Q1's function on (R, C) rows: (xq (R, C) int8, sc (R, 1) float32).

    Without ``gamma``, ``quantize_activation``'s k = 0 arithmetic:
    sc = max(max|x|, 1e-6) / 127, xq = clip(round(x / sc)).  With it,
    ``rms_quantize_activation``'s: t = x * gamma, m = max(max|t|, 1e-6),
    xq = clip(round(t * (127 / m))), sc = m * rsqrt(mean x^2 + eps) / 127.
    Rounding is half to even."""
    xf = x.float()
    if gamma is None:
        sc = _div(xf.abs().amax(-1, keepdim=True).clamp_min(1e-6), 127.0)
        return torch.round(xf / sc).clamp(-127, 127).to(torch.int8), sc
    t = xf * gamma.float()
    m = t.abs().amax(-1, keepdim=True).clamp_min(1e-6)
    ms = xf.square().mean(-1, keepdim=True)
    sc = m * torch.rsqrt(ms + eps) * (1.0 / 127.0)
    return torch.round(t * _div(127.0, m)).clamp(-127, 127).to(torch.int8), sc


def _check_rows_shapes(x, gamma) -> None:
    if x.dim() != 2 or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"expected bf16/float32 rows (R, C), got {tuple(x.shape)} {x.dtype}")
    if gamma is not None and (gamma.shape != (x.shape[1],) or gamma.dtype not in _DTYPE_CODES):
        raise ValueError(f"gamma must be a bf16/float32 ({x.shape[1]},) vector, got "
                         f"{tuple(gamma.shape)} {gamma.dtype}")


def _quantize_rows_fake(x, gamma, eps):
    _check_rows_shapes(x, gamma)
    return (x.new_empty(x.shape, dtype=torch.int8),
            x.new_empty((x.shape[0], 1), dtype=torch.float32))


@kernel_op("quantize_rows", cpu=quantize_rows_plain, fake=_quantize_rows_fake)
def _quantize_rows_op(x: torch.Tensor, gamma: Optional[torch.Tensor],
                      eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel Q1 on the card: checks, then one launch (none for 0 rows)."""
    _check_rows_shapes(x, gamma)
    if not x.is_contiguous():
        raise ValueError(f"expected contiguous CUDA bf16/float32 rows (R, C), got "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    R, C = x.shape
    if gamma is not None and (not gamma.is_cuda or not gamma.is_contiguous()):
        raise ValueError(f"gamma must be a contiguous CUDA bf16/float32 ({C},) vector")
    xq = torch.empty((R, C), dtype=torch.int8, device=x.device)
    sc = torch.empty((R, 1), dtype=torch.float32, device=x.device)
    if R:
        QUANTIZE_ROWS.launch(0, x.data_ptr(), None if gamma is None else gamma.data_ptr(),
                             None, None, None, xq.data_ptr(), sc.data_ptr(), R, C,
                             _DTYPE_CODES[x.dtype],
                             0 if gamma is None else _DTYPE_CODES[gamma.dtype], eps)
    return xq, sc


def quantize_rows(x: torch.Tensor, gamma: Optional[torch.Tensor] = None,
                  eps: float = 1e-6):
    """Kernel Q1 wrapper, the op ``llmseg::quantize_rows``.  Shapes and forms
    as :func:`quantize_rows_plain`; x bf16 or float32, gamma bf16 or
    float32."""
    return _quantize_rows_op(x, gamma, eps)


def row_absmax_plain(x: torch.Tensor) -> torch.Tensor:
    """Q1's form (a) on (R, C) rows: max |x| a row, (R, 1) float32."""
    return x.float().abs().amax(-1, keepdim=True)


def quantize_rows_scaled_plain(x: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
    """Q1's form (b): (R, C) rows and a row scale sc (R, 1) float32 ->
    clip(round(x / sc)) int8, the plain form's values for that scale."""
    return torch.round(_div(x.float(), sc)).clamp(-127, 127).to(torch.int8)


def _check_rows(x: torch.Tensor) -> None:
    if x.dim() != 2 or x.dtype not in _DTYPE_CODES or not x.is_contiguous():
        raise ValueError(f"expected contiguous bf16/float32 rows (R, C), got "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")


def row_absmax(x: torch.Tensor) -> torch.Tensor:
    """Q1's form (a) wrapper (``csrc/quant.cu``, op 2): the rows' max |x|,
    written without quantizing.  Shapes as :func:`row_absmax_plain`."""
    if x.device.type == "cpu":
        return row_absmax_plain(x)
    _check_rows(x)
    R, C = x.shape
    out = torch.empty((R, 1), dtype=torch.float32, device=x.device)
    if R:
        ROW_ABSMAX.launch(2, x.data_ptr(), None, None, None, None, None, out.data_ptr(), R, C,
                          _DTYPE_CODES[x.dtype], 0, 0.0)
    return out


def quantize_rows_scaled(x: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
    """Q1's form (b) wrapper (``csrc/quant.cu``, op 3): the int8 values of
    (R, C) rows for the caller's row scale sc (R, 1) float32, dividing as
    :func:`quantize_rows_scaled_plain` does."""
    if x.device.type == "cpu":
        return quantize_rows_scaled_plain(x, sc)
    _check_rows(x)
    R, C = x.shape
    if sc.shape != (R, 1) or sc.dtype != torch.float32 or not sc.is_cuda \
            or not sc.is_contiguous():
        raise ValueError(f"sc must be a contiguous CUDA float32 ({R}, 1), got "
                         f"{tuple(sc.shape)} {sc.dtype} on {sc.device}")
    xq = torch.empty((R, C), dtype=torch.int8, device=x.device)
    if R:
        QUANTIZE_ROWS_SCALED.launch(3, x.data_ptr(), sc.data_ptr(), None, None, None,
                                    xq.data_ptr(), None, R, C, _DTYPE_CODES[x.dtype], 0, 0.0)
    return xq


# ---------------------------------------------------------------------------
# The W8A8 product: kernel Q2 (the product with its rescale, or its int32
# accumulators), and the rescale alone (after the row split's int32 sum over
# tp; after torch._int_mm, the route Q2 replaced, it is the yardstick)
# ---------------------------------------------------------------------------


def w8a8_epilogue_plain(acc: torch.Tensor, sc: torch.Tensor, w_scale: torch.Tensor,
                        bias: Optional[torch.Tensor], out_dtype: torch.dtype,
                        side: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The rescale of Q2's function: acc (R, N) int32, sc (R, 1), w_scale
    (N,) and side (R, N) float32 -> ((float(acc) * sc) * w_scale + side)
    rounded once to ``out_dtype``, then + bias in ``out_dtype``
    (``qdense_act``'s order)."""
    y = acc.float() * sc * w_scale
    if side is not None:
        y = y + side
    y = y.to(out_dtype)
    if bias is not None:
        y = y + bias
    return y


def w8a8_epilogue(acc: torch.Tensor, sc: torch.Tensor, w_scale: torch.Tensor,
                  bias: Optional[torch.Tensor], out_dtype: torch.dtype,
                  side: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The standalone rescale's wrapper (``csrc/quant.cu``, op 1): on the
    row split's path after the int32 sum over tp (:func:`qdense_rows`).
    Shapes as :func:`w8a8_epilogue_plain`; the output is bf16 or float32,
    the bias (if any) of the output's type."""
    if acc.device.type == "cpu":
        return w8a8_epilogue_plain(acc, sc, w_scale, bias, out_dtype, side)
    if acc.dim() != 2 or acc.dtype != torch.int32 or not acc.is_contiguous():
        raise ValueError(f"acc must be a contiguous int32 (R, N), got {tuple(acc.shape)} "
                         f"{acc.dtype}")
    R, N = acc.shape
    _check_rescale_operands(R, N, sc, w_scale, bias, out_dtype, side)
    out = torch.empty((R, N), dtype=out_dtype, device=acc.device)
    if R:
        W8A8_EPILOGUE.launch(1, acc.data_ptr(), sc.data_ptr(), w_scale.data_ptr(),
                             None if bias is None else bias.data_ptr(),
                             None if side is None else side.data_ptr(), out.data_ptr(), None,
                             R, N, _DTYPE_CODES[out_dtype], 0, 0.0)
    return out


def _check_rescale_operands(R, N, sc, w_scale, bias, out_dtype, side, *, device=True) -> None:
    """Shapes and dtypes of the rescale's operands; with ``device`` also
    that each lies contiguous on the card."""
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"output dtype {out_dtype} is not bf16 or float32")
    checks = ((sc, (R, 1), torch.float32), (w_scale, (N,), torch.float32),
              (bias, (N,), out_dtype), (side, (R, N), torch.float32))
    for t, shape, dtype in checks:
        if t is not None and (t.shape != shape or t.dtype != dtype or device and (
                not t.is_cuda or not t.is_contiguous())):
            raise ValueError(f"expected a contiguous CUDA {dtype} {shape}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def w8a8_linear_plain(xq: torch.Tensor, sc: torch.Tensor, w_q: torch.Tensor,
                      w_scale: torch.Tensor, bias: Optional[torch.Tensor],
                      out_dtype: torch.dtype,
                      side: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Q2's function: xq (R, K) int8 times w_q (N, K) int8, transposed,
    exactly in int32, then :func:`w8a8_epilogue_plain`'s rescale (sc (R, 1),
    w_scale (N,), side (R, N) float32; the bias in ``out_dtype``)."""
    return w8a8_epilogue_plain(_int_mm(xq, w_q), sc, w_scale, bias, out_dtype, side)


def _check_w8a8_shapes(xq, sc, w_q, w_scale, bias, out_dtype, side) -> None:
    """Q2's contract on shapes and dtypes: K a multiple of 16 up to
    ``W8A8_MAX_K``, N a multiple of 8, int8 operands."""
    if xq.dim() != 2 or w_q.dim() != 2 or xq.shape[1] != w_q.shape[1]:
        raise ValueError(f"expected xq (R, K) and w_q (N, K), got {tuple(xq.shape)} and "
                         f"{tuple(w_q.shape)}")
    (R, K), N = xq.shape, w_q.shape[0]
    if K % 16 or N % 8 or K > W8A8_MAX_K:
        raise ValueError(f"the W8A8 product takes K a multiple of 16 up to {W8A8_MAX_K} and "
                         f"N a multiple of 8, got K={K}, N={N}")
    if xq.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise ValueError(f"expected int8 operands, got {xq.dtype} and {w_q.dtype}")
    _check_rescale_operands(R, N, sc, w_scale, bias, out_dtype, side, device=False)


def _w8a8_linear_fake(xq, sc, w_q, w_scale, bias, out_dtype, side):
    _check_w8a8_shapes(xq, sc, w_q, w_scale, bias, out_dtype, side)
    return xq.new_empty((xq.shape[0], w_q.shape[0]), dtype=out_dtype)


@kernel_op("w8a8_linear", cpu=w8a8_linear_plain, fake=_w8a8_linear_fake)
def _w8a8_linear_op(xq: torch.Tensor, sc: torch.Tensor, w_q: torch.Tensor,
                    w_scale: torch.Tensor, bias: Optional[torch.Tensor], out_dtype: torch.dtype,
                    side: Optional[torch.Tensor]) -> torch.Tensor:
    """Kernel Q2 on the card: the contract, the device checks, then one
    launch (none for 0 rows)."""
    _check_w8a8_shapes(xq, sc, w_q, w_scale, bias, out_dtype, side)
    (R, K), N = xq.shape, w_q.shape[0]
    for t in (xq, w_q):
        if not t.is_cuda or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"expected a contiguous, 16-byte aligned CUDA int8 operand, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    _check_rescale_operands(R, N, sc, w_scale, bias, out_dtype, side)
    if any(t is not None and t.data_ptr() % 8 for t in (w_scale, bias, side)):
        raise ValueError("w_scale, bias and side must be 8-byte aligned (read in pairs)")
    out = torch.empty((R, N), dtype=out_dtype, device=xq.device)
    if R:
        W8A8_LINEAR.launch(xq.data_ptr(), w_q.data_ptr(), sc.data_ptr(), w_scale.data_ptr(),
                           None if bias is None else bias.data_ptr(),
                           None if side is None else side.data_ptr(), out.data_ptr(), R, N, K,
                           _DTYPE_CODES[out_dtype])
    return out


def w8a8_linear(xq: torch.Tensor, sc: torch.Tensor, w_q: torch.Tensor,
                w_scale: torch.Tensor, bias: Optional[torch.Tensor], out_dtype: torch.dtype,
                side: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel Q2 wrapper, the op ``llmseg::w8a8_linear``:
    :func:`w8a8_linear_plain`'s function, equal to the bit, in one kernel
    (``csrc/w8a8_gemm.cu``): the int8 product on ``wgmma`` and its rescale
    applied to the accumulators in registers; no int32 tensor is formed.
    Any R; K a multiple of 16 up to ``W8A8_MAX_K`` and N a multiple of 8
    (checked by the fake implementation as the op is traced, and by the
    CUDA one before any launch); the output bf16 or float32."""
    return _w8a8_linear_op(xq, sc, w_q, w_scale, bias, out_dtype, side)


def w8a8_int_mm(xq: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Q2's int32 output (``csrc/w8a8_gemm.cu``, output code 2): xq (R, K)
    int8 times w_q (N, K) int8, transposed, its accumulators stored as
    they are, (R, N) int32, exact.  The contract of :func:`w8a8_linear` (K
    a multiple of 16 up to ``W8A8_MAX_K``, N a multiple of 8); the plain
    version is :func:`_int_mm`."""
    if xq.device.type == "cpu":
        return _int_mm(xq, w_q)
    _check_w8a8_shapes(xq, None, w_q, None, None, torch.float32, None)
    (R, K), N = xq.shape, w_q.shape[0]
    for t in (xq, w_q):
        if not t.is_cuda or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"expected a contiguous, 16-byte aligned CUDA int8 operand, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    out = torch.empty((R, N), dtype=torch.int32, device=xq.device)
    if R:
        W8A8_INT32.launch(xq.data_ptr(), w_q.data_ptr(), None, None, None, None, out.data_ptr(),
                          R, N, K, _INT32_CODE)
    return out


def _int_mm(xq: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """xq (R, K) int8 times w_q (N, K) int8, transposed: (R, N) int32, exact
    (the plain version's product, and the yardstick's).  On CUDA
    ``torch._int_mm`` takes more than 16 rows and K, N multiples of 8: fewer
    rows are padded with zeros."""
    R, K = xq.shape
    if xq.is_cuda:
        N = w_q.shape[0]
        if K % 8 or N % 8:
            raise ValueError(f"the int8 product on CUDA needs K and N multiples of 8, "
                             f"got K={K}, N={N}")
        if R < _INT_MM_MIN_ROWS:
            padded = xq.new_zeros((_INT_MM_MIN_ROWS, K))
            padded[:R] = xq
            return torch._int_mm(padded, w_q.t())[:R]
    return torch._int_mm(xq, w_q.t())


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (R, K) times w (N, K), transposed, with float32 accumulation and a
    float32 result: ``torch.mm(..., out_dtype=torch.float32)`` for a
    low-precision CUDA x where the installed PyTorch has it, else both
    operands cast to float32 (the same products: w's int8 values and x's
    bf16 values are exact in float32)."""
    if x.is_cuda and x.dtype != torch.float32 and _HAS_MM_OUT_DTYPE:
        return torch.mm(x, w.to(x.dtype).t(), out_dtype=torch.float32)
    return x.float() @ w.float().t()


class _Int8MM(torch.autograd.Function):
    """x (R, K) times the int8 weight w_q (N, K), transposed, times the
    column scales: (R, N) float32, :func:`_mm_f32`'s product.  Its
    ``torch.mm`` overload with ``out_dtype``, which the card takes, has no
    derivative in PyTorch, so the backward is written here:
    dx = (dy * w_scale) rounded to x's type, times w_q cast to x's type,
    accumulated in float32 and rounded to x's type.  The int8 weight and
    its scales are frozen buffers and get no gradient.  With ``mesh`` (the
    row split: x and w_q hold this rank's K block) the float32 products are
    summed over tp before the scales, as JAX's partitioned dot sums them;
    the gradient of this rank's block needs no sum."""

    @staticmethod
    def forward(ctx, x, w_q, w_scale, mesh=None):
        ctx.save_for_backward(w_q, w_scale)
        ctx.x_dtype = x.dtype
        y = _mm_f32(x, w_q)
        if mesh is not None:
            y = M.all_reduce(y, mesh.groups["tp"])
        return y * w_scale

    @staticmethod
    def backward(ctx, g):
        w_q, w_scale = ctx.saved_tensors
        gs = (g * w_scale).to(ctx.x_dtype)
        return _mm_f32(gs, w_q.t()).to(ctx.x_dtype), None, None, None


# ---------------------------------------------------------------------------
# Weight quantizers: nn.Linear -> a quantized module
# ---------------------------------------------------------------------------


def _bias(lin: nn.Linear) -> Optional[torch.Tensor]:
    return None if lin.bias is None else lin.bias.detach()


@torch.no_grad()
def quantize_dense(lin: nn.Linear) -> L.Int8Linear:
    """Weight-only int8 with symmetric per-output-channel scales."""
    w = lin.weight.detach().float()
    scale = _div(w.abs().amax(1), 127.0).clamp_min(1e-8)
    q = torch.round(w / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return L.Int8Linear(q, scale, _bias(lin))


def quantize_dense_w8a8(lin: nn.Linear) -> L.W8A8Linear:
    """As :func:`quantize_dense`, stored for the W8A8 path: the apply path
    also quantizes the activations per row and runs the product s8 x s8 ->
    s32.  SmoothQuant's fold happens before this, on the bf16 model; the
    quantized module carries nothing extra."""
    q = quantize_dense(lin)
    return L.W8A8Linear(q.w_q, q.w_scale, q.bias)


@torch.no_grad()
def quantize_dense4(lin: nn.Linear, group: int = 128) -> L.Int4Linear:
    """int4 with symmetric per-(group, output channel) scales; the input
    dim is padded to whole groups, and the true width is recovered from
    the activations at apply time."""
    if group % 2:
        raise ValueError(f"group must be even, got {group}")
    w = lin.weight.detach().float()
    out_dim, in_dim = w.shape
    n_groups = -(-in_dim // group)
    wg = F.pad(w, (0, n_groups * group - in_dim)).reshape(out_dim, n_groups, group)
    scale = _div(wg.abs().amax(-1), 7.0).clamp_min(1e-8)
    q = torch.round(wg / scale[..., None]).clamp(-7, 7).reshape(out_dim, -1).to(torch.int16)
    lo, hi = q[:, 0::2], q[:, 1::2]
    packed = ((lo & 0xF) | ((hi & 0xF) << 4)).to(torch.uint8).view(torch.int8)
    return L.Int4Linear(packed, scale, _bias(lin))


def is_quantized(m: nn.Module) -> bool:
    return isinstance(m, (L.Int8Linear, L.W8A8Linear, L.Int4Linear))


def _unpack4(packed: torch.Tensor) -> torch.Tensor:
    """(out, P) packed int8 -> (out, 2P) signed nibbles (two's complement)."""
    p = packed.to(torch.int16)
    lo = ((p & 0xF) ^ 8) - 8
    hi = p >> 4
    return torch.stack([lo, hi], -1).reshape(packed.shape[0], -1)


def _qdense4(m: L.Int4Linear, x: torch.Tensor) -> torch.Tensor:
    """Unpack, dequantize in x's type (the scale cast to it first), slice
    to x's width, then one product with float32 accumulation rounded to
    x's type, then the bias."""
    w = _unpack4(m.w_q4)
    out_dim, n_groups = m.w_scale4.shape
    wd = (w.reshape(out_dim, n_groups, -1).to(x.dtype)
          * m.w_scale4[..., None].to(x.dtype))
    wd = wd.reshape(out_dim, -1)[:, :x.shape[-1]]
    y = torch.matmul(x, wd.t()).to(x.dtype)
    if m.bias is not None:
        y = y + m.bias
    return y


# ---------------------------------------------------------------------------
# Activation quantization and the quantized products
# ---------------------------------------------------------------------------


def quantize_activation(x: torch.Tensor, k: Optional[int] = None) -> Dict:
    """Per-row activation quantization, computed once and shared by every
    W8A8 product on the same input.  Returns {'xq' int8 (x's shape), 'sc'
    (..., 1) float32} and, with the outlier decomposition on (k, default
    ``W8A8_OUTLIER_K``, capped at half the width), 'idx' (the k columns of
    largest |x| over all rows, which the int8 operand sees as zeros) and
    'x_out' (..., k) float32 (their values, for a float32 side product)."""
    in_dim = x.shape[-1]
    k = min(W8A8_OUTLIER_K if k is None else k, in_dim // 2)
    rows = x.reshape(-1, in_dim)
    qa: Dict = {}
    if k > 0:
        xf = rows.float()
        idx = torch.topk(xf.abs().amax(0), k).indices
        qa["idx"] = idx
        qa["x_out"] = xf[:, idx].reshape(*x.shape[:-1], k)
        keep = torch.ones(in_dim, dtype=torch.float32, device=x.device)
        keep[idx] = 0.0
        rows = xf * keep
    xq, sc = quantize_rows(rows.contiguous())
    qa["sc"] = sc.reshape(*x.shape[:-1], 1)
    qa["xq"] = xq.reshape(x.shape)
    return qa


def rms_quantize_activation(x: torch.Tensor, gamma: torch.Tensor,
                            eps: float = 1e-6) -> Dict:
    """Per-row int8 quantization of rmsnorm(x; gamma) without the normed
    tensor: the row's rsqrt factor cancels inside the int8 values and moves
    into the scale (see :func:`quantize_rows_plain`).  Not for the outlier
    decomposition: callers fall back to the unfused path there."""
    C = x.shape[-1]
    xq, sc = quantize_rows(x.reshape(-1, C).contiguous(), gamma.contiguous(), eps)
    return {"xq": xq.reshape(x.shape), "sc": sc.reshape(*x.shape[:-1], 1)}


def qdense_act(m: L.W8A8Linear, qa: Dict, out_dtype: torch.dtype) -> torch.Tensor:
    """The int8 product against a quantized activation, rescaled by the
    outer product of the row and column scales, plus the float32 outlier
    side product when ``qa`` carries one: one :func:`w8a8_linear`."""
    xq = qa["xq"]
    lead, K = xq.shape[:-1], xq.shape[-1]
    rows = xq.reshape(-1, K)
    side = None
    if "idx" in qa:
        w_rows = m.w_q8a[:, qa["idx"]].float().t() * m.w_scale[None, :]   # (k, out)
        side = qa["x_out"].reshape(rows.shape[0], -1) @ w_rows
    y = w8a8_linear(rows, qa["sc"].reshape(-1, 1), m.w_q8a, m.w_scale, m.bias, out_dtype, side)
    return y.reshape(*lead, y.shape[-1])


def qdense(m: nn.Module, x: torch.Tensor, mesh: Optional[M.Mesh] = None) -> torch.Tensor:
    """x through a quantized module.  Weight-only int8: a product of x and
    the int8 weight (cast to x's type) with a float32 result
    (:func:`_mm_f32`), scaled by the column scales in float32, then rounded
    to x's type, then the bias, through :class:`_Int8MM` (which gives
    QLoRA's frozen base its backward; with ``mesh``, the row split's sum
    over tp).  W8A8: :func:`quantize_activation` and :func:`qdense_act`.
    int4: :func:`_qdense4`."""
    if isinstance(m, L.Int4Linear):
        return _qdense4(m, x)
    if isinstance(m, L.W8A8Linear):
        return qdense_act(m, quantize_activation(x), x.dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    y = _Int8MM.apply(x2, m.w_q, m.w_scale, mesh).to(x.dtype)
    if m.bias is not None:
        y = y + m.bias
    return y.reshape(*lead, y.shape[-1])


def qdense_rows(m: nn.Module, x: torch.Tensor, mesh: M.Mesh) -> torch.Tensor:
    """The row split of a quantized projection (o, down) on a mesh with tp
    above 1: x (..., K / tp) is this rank's block of the input and ``m``
    holds the codes of this rank's K block, whole over fsdp
    (``mesh.fsdp_module``).  The output is the whole product on every tp
    rank, as one process's:

      * int8: the float32 products summed over tp, then the scales
        (:class:`_Int8MM`);
      * W8A8: each row's max |x| over its blocks (Q1's form (a), then a
        MAX over tp), the int8 values for that shared scale (Q1's form
        (b)), this block's int32 product (Q2's int32 output), summed over
        tp in int32, then the rescale and the bias (:func:`w8a8_epilogue`):
        equal to one process's product to the bit.  With the outlier
        decomposition on, the input and the codes are gathered over tp
        and the one-process product runs;
      * int4: a group of 128 inputs spans the tp blocks (down's 86 groups
        at 7B do not divide over tp = 4), so the input is gathered over tp
        (the gradient takes this rank's columns) and each rank computes the
        whole product from the whole packed codes it holds."""
    if isinstance(m, L.Int4Linear):
        return _qdense4(m, M.gather_from_tp(x, -1, mesh))
    if not isinstance(m, L.W8A8Linear):
        return qdense(m, x, mesh)
    if W8A8_OUTLIER_K > 0:
        whole = copy.copy(m)
        whole._buffers = {**m._buffers, "w_q8a": M.all_gather(m.w_q8a, 1, mesh.groups["tp"],
                                                              mesh.tp)}
        return qdense(whole, M.all_gather(x, x.dim() - 1, mesh.groups["tp"], mesh.tp))
    lead, K = x.shape[:-1], x.shape[-1]
    rows = x.reshape(-1, K).contiguous()
    amax = M.all_reduce_max(row_absmax(rows), mesh.groups["tp"])
    sc = _div(amax.clamp_min(1e-6), 127.0)
    acc = w8a8_int_mm(quantize_rows_scaled(rows, sc), m.w_q8a)
    acc = M.all_reduce(acc, mesh.groups["tp"])
    y = w8a8_epilogue(acc, sc, m.w_scale, m.bias, x.dtype)
    return y.reshape(*lead, y.shape[-1])


# ---------------------------------------------------------------------------
# SmoothQuant: the static calibration fold
# ---------------------------------------------------------------------------


def _f32(v, device=None) -> torch.Tensor:
    """A statistic (tensor or array) as a float32 tensor."""
    t = v if torch.is_tensor(v) else torch.from_numpy(np.array(v, np.float32))
    return t.to(device=device, dtype=torch.float32)


def _smooth_scales(a_max, w_max, alpha: float) -> torch.Tensor:
    """SmoothQuant's per-input-channel strength
    s_j = a_max_j^alpha / w_max_j^(1-alpha), clipped to [1e-3, 1e3].  A
    site with degenerate stats (non-finite, or every activation column
    below 1e-4) opts out: s = ones."""
    a = _f32(a_max)
    w = _f32(w_max, a.device)
    ok = (torch.isfinite(a).all() & torch.isfinite(w).all()
          & (a.max() > 1e-4) & (w.max() > 1e-8))
    s = (a.clamp_min(1e-5) ** alpha / w.clamp_min(1e-5) ** (1.0 - alpha)).clamp(1e-3, 1e3)
    return torch.where(ok, s, torch.ones_like(s))


def _mesh_of(llm: nn.Module) -> Optional[M.Mesh]:
    """A LLaMA's mesh where it is sharded, else None."""
    mesh = getattr(llm, "mesh", None)
    return mesh if mesh is not None and mesh.sharded else None


def _wmax(lin: nn.Linear, mesh: Optional[M.Mesh] = None, spec=M.COLUMN) -> torch.Tensor:
    """max |w| over the outputs, per input channel, of the whole weight: on
    a mesh (``spec`` its axes) the block's maxima taken over the output
    axis's ranks and gathered along the input axis (exact)."""
    w = lin.weight.detach().float().abs().amax(0)
    if mesh is None:
        return w
    out, inp = spec
    if out and mesh.size(out) > 1:
        w = M.all_reduce_max(w, mesh.groups[out])
    if inp and mesh.size(inp) > 1:
        w = M.all_gather(w, 0, mesh.groups[inp], mesh.size(inp))
    return w


@torch.no_grad()
def llama_smooth_plan(llm: nn.Module, stats, alpha: Optional[float] = None,
                      head_dim: Optional[int] = None):
    """Per-layer fold vectors from calibration stats (one dict per layer
    with 'attn_in', 'o_in', 'mlp_in', 'down_in' column maxima, from
    ``llmseg.calibrate_quant_stats`` or ``Llama(quant_stats=...)``).  A
    shared-input group (q/k/v, gate/up) gets one s from its largest |w|.

    Returns one {'attn', 'o', 'o_rows', 'mlp', 'down'} dict of float32
    vectors per layer: 'o' divides v's output channels, 'o_rows' multiplies
    o's input channels.  Under grouped-query attention one v channel feeds
    ``num_heads / num_kv_heads`` o channels, so with ``head_dim`` s is one
    per kv-shared group (the group max of both statistics) and 'o_rows'
    repeats it; without ``head_dim`` the o site is skipped ('o' None).
    lm_head has no calibration site and stays unsmoothed.  On a mesh the
    vectors are the whole ones, on every rank."""
    alpha = W8A8_SMOOTH_ALPHA if alpha is None else alpha
    mesh = _mesh_of(llm)
    tp = 1 if mesh is None else mesh.tp
    plan = []
    for layer, st in zip(llm.layers, stats):
        a, m = layer.attn, layer.mlp
        dev = a.q.weight.device
        st = {k: _f32(v, dev) for k, v in st.items()}
        wm_qkv = torch.maximum(torch.maximum(_wmax(a.q, mesh), _wmax(a.k, mesh)),
                               _wmax(a.v, mesh))
        wm_gu = torch.maximum(_wmax(m.gate, mesh), _wmax(m.up, mesh))
        o_in, v_out = a.o.weight.shape[1] * tp, a.v.weight.shape[0] * tp
        rep = o_in // v_out
        if rep == 1:
            s_o = s_o_rows = _smooth_scales(st["o_in"], _wmax(a.o, mesh, M.ROW), alpha)
        elif head_dim is not None:
            n_kv = v_out // head_dim

            def grp(v):
                return v.reshape(n_kv, rep, head_dim).amax(1).reshape(-1)

            s_o = _smooth_scales(grp(st["o_in"]), grp(_wmax(a.o, mesh, M.ROW)), alpha)
            s_o_rows = s_o.reshape(n_kv, 1, head_dim).expand(n_kv, rep, head_dim).reshape(-1)
        else:
            s_o = s_o_rows = None
        plan.append({
            "attn": _smooth_scales(st["attn_in"], wm_qkv, alpha),
            "o": s_o,
            "o_rows": s_o_rows,
            "mlp": _smooth_scales(st["mlp_in"], wm_gu, alpha),
            "down": _smooth_scales(st["down_in"], _wmax(m.down, mesh, M.ROW), alpha),
        })
    return plan


def _block(s: torch.Tensor, axis: Optional[str], mesh: Optional[M.Mesh]) -> torch.Tensor:
    """This rank's block of a whole per-channel vector along ``axis``."""
    return s if mesh is None or axis is None else M.local_block(s, (axis,), mesh)


def _scale_in(w: torch.Tensor, s: torch.Tensor, mesh=None, spec=M.COLUMN) -> None:
    """w (out, in) *= s per input channel (a row of the JAX (in, out)
    kernel); on a mesh w is the block of axes ``spec`` and s is whole."""
    w.copy_((w.float() * _block(s, spec[1], mesh)[None, :]).to(w.dtype))


def _scale_in_div_out(w: torch.Tensor, s_in: torch.Tensor, s_out: torch.Tensor,
                      mesh=None, spec=M.COLUMN) -> None:
    s_in, s_out = _block(s_in, spec[1], mesh), _block(s_out, spec[0], mesh)
    w.copy_((w.float() * s_in[None, :] / s_out[:, None]).to(w.dtype))


def _div_out(w: torch.Tensor, s: torch.Tensor, mesh=None, axis=None) -> None:
    """w (out, ...) /= s per output channel (a vector: a bias or a gamma;
    a matrix: LoRA's B, its output axis ``axis`` on a mesh)."""
    s = _block(s, axis, mesh)
    shape = (-1,) + (1,) * (w.dim() - 1)
    w.copy_((w.float() / s.reshape(shape)).to(w.dtype))


@torch.no_grad()
def fold_smooth_llama_inplace(llm: nn.Module, smooth_stats, alpha: Optional[float] = None,
                              lora: Optional[nn.Module] = None,
                              head_dim: Optional[int] = None) -> nn.Module:
    """Fold SmoothQuant's scales into the live model, in place, before it
    is quantized: an exact reparameterisation (the same outputs in exact
    arithmetic), each 1/s landing in what produces the product's input:

      input_norm gamma /= s_attn;  q/k/v input channels *= s_attn
      post_norm  gamma /= s_mlp;   gate/up input channels *= s_mlp
      v outputs (+bias) /= s_o;    o input channels *= s_o_rows
      up outputs (+bias) /= s_down; down input channels *= s_down

    Each weight is rewritten through one float32 temporary, so the extra
    memory is one weight's.  ``lora``: the live ``LlamaLora`` overlay that
    will run on the folded base; it must be given so that it is
    compensated too (q/v A input channels *= s_attn, v B outputs /= s_o).
    ``head_dim`` enables the exact grouped-query o fold.  On a mesh each
    weight is this rank's block and takes its block of the (whole) scales:
    every element's arithmetic is one process's, so the folded blocks are
    one process's blocks to the bit."""
    mesh = _mesh_of(llm)
    plan = llama_smooth_plan(llm, smooth_stats, alpha, head_dim)
    lora_layers = [None] * len(plan) if lora is None else lora.layers
    for layer, e, ll in zip(llm.layers, plan, lora_layers):
        a, m = layer.attn, layer.mlp
        _div_out(layer.input_norm.weight, e["attn"])
        _scale_in(a.q.weight, e["attn"], mesh)
        _scale_in(a.k.weight, e["attn"], mesh)
        if e["o"] is None:
            _scale_in(a.v.weight, e["attn"], mesh)
        else:
            _scale_in_div_out(a.v.weight, e["attn"], e["o"], mesh)
            if a.v.bias is not None:
                _div_out(a.v.bias, e["o"])
            _scale_in(a.o.weight, e["o_rows"], mesh, M.ROW)
        if ll:
            unknown = set(ll.keys()) - {"q", "v"}
            if unknown:
                raise ValueError(f"LoRA targets {unknown} have no SmoothQuant compensation")
            for name in ("q", "v"):
                if name in ll:
                    _scale_in(ll[name].a.weight, e["attn"], mesh, M.LORA_A)
            if "v" in ll and e["o"] is not None:
                _div_out(ll["v"].b.weight, e["o"], mesh, M.LORA_B[0])
        _div_out(layer.post_norm.weight, e["mlp"])
        _scale_in(m.gate.weight, e["mlp"], mesh)
        _scale_in_div_out(m.up.weight, e["mlp"], e["down"], mesh)
        if m.up.bias is not None:
            _div_out(m.up.bias, e["down"])
        _scale_in(m.down.weight, e["down"], mesh, M.ROW)
    return llm


# ---------------------------------------------------------------------------
# Quantizing a model
# ---------------------------------------------------------------------------


def _pick_qfn(bits: int, w8a8: bool) -> Callable[[nn.Linear], nn.Module]:
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if w8a8 and bits == 4:
        raise ValueError("W8A8 is an int8 mode")
    if bits == 4:
        return quantize_dense4
    return quantize_dense_w8a8 if w8a8 else quantize_dense


def _replace_linears(root: nn.Module, predicate, qfn, mesh: Optional[M.Mesh] = None) -> None:
    """Replace, one at a time, every ``nn.Linear`` under ``root`` whose path
    (a tuple of names) the predicate selects; each old module (and its
    weight) is freed as soon as its quantized copy is in place.  With
    ``mesh`` (``root`` a sharded ``Llama``) each weight is gathered whole
    over the mesh, quantized as in one process and its codes and scales
    sliced to this rank's blocks (``mesh.quant_spec``), so that they are
    one process's to the bit; the whole copy is freed before the next."""
    names = [n for n, mod in root.named_modules()
             if n and isinstance(mod, nn.Linear)
             and (predicate is None or predicate(tuple(n.split("."))))]
    for name in names:
        parent_name, _, leaf = name.rpartition(".")
        parent = root.get_submodule(parent_name)
        lin = getattr(parent, leaf)
        if mesh is None:
            setattr(parent, leaf, qfn(lin))
            continue
        out = M.out_axis(name)
        whole = nn.Module()
        whole.weight = M.gather_tensor(lin.weight.detach(), M.quant_spec(out, "w_q", 2), mesh)
        whole.bias = None if lin.bias is None else lin.bias.detach()
        q = qfn(whole)
        del whole
        M.shard_buffers(q, out, mesh)
        setattr(parent, leaf, q)


def quantize_tree(module: nn.Module, predicate=None, bits: int = 8,
                  w8a8: bool = False) -> nn.Module:
    """A copy of ``module`` with every ``nn.Linear`` that ``predicate``
    (path tuple -> bool) selects quantized; the copy shares every other
    tensor with ``module``, which is not changed.  bits 8 or 4; w8a8 also
    quantizes the activations at apply time."""
    qfn = _pick_qfn(bits, w8a8)
    if isinstance(module, nn.Linear):
        return qfn(module) if predicate is None or predicate(()) else module
    shared = {id(t): t for t in (*module.parameters(), *module.buffers())}
    out = copy.deepcopy(module, shared)
    _replace_linears(out, predicate, qfn)
    return out


def _llama_pred(path) -> bool:
    joined = "/".join(str(p) for p in path)
    return "attn" in joined or "mlp" in joined or "lm_head" in joined


def quantize_llama(llm: nn.Module, bits: int = 8, w8a8: bool = False, smooth_stats=None,
                   alpha: Optional[float] = None, head_dim: Optional[int] = None) -> nn.Module:
    """A quantized copy of a ``Llama``: its projections and lm_head;
    embeddings and norms stay in full precision.  ``smooth_stats`` applies
    the calibration fold first (on a copy): SmoothQuant for W8A8, the
    AWQ-style protection for int4 (``W4_SMOOTH_ALPHA`` by default); int8
    weight-only ignores them.  With a LoRA overlay at inference use
    :func:`quantize_llama_inplace` (``lora=``)."""
    require_ported(llm.cfg, "quantization")
    if smooth_stats is not None and (w8a8 or bits == 4):
        if alpha is None and not w8a8:
            alpha = W4_SMOOTH_ALPHA
        llm = copy.deepcopy(llm)
        fold_smooth_llama_inplace(llm, smooth_stats, alpha, head_dim=head_dim)
    return quantize_tree(llm, _llama_pred, bits=bits, w8a8=w8a8)


def quantize_llama_inplace(llm: nn.Module, bits: int = 8, w8a8: bool = False,
                           smooth_stats=None, alpha: Optional[float] = None,
                           lora: Optional[nn.Module] = None,
                           head_dim: Optional[int] = None,
                           skip: Optional[Callable] = None) -> nn.Module:
    """:func:`quantize_llama` in place, for a model that fills the card: the
    fold (with ``lora`` compensated, see :func:`fold_smooth_llama_inplace`)
    rewrites each weight in place, then each projection is replaced by its
    quantized module and its bf16 weight freed at once, so the extra memory
    is one weight's, never a second copy of the model.  ``skip`` (module
    path tuple -> bool) keeps the projections it selects in full precision
    (QLoRA's trainable lm_head, ``train.optim.quantize_skeleton``).  A
    LLaMA sharded over a mesh (``parallel/mesh.py``) is folded on its
    blocks and quantized one whole projection at a time, its codes and
    scales left as this rank's blocks: the extra memory is still one
    weight's."""
    require_ported(llm.cfg, "quantization")
    if smooth_stats is not None and (w8a8 or bits == 4):
        if alpha is None and not w8a8:
            alpha = W4_SMOOTH_ALPHA
        fold_smooth_llama_inplace(llm, smooth_stats, alpha, lora=lora, head_dim=head_dim)
    pred = _llama_pred if skip is None else (lambda path: _llama_pred(path) and not skip(path))
    _replace_linears(llm, pred, _pick_qfn(bits, w8a8), _mesh_of(llm))
    return llm
