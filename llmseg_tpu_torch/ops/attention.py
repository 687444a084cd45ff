"""Attention: the plain path and the five hand-written Hopper kernels.

Counterpart of ``llmseg_tpu.ops.attention``.  Layout at the public functions:
q (B, T, H, D), k/v (B, S, H, D) -> (B, T, H, D).

* :func:`attention_plain` is the port of ``attention_xla``: float32 logits,
  the finite ``NEG_INF`` causal mask, float32 softmax, probabilities cast to
  v's dtype for the second product.
* :func:`flash_attention` keeps ``flash_attention``'s contract: q is
  multiplied by ``scale * log2(e)`` in q's own dtype, logits live in the
  exp2 domain, statistics are float32, D other than 64/128 is zero-padded.
  The kernels mask the ragged key tile themselves, so T and S need no
  padding and no query rows are sliced off.  Under autograd it enters
  :class:`FlashAttentionFn`, the counterpart of ``_flash_attention``'s
  ``custom_vjp``: kernel A with the lse forward, kernels C and D backward.
* :func:`attention` dispatches on the tensors' device: CUDA tensors without
  a bias, causal with T >= 256 or non-causal with T >= 2048, go to the
  kernels (the layers that reach the Pallas kernels on the TPU: LLaMA and
  DINOv2); everything else, CPU tensors included, takes the plain path.
  The inference forward of non-causal attention follows the JAX module's
  flags, read at import: kernel B by default, kernel A with
  ``LLMSEG_ATTN_ONEPASS=0``, kernel J with ``LLMSEG_ATTN_ONEPASS_T=1``.

Each kernel wrapper (:func:`flash_fwd`, kernel A; :func:`flash_fwd_1pass`,
kernel B; :func:`flash_bwd_dq`, kernel C; :func:`flash_bwd_dkv`, kernel D;
:func:`flash_fwd_1pass_t`, kernel J) takes (B*H, L, D) tensors.  For a
CUDA tensor it launches its kernel or raises; only a tensor on the CPU goes
to the plain version beside it, which computes the same function step by
step.  The inference forwards A, B and J are custom ops
(``torch.ops.llmseg.flash_fwd``, ``flash_fwd_1pass``, ``flash_fwd_1pass_t``;
``ops.kernels.kernel_op``), so that ``torch.export`` traces them as nodes
that launch the kernels; :func:`flash_attention_bias` is A with an additive
bias.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch

from llmseg_tpu_torch.ops.kernels import Kernel, kernel_op

NEG_INF = -1e9   # finite: fully masked rows stay NaN-free
LOG2E = 1.4426950408889634
INV_LOG2E = 1.0 / LOG2E
RESCUE_L = 1e-12  # kernel B redoes a row whose bound-shifted sum is this small

FLASH_FWD = Kernel("flash_fwd")              # kernel A, csrc/flash_fwd.cu
FLASH_FWD_1PASS = Kernel("flash_fwd_1pass")  # kernel B, csrc/flash_fwd_1pass.cu
FLASH_BWD_DQ = Kernel("flash_bwd_dq")        # kernel C, csrc/flash_bwd_dq.cu
FLASH_BWD_DKV = Kernel("flash_bwd_dkv")      # kernel D, csrc/flash_bwd_dkv.cu
FLASH_FWD_1PASS_T = Kernel("flash_fwd_1pass_t")  # kernel J, csrc/flash_fwd_1pass_t.cu
KERNELS = (FLASH_FWD, FLASH_FWD_1PASS, FLASH_BWD_DQ, FLASH_BWD_DKV, FLASH_FWD_1PASS_T)

# the JAX module's flags for the non-causal inference forward: the one-pass
# kernel B (default), or A with ONEPASS=0; its transposed form J with ONEPASS_T=1
ONEPASS = os.environ.get("LLMSEG_ATTN_ONEPASS", "1") == "1"
ONEPASS_T = os.environ.get("LLMSEG_ATTN_ONEPASS_T", "0") == "1"


def attention_plain(q, k, v, *, bias=None, causal=False, scale=None):
    """Plain attention; bias broadcastable to (B, H, T, S)."""
    T, D = q.shape[1], q.shape[3]
    S = k.shape[1]
    scale = (1.0 / math.sqrt(D)) if scale is None else scale
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        keep = torch.ones(T, S, dtype=torch.bool, device=q.device).tril()
        logits = torch.where(keep, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Kernel A: exact online-softmax forward (the port of _fwd_kernel)
# ---------------------------------------------------------------------------


def flash_fwd_plain(q, k, v, *, causal: bool, bias=None, with_lse=False):
    """Kernel A's function, step by step.  q (BH, T, D) pre-scaled by
    scale*log2(e); k, v (BH, S, D); bias (BH or 1, T, S) log2-domain.
    Returns (o, lse or None); lse (BH, T) float32 in log2."""
    T, S = q.shape[1], k.shape[1]
    s = torch.matmul(q.float(), k.float().transpose(1, 2))
    if bias is not None:
        s = s + bias.float()
    if causal:
        keep = torch.ones(T, S, dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l_safe
    lse = (m + torch.log2(l_safe))[..., 0] if with_lse else None
    return o.to(q.dtype), lse


def _check_shapes(q, k, v) -> None:
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 \
            or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"expected q (BH, T, D), k/v (BH, S, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype or q.dtype not in (torch.bfloat16,
                                                                   torch.float32):
        raise ValueError(f"q/k/v must share dtype bf16 or float32, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[2] not in (64, 128):
        raise ValueError(f"head dim {q.shape[2]} not in (64, 128)")


def _check_cuda(q, k, v) -> None:
    """The kernels' contract on CUDA tensors: :func:`_check_shapes`, then
    each tensor contiguous and 16-byte aligned on the card."""
    _check_shapes(q, k, v)
    for t in (q, k, v):
        if not t.is_cuda:
            raise ValueError(f"expected CUDA tensors, got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("q/k/v must be contiguous and 16-byte aligned")


def _check_bias(bias, q, S) -> None:
    BH, T = q.shape[:2]
    if (bias.dtype != torch.float32 or bias.dim() != 3 or bias.shape[1:] != (T, S)
            or bias.shape[0] not in (1, BH)):
        raise ValueError(f"bias must be float32 (B*H or 1, T, S), got {bias.dtype} "
                         f"{tuple(bias.shape)}")


def _no_lse(q) -> torch.Tensor:
    """The op's lse output when none is asked for: an empty float32 tensor
    (a custom op returns tensors, not None)."""
    return q.new_empty((0,), dtype=torch.float32)


def _flash_fwd_cpu(q, k, v, bias, causal, with_lse):
    o, lse = flash_fwd_plain(q, k, v, causal=causal, bias=bias, with_lse=with_lse)
    return o, _no_lse(q) if lse is None else lse


def _flash_fwd_fake(q, k, v, bias, causal, with_lse):
    _check_shapes(q, k, v)
    if bias is not None:
        _check_bias(bias, q, k.shape[1])
    lse = q.new_empty(q.shape[:2], dtype=torch.float32) if with_lse else _no_lse(q)
    return q.new_empty(q.shape), lse


@kernel_op("flash_fwd", cpu=_flash_fwd_cpu, fake=_flash_fwd_fake)
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor], causal: bool,
                  with_lse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel A on the card: checks, then one launch."""
    _check_cuda(q, k, v)
    BH, T, D = q.shape
    S = k.shape[1]
    stride = 0
    if bias is not None:
        _check_bias(bias, q, S)
        if not bias.is_cuda or not bias.is_contiguous():
            raise ValueError("bias must be contiguous CUDA float32 (B*H or 1, T, S)")
        stride = T * S if bias.shape[0] == BH else 0
    o = torch.empty_like(q)
    lse = (torch.empty((BH, T), dtype=torch.float32, device=q.device)
           if with_lse else _no_lse(q))
    FLASH_FWD.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     None if bias is None else bias.data_ptr(), stride,
                     o.data_ptr(), lse.data_ptr() if with_lse else None,
                     BH, T, S, D, int(q.dtype == torch.bfloat16), int(causal))
    return o, lse


def flash_fwd(q, k, v, *, causal: bool, bias=None, with_lse=False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Kernel A wrapper, the op ``llmseg::flash_fwd``.  Shapes as
    :func:`flash_fwd_plain`."""
    o, lse = _flash_fwd_op(q, k, v, bias, causal, with_lse)
    return o, lse if with_lse else None


# ---------------------------------------------------------------------------
# Kernel B: non-causal one-pass forward (the port of _fwd1_kernel)
# ---------------------------------------------------------------------------


def key_norm_max(k: torch.Tensor) -> torch.Tensor:
    """(BH, S, D) -> (BH,) float32 max_j |k_j|, the per-head input of the
    plain versions of kernels B and J (on the card each kernel's C call
    computes it)."""
    return k.float().square().sum(-1).sqrt().amax(-1).contiguous()


def flash_fwd_1pass_plain(q, k, v, kmax):
    """Kernel B's function, step by step.  q (BH, T, D) pre-scaled; k, v
    (BH, S, D); kmax (BH,).  The rescue is decided per row."""
    qf, kf, vf = q.float(), k.float(), v.float()
    b = torch.clamp_min(qf.square().sum(-1, keepdim=True).sqrt()
                        * kmax[:, None, None], 1.0)
    s = torch.matmul(qf, kf.transpose(1, 2))
    p = torch.exp2(s - b).to(v.dtype).float()
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p, vf)
    ok = l > RESCUE_L
    if bool(ok.all()):
        return (o / l).to(q.dtype)
    p2 = torch.exp2(s - s.amax(-1, keepdim=True)).to(v.dtype).float()
    l2 = p2.sum(-1, keepdim=True)
    o2 = torch.matmul(p2, vf)
    return torch.where(ok, o / l, o2 / l2.clamp_min(1e-30)).to(q.dtype)


def _onepass_fake(q, k, v):
    _check_shapes(q, k, v)
    return q.new_empty(q.shape)


@kernel_op("flash_fwd_1pass", cpu=lambda q, k, v: flash_fwd_1pass_plain(q, k, v, key_norm_max(k)),
           fake=_onepass_fake)
def flash_fwd_1pass(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel B, the op ``llmseg::flash_fwd_1pass``.  q (BH, T, D)
    pre-scaled; k, v (BH, S, D).  On the card the C call computes max_j
    |k_j| itself, by one reduction kernel into ``kmax``, before kernel B, as
    kernel J's does."""
    _check_cuda(q, k, v)
    BH, T, D = q.shape
    kmax = torch.empty((BH,), dtype=torch.float32, device=q.device)
    o = torch.empty_like(q)
    FLASH_FWD_1PASS.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           kmax.data_ptr(), o.data_ptr(), BH, T, k.shape[1],
                           D, int(q.dtype == torch.bfloat16))
    return o


# ---------------------------------------------------------------------------
# Kernel J: kernel B's function, every tile transposed (the port of _fwd1t_kernel)
# ---------------------------------------------------------------------------


def flash_fwd_1pass_t_plain(q, k, v, kmax):
    """Kernel J's function, step by step: s^T = k q^T, the bound b of each
    query column, p^T = exp2(s^T - b) rounded to v's dtype, o^T = v^T p^T
    over the column sums l.  q (BH, T, D) pre-scaled; k, v (BH, S, D); kmax
    (BH,).  Returns o^T (BH, D, T).  The rescue is decided per column."""
    qf, kf, vf = q.float(), k.float(), v.float()
    b = torch.clamp_min(qf.square().sum(-1).sqrt()[:, None, :] * kmax[:, None, None], 1.0)
    st = torch.matmul(kf, qf.transpose(1, 2))                   # (BH, S, T)
    p = torch.exp2(st - b).to(v.dtype).float()
    l = p.sum(1, keepdim=True)
    ot = torch.matmul(vf.transpose(1, 2), p)                    # (BH, D, T)
    ok = l > RESCUE_L
    if bool(ok.all()):
        return (ot / l).to(q.dtype)
    p2 = torch.exp2(st - st.amax(1, keepdim=True)).to(v.dtype).float()
    l2 = p2.sum(1, keepdim=True)
    o2 = torch.matmul(vf.transpose(1, 2), p2)
    return torch.where(ok, ot / l, o2 / l2.clamp_min(1e-30)).to(q.dtype)


def _onepass_t_fake(q, k, v):
    _check_shapes(q, k, v)
    return q.new_empty((q.shape[0], q.shape[2], q.shape[1]))


@kernel_op("flash_fwd_1pass_t",
           cpu=lambda q, k, v: flash_fwd_1pass_t_plain(q, k, v, key_norm_max(k)),
           fake=_onepass_t_fake)
def flash_fwd_1pass_t(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel J, the op ``llmseg::flash_fwd_1pass_t``.  q (BH, T, D)
    pre-scaled; k, v (BH, S, D).  Returns o^T (BH, D, T).  On the card the C
    call computes max_j |k_j| itself, by one reduction kernel into
    ``kmax``, before kernel J."""
    _check_cuda(q, k, v)
    BH, T, D = q.shape
    kmax = torch.empty((BH,), dtype=torch.float32, device=q.device)
    ot = torch.empty((BH, D, T), dtype=q.dtype, device=q.device)
    FLASH_FWD_1PASS_T.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), kmax.data_ptr(),
                             ot.data_ptr(), BH, T, k.shape[1], D,
                             int(q.dtype == torch.bfloat16))
    return ot


# ---------------------------------------------------------------------------
# Kernels C and D: the backward (the ports of _bwd_dq_kernel, _bwd_dkv_kernel)
# ---------------------------------------------------------------------------


def bwd_delta(o, do) -> torch.Tensor:
    """(BH, T) float32 rowsum(do * o), the backward's per-row correction."""
    return (do.float() * o.float()).sum(-1)


def _bwd_plain(q, k, v, do, lse, delta, *, causal: bool):
    T, S = q.shape[1], k.shape[1]
    s = torch.matmul(q.float(), k.float().transpose(1, 2))
    if causal:
        keep = torch.ones(T, S, dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, NEG_INF)
    p = torch.exp2(s - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    ds = p * (dp - delta[..., None])
    dq = torch.matmul(ds.to(k.dtype).float(), k.float()) * INV_LOG2E
    dk = torch.matmul(ds.to(q.dtype).float().transpose(1, 2), q.float()) * INV_LOG2E
    dv = torch.matmul(p.to(do.dtype).float().transpose(1, 2), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_plain(q, k, v, o, do, lse, *, causal: bool):
    """Kernels C and D's function, step by step, in float32.  q, o, do
    (BH, T, D) with q pre-scaled by scale*log2(e); k, v (BH, S, D); lse
    (BH, T) float32 log2.  p is rounded to do's dtype before the dv product
    and ds to the input dtype before the dq and dk products, as the TPU
    kernels do.  Returns (dq, dk, dv)."""
    return _bwd_plain(q, k, v, do, lse, bwd_delta(o, do), causal=causal)


def _check_rows(name, x, like) -> None:
    if (not x.is_cuda or x.dtype != like.dtype or x.shape != like.shape
            or not x.is_contiguous() or x.data_ptr() % 16):
        raise ValueError(f"{name} must be a contiguous CUDA tensor like q, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def _check_stat(name, x, q) -> None:
    if (not x.is_cuda or x.dtype != torch.float32 or x.shape != q.shape[:2]
            or not x.is_contiguous()):
        raise ValueError(f"{name} must be contiguous CUDA float32 (BH, T), "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def flash_bwd_dq(q, k, v, o, do, lse, *, causal: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel C wrapper: (dq, delta).  Shapes as :func:`flash_bwd_plain`;
    delta (BH, T) float32 is kernel D's input."""
    if q.device.type == "cpu":
        delta = bwd_delta(o, do)
        return _bwd_plain(q, k, v, do, lse, delta, causal=causal)[0], delta
    _check_cuda(q, k, v)
    _check_rows("o", o, q)
    _check_rows("do", do, q)
    _check_stat("lse", lse, q)
    BH, T, D = q.shape
    dq = torch.empty_like(q)
    delta = torch.empty((BH, T), dtype=torch.float32, device=q.device)
    FLASH_BWD_DQ.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                        do.data_ptr(), lse.data_ptr(), dq.data_ptr(), delta.data_ptr(),
                        BH, T, k.shape[1], D, int(q.dtype == torch.bfloat16), int(causal))
    return dq, delta


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel D wrapper: (dk, dv), from kernel C's delta."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, lse, delta, causal=causal)[1:]
    _check_cuda(q, k, v)
    _check_rows("do", do, q)
    _check_stat("lse", lse, q)
    _check_stat("delta", delta, q)
    BH, T, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    FLASH_BWD_DKV.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                         lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                         BH, T, k.shape[1], D, int(q.dtype == torch.bfloat16), int(causal))
    return dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention on (BH, L, D) pre-scaled inputs, the
    counterpart of ``_flash_attention``'s ``custom_vjp``: the forward is
    kernel A with the lse output (``_flash_attention_fwd``), the backward
    kernels C then D (``_flash_bwd``).  The kernels write through raw
    pointers, so without this Function their outputs carry no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = flash_fwd(q, k, v, causal=causal, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        dq, delta = flash_bwd_dq(q, k, v, o, do, lse, causal=ctx.causal)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal=ctx.causal)
        return dq, dk, dv, None


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------


def _heads_major(q, k, v, scale):
    """(B, T, H, D) q and (B, S, H, D) k, v -> (B*H, L, Dp) contiguous, D
    zero-padded to 64 or 128, q times scale*log2(e) rounded to q's dtype
    (the JAX package multiplies by that constant in q's dtype: the product
    of two values of q's dtype is exact in float32 and rounds once either
    way).  Returns (qf, kf, vf, Dp)."""
    B, T, H, D = q.shape
    S = k.shape[1]
    if D > 128:
        raise ValueError(f"head dim {D} > 128")
    scale = (1.0 / math.sqrt(D)) if scale is None else scale
    Dp = D if D in (64, 128) else (64 if D < 64 else 128)

    def prep(x, L):
        if Dp != D:
            x = torch.nn.functional.pad(x, (0, Dp - D))
        return x.permute(0, 2, 1, 3).reshape(B * H, L, Dp).contiguous()

    qs = q * float(torch.tensor(scale * LOG2E, dtype=q.dtype))
    return prep(qs, T), prep(k, S), prep(v, S), Dp


def flash_attention(q, k, v, *, causal=False, scale=None):
    """q (B, T, H, D); k, v (B, S, H, D).  Under autograd (grad enabled and
    any of q, k, v requiring grad) it runs :class:`FlashAttentionFn`, on
    every device.  Otherwise causal attention runs kernel A and non-causal
    kernel B, the inference forward (A with ``ONEPASS`` off, J with
    ``ONEPASS_T`` on); the grad path never takes kernel B or J, as in the
    JAX package."""
    B, T, H, D = q.shape
    qf, kf, vf, Dp = _heads_major(q, k, v, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        o = FlashAttentionFn.apply(qf, kf, vf, causal)
    elif causal or not ONEPASS:
        o, _ = flash_fwd(qf, kf, vf, causal=causal)
    elif ONEPASS_T:
        o = flash_fwd_1pass_t(qf, kf, vf).transpose(1, 2)
    else:
        o = flash_fwd_1pass(qf, kf, vf)
    return o.reshape(B, H, T, Dp).permute(0, 2, 1, 3)[..., :D]


def flash_attention_bias(q, k, v, bias, *, scale=None):
    """Inference-only flash attention with a precomputed additive bias, the
    port of ``flash_attention_bias``: kernel A, non-causal, with the bias in
    its exp2 domain (times log2(e) in float32).  q (B, T, H, D); k, v (B, S,
    H, D); bias (B*H or 1, T, S) float32 or bf16.  No gradient, as in the
    JAX package (which calls it from no entry point)."""
    B, T, H, D = q.shape
    qf, kf, vf, Dp = _heads_major(q, k, v, scale)
    b = (bias.float() * LOG2E).contiguous()
    o, _ = flash_fwd(qf, kf, vf, causal=False, bias=b)
    return o.reshape(B, H, T, Dp).permute(0, 2, 1, 3)[..., :D]


def attention(q, k, v, *, bias=None, causal=False, scale=None):
    """Dispatch on the tensors' device: see the module docstring."""
    min_t = 256 if causal else 2048
    if q.is_cuda and bias is None and q.shape[1] >= min_t:
        return flash_attention(q, k, v, causal=causal, scale=scale)
    return attention_plain(q, k, v, bias=bias, causal=causal, scale=scale)
