"""Attention with SAM's decomposed relative-position bias: the plain path
and kernels E and F.

Counterpart of ``llmseg_tpu.ops.relpos_attention``.  The bias of query
(h, w) and key (h', w') on a G x G token grid is

    bias = rh[(h, w), h'] + rw[(h, w), w'],
    rh[(h, w), h'] = q[(h, w)] . Rh[h, h'],  rw[(h, w), w'] = q[(h, w)] . Rw[w, w']

from the UNSCALED q.  :func:`relpos_tables` computes the two (T, G) tables,
scales them by log2(e) and rounds them to q's dtype, as the JAX package
does; q is then pre-scaled by scale*log2(e) in its own dtype, and the
kernels work in the exp2 domain and never materialise the (T, T) bias.

* :func:`relpos_fwd` (kernel E, ``csrc/relpos_fwd.cu``): online-softmax
  flash forward, the port of ``_kernel``; grids of T > 512.
* :func:`relpos_window` (kernel F, ``csrc/relpos_window.cu``): exact row
  max, p normalised and rounded before the PV product, the port of
  ``_window_kernel``; grids of T <= 512.

Both wrappers take (B*H, T, D) tensors; for a CUDA tensor they launch
their kernel or raise, and only a tensor on the CPU goes to the plain
version beside each (:func:`relpos_fwd_plain`, :func:`relpos_window_plain`).
"""

from __future__ import annotations

import math

import torch

from llmseg_tpu_torch.ops.attention import LOG2E
from llmseg_tpu_torch.ops.kernels import Kernel

RELPOS_FWD = Kernel("relpos_fwd")         # kernel E, csrc/relpos_fwd.cu
RELPOS_WINDOW = Kernel("relpos_window")   # kernel F, csrc/relpos_window.cu
KERNELS = (RELPOS_FWD, RELPOS_WINDOW)
WINDOW_MAX_T = 512                        # the JAX dispatch: T <= 512 -> F


def rel_pos_table(rel_pos: torch.Tensor, q_size: int, k_size: int) -> torch.Tensor:
    """(2*max(q, k)-1, D) table -> (q_size, k_size, D); q_size == k_size."""
    if rel_pos.shape[0] != 2 * max(q_size, k_size) - 1:
        raise ValueError(f"rel_pos table {rel_pos.shape[0]} != {2 * max(q_size, k_size) - 1}")
    q_coords = torch.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long().to(rel_pos.device)]


def decomposed_rel_pos_bias(q: torch.Tensor, rel_pos_h: torch.Tensor,
                            rel_pos_w: torch.Tensor, hw: int) -> torch.Tensor:
    """q (B, heads, hw*hw, D) -> float32 bias (B, heads, hw*hw, hw*hw)."""
    B, H, _, D = q.shape
    Rh = rel_pos_table(rel_pos_h, hw, hw).float()
    Rw = rel_pos_table(rel_pos_w, hw, hw).float()
    qr = q.reshape(B, H, hw, hw, D).float()
    rel_h = torch.einsum("bnhwc,hkc->bnhwk", qr, Rh)
    rel_w = torch.einsum("bnhwc,wkc->bnhwk", qr, Rw)
    bias = rel_h[..., :, None] + rel_w[..., None, :]
    return bias.reshape(B, H, hw * hw, hw * hw)


def relpos_tables(q: torch.Tensor, rel_pos_h: torch.Tensor, rel_pos_w: torch.Tensor,
                  G: int):
    """q (B, T, H, D) unscaled -> (rh, rw), each (B*H, T, G) in q's dtype,
    log2(e)-scaled."""
    B, T, H, D = q.shape
    Rh = rel_pos_table(rel_pos_h, G, G).to(q.dtype).float()
    Rw = rel_pos_table(rel_pos_w, G, G).to(q.dtype).float()
    qg = q.reshape(B, G, G, H, D).float()
    rh = torch.einsum("bhwnd,hkd->bnhwk", qg, Rh)
    rw = torch.einsum("bhwnd,wkd->bnhwk", qg, Rw)
    return ((rh.reshape(B * H, T, G) * LOG2E).to(q.dtype).contiguous(),
            (rw.reshape(B * H, T, G) * LOG2E).to(q.dtype).contiguous())


def _logits(q, k, rh, rw):
    """float32 exp2-domain logits with the bias, (BH, T, T)."""
    G = rh.shape[-1]
    key = torch.arange(q.shape[1], device=q.device)
    s = torch.matmul(q.float(), k.float().transpose(1, 2))
    return s + rh.float()[:, :, key // G] + rw.float()[:, :, key % G]


def relpos_fwd_plain(q, k, v, rh, rw):
    """Kernel E's function.  q (BH, T, D) pre-scaled; k, v (BH, T, D);
    rh, rw (BH, T, G).  p is rounded to v's dtype before the PV product
    and the row divided by its float32 sum after it."""
    s = _logits(q, k, rh, rw)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    return (torch.matmul(p.to(v.dtype).float(), v.float()) / l).to(q.dtype)


def relpos_window_plain(q, k, v, rh, rw):
    """Kernel F's function: p normalised, then rounded, then times v."""
    s = _logits(q, k, rh, rw)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def _check(q, k, v, rh, rw) -> None:
    BH, T, D = q.shape
    G = rh.shape[-1]
    if k.shape != q.shape or v.shape != q.shape or T != G * G \
            or rh.shape != (BH, T, G) or rw.shape != (BH, T, G):
        raise ValueError(f"expected q/k/v (BH, G*G, D) and rh/rw (BH, G*G, G); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(rh.shape)}, {tuple(rw.shape)}")
    for t in (q, k, v, rh, rw):
        if not t.is_cuda or t.dtype != q.dtype or q.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"expected CUDA tensors of one dtype, bf16 or float32; "
                             f"got {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("inputs must be contiguous and 16-byte aligned")
    if q.dtype == torch.bfloat16 and D not in (16, 32, 64, 80, 128):
        raise ValueError(f"bf16 head dim {D} not in (16, 32, 64, 80, 128)")
    if D > 128 or G > 64:
        raise ValueError(f"head dim {D} > 128 or grid {G} > 64")


def _launch(kern: Kernel, q, k, v, rh, rw) -> torch.Tensor:
    _check(q, k, v, rh, rw)
    BH, T, D = q.shape
    o = torch.empty_like(q)
    kern.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), rh.data_ptr(), rw.data_ptr(),
                o.data_ptr(), BH, T, rh.shape[-1], D, int(q.dtype == torch.bfloat16))
    return o


def relpos_fwd(q, k, v, rh, rw) -> torch.Tensor:
    """Kernel E wrapper.  Shapes as :func:`relpos_fwd_plain`."""
    if q.device.type == "cpu":
        return relpos_fwd_plain(q, k, v, rh, rw)
    return _launch(RELPOS_FWD, q, k, v, rh, rw)


def relpos_window(q, k, v, rh, rw) -> torch.Tensor:
    """Kernel F wrapper.  Shapes as :func:`relpos_window_plain`."""
    if q.device.type == "cpu":
        return relpos_window_plain(q, k, v, rh, rw)
    if q.shape[1] > WINDOW_MAX_T:
        raise ValueError(f"T = {q.shape[1]} > {WINDOW_MAX_T}: kernel E's grid")
    return _launch(RELPOS_WINDOW, q, k, v, rh, rw)


def relpos_flash_attention(q, k, v, rel_pos_h, rel_pos_w, grid_g: int, *,
                           scale=None) -> torch.Tensor:
    """q/k/v (B, T, H, D) with T == grid_g**2; rel_pos_h/w (2G-1, D).
    Returns (B, T, H, D): kernel F for T <= 512, else kernel E."""
    B, T, H, D = q.shape
    G = grid_g
    if T != G * G:
        raise ValueError(f"T = {T} is not {G}^2")
    scale = (1.0 / math.sqrt(D)) if scale is None else scale
    rh, rw = relpos_tables(q, rel_pos_h, rel_pos_w, G)
    qs = q * torch.tensor(scale * LOG2E, dtype=q.dtype, device=q.device)

    def prep(x):
        return x.permute(0, 2, 1, 3).reshape(B * H, T, D).contiguous()

    run = relpos_window if T <= WINDOW_MAX_T else relpos_fwd
    o = run(prep(qs), prep(k), prep(v), rh, rw)
    return o.reshape(B, H, T, D).permute(0, 2, 1, 3)
