"""Training objectives of the selection head, the counterpart of
``llmseg_tpu.losses`` (``softmax_align_loss`` and ``iou_regression_loss``).

The JAX functions take one conversation row and are ``vmap``-ed over rows;
these take any leading batch dimensions and return one loss per row.  Every
loss takes a validity mask, so padded proposals never contribute.  The
legacy pixel-decoder losses (sigmoid alignment, DICE, BCE) are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch


def softmax_align_loss(proposal_embeds: torch.Tensor, target_embed: torch.Tensor,
                       gt_ious: torch.Tensor, valid: Optional[torch.Tensor] = None,
                       temperature: float = 0.05) -> torch.Tensor:
    """KL(softmax(gt_iou / T) || softmax(cos_sim / T)) over the K proposals,
    summed.  proposal_embeds (..., K, D), target_embed (..., D), gt_ious and
    valid (..., K) -> (...).  Invalid proposals leave both softmaxes."""
    p = proposal_embeds.float()
    t = target_embed.float()
    p = p / (torch.linalg.vector_norm(p, dim=-1, keepdim=True) + 1e-8)
    t = t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-8)
    sim_l = torch.einsum("...kd,...d->...k", p, t) / temperature
    gt_l = gt_ious.float() / temperature
    if valid is not None:
        sim_l = torch.where(valid, sim_l, -1e9)
        gt_l = torch.where(valid, gt_l, -1e9)
    log_sim = torch.log_softmax(sim_l, dim=-1)
    log_gt = torch.log_softmax(gt_l, dim=-1)
    kl = torch.softmax(gt_l, dim=-1) * (log_gt - log_sim)
    if valid is not None:
        kl = torch.where(valid, kl, 0.0)
    return kl.sum(-1)


def iou_regression_loss(pred_ious: torch.Tensor, gt_ious: torch.Tensor,
                        valid: Optional[torch.Tensor] = None, weighted: bool = True,
                        scale: float = 50.0) -> torch.Tensor:
    """Weighted MSE on IoP: err * exp(gt - 1), mean over the valid
    proposals, times ``scale``.  (..., K) -> (...)."""
    gt = gt_ious.float()
    err = (pred_ious.float() - gt).square()
    if not weighted:
        if valid is not None:
            err = torch.where(valid, err, 0.0)
        return err.sum(-1)
    err = err * torch.exp(gt - 1.0)
    if valid is not None:
        err = torch.where(valid, err, 0.0)
        denom = valid.float().sum(-1).clamp_min(1.0)
    else:
        denom = err.shape[-1]
    return err.sum(-1) / denom * scale
