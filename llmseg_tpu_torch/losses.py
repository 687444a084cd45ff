"""Training objectives, the counterpart of ``llmseg_tpu.losses``: the
selection head's ``softmax_align_loss`` and ``iou_regression_loss``, and
the legacy ones that nothing calls (the reference's loss.py, kept for
parity): the SigLIP-style ``sigmoid_align_loss`` and the pixel decoder's
``dice_loss`` and ``sigmoid_ce_loss``.

The JAX alignment and regression functions take one conversation row and
are ``vmap``-ed over rows; these take any leading batch dimensions and
return one loss per row.  Every alignment and regression loss takes a
validity mask, so padded proposals never contribute.
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


def sigmoid_align_loss(proposal_embeds: torch.Tensor, target_embed: torch.Tensor,
                       gt_ious: torch.Tensor, temperature: torch.Tensor,
                       bias: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SigLIP-style pairwise sigmoid alignment (reference loss.py:97-129):
    logits = cos_sim * exp(temperature) + bias (``temperature`` is a log
    scale), soft labels z = 2 iou - 1, loss -log(sigmoid(z logits) + 1e-8)
    summed over the valid proposals.  proposal_embeds (..., K, D),
    target_embed (..., D), gt_ious and valid (..., K) -> (...)."""
    p = proposal_embeds.float()
    t = target_embed.float()
    p = p / (torch.linalg.vector_norm(p, dim=-1, keepdim=True) + 1e-8)
    t = t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-8)
    sim = torch.einsum("...kd,...d->...k", p, t)
    logits = sim * torch.exp(torch.as_tensor(temperature, dtype=torch.float32)) + bias
    z = 2.0 * gt_ious.float() - 1.0
    loss = -torch.log(torch.sigmoid(z * logits) + 1e-8)
    if valid is not None:
        loss = torch.where(valid, loss, 0.0)
    return loss.sum(-1)


def dice_loss(inputs: torch.Tensor, targets: torch.Tensor, num_masks,
              scale: float = 1000.0, eps: float = 1e-6) -> torch.Tensor:
    """DICE on mask logits (reference loss.py:4-27), summed over the masks
    and divided by ``num_masks``.  inputs, targets (N, H*W) -> ()."""
    x = torch.sigmoid(inputs.float())
    t = targets.float()
    numerator = 2 * (x / scale * t).sum(-1)
    denominator = (x / scale).sum(-1) + (t / scale).sum(-1)
    loss = 1 - (numerator + eps) / (denominator + eps)
    return loss.sum() / (num_masks + 1e-8)


def sigmoid_ce_loss(inputs: torch.Tensor, targets: torch.Tensor, num_masks) -> torch.Tensor:
    """Per-pixel binary cross entropy on mask logits (reference
    loss.py:30-47), the mean over pixels summed over the masks and divided
    by ``num_masks``.  inputs, targets (N, H*W) -> ()."""
    x = inputs.float()
    t = targets.float()
    loss = x.clamp_min(0) - x * t + torch.log1p(torch.exp(-x.abs()))
    return loss.mean(-1).sum() / (num_masks + 1e-8)
