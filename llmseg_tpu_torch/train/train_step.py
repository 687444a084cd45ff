"""The train step, the counterpart of
``llmseg_tpu.train.train_step.make_partitioned_train_step``: loss, gradients
of the trainable subset, and the optimizer's update; and the eval step,
``make_eval_step``'s."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from llmseg_tpu_torch.config import LoraConfig
from llmseg_tpu_torch.models import llmseg
from llmseg_tpu_torch.train.optim import TrainableOptimizer, global_norm


def train_step(model: llmseg.LLMSeg, opt: TrainableOptimizer, batch: Dict, *,
               lora_cfg: Optional[LoraConfig] = None, remat="dots",
               pool: str = "adjoint") -> Dict[str, torch.Tensor]:
    """One micro-step.  Returns the loss terms and ``grad_norm``, the global
    norm of this micro-step's gradient (before accumulation and clipping),
    as 0-d tensors on the model's device."""
    loss, aux = llmseg.loss_fn(model, batch, pool=pool, lora_cfg=lora_cfg, remat=remat)
    loss.backward()
    grad_norm = global_norm(p.grad for p in opt.params.values() if p.grad is not None)
    opt.step(grad_norm)
    return {**{k: v.detach() for k, v in aux.items()}, "grad_norm": grad_norm}


def eval_step(model: llmseg.LLMSeg, batch: Dict, *, lora_cfg: Optional[LoraConfig] = None,
              pool: str = "adjoint") -> Dict[str, torch.Tensor]:
    """``predict`` on the model's device, without autograd: the scores that
    ``evaluate.run_validation`` reads."""
    device = next(model.parameters()).device
    return llmseg.predict(model, batch, device=device, pool=pool, lora_cfg=lora_cfg)
