"""LLaVA supervised finetuning, the counterpart of ``llmseg_tpu.train.sft``
(the reference's model/llava/train/train.py ``train()``).

The reference's two parameter regimes, and full SFT, as a trainable mask
over the model's parameter names (:func:`sft_trainable_mask`, given to
``optim.partition``):
  * ``tune_mm_mlp_adapter`` (feature-alignment pretraining,
    train.py:963-971): only the projector trains;
  * ``lora_enable`` (instruction SFT, train.py:897-915): LoRA on LLaMA's
    q/v projections and the projector;
  * neither: the LLM, LoRA and the projector.
The CLIP tower never trains.  The loss is the causal-LM objective over the
spliced sequence (:func:`sft_loss`).  LLaMA's causal attention over the
spliced sequence runs on kernel A forward (and its recompute under remat)
and kernels C and D backward on the card.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from llmseg_tpu_torch.config import LlavaConfig, LoraConfig, TrainConfig
from llmseg_tpu_torch.device import require
from llmseg_tpu_torch.models import llama, llava
from llmseg_tpu_torch.models.llama import LlamaLora
from llmseg_tpu_torch.models.llava import Llava
from llmseg_tpu_torch.parallel import ddp
from llmseg_tpu_torch.train.optim import TrainableOptimizer, global_norm


class LlavaSFT(Llava):
    """``Llava`` plus an optional ``LlamaLora`` overlay: the JAX package's
    ``llava.init`` tree with a ``"lora"`` key (``from_jax.load_`` loads such
    a tree as it is)."""

    def __init__(self, cfg: LlavaConfig, lora_cfg: Optional[LoraConfig] = None, *,
                 device=None, dtype=None):
        super().__init__(cfg, device=device, dtype=dtype)
        self.lora = (None if lora_cfg is None
                     else LlamaLora(cfg.llm, lora_cfg, device=device, dtype=dtype))


def init(cfg: LlavaConfig, *, seed: int = 0, device="cuda", dtype=torch.float32,
         lora_cfg: Optional[LoraConfig] = None) -> LlavaSFT:
    """A randomly initialised SFT model on ``device`` (the card by default),
    with the JAX package's initialisers (``llmseg.random_init_``)."""
    from llmseg_tpu_torch.models.llmseg import random_init_

    dev = require(device)
    model = LlavaSFT(cfg, lora_cfg, device="meta", dtype=dtype).to_empty(device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return random_init_(model, gen)


def sft_trainable_mask(model: torch.nn.Module, *, tune_mm_mlp_adapter: bool = False,
                       lora_enable: bool = False) -> Dict[str, bool]:
    """{parameter name: trainable} for ``optim.partition``."""
    def trains(name: str) -> bool:
        if name.startswith("mm_projector."):
            return True
        if lora_enable and name.startswith("lora."):
            return True
        if not tune_mm_mlp_adapter and not lora_enable:   # full SFT
            return name.startswith(("llm.", "lora."))
        return False

    return {name: trains(name) for name, _ in model.named_parameters()}


def sft_loss(model: LlavaSFT, batch: Dict[str, torch.Tensor], *,
             lora_cfg: Optional[LoraConfig] = None, remat=False) -> torch.Tensor:
    """The causal-LM loss over the spliced sequence.  batch: images_clip (B,
    H, W, 3), input_ids (B, T), labels (B, T), image_pos (B,), has_image
    (B,).  A text-only row's image embeddings are zeroed (the collator
    parked its splice in the padded tail)."""
    cfg = model.cfg
    image_embeds = model.encode_images(batch["images_clip"])
    image_embeds = image_embeds * batch["has_image"].to(image_embeds.dtype)[:, None, None]
    hidden = model(input_ids=batch["input_ids"], image_pos=batch["image_pos"],
                   image_embeds=image_embeds, lora=model.lora, lora_cfg=lora_cfg,
                   remat=remat)
    logits = llama.logits(model.llm, hidden)
    labels = llava.splice_labels(batch["labels"], batch["image_pos"], cfg.num_image_tokens)
    return llava.causal_lm_loss(logits, labels)


def make_sft_train_step(cfg: TrainConfig, trainable: Dict[str, torch.nn.Parameter], *,
                        lora_cfg: Optional[LoraConfig] = None, remat="full"):
    """``make_sft_train_step`` with the port's optimizer: returns (step,
    optimizer); ``step(model, batch)`` runs one micro-step (clip, AdamW,
    warmup-decay, accumulation as ``TrainableOptimizer``) and returns
    ``ce_loss`` and ``grad_norm`` (the global norm of the raw gradients) as
    0-d tensors.  JAX's ``remat=True`` is "full".  In a data-parallel run
    the gradients are summed over the processes (``parallel/ddp.py``: each
    loss is a share of the global batch's) and ``ce_loss`` is the global
    one."""
    opt = TrainableOptimizer(cfg, trainable)

    def step(model: LlavaSFT, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        loss = sft_loss(model, batch, lora_cfg=lora_cfg, remat=remat)
        loss.backward()
        ddp.all_reduce_grads(trainable.values())
        grad_norm = global_norm(p.grad for p in trainable.values() if p.grad is not None)
        opt.step(grad_norm)
        return {"ce_loss": ddp.global_sum(loss.detach()), "grad_norm": grad_norm}

    return step, opt
