"""LLaVA: CLIP tower + linear projector + LLaMA with the image-token splice,
the counterpart of ``llmseg_tpu.models.llava``.

Sequence layout per row: [tok_0 .. tok_{p-1} | img_0 .. img_{N-1} | tok_p ..]
where p = image_pos (the placeholder token itself is consumed).  The splice
is one gather; the JAX package's one-hot einsums exist only for the TPU's
SPMD partitioner.  :func:`splice_labels` and :func:`causal_lm_loss` are the
language-model half of the training loss.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from llmseg_tpu_torch.config import LlavaConfig, LoraConfig, MptConfig
from llmseg_tpu_torch.models import vit
from llmseg_tpu_torch.models.llama import Llama, LlamaLora
from llmseg_tpu_torch.models.mpt import Mpt
from llmseg_tpu_torch.parallel import ddp

IGNORE_INDEX = -100


class Llava(nn.Module):
    """With ``mpt_cfg`` the language model is an ``Mpt`` (the reference's
    llava_mpt.py; :meth:`forward_mpt`) in place of the LLaMA."""

    def __init__(self, cfg: LlavaConfig, *, mpt_cfg: Optional[MptConfig] = None,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.vision_tower = vit.ViT(cfg.vision, **kw)
        llm_dim = cfg.llm.hidden_size if mpt_cfg is None else mpt_cfg.d_model
        self.mm_projector = nn.Linear(cfg.mm_hidden_size, llm_dim, **kw)
        self.llm = Llama(cfg.llm, **kw) if mpt_cfg is None else Mpt(mpt_cfg, **kw)

    def encode_images(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) CLIP input -> (B, N, llm_dim) projected tokens."""
        feats = vit.clip_features(self.vision_tower, images,
                                  select_layer=self.cfg.vision_select_layer)
        return self.mm_projector(feats)

    def forward(self, *, input_ids: torch.Tensor, image_pos: torch.Tensor,
                images: Optional[torch.Tensor] = None,
                image_embeds: Optional[torch.Tensor] = None,
                lora: Optional[LlamaLora] = None,
                lora_cfg: Optional[LoraConfig] = None, remat=False,
                quant_stats: Optional[list] = None) -> torch.Tensor:
        """Multimodal forward -> final hidden states (B, T+N-1, C).
        ``quant_stats``: SmoothQuant's calibration collector (``Llama``)."""
        if image_embeds is None:
            image_embeds = self.encode_images(images)
        text_embeds = self.llm.embed_tokens(input_ids)
        x = splice_image_tokens(text_embeds, image_embeds.to(text_embeds.dtype),
                                image_pos)
        return self.llm(inputs_embeds=x, lora=lora, lora_cfg=lora_cfg, remat=remat,
                        quant_stats=quant_stats)

    def forward_mpt(self, *, input_ids: torch.Tensor, image_pos: torch.Tensor,
                    images: Optional[torch.Tensor] = None,
                    image_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``llava.forward_mpt``: the same tower, projector and splice, the
        MPT decoder after them.  Final hidden states (B, T+N-1, d)."""
        if image_embeds is None:
            image_embeds = self.encode_images(images)
        text_embeds = self.llm.wte[input_ids]
        x = splice_image_tokens(text_embeds, image_embeds.to(text_embeds.dtype), image_pos)
        return self.llm(inputs_embeds=x)


def splice_image_tokens(text_embeds: torch.Tensor, image_embeds: torch.Tensor,
                        image_pos: torch.Tensor) -> torch.Tensor:
    """Insert the N image tokens at each row's placeholder position.

    text_embeds (B, T, C), image_embeds (B, N, C), image_pos (B,) int.
    Output index j takes text[j] for j < pos, image[j - pos] for
    pos <= j < pos + N, and text[j - N + 1] after.  Returns (B, T+N-1, C)."""
    B, T, C = text_embeds.shape
    N = image_embeds.shape[1]
    j = torch.arange(T + N - 1, device=text_embeds.device)[None, :]
    pos = image_pos.to(torch.long)[:, None]
    in_image = (j >= pos) & (j < pos + N)
    text_idx = torch.where(j < pos, j, j - N + 1).clamp(0, T - 1)
    img_idx = (j - pos).clamp(0, N - 1)
    text = torch.gather(text_embeds, 1, text_idx[..., None].expand(-1, -1, C))
    img = torch.gather(image_embeds, 1, img_idx[..., None].expand(-1, -1, C))
    return torch.where(in_image[..., None], img, text)


def splice_labels(labels: torch.Tensor, image_pos: torch.Tensor,
                  num_image_tokens: int) -> torch.Tensor:
    """The same splice for labels (B, T): the N image positions get
    IGNORE_INDEX.  Returns (B, T+N-1) in the labels' dtype."""
    B, T = labels.shape
    N = num_image_tokens
    j = torch.arange(T + N - 1, device=labels.device)[None, :]
    pos = image_pos.to(torch.long)[:, None]
    in_image = (j >= pos) & (j < pos + N)
    text_idx = torch.where(j < pos, j, j - N + 1).clamp(0, T - 1)
    gathered = torch.gather(labels, 1, text_idx.expand(B, -1))
    return torch.where(in_image, IGNORE_INDEX, gathered)


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Shifted cross entropy with IGNORE_INDEX masking, one mean over the
    valid targets; a batch without one gives 0 (the count is at least 1),
    where a mean-reducing cross entropy would give NaN.  Labels may arrive
    as int32.  In a data-parallel run the count is the global batch's
    (``ddp.global_sum``): each process's loss is its share of the global
    mean."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:].long()
    total = F.cross_entropy(shift_logits.reshape(-1, shift_logits.shape[-1]),
                            shift_labels.reshape(-1), ignore_index=IGNORE_INDEX,
                            reduction="sum")
    count = ddp.global_sum((shift_labels != IGNORE_INDEX).sum()).clamp_min(1)
    return total / count
