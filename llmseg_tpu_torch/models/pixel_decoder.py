"""The legacy LISA pixel-decoder path, the counterpart of
``llmseg_tpu.models.pixel_decoder``: greedy generation with a KV cache, the
hidden state of the first generated [SEG] through the text projection, and
that embedding as a SAM text prompt (the prompt encoder's ``text_embeds``
pathway) against each row's own image embedding, then ``postprocess_masks``.

:func:`evaluate` is the composition of :func:`generate_answer`,
:func:`seg_prompts` and :func:`decode_seg_masks`, then the select of rows
without a [SEG] to -1e9.  On the card a batch of 8 or more images reaches
kernel A (the prefill), kernels E and F (the SAM encoder) and kernel H (the
decode, a base per prompt).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from llmseg_tpu_torch.config import LoraConfig
from llmseg_tpu_torch.device import require
from llmseg_tpu_torch.models import generate
from llmseg_tpu_torch.models.llava import splice_image_tokens
from llmseg_tpu_torch.models.llmseg import LLMSeg
from llmseg_tpu_torch.models.sam import sam as sam_lib


@torch.inference_mode()
def generate_answer(model: LLMSeg, *, images_clip: torch.Tensor, input_ids: torch.Tensor,
                    image_pos: torch.Tensor, max_new_tokens: int = 32,
                    lora_cfg: Optional[LoraConfig] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """CLIP, the image-token splice and greedy generation: (tokens (B, N),
    final-norm hidden states (B, N, C))."""
    llava = model.llava
    img = llava.encode_images(images_clip)
    text = llava.llm.embed_tokens(input_ids)
    x = splice_image_tokens(text, img.to(text.dtype), image_pos)
    return generate.greedy_generate(llava.llm, x, max_new_tokens, lora=model.lora,
                                    lora_cfg=lora_cfg)


@torch.inference_mode()
def seg_prompts(model: LLMSeg, tokens: torch.Tensor, hiddens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hidden state at each row's first generated [SEG] (the first
    position when there is none) through ``project_text``: (prompts (B,
    dim), has_seg (B,))."""
    is_seg = tokens == model.cfg.seg_token_id
    idx = is_seg.to(torch.int32).argmax(1)
    seg_hidden = hiddens[torch.arange(tokens.shape[0], device=tokens.device), idx]
    return model.select.project_text(seg_hidden), is_seg.any(1)


@torch.inference_mode()
def decode_seg_masks(sam_model: sam_lib.Sam, images_sam: torch.Tensor, prompts: torch.Tensor,
                     input_hw: Tuple[int, int], original_hw: Tuple[int, int]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SAM on each row's image with its prompt (B, dim) as one text token,
    the single-mask output: (mask logits (B, 1, *original_hw), iou (B, 1))."""
    emb = sam_lib.encode_image(sam_model, images_sam)
    masks, iou = sam_lib.decode_masks(sam_model, emb, text_embeds=prompts[:, None, :],
                                      multimask_output=False)
    return sam_lib.postprocess_masks(masks, input_hw, original_hw, sam_model.cfg), iou


@torch.inference_mode()
def evaluate(model: LLMSeg, sam_model: sam_lib.Sam, *, images_clip: torch.Tensor,
             images_sam: torch.Tensor, input_ids: torch.Tensor, image_pos: torch.Tensor,
             input_hw: Tuple[int, int], original_hw: Tuple[int, int],
             max_new_tokens: int = 32, lora_cfg: Optional[LoraConfig] = None,
             device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Generate an answer and decode the mask of its first [SEG].
    images_clip (B, 224, 224, 3); images_sam (B, 1024, 1024, 3)
    preprocessed; input_ids (B, T) with the image placeholder at image_pos.
    Returns (tokens (B, N), mask logits (B, *original_hw), -1e9 for rows
    without a [SEG]).  The models and tensors must live on ``device`` (the
    card by default)."""
    dev = require(device)
    for t in (next(model.parameters()), next(sam_model.parameters()), input_ids, images_sam):
        if t.device.type != dev.type:
            raise ValueError(f"expected tensors on {dev}, got {t.device}")
    tokens, hiddens = generate_answer(model, images_clip=images_clip, input_ids=input_ids,
                                      image_pos=image_pos, max_new_tokens=max_new_tokens,
                                      lora_cfg=lora_cfg)
    prompts, has_seg = seg_prompts(model, tokens, hiddens)
    pred, _ = decode_seg_masks(sam_model, images_sam, prompts, input_hw, original_hw)
    pred = torch.where(has_seg[:, None, None, None], pred, -1e9)
    return tokens, pred[:, 0]
