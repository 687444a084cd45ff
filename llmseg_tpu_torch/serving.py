"""Serving artifacts: the full LLM-Seg inference program as a
``torch.export`` program, the counterpart of ``llmseg_tpu.serving``.

``torch.export`` stages ``llmseg.forward`` (CLIP -> splice -> LLaMA ->
[SEG] gather -> DINOv2 pooling -> selection head) under ``no_grad``, with
the model's weights (bf16, or a LLaMA quantized in place to W8A8) held in
the artifact, so a deployment loads one file and calls it on a batch dict.
One program per deployment shape (images x rows x text length), as the
JAX package exports one per shape.

The program keeps the route that the model's tensors take: on the card it
calls the port's kernels as the custom ops ``llmseg::flash_fwd`` (A, one a
LLaMA layer), ``llmseg::flash_fwd_1pass`` (B, one a DINOv2 block; J's
``llmseg::flash_fwd_1pass_t`` with ``LLMSEG_ATTN_ONEPASS_T=1``) and, in
W8A8, ``llmseg::quantize_rows`` and ``llmseg::w8a8_linear`` (Q1, Q2).  The
attention flags ``LLMSEG_ATTN_ONEPASS`` / ``_T`` are read when
``ops.attention`` is imported, so the route they pick is baked into the
artifact.  Loading one therefore needs this package installed, which
registers the ops (:func:`load_predict` imports it); the JAX package's
artifact needs only jax.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from llmseg_tpu_torch.config import LLMSegConfig, LoraConfig
from llmseg_tpu_torch.models import llmseg

OUTPUTS = ("pred_similarity", "pred_iou", "prop_valid", "row_valid")


def predict_arg_shapes(cfg: LLMSegConfig, *, num_images: int = 1, rows: int = 1,
                       text_len: int = 512, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The batch contract of ``llmseg.predict`` as meta tensors."""
    B, R, K, G = num_images, rows, cfg.max_proposals, cfg.seg_grid
    lv = cfg.llava

    def f(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")

    return {
        "images_dino": f((B, cfg.dino.img_size, cfg.dino.img_size, 3), dtype),
        "images_clip": f((B, lv.vision.img_size, lv.vision.img_size, 3), dtype),
        "input_ids": f((R, text_len), torch.int32),
        "image_pos": f((R,), torch.int32),
        "row_to_image": f((R,), torch.int32),
        "row_valid": f((R,), torch.bool),
        "sam_segs": f((B, K, G, G), dtype),
        "prop_valid": f((B, K), torch.bool),
    }


class PredictProgram(nn.Module):
    """``predict``'s outputs from ``llmseg.forward``, traced under
    ``no_grad`` (``predict`` itself runs under ``inference_mode`` and checks
    devices, which a traced program does not need)."""

    def __init__(self, model: llmseg.LLMSeg, *, pool: str = "adjoint",
                 lora_cfg: Optional[LoraConfig] = None):
        super().__init__()
        self.model = model
        self.pool = pool
        self.lora_cfg = lora_cfg

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = llmseg.forward(self.model, batch, pool=self.pool, lora_cfg=self.lora_cfg)
        return {"pred_similarity": out["similarity"], "pred_iou": out["pred_iou"],
                "prop_valid": out["prop_valid"], "row_valid": out["row_valid"]}


def export_predict(model: llmseg.LLMSeg, *, num_images: int = 1, rows: int = 1,
                   text_len: int = 512, dtype=torch.bfloat16, pool: str = "adjoint",
                   lora_cfg: Optional[LoraConfig] = None) -> torch.export.ExportedProgram:
    """Export ``predict`` at one batch shape, on the device the model lies
    on, with its weights in the program.  Traced under ``no_grad``, so the
    program holds the inference forward (kernel B or J for DINOv2, never
    the autograd function around kernel A)."""
    shapes = predict_arg_shapes(model.cfg, num_images=num_images, rows=rows,
                                text_len=text_len, dtype=dtype)
    dev = next(model.parameters()).device
    batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev) for k, v in shapes.items()}
    with torch.no_grad():
        return torch.export.export(PredictProgram(model, pool=pool, lora_cfg=lora_cfg),
                                   (batch,))


def save_predict(path: str, model: llmseg.LLMSeg, **kw) -> torch.export.ExportedProgram:
    """Export (``export_predict``'s keywords) and write the artifact."""
    exported = export_predict(model, **kw)
    torch.export.save(exported, path)
    return exported


def load_predict(path: str):
    """Load a saved predict program; returns batch dict -> outputs dict.
    Needs this package (its kernels' ops), not its model code."""
    fn = torch.export.load(path).module()

    def call(batch):
        with torch.no_grad():
            return fn(batch)
    return call
