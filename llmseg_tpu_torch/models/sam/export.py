"""Serializable SAM decoder program, the counterpart of
``llmseg_tpu.models.sam.export`` (the reference's ONNX export,
model/segment_anything/utils/onnx.py:17-157, as a ``torch.export``
artifact).

The prompt encoder, the mask decoder on its plain route (the JAX
package's ``impl="xla"``: a serialized program keeps one set of numerics
and dtype whatever the prompt batch, where the fused kernels would switch
the mask logits to the image dtype from 8 prompts on) and the
postprocessing are staged into one program with the weights held in it.
Shapes (prompt batch, points per prompt, original image size) are fixed at
export; the caller passes raw click points and the padding point is
appended inside (predictor semantics).

Options mirror SamOnnxModel: ``return_single_mask`` (the num_points - 2.5
score reweighting, onnx.py:103-116), ``use_stability_score`` and
``return_extra_metrics``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from llmseg_tpu_torch.models.sam.sam import Sam
from llmseg_tpu_torch.ops import amg_utils

STABILITY_SCORE_OFFSET = 1.0   # onnx.py:38


class DecoderProgram(nn.Module):
    """The traceable decoder (SamOnnxModel.forward's counterpart).

    forward(image_embedding (1|B, S, S, D), point_coords (B, N, 2) input-frame
    pixels, point_labels (B, N) int32, mask_input (B, 4S, 4S, 1),
    has_mask_input ()) -> (masks, scores[, stability, areas], low_masks);
    masks are logits at ``orig_hw`` (the model's input frame when None)."""

    def __init__(self, model: Sam, *, return_single_mask: bool = False,
                 use_stability_score: bool = False, return_extra_metrics: bool = False,
                 orig_hw: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.cfg = model.cfg
        self.prompt_encoder = model.prompt_encoder
        self.mask_decoder = model.mask_decoder
        self.return_single_mask = return_single_mask
        self.use_stability_score = use_stability_score
        self.return_extra_metrics = return_extra_metrics
        self.orig_hw = orig_hw

    def forward(self, image_embedding, point_coords, point_labels, mask_input, has_mask_input):
        cfg = self.cfg
        n_points = point_coords.shape[1]
        pe_mod = self.prompt_encoder
        sparse, dense_m = pe_mod(points=point_coords, labels=point_labels, masks=mask_input)
        _, dense_nm = pe_mod(points=point_coords, labels=point_labels)
        w = has_mask_input.to(dense_m.dtype)
        dense = w * dense_m + (1.0 - w) * dense_nm
        pe = pe_mod.dense_pe(cfg.prompt.image_embedding_size)[None]
        masks, scores = self.mask_decoder.predict_masks(image_embedding, pe, sparse, dense,
                                                        impl="xla")

        if self.use_stability_score:                   # onnx.py:135-138
            scores = amg_utils.calculate_stability_score(masks, cfg.mask_threshold,
                                                         STABILITY_SCORE_OFFSET)
        if self.return_single_mask:                    # onnx.py:103-116
            nt = masks.shape[1]
            first = torch.arange(nt, device=scores.device) == 0
            score = scores + (n_points - 2.5) * torch.where(first, 1000.0, 0.0).to(scores.dtype)
            best = torch.argmax(score, 1)
            rows = torch.arange(masks.shape[0], device=masks.device)
            masks = masks[rows, best][:, None]
            scores = scores[rows, best][:, None]

        # postprocess to the input frame, and to the original size if given
        s = cfg.encoder.img_size
        up = amg_utils.resize_bilinear(masks, (s, s))
        if self.orig_hw is not None:
            scale = s / max(self.orig_hw)
            ph = int((self.orig_hw[0] * scale) + 0.5)
            pw = int((self.orig_hw[1] * scale) + 0.5)
            up = amg_utils.resize_bilinear(up[..., :ph, :pw], self.orig_hw)

        if self.return_extra_metrics:                  # onnx.py:141-146
            stab = amg_utils.calculate_stability_score(up, cfg.mask_threshold,
                                                       STABILITY_SCORE_OFFSET)
            areas = (up > cfg.mask_threshold).sum((-2, -1))
            return up, scores, stab, areas, masks
        return up, scores, masks


def decoder_args(model: Sam, *, batch: int = 1, n_points: int = 1, dtype=torch.float32):
    """Zero inputs of the decoder program's shapes, on the model's device."""
    S = model.cfg.prompt.image_embedding_size
    D = model.cfg.prompt.embed_dim
    dev = model.prompt_encoder.point_embeddings.device
    return (torch.zeros((1, S, S, D), dtype=dtype, device=dev),
            torch.zeros((batch, n_points, 2), dtype=dtype, device=dev),
            torch.zeros((batch, n_points), dtype=torch.int32, device=dev),
            torch.zeros((batch, 4 * S, 4 * S, 1), dtype=dtype, device=dev),
            torch.zeros((), dtype=dtype, device=dev))


def export_decoder(model: Sam, *, batch: int = 1, n_points: int = 1, dtype=torch.float32,
                   **options) -> torch.export.ExportedProgram:
    """Stage the decoder (``DecoderProgram``'s options) into a program,
    traced under ``no_grad``."""
    args = decoder_args(model, batch=batch, n_points=n_points, dtype=dtype)
    with torch.no_grad():
        return torch.export.export(DecoderProgram(model, **options), args)


def save_decoder(path: str, model: Sam, **kw) -> torch.export.ExportedProgram:
    exported = export_decoder(model, **kw)
    torch.export.save(exported, path)
    return exported


def load_decoder(path: str):
    """Load a saved decoder program; returns a callable.  Needs this package
    installed, not its model code."""
    fn = torch.export.load(path).module()

    def call(*args):
        with torch.no_grad():
            return fn(*args)
    return call
