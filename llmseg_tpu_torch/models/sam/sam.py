"""SAM assembly, the counterpart of ``llmseg_tpu.models.sam.sam``:
preprocess -> image encoder -> prompt encoder -> mask decoder ->
postprocess, NHWC.  ``init`` builds a seeded random model on the card by
default and raises without CUDA unless the CPU is asked for.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from llmseg_tpu_torch.config import SamConfig, sam_vit_b, sam_vit_h, sam_vit_l
from llmseg_tpu_torch.device import require
from llmseg_tpu_torch.models.sam.image_encoder import ImageEncoder
from llmseg_tpu_torch.models.sam.mask_decoder import MaskDecoder
from llmseg_tpu_torch.models.sam.prompt_encoder import PromptEncoder
from llmseg_tpu_torch.ops import twoway_kernel
from llmseg_tpu_torch.ops.amg_utils import resize_bilinear

MODEL_REGISTRY = {
    "vit_h": sam_vit_h,
    "vit_l": sam_vit_l,
    "vit_b": sam_vit_b,
    "default": sam_vit_h,
}

_NORMAL = ("iou_token", "mask_tokens", "point_embeddings", "not_a_point_embed",
           "no_mask_embed", "gaussian")


class Sam(nn.Module):
    def __init__(self, cfg: SamConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.image_encoder = ImageEncoder(cfg.encoder, **kw)
        self.prompt_encoder = PromptEncoder(cfg.prompt, **kw)
        self.mask_decoder = MaskDecoder(cfg.decoder, **kw)


def build(cfg: SamConfig, *, device="cuda", dtype=torch.float32) -> Sam:
    """The module with uninitialised storage on ``device``."""
    return Sam(cfg, device="meta", dtype=dtype).to_empty(device=require(device))


@torch.no_grad()
def random_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's SAM initialisers, drawn from ``generator``:
    LeCun-normal dense and conv weights (std 1/sqrt(fan_in)), zero biases,
    unit norm scales, zero position embedding and rel-pos tables, standard
    normal tokens, prompt embeddings and Fourier matrix."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("pos_embed", "rel_pos_h", "rel_pos_w", "bias"):
            p.zero_()
        elif leaf in _NORMAL:
            p.normal_(0.0, 1.0, generator=generator)
        elif p.ndim == 1:
            p.fill_(1.0)
        else:
            p.normal_(0.0, float(np.prod(p.shape[1:])) ** -0.5, generator=generator)
    return model


def init(cfg: SamConfig, *, seed: int = 0, device="cuda", dtype=torch.float32) -> Sam:
    dev = require(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return random_init_(build(cfg, device=dev, dtype=dtype), gen)


def preprocess(x: torch.Tensor, cfg: SamConfig) -> torch.Tensor:
    """(B, H, W, 3) pixels -> normalised float32, zero-padded bottom/right
    to the square input."""
    mean = torch.tensor(cfg.pixel_mean, device=x.device)
    std = torch.tensor(cfg.pixel_std, device=x.device)
    x = (x.float() - mean) / std
    s = cfg.encoder.img_size
    return F.pad(x, (0, 0, 0, s - x.shape[2], 0, s - x.shape[1]))


def encode_image(model: Sam, x: torch.Tensor) -> torch.Tensor:
    """(B, img, img, 3) preprocessed -> (B, grid, grid, out_chans)."""
    return model.image_encoder(x)


def decode_masks(model: Sam, image_embedding: torch.Tensor, *, points=None, labels=None,
                 boxes=None, masks=None, text_embeds=None, multimask_output: bool = True,
                 cache=None):
    """An image embedding (1 or B, S, S, C) and a prompt batch -> (low-res
    mask logits (B, M, 4S, 4S), iou (B, M)).  Prompt batches of >= 8 on the
    card take kernel G and return the image dtype; others float32.
    ``cache``: a dict kept across prompt batches, which keeps what is the
    same for every batch of one image (the positional encoding, kernel G's
    recorded sequence) while its inputs are unchanged
    (``twoway_kernel.cached``)."""
    pe_mod = model.prompt_encoder
    sparse, dense = pe_mod(points=points, labels=labels, boxes=boxes, masks=masks,
                           text_embeds=text_embeds, batch=image_embedding.shape[0])
    size = model.cfg.prompt.image_embedding_size
    pe = twoway_kernel.cached(cache, "dense_pe", [pe_mod.pe.gaussian],
                              lambda _: pe_mod.dense_pe(size)[None], extra=(size,))
    return model.mask_decoder(image_embedding, pe, sparse, dense,
                              multimask_output=multimask_output,
                              dense_shared=masks is None, cache=cache)


def postprocess_masks(masks: torch.Tensor, input_hw: Tuple[int, int],
                      original_hw: Tuple[int, int], cfg: SamConfig) -> torch.Tensor:
    """Low-res logits (B, M, S, S) -> resize to the square input, crop the
    padding, resize to the original size (``jax.image.resize``'s bilinear,
    antialiased where it shrinks)."""
    s = cfg.encoder.img_size
    m = resize_bilinear(masks, (s, s))[..., :input_hw[0], :input_hw[1]]
    return resize_bilinear(m, original_hw)


def forward(model: Sam, image: torch.Tensor, *, points=None, labels=None, boxes=None,
            multimask_output: bool = True):
    """Promptable segmentation of one preprocessed image batch."""
    emb = encode_image(model, preprocess(image, model.cfg))
    return decode_masks(model, emb, points=points, labels=labels, boxes=boxes,
                        multimask_output=multimask_output)
