"""Top-level LLM-Seg model, the counterpart of ``llmseg_tpu.models.llmseg``:

  * images -> DINOv2 patch features -> 1x1 projection -> proposal pooling
  * LLaVA forward -> hidden state left of the first [SEG] token -> text
    projection
  * selection head -> per-proposal similarity and IoP
  * losses (training): LLaVA CE + KL alignment + weighted-MSE IoP regression

Batch keys (B images, R conversation rows, K proposals, T text tokens,
G seg_grid): images_dino (B, 896, 896, 3), images_clip (B, 224, 224, 3),
input_ids (R, T), image_pos (R,), row_to_image (R,), row_valid (R,) bool,
sam_segs (B, K, G, G) soft masks, prop_valid (B, K) bool.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from llmseg_tpu_torch import losses as LS
from llmseg_tpu_torch.config import LLMSegConfig, LoraConfig, require_ported
from llmseg_tpu_torch.device import require
from llmseg_tpu_torch.models import llama, llava, vit
from llmseg_tpu_torch.models.llama import LlamaLora
from llmseg_tpu_torch.models.llava import Llava
from llmseg_tpu_torch.models.selection_head import SelectionHead, mask_pooling
from llmseg_tpu_torch.parallel import ddp
from llmseg_tpu_torch.parallel import mesh as M
from llmseg_tpu_torch.utils import profiling

POOL_ROUTES = ("adjoint", "unfused")


class LLMSeg(nn.Module):
    mesh: Optional[M.Mesh] = None     # set by parallel.mesh.shard_params

    def __init__(self, cfg: LLMSegConfig, lora_cfg: Optional[LoraConfig] = None,
                 *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.llava = Llava(cfg.llava, **kw)
        self.dino = vit.ViT(cfg.dino, **kw)
        self.select = SelectionHead(cfg.select, **kw)
        if lora_cfg is not None:
            require_ported(cfg.llava.llm, "lora")
        self.lora = (None if lora_cfg is None
                     else LlamaLora(cfg.llava.llm, lora_cfg, **kw))


def build(cfg: LLMSegConfig, *, device, dtype=torch.float32,
          lora_cfg: Optional[LoraConfig] = None) -> LLMSeg:
    """The module with uninitialised storage on ``device``."""
    model = LLMSeg(cfg, lora_cfg, device="meta", dtype=dtype)
    return model.to_empty(device=require(device))


@torch.no_grad()
def random_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's initialisers, drawn from ``generator``: LeCun-normal
    weights (std 1/sqrt(fan_in)), zero biases, unit norm scales, truncated
    normal (std 0.02) token / position / cls embeddings (MPT's ``wte`` and
    ``wpe`` too), LayerScale 1e-5,
    LoRA B zero; a router's correction bias (a buffer) zero."""
    for name, b in model.named_buffers():
        if name.endswith("correction_bias"):
            b.zero_()
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith("embed_tokens.weight") or leaf in ("pos_embed", "cls_token", "wte",
                                                            "wpe"):
            tmp = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            p.copy_(nn.init.trunc_normal_(tmp, std=0.02, a=-0.04, b=0.04,
                                          generator=generator))
        elif leaf in ("ls1", "ls2"):
            p.fill_(1e-5)
        elif name.startswith("lora.") and name.endswith(".b.weight"):
            p.zero_()
        elif leaf == "bias":
            p.zero_()
        elif p.ndim == 1:
            p.fill_(1.0)
        else:
            p.normal_(0.0, float(np.prod(p.shape[1:])) ** -0.5, generator=generator)
    return model


def init(cfg: LLMSegConfig, *, seed: int = 0, device="cuda",
         dtype=torch.float32, lora_cfg: Optional[LoraConfig] = None) -> LLMSeg:
    """A randomly initialised model on ``device`` (the card by default)."""
    dev = require(device)
    model = build(cfg, device=dev, dtype=dtype, lora_cfg=lora_cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return random_init_(model, gen)


def fold_frozen_inplace(model: LLMSeg) -> LLMSeg:
    """Inference-time exact reparameterisation of the frozen towers: the
    DINOv2 LayerScale fold."""
    vit.fold_layerscale_inplace(model.dino)
    return model


@torch.inference_mode()
def calibrate_quant_stats(model: LLMSeg, batch, lora_cfg: Optional[LoraConfig] = None):
    """Forwards on calibration data that record, per LLaMA layer, the
    column max |input| of every quantized product's site (SmoothQuant's
    statistic; run on the bf16 model before ``ops.quant.quantize_llama_inplace
    (smooth_stats=...)``).  ``batch`` is one batch dict or an iterable of
    them; several are merged by elementwise max.  Returns a list of dicts
    of float32 tensors on the model's device, or None for an empty
    iterable.  On a mesh (``model.mesh``) each rank sees its data rank's
    rows: the o and down sites' columns of this rank's heads and MLP
    block are gathered over tp in rank order, and every site's maxima are
    taken over the data group, so that every rank holds one process's
    statistics of the global batch (a max is exact in any order)."""
    if isinstance(batch, dict):
        batch = (batch,)
    merged = None
    for b in batch:
        st: list = []
        forward(model, b, lora_cfg=lora_cfg, quant_stats=st)
        merged = st if merged is None else [
            {k: torch.maximum(m[k], s[k]) for k in m} for m, s in zip(merged, st)]
    mesh = getattr(model, "mesh", None)
    if merged is None or mesh is None or mesh.data is None:
        return merged
    out = []
    for layer in merged:
        st = {}
        for k, v in layer.items():
            if k in ("o_in", "down_in") and mesh.tp > 1:
                v = M.all_gather(v, 0, mesh.groups["tp"], mesh.tp)
            st[k] = M.all_reduce_max(v, mesh.data) if mesh.data_size > 1 else v
        out.append(st)
    return out


def _interp_matrix(n_in: int, n_out: int, device="cpu") -> torch.Tensor:
    """(n_out, n_in) float32 bilinear weights: half-pixel sample coordinates,
    triangle kernel, edge rows renormalised (jax.image.resize('bilinear')
    applied to the identity).  Computed in float64 on ``device`` by tensor
    operations, so that an exported program computes it rather than holding
    a host constant; each row has at most two nonzero taps, so its sum, and
    the matrix, are the same in any summation order."""
    f64 = dict(dtype=torch.float64, device=device)
    x = (torch.arange(n_out, **f64) + 0.5) / torch.full((n_out,), n_out / n_in, **f64) - 0.5
    i = torch.arange(n_in, **f64)
    w = (1.0 - (x[:, None] - i[None, :]).abs()).clamp_min(0.0)
    return (w / w.sum(-1, keepdim=True)).float()


def _bilinear_upsample(fmap: torch.Tensor, out: int) -> torch.Tensor:
    """float32 bilinear (B, g, g, C) -> (B, out, out, C) as two separable
    products with the (out, g) interpolation matrix."""
    M = _interp_matrix(fmap.shape[1], out, fmap.device)
    t = torch.einsum("oh,bhwd->bowd", M, fmap)
    return torch.einsum("ow,bhwd->bhod", M, t)


def _frozen_dino(model: LLMSeg, images: torch.Tensor) -> torch.Tensor:
    """DINOv2 patch features with no gradient (the tower is frozen: the
    JAX package's stop_gradient); the projection after it trains."""
    with torch.no_grad():
        return vit.dino_patch_features(model.dino, images)


def dino_features(model: LLMSeg, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, seg_grid^2, dim): projected features, float32
    bilinear upsample to seg_grid (the unfused route)."""
    cfg = model.cfg
    feats = model.select.project_dino(_frozen_dino(model, images))
    B, _, D = feats.shape
    g = cfg.dino.grid
    fmap = _bilinear_upsample(feats.reshape(B, g, g, D).float(), cfg.seg_grid)
    return fmap.reshape(B, cfg.seg_grid * cfg.seg_grid, D).to(feats.dtype)


def _pool_dino_proposals(model: LLMSeg, batch: Dict) -> torch.Tensor:
    """Mask pooling with the adjoint of the upsample on the masks:
    segs @ upsample(F) == (upsample^T segs) @ F, so the seg_grid^2 x dim
    feature map is never formed.  The denominator is the full-resolution
    mask area."""
    cfg = model.cfg
    feats = model.select.project_dino(_frozen_dino(model, batch["images_dino"]))
    B = feats.shape[0]
    g = cfg.dino.grid
    segs = batch["sam_segs"].float()
    if cfg.seg_grid != g:
        M = _interp_matrix(g, cfg.seg_grid, segs.device)
        t = torch.einsum("Oh,bkOW->bkhW", M, segs)
        segs_g = torch.einsum("Ww,bkhW->bkhw", M, t)
    else:
        segs_g = segs
    w = segs_g.reshape(B, segs.shape[1], g * g)
    pooled = torch.einsum("bkh,bhd->bkd", w, feats.float())
    denom = segs.sum((-1, -2))[..., None] + 1e-8
    return (pooled / denom).to(feats.dtype)


def seg_hidden_index(input_ids: torch.Tensor, cfg: LLMSegConfig):
    """Index in the spliced sequence of the hidden state one left of each
    row's first [SEG] token, and whether the row has one.  (R,), (R,)."""
    is_seg = input_ids == cfg.seg_token_id
    has_seg = is_seg.any(dim=1)
    text_pos = torch.argmax(is_seg.to(torch.int32), dim=1)  # first [SEG]
    idx = text_pos - 1 + (cfg.llava.num_image_tokens - 1)
    return idx.clamp_min(0), has_seg


def forward(model: LLMSeg, batch: Dict, *, pool: str = "adjoint",
            lora_cfg: Optional[LoraConfig] = None, remat=False,
            quant_stats: Optional[list] = None) -> Dict:
    """Shared train/inference forward; ``pool`` picks the pooling route
    ("adjoint", the default, or "unfused": upsampled features, then
    mask_pooling); ``remat`` and ``quant_stats`` (SmoothQuant's calibration
    collector) are passed to the LLaMA layers.  Its four stages are the
    spans ``llmseg.dino``, ``llmseg.clip``, ``llmseg.llm`` and
    ``llmseg.head``, timed on the CUDA stream too (``utils.profiling``)."""
    if pool not in POOL_ROUTES:
        raise ValueError(f"pool must be one of {POOL_ROUTES}, got {pool!r}")
    cfg = model.cfg
    on_card = batch["input_ids"].is_cuda
    with profiling.span("llmseg.dino", device=on_card):
        if pool == "adjoint":
            pooled = _pool_dino_proposals(model, batch)
        else:
            feat_flat = dino_features(model, batch["images_dino"])
            B, K = batch["sam_segs"].shape[:2]
            segs = batch["sam_segs"].reshape(B, K, -1).to(feat_flat.dtype)
            pooled = mask_pooling(feat_flat, segs)
    with profiling.span("llmseg.clip", device=on_card), torch.no_grad():
        img_embeds = model.llava.encode_images(batch["images_clip"])  # frozen tower, projector

    row_img = batch["row_to_image"].long()
    with profiling.span("llmseg.llm", device=on_card):
        hidden = model.llava(input_ids=batch["input_ids"],
                             image_pos=batch["image_pos"],
                             image_embeds=img_embeds[row_img],
                             lora=model.lora, lora_cfg=lora_cfg, remat=remat,
                             quant_stats=quant_stats)

    with profiling.span("llmseg.head", device=on_card):
        prop_embeds = pooled[row_img]
        prop_valid = batch["prop_valid"][row_img]
        seg_idx, has_seg = seg_hidden_index(batch["input_ids"], cfg)
        seg_hidden = hidden[torch.arange(hidden.shape[0], device=hidden.device), seg_idx]
        pred_embeddings = model.select.project_text(seg_hidden)
        similarity, pred_iou, seg_features = model.select(
            prop_embeds, pred_embeddings, prop_valid)
    return {
        "hidden": hidden,
        "similarity": similarity,
        "pred_iou": pred_iou,
        "seg_features": seg_features,
        "pred_embeddings": pred_embeddings,
        "prop_valid": prop_valid,
        "row_valid": batch["row_valid"] & has_seg,
    }


def loss_fn(model: LLMSeg, batch: Dict, *, pool: str = "adjoint",
            lora_cfg: Optional[LoraConfig] = None, remat=False):
    """Total training loss and its terms, ``llmseg.loss_fn``: causal-LM
    cross entropy over the splice-adjusted labels, plus the KL alignment and
    the IoP regression per row, averaged over the rows of each image and
    then over the images with at least one valid row.  In a data-parallel
    run both means divide by the global batch's counts (``ddp``, over the
    mesh's data group), so each process's terms are its shares of the
    global ones.  Extra batch keys:
    labels (R, T), gt_ious (R, K), gt_iops (R, K).  Returns
    (total, {"loss", "ce_loss", "align_loss", "regression_loss"})."""
    cfg = model.cfg
    out = forward(model, batch, pool=pool, lora_cfg=lora_cfg, remat=remat)
    B = batch["images_dino"].shape[0]

    lg = llama.logits(model.llava.llm, out["hidden"])
    labels = llava.splice_labels(batch["labels"], batch["image_pos"],
                                 cfg.llava.num_image_tokens)
    labels = torch.where(batch["row_valid"][:, None], labels, llava.IGNORE_INDEX)
    group = M.data_group(model)
    ce = llava.causal_lm_loss(lg, labels, group)

    align_r = LS.softmax_align_loss(out["seg_features"], out["pred_embeddings"],
                                    batch["gt_ious"], out["prop_valid"],
                                    cfg.loss.align_temperature)
    reg_r = LS.iou_regression_loss(out["pred_iou"], batch["gt_iops"], out["prop_valid"],
                                   scale=cfg.loss.regression_scale)
    rv = out["row_valid"].float()
    row_img = batch["row_to_image"].long()

    def per_image(x):  # jax.ops.segment_sum over images
        return torch.zeros(B, dtype=x.dtype, device=x.device).index_add_(0, row_img, x)

    rows_per_img = per_image(rv)
    img_valid = rows_per_img > 0
    denom = rows_per_img.clamp_min(1e-8)
    n_img = ddp.global_sum(img_valid.float().sum(), group).clamp_min(1.0)
    align = torch.where(img_valid, per_image(align_r * rv) / denom, 0.0).sum() / n_img
    reg = torch.where(img_valid, per_image(reg_r * rv) / denom, 0.0).sum() / n_img

    ce = ce * cfg.loss.ce_weight
    align = align * cfg.loss.align_weight
    reg = reg * cfg.loss.regression_weight
    total = ce + align + reg
    return total, {"loss": total, "ce_loss": ce, "align_loss": align,
                   "regression_loss": reg}


@torch.inference_mode()
def predict(model: LLMSeg, batch: Dict, *, device="cuda", pool: str = "adjoint",
            lora_cfg: Optional[LoraConfig] = None) -> Dict:
    """Inference: similarity and IoP per proposal, one teacher-forced pass.
    The model and the batch must live on ``device`` (the card by default)."""
    dev = require(device)
    for t in (next(model.parameters()), batch["input_ids"]):
        if t.device.type != dev.type:
            raise ValueError(f"expected tensors on {dev}, got {t.device}")
    with profiling.span("llmseg.predict", request=profiling.next_request()):
        out = forward(model, batch, pool=pool, lora_cfg=lora_cfg)
    return {"pred_similarity": out["similarity"], "pred_iou": out["pred_iou"],
            "prop_valid": out["prop_valid"], "row_valid": out["row_valid"]}
