"""Torch-checkpoint importers into the port's modules, the counterpart of
``llmseg_tpu.import_weights.torch_import``.

Covers every format the reference consumes:
  * SAM ``sam_vit_h_4b8939.pth`` (torch state dict)         -> ``models/sam``
  * HF LLaMA / LLaVA directory (safetensors or .bin shards)  -> ``Llava``
  * HF CLIP vision tower (openai/clip-vit-large-patch14)     -> ``ViT``
  * DINOv2 torch.hub checkpoint (dinov2_vitl14)              -> ``ViT``
  * DeepSpeed ``mp_rank_00_model_states.pt`` with peft-LoRA  -> ``LLMSeg``
  * HF ``MptForCausalLM`` (mosaicml naming)                  -> ``Mpt``

Each ``import_*`` builds the JAX package's parameter tree (dense ``w``
(in, out), conv ``w`` HWIO, transposed-conv taps flipped) from the state
dict's tensors, and ``from_jax.load_`` places it, so that the layout maps,
the transposed-conv flip and the quantized leaves live in one place.  The
tensors keep the checkpoint's dtype through the mapping (a bf16 LLaMA stays
bf16 on the host; the JAX package turns every tensor into float32 numpy),
and ``load_`` casts them to the module's.  The thin ``load_*_into`` helpers
put a component's weights into a model on the card, unless the caller
asks for the CPU.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from llmseg_tpu_torch.device import require
from llmseg_tpu_torch.import_weights.from_jax import load_

StateDict = Dict[str, torch.Tensor]


def load_torch_state(path: str) -> StateDict:
    """Load a .pth/.pt/.bin/.safetensors file into {name: tensor}, each
    tensor in the file's dtype.  ``safetensors`` is imported only for a
    ``.safetensors`` file; torch files are memory-mapped."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return dict(load_file(path))
    sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if isinstance(sd, dict) and "module" in sd:     # DeepSpeed wrapper
        sd = sd["module"]
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v if torch.is_tensor(v) else torch.as_tensor(v) for k, v in sd.items()}


def load_hf_dir(path: str) -> StateDict:
    """Merge all weight shards of an HF model directory (safetensors shards
    if there are any, else the ``.bin`` ones)."""
    names = sorted(os.listdir(path))
    shards = [n for n in names if n.endswith(".safetensors")
              and not n.endswith("index.safetensors")]
    if not shards:
        shards = [n for n in names
                  if n.endswith(".bin") and "training_args" not in n]
    out: StateDict = {}
    for shard in shards:
        out.update(load_torch_state(os.path.join(path, shard)))
    return out


def linear(sd: StateDict, name: str, bias: bool = True) -> Dict:
    p = {"w": sd[f"{name}.weight"].T}
    if bias and f"{name}.bias" in sd:
        p["b"] = sd[f"{name}.bias"]
    return p


def conv2d(sd: StateDict, name: str, bias: bool = True) -> Dict:
    p = {"w": sd[f"{name}.weight"].permute(2, 3, 1, 0)}   # OIHW -> HWIO
    if bias and f"{name}.bias" in sd:
        p["b"] = sd[f"{name}.bias"]
    return p


def conv_transpose2d(sd: StateDict, name: str) -> Dict:
    """torch ConvTranspose2d weight (in, out, kh, kw) -> the JAX package's
    (kh, kw, in, out) with the taps flipped (``jax.lax.conv_transpose``'s
    convention; ``from_jax`` maps it to the port's layout)."""
    w = sd[f"{name}.weight"].permute(2, 3, 0, 1).flip(0, 1)
    p = {"w": w}
    if f"{name}.bias" in sd:
        p["b"] = sd[f"{name}.bias"]
    return p


def norm(sd: StateDict, name: str) -> Dict:
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def rms(sd: StateDict, name: str) -> Dict:
    return {"scale": sd[f"{name}.weight"]}


def mlp_stack(sd: StateDict, name: str, n: int) -> Dict:
    return {"layers": [linear(sd, f"{name}.layers.{i}") for i in range(n)]}


def seq_mlp(sd: StateDict, name: str, idxs) -> Dict:
    """nn.Sequential(Linear, act, Linear, ...) -> mlp_stack layers."""
    return {"layers": [linear(sd, f"{name}.{i}") for i in idxs]}


# ---------------------------------------------------------------------------
# SAM
# ---------------------------------------------------------------------------


def import_sam(sd: StateDict, cfg) -> Dict:
    """State dict of the reference's build_sam checkpoints -> SAM tree."""
    enc = cfg.encoder
    blocks = []
    for i in range(enc.depth):
        b = f"image_encoder.blocks.{i}"
        attn = {"qkv": linear(sd, f"{b}.attn.qkv"),
                "proj": linear(sd, f"{b}.attn.proj")}
        if enc.use_rel_pos:
            attn["rel_pos_h"] = sd[f"{b}.attn.rel_pos_h"]
            attn["rel_pos_w"] = sd[f"{b}.attn.rel_pos_w"]
        blocks.append({
            "norm1": norm(sd, f"{b}.norm1"),
            "attn": attn,
            "norm2": norm(sd, f"{b}.norm2"),
            "mlp": {"fc1": linear(sd, f"{b}.mlp.lin1"),
                    "fc2": linear(sd, f"{b}.mlp.lin2")},
        })
    image_encoder = {
        "patch_embed": conv2d(sd, "image_encoder.patch_embed.proj"),
        "pos_embed": sd["image_encoder.pos_embed"],
        "blocks": blocks,
        "neck": {
            "conv1": conv2d(sd, "image_encoder.neck.0", bias=False),
            "ln1": norm(sd, "image_encoder.neck.1"),
            "conv2": conv2d(sd, "image_encoder.neck.2", bias=False),
            "ln2": norm(sd, "image_encoder.neck.3"),
        },
    }

    pe = {
        "pe": {"gaussian":
               sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"]},
        "point_embeddings": torch.stack(
            [sd[f"prompt_encoder.point_embeddings.{i}.weight"][0] for i in range(4)]),
        "not_a_point_embed": sd["prompt_encoder.not_a_point_embed.weight"],
        "no_mask_embed": sd["prompt_encoder.no_mask_embed.weight"],
        "mask_downscale": {
            "conv1": conv2d(sd, "prompt_encoder.mask_downscaling.0"),
            "ln1": norm(sd, "prompt_encoder.mask_downscaling.1"),
            "conv2": conv2d(sd, "prompt_encoder.mask_downscaling.3"),
            "ln2": norm(sd, "prompt_encoder.mask_downscaling.4"),
            "conv3": conv2d(sd, "prompt_encoder.mask_downscaling.6"),
        },
    }

    def twt_attention(name):
        return {"q": linear(sd, f"{name}.q_proj"),
                "k": linear(sd, f"{name}.k_proj"),
                "v": linear(sd, f"{name}.v_proj"),
                "out": linear(sd, f"{name}.out_proj")}

    def twt_block(name):
        return {
            "self_attn": twt_attention(f"{name}.self_attn"),
            "norm1": norm(sd, f"{name}.norm1"),
            "cross_attn_t2i": twt_attention(f"{name}.cross_attn_token_to_image"),
            "norm2": norm(sd, f"{name}.norm2"),
            "mlp": {"fc1": linear(sd, f"{name}.mlp.lin1"),
                    "fc2": linear(sd, f"{name}.mlp.lin2")},
            "norm3": norm(sd, f"{name}.norm3"),
            "cross_attn_i2t": twt_attention(f"{name}.cross_attn_image_to_token"),
            "norm4": norm(sd, f"{name}.norm4"),
        }

    t = "mask_decoder.transformer"
    transformer = {
        "layers": [twt_block(f"{t}.layers.{i}")
                   for i in range(cfg.decoder.transformer_depth)],
        "final_attn": twt_attention(f"{t}.final_attn_token_to_image"),
        "norm_final": norm(sd, f"{t}.norm_final_attn"),
    }
    num_tokens = cfg.decoder.num_multimask_outputs + 1
    mask_decoder = {
        "iou_token": sd["mask_decoder.iou_token.weight"],
        "mask_tokens": sd["mask_decoder.mask_tokens.weight"],
        "transformer": transformer,
        "upscale_conv1": conv_transpose2d(sd, "mask_decoder.output_upscaling.0"),
        "upscale_ln": norm(sd, "mask_decoder.output_upscaling.1"),
        "upscale_conv2": conv_transpose2d(sd, "mask_decoder.output_upscaling.3"),
        "hyper_mlps": [mlp_stack(sd, f"mask_decoder.output_hypernetworks_mlps.{i}", 3)
                       for i in range(num_tokens)],
        "iou_head": mlp_stack(sd, "mask_decoder.iou_prediction_head",
                              cfg.decoder.iou_head_depth),
    }
    return {"image_encoder": image_encoder, "prompt_encoder": pe,
            "mask_decoder": mask_decoder}


def import_sam_pth(path: str, cfg) -> Dict:
    return import_sam(load_torch_state(path), cfg)


# ---------------------------------------------------------------------------
# CLIP vision tower (HF CLIPVisionModel)
# ---------------------------------------------------------------------------


def import_clip_vision(sd: StateDict, cfg, prefix: str = "vision_model.") -> Dict:
    def k(name):
        return f"{prefix}{name}"

    blocks = []
    for i in range(cfg.depth):
        b = k(f"encoder.layers.{i}")
        blocks.append({
            "norm1": norm(sd, f"{b}.layer_norm1"),
            "attn": {"q": linear(sd, f"{b}.self_attn.q_proj"),
                     "k": linear(sd, f"{b}.self_attn.k_proj"),
                     "v": linear(sd, f"{b}.self_attn.v_proj"),
                     "out": linear(sd, f"{b}.self_attn.out_proj")},
            "norm2": norm(sd, f"{b}.layer_norm2"),
            "mlp": {"fc1": linear(sd, f"{b}.mlp.fc1"),
                    "fc2": linear(sd, f"{b}.mlp.fc2")},
        })
    return {
        "patch_embed": {"w": sd[k("embeddings.patch_embedding.weight")].permute(2, 3, 1, 0)},
        "cls_token": sd[k("embeddings.class_embedding")].reshape(1, 1, -1),
        "pos_embed": sd[k("embeddings.position_embedding.weight")][None],
        "pre_norm": norm(sd, k("pre_layrnorm")),
        "blocks": blocks,
        "norm": norm(sd, k("post_layernorm")),
    }


def import_clip_dir(path: str, cfg) -> Dict:
    return import_clip_vision(load_hf_dir(path), cfg)


# ---------------------------------------------------------------------------
# DINOv2 (torch.hub checkpoint)
# ---------------------------------------------------------------------------


def keys_cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float64 weights of ``jax.image.resize(method="bicubic")``
    along one axis, which is ``scale_and_translate`` with Keys' cubic kernel
    (a = -0.5): half-pixel sample positions, the kernel widened by the
    scale when it shrinks (antialiased), taps outside the input dropped and
    each row renormalised over the taps that remain, rows whose sample lies
    outside the input zero.  ``torch.nn.functional.interpolate(mode=
    "bicubic")`` (a = -0.75, the border clamped) gives other numbers."""
    inv = n_in / n_out
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv - 0.5
    x = np.abs(sample[:, None] - np.arange(n_in, dtype=np.float64)[None, :]) / max(inv, 1.0)
    w = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, ((1.5 * x - 2.5) * x) * x + 1.0)
    w = np.where(x >= 2.0, 0.0, w)
    total = w.sum(1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[:, None], w, 0.0)


def interpolate_pos_embed(pos: torch.Tensor, src_grid: int, dst_grid: int,
                          num_prefix: int = 1) -> torch.Tensor:
    """Bicubic 2-D interpolation of patch position embeddings (what DINOv2's
    interpolate_pos_encoding does at run time; baked in at import):
    :func:`keys_cubic_weights` along rows and columns, in float64, the
    result in ``pos``'s dtype.  pos (1, num_prefix + src_grid^2, C)."""
    if src_grid == dst_grid:
        return pos
    prefix = pos[:, :num_prefix]
    grid = pos[0, num_prefix:].double().reshape(src_grid, src_grid, -1)
    m = torch.from_numpy(keys_cubic_weights(src_grid, dst_grid))
    out = torch.einsum("oh,pw,hwc->opc", m, m, grid)
    out = out.reshape(1, dst_grid * dst_grid, -1).to(pos.dtype)
    return torch.cat([prefix, out], 1)


def import_dinov2(sd: StateDict, cfg) -> Dict:
    blocks = []
    for i in range(cfg.depth):
        b = f"blocks.{i}"
        qkv = sd[f"{b}.attn.qkv.weight"].T        # (D, 3D)
        qkv_b = sd[f"{b}.attn.qkv.bias"]
        d = qkv.shape[0]
        blocks.append({
            "norm1": norm(sd, f"{b}.norm1"),
            "attn": {
                "q": {"w": qkv[:, :d], "b": qkv_b[:d]},
                "k": {"w": qkv[:, d:2 * d], "b": qkv_b[d:2 * d]},
                "v": {"w": qkv[:, 2 * d:], "b": qkv_b[2 * d:]},
                "out": linear(sd, f"{b}.attn.proj"),
            },
            "norm2": norm(sd, f"{b}.norm2"),
            "mlp": {"fc1": linear(sd, f"{b}.mlp.fc1"),
                    "fc2": linear(sd, f"{b}.mlp.fc2")},
            "ls1": sd[f"{b}.ls1.gamma"],
            "ls2": sd[f"{b}.ls2.gamma"],
        })
    pos = sd["pos_embed"]
    src_grid = int(round((pos.shape[1] - 1) ** 0.5))
    return {
        "patch_embed": conv2d(sd, "patch_embed.proj"),
        "cls_token": sd["cls_token"],
        "pos_embed": interpolate_pos_embed(pos, src_grid, cfg.grid),
        "blocks": blocks,
        "norm": norm(sd, "norm"),
    }


def import_dinov2_pth(path: str, cfg) -> Dict:
    return import_dinov2(load_torch_state(path), cfg)


# ---------------------------------------------------------------------------
# LLaMA / LLaVA (HF layout)
# ---------------------------------------------------------------------------


def import_llama(sd: StateDict, cfg, prefix: str = "model.") -> Dict:
    layers = []
    for i in range(cfg.num_layers):
        b = f"{prefix}layers.{i}"
        layers.append({
            "input_norm": rms(sd, f"{b}.input_layernorm"),
            "attn": {"q": linear(sd, f"{b}.self_attn.q_proj", bias=False),
                     "k": linear(sd, f"{b}.self_attn.k_proj", bias=False),
                     "v": linear(sd, f"{b}.self_attn.v_proj", bias=False),
                     "o": linear(sd, f"{b}.self_attn.o_proj", bias=False)},
            "post_norm": rms(sd, f"{b}.post_attention_layernorm"),
            "mlp": {"gate": linear(sd, f"{b}.mlp.gate_proj", bias=False),
                    "up": linear(sd, f"{b}.mlp.up_proj", bias=False),
                    "down": linear(sd, f"{b}.mlp.down_proj", bias=False)},
        })
    p = {"embed_tokens": _pad_vocab(sd[f"{prefix}embed_tokens.weight"], cfg.vocab_size),
         "layers": layers,
         "norm": rms(sd, f"{prefix}norm")}
    if "lm_head.weight" in sd:
        p["lm_head"] = {"w": _pad_vocab(sd["lm_head.weight"], cfg.vocab_size).T}
    return p


def import_mpt(sd: StateDict, cfg, prefix: str = "transformer.") -> Dict:
    """An MPT checkpoint (HF ``MptForCausalLM``; the reference's vendored
    branch has the same keys, modeling_mpt.py) -> the ``models/mpt.py``
    tree.  The head is tied to ``wte``, so none is imported; a norm without
    a bias (``no_bias``) gets zeros."""
    def ln(name):
        w = sd[f"{name}.weight"]
        return {"scale": w, "bias": sd.get(f"{name}.bias", torch.zeros_like(w))}

    blocks = []
    for i in range(cfg.n_layers):
        b = f"{prefix}blocks.{i}"
        blk = {"norm_1": ln(f"{b}.norm_1"),
               "attn": {"wqkv": linear(sd, f"{b}.attn.Wqkv"),
                        "out_proj": linear(sd, f"{b}.attn.out_proj")},
               "norm_2": ln(f"{b}.norm_2"),
               "ffn": {"up_proj": linear(sd, f"{b}.ffn.up_proj"),
                       "down_proj": linear(sd, f"{b}.ffn.down_proj")}}
        if cfg.qk_ln:
            blk["attn"]["q_ln"] = ln(f"{b}.attn.q_ln")
            blk["attn"]["k_ln"] = ln(f"{b}.attn.k_ln")
        blocks.append(blk)
    p = {"wte": sd[f"{prefix}wte.weight"], "blocks": blocks, "norm_f": ln(f"{prefix}norm_f")}
    if f"{prefix}wpe.weight" in sd:
        p["wpe"] = sd[f"{prefix}wpe.weight"]
    return p


def _pad_vocab(w: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Resize token embeddings (the reference adds [SEG]/<im_start>/<im_end>
    and resizes, training.py:229).  New rows are the mean of the existing
    rows (HF resize_token_embeddings' default), taken in float32 as the JAX
    package takes it and rounded once to ``w``'s dtype."""
    if w.shape[0] == vocab_size:
        return w
    if w.shape[0] > vocab_size:
        return w[:vocab_size]
    mean = torch.from_numpy(w.float().numpy().mean(axis=0, keepdims=True)).to(w.dtype)
    return torch.cat([w, mean.expand(vocab_size - w.shape[0], -1)], 0)


def apply_delta(base_sd: StateDict, delta_sd: StateDict) -> StateDict:
    """Merge LLaVA delta weights over a base LLaMA (the published
    LLaVA-lightning-7B-v1 ships as deltas; reference
    model/llava/model/apply_delta.py:27-56):

      * keys absent from base must be the mm_projector (kept as-is),
      * same-shape keys: delta + base,
      * embed_tokens / lm_head (delta vocab is larger, added special
        tokens): base added into the leading [V_base, D_base] block.

    Each sum is taken in float32 and rounded once to the delta's dtype."""
    def add(p, b):
        return (p.float() + b.float()).to(p.dtype)

    out: StateDict = {}
    for name, p in delta_sd.items():
        if name not in base_sd:
            if name not in ("model.mm_projector.weight", "model.mm_projector.bias"):
                raise KeyError(f"delta key {name} not in base model")
            out[name] = p
            continue
        b = base_sd[name]
        if p.shape == b.shape:
            out[name] = add(p, b)
        else:
            if name not in ("model.embed_tokens.weight", "lm_head.weight"):
                raise ValueError(f"{name} dimension mismatch: {tuple(p.shape)} vs "
                                 f"{tuple(b.shape)}")
            q = p.clone()
            q[:b.shape[0], :b.shape[1]] = add(q[:b.shape[0], :b.shape[1]], b)
            out[name] = q
    return out


def import_llava_delta_dirs(base_path: str, delta_path: str, cfg) -> Dict:
    """Base LLaMA HF dir + LLaVA delta HF dir -> merged LLaVA tree (the
    reference README's weight-acquisition path: apply_delta, then load)."""
    return import_llava_state(apply_delta(load_hf_dir(base_path), load_hf_dir(delta_path)), cfg)


def import_llava_dir(path: str, cfg) -> Dict:
    """HF LLaVA directory -> {llm, mm_projector?, vision_tower?}.  The vision
    tower usually lives in a separate CLIP checkpoint; the projector and the
    tower are imported when the directory has them."""
    return import_llava_state(load_hf_dir(path), cfg)


def import_llava_state(sd: StateDict, cfg) -> Dict:
    out = {"llm": import_llama(sd, cfg.llm, prefix="model.")}
    for key in ("model.mm_projector", "mm_projector"):
        if f"{key}.weight" in sd:
            out["mm_projector"] = linear(sd, key)
            break
    for pref in ("model.vision_tower.vision_tower.vision_model.",
                 "vision_tower.vision_model."):
        if f"{pref}post_layernorm.weight" in sd:
            out["vision_tower"] = import_clip_vision(sd, cfg.vision, prefix=pref)
            break
    return out


# ---------------------------------------------------------------------------
# LLM-Seg DeepSpeed checkpoint (LoRA + lisa heads)
# ---------------------------------------------------------------------------


def strip_peft(sd: StateDict):
    """Split a peft-wrapped state dict into (base_sd, lora_sd).

    peft names: base_model.model.<orig>.base_layer.weight (or .weight) and
    base_model.model.<orig>.lora_A.default.weight etc."""
    base, lora = {}, {}
    for k, v in sd.items():
        name = k
        if name.startswith("base_model.model."):
            name = name[len("base_model.model."):]
        if ".lora_A." in name or ".lora_B." in name:
            lora[name] = v
            continue
        base[name.replace(".base_layer.", ".")] = v
    return base, lora


def resolve_deepspeed_dir(path: str) -> str:
    """Resolve the reference's on-disk checkpoint layout (training.py:
    405-421,460-477 + README "Evaluation"): <log>/ckpt_model/latest names
    a global_stepN tag; the weights live at
    <log>/ckpt_model/global_stepN/mp_rank_00_model_states.pt.  Accepts the
    ckpt_model dir, a global_stepN dir, or the .pt file itself."""
    if os.path.isfile(path):
        return path
    latest = os.path.join(path, "latest")
    if os.path.isfile(latest):
        with open(latest) as f:
            tag = f.read().strip()
        path = os.path.join(path, tag)
    cand = os.path.join(path, "mp_rank_00_model_states.pt")
    if os.path.isfile(cand):
        return cand
    raise FileNotFoundError(f"no DeepSpeed checkpoint under {path!r} "
                            "(expected mp_rank_00_model_states.pt, "
                            "optionally via a `latest` pointer)")


def import_llmseg_checkpoint(path: str, cfg, lora_cfg=None) -> Dict:
    """DeepSpeed checkpoint (reference format, training.py:460-477) -> the
    llmseg tree.  ``path`` may be the .pt file or a checkpoint directory with
    a ``latest`` pointer (:func:`resolve_deepspeed_dir`).  SAM weights inside
    the checkpoint (model.visual_model.*) belong to the legacy pixel-decoder
    path and are not imported."""
    return import_llmseg_state(load_torch_state(resolve_deepspeed_dir(path)), cfg,
                               lora_cfg=lora_cfg)


def import_llmseg_state(sd: StateDict, cfg, lora_cfg=None,
                        include_towers: bool = False) -> Dict:
    """In-memory LISAForCausalLM state dict -> llmseg tree.
    ``include_towers`` also imports the CLIP vision tower
    (model.vision_tower.vision_tower.*), for state dicts taken from a live
    reference model rather than its saved checkpoints (which exclude the
    frozen towers)."""
    base, lora_sd = strip_peft(sd)
    llm = import_llama(base, cfg.llava.llm, prefix="model.")

    def att(n):
        return {"q": linear(base, f"{n}.q_proj"), "k": linear(base, f"{n}.k_proj"),
                "v": linear(base, f"{n}.v_proj"), "out": linear(base, f"{n}.out_proj")}

    select = {
        "text_fc1": linear(base, "model.text_hidden_fcs.0.0"),
        "text_fc2": linear(base, "model.text_hidden_fcs.0.2"),
        "dino_conv": {"w": base["model.lisa_dino_conv.weight"][:, :, 0, 0].T,
                      "b": base["model.lisa_dino_conv.bias"]},
        "blocks": [],
        "final_attn": att("model.lisa_final_attn"),
        "norm_final": norm(base, "model.lisa_norm_final_attn"),
        "iou_head": seq_mlp(base, "model.lisa_iou_head", (0, 2)),
        "embedding_head": seq_mlp(base, "model.lisa_embedding_head", (0, 2)),
    }
    for i in range(cfg.select.depth):
        b = f"model.lisa_attention_layers.{i}"
        select["blocks"].append({
            "self_attn": att(f"{b}.self_attn"),
            "norm1": norm(base, f"{b}.norm1"),
            "cross_t2i": att(f"{b}.cross_attn_token_to_image"),
            "norm2": norm(base, f"{b}.norm2"),
            "mlp": {"fc1": linear(base, f"{b}.mlp.lin1"),
                    "fc2": linear(base, f"{b}.mlp.lin2")},
            "norm3": norm(base, f"{b}.norm3"),
            "cross_i2t": att(f"{b}.cross_attn_image_to_token"),
            "norm4": norm(base, f"{b}.norm4"),
        })

    out = {"llava": {"llm": llm}, "select": select}
    if "model.mm_projector.weight" in base:
        out["llava"]["mm_projector"] = linear(base, "model.mm_projector")
    if include_towers:
        out["llava"]["vision_tower"] = import_clip_vision(
            base, cfg.llava.vision, prefix="model.vision_tower.vision_tower.vision_model.")

    if lora_sd and lora_cfg is not None:
        layers = []
        for i in range(cfg.llava.llm.num_layers):
            layer = {}
            for name in ("q", "v"):
                a_key = None
                for cand in (f"model.layers.{i}.self_attn.{name}_proj.lora_A.weight",
                             f"model.layers.{i}.self_attn.{name}_proj.lora_A.default.weight"):
                    if cand in lora_sd:
                        a_key = cand
                        break
                if a_key is None:
                    continue
                b_key = a_key.replace("lora_A", "lora_B")
                layer[name] = {"a": lora_sd[a_key].T, "b": lora_sd[b_key].T}
            layers.append(layer)
        out["lora"] = {"layers": layers}
    return out


# ---------------------------------------------------------------------------
# Into a model, on the card unless the caller asks for the CPU
# ---------------------------------------------------------------------------


def _into(model: nn.Module, module: nn.Module, tree, device, strict: bool = True):
    model.to(require(device))
    load_(module, tree, strict=strict)
    return model


def load_sam_into(model, path: str, *, device="cuda"):
    """A SAM ``.pth`` into a ``models.sam.sam.Sam``, every parameter."""
    return _into(model, model, import_sam_pth(path, model.cfg), device)


def load_clip_into(model, path: str, *, device="cuda"):
    """An HF CLIP vision directory into ``model.llava.vision_tower``."""
    return _into(model, model.llava.vision_tower, import_clip_dir(path, model.cfg.llava.vision),
                 device)


def load_dinov2_into(model, path: str, *, device="cuda"):
    """A DINOv2 hub ``.pth`` into ``model.dino`` (the position table resized
    to the model's grid)."""
    return _into(model, model.dino, import_dinov2_pth(path, model.cfg.dino), device)


def load_llava_into(model, path: str, *, base: Optional[str] = None, device="cuda"):
    """An HF LLaVA directory into ``model.llava`` (an ``LLMSeg``) or into
    ``model`` itself (a ``Llava``, such as the SFT model): the LLaMA, and
    the projector and the vision tower where the directory has them; with
    ``base``, ``path`` is a delta directory applied over that base LLaMA."""
    llava = getattr(model, "llava", model)
    tree = (import_llava_dir(path, llava.cfg) if base is None
            else import_llava_delta_dirs(base, path, llava.cfg))
    return _into(model, llava, tree, device, strict=False)


def load_llmseg_into(model, path: str, *, lora_cfg=None, device="cuda"):
    """An LLM-Seg DeepSpeed checkpoint (file or directory) into ``model``:
    the LLaMA, the selection head, the projector if saved, and the LoRA
    weights when ``lora_cfg`` is given (the model built with it)."""
    return _into(model, model, import_llmseg_checkpoint(path, model.cfg, lora_cfg), device,
                 strict=False)
