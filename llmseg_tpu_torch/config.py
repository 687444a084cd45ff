"""Model configuration: the port's copy of the JAX package's dataclasses,
and one decoder the JAX package lacks.

Every dataclass and preset of ``llmseg_tpu.config`` is kept.  Field names,
defaults and presets match, so one preset name means one architecture in
both packages.  :class:`DeepseekV3Config` (latent attention and routed
experts, ``models/deepseek_v3.py``) and its presets are the port's own: an
``LlavaConfig`` whose ``llm`` is one builds that decoder in place of the
LLaMA.  A decoder's config names the paths not ported for it (``unported``,
not a field); :func:`require_ported` is the one check of them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, ClassVar, FrozenSet, Optional, Tuple, Union


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


@dataclass(frozen=True)
class ViTConfig:
    """Plain ViT: CLIP ViT-L/14 vision tower or DINOv2 ViT-L/14."""

    img_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_prefix_tokens: int = 1     # CLS
    use_class_embedding: bool = True
    layernorm_pre: bool = True      # CLIP has pre-LN after embeddings
    use_swiglu: bool = False
    layerscale: bool = False        # DINOv2 uses LayerScale
    use_quick_gelu: bool = True     # CLIP quick-gelu; DINOv2 tanh-gelu
    ln_eps: float = 1e-5            # CLIP 1e-5, DINOv2 1e-6

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid


def clip_vit_l14() -> ViTConfig:
    """openai/clip-vit-large-patch14 @224: 256 patch tokens, hidden 1024."""
    return ViTConfig()


def dinov2_vit_l14() -> ViTConfig:
    """dinov2_vitl14 @896: 64x64 patch tokens."""
    return ViTConfig(img_size=896, layernorm_pre=False, layerscale=True,
                     use_quick_gelu=False, ln_eps=1e-6)


def vit_tiny(img_size: int = 28, patch_size: int = 14) -> ViTConfig:
    return ViTConfig(img_size=img_size, patch_size=patch_size, hidden_size=32,
                     depth=2, num_heads=2)


# the paths a decoder may not port, by name, and what its error calls each
UNPORTED = {
    "lora": "LoRA",
    "quant_stats": "SmoothQuant's calibration (quant_stats)",
    "training": "training (a forward with grad enabled)",
    "cache": "decoding with a (latent) cache",
    "quantization": "quantization (int8, int4, W8A8)",
    "mesh": "the (dp, fsdp, tp) mesh",
}


def require_ported(cfg, path: str) -> None:
    """Raise ``NotImplementedError`` if ``path`` (a key of :data:`UNPORTED`)
    is not ported for the decoder that ``cfg`` configures; only the
    DeepSeek-V3 decoder leaves paths unported."""
    if path in cfg.unported:
        raise NotImplementedError(f"{UNPORTED[path]} is not ported for the DeepSeek-V3 "
                                  f"decoder (inference of models/deepseek_v3.py only)")


@dataclass(frozen=True)
class LlamaConfig:
    """LLaMA decoder."""

    vocab_size: int = 32004          # 32000 + [SEG], <im_start>, <im_end>, pad
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    max_seq_len: int = 1024          # 512 text + up to 255 image + margin
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    tie_embeddings: bool = False
    unported: ClassVar[FrozenSet[str]] = frozenset()


def llama_7b() -> LlamaConfig:
    return LlamaConfig()


def llama_tiny(vocab_size: int = 256) -> LlamaConfig:
    return LlamaConfig(vocab_size=vocab_size, hidden_size=64,
                       intermediate_size=128, num_layers=2, num_heads=4,
                       num_kv_heads=4, head_dim=16, max_seq_len=512)


@dataclass(frozen=True)
class DeepseekV3Config:
    """DeepSeek-V3's decoder, as Kimi-VL-A3B-Instruct's language model
    publishes it (the defaults): multi-head latent attention without q
    compression, ``first_k_dense_replace`` leading dense SwiGLU layers, then
    layers of ``n_routed_experts`` SwiGLU experts of which a sigmoid router
    with a correction bias picks ``num_experts_per_tok`` (``noaux_tc`` in
    one group, the weights normalised and scaled by
    ``routed_scaling_factor``) beside ``n_shared_experts`` shared ones
    (one SwiGLU of their summed width).  Inference only."""

    vocab_size: int = 163844         # 163840 + [SEG], <im_start>, <im_end>, pad
    hidden_size: int = 2048
    intermediate_size: int = 11264   # the leading dense layers' SwiGLU
    moe_intermediate_size: int = 1408
    num_layers: int = 27
    num_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    max_seq_len: int = 1024
    rope_theta: float = 800000.0
    rms_norm_eps: float = 1e-5
    kv_norm_eps: float = 1e-6        # kv_a_layernorm: the modeling code's default
    tie_embeddings: bool = False
    unported: ClassVar[FrozenSet[str]] = frozenset(UNPORTED)

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


def kimi_vl_a3b_llm() -> DeepseekV3Config:
    """moonshotai/Kimi-VL-A3B-Instruct's text config, with LLM-Seg's four
    added tokens."""
    return DeepseekV3Config()


def deepseek_v3_tiny(vocab_size: int = 256) -> DeepseekV3Config:
    return DeepseekV3Config(vocab_size=vocab_size, hidden_size=64, intermediate_size=128,
                            moe_intermediate_size=32, num_layers=3, num_heads=4,
                            kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                            v_head_dim=16, n_routed_experts=8, num_experts_per_tok=2,
                            n_shared_experts=1, max_seq_len=512)


@dataclass(frozen=True)
class MptConfig:
    """MPT decoder (the reference's model/llava/model/language_model/mpt/,
    a LLaVA backbone no entry point selects).  Defaults are MPT-7B's:
    ALiBi positions, bias-free linears and norms, one fused Wqkv, an
    exact-GELU FFN."""

    vocab_size: int = 50368
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    kv_n_heads: int = 32             # 1 = MultiQueryAttention
    expansion_ratio: int = 4
    max_seq_len: int = 2048
    alibi: bool = True
    alibi_bias_max: int = 8
    learned_pos_emb: bool = False    # used only when alibi is off
    clip_qkv: Optional[float] = None
    qk_ln: bool = False
    softmax_scale: Optional[float] = None
    no_bias: bool = True
    ln_eps: float = 1e-5


def mpt_7b() -> MptConfig:
    return MptConfig()


def mpt_tiny(vocab_size: int = 256) -> MptConfig:
    return MptConfig(vocab_size=vocab_size, d_model=64, n_layers=2, n_heads=4,
                     kv_n_heads=4, expansion_ratio=2, max_seq_len=128)


@dataclass(frozen=True)
class LoraConfig:
    """LoRA on the attention q/v projections."""

    rank: int = 8
    alpha: float = 16.0
    dropout: float = 0.05
    target_modules: Tuple[str, ...] = ("q_proj", "v_proj")


@dataclass(frozen=True)
class LlavaConfig:
    """CLIP tower + linear projector + LLaMA (or, with a
    :class:`DeepseekV3Config`, DeepSeek-V3's decoder)."""

    vision: ViTConfig = field(default_factory=clip_vit_l14)
    llm: Union[LlamaConfig, DeepseekV3Config] = field(default_factory=llama_7b)
    mm_hidden_size: int = 1024
    vision_select_layer: int = -2
    num_image_tokens: int = 256       # 224/14 squared


def llava_tiny() -> LlavaConfig:
    v = vit_tiny()
    l = llama_tiny()
    return LlavaConfig(vision=v, llm=l, mm_hidden_size=v.hidden_size,
                       num_image_tokens=v.num_patches)


@dataclass(frozen=True)
class SelectionHeadConfig:
    """Mask-selection transformer: two two-way blocks (proposals <-> [SEG]
    text), a final cross attention, the IoP and embedding heads; DINOv2
    features enter through a 1x1 projection."""

    dim: int = 256
    num_heads: int = 8
    mlp_dim: int = 2048
    depth: int = 2
    attention_downsample_rate: int = 2
    dino_dim: int = 1024
    llm_dim: int = 4096
    iou_head_hidden: int = 128
    embed_head_hidden: int = 2048


def selection_head_tiny(llm_dim: int = 64, dino_dim: int = 32) -> SelectionHeadConfig:
    return SelectionHeadConfig(dim=16, num_heads=2, mlp_dim=32, depth=2,
                               dino_dim=dino_dim, llm_dim=llm_dim,
                               iou_head_hidden=8, embed_head_hidden=32)


@dataclass(frozen=True)
class LossConfig:
    ce_weight: float = 1.0
    align_weight: float = 1.0
    regression_weight: float = 1.0
    align_temperature: float = 0.05
    regression_scale: float = 50.0
    dice_weight: float = 0.5
    bce_weight: float = 2.0


@dataclass(frozen=True)
class LLMSegConfig:
    """Top-level composition: LLaVA + DINOv2 + selection head."""

    llava: LlavaConfig = field(default_factory=LlavaConfig)
    dino: ViTConfig = field(default_factory=dinov2_vit_l14)
    select: SelectionHeadConfig = field(default_factory=SelectionHeadConfig)
    sam: Optional["SamConfig"] = None   # the legacy pixel-decoder path only
    loss: LossConfig = field(default_factory=LossConfig)

    max_proposals: int = 50           # top-K SAM proposals
    seg_grid: int = 256               # proposals resized to 256x256 for pooling
    seg_token_id: int = 32000         # [SEG]
    max_seq_len: int = 1024
    dtype: str = "bfloat16"


def llmseg_7b() -> LLMSegConfig:
    return LLMSegConfig()


def llmseg_small() -> LLMSegConfig:
    """Full architecture at ~1B-class LLM scale (16-layer LLaMA)."""
    llm = LlamaConfig(hidden_size=2048, intermediate_size=5504,
                      num_layers=16, num_heads=16, num_kv_heads=16,
                      head_dim=128)
    llava = LlavaConfig(llm=llm)
    return LLMSegConfig(
        llava=llava,
        select=SelectionHeadConfig(llm_dim=llm.hidden_size))


def llmseg_tiny() -> LLMSegConfig:
    llava = llava_tiny()
    dino = vit_tiny(img_size=56, patch_size=14)  # 4x4 grid
    return LLMSegConfig(
        llava=llava, dino=dino,
        select=selection_head_tiny(llm_dim=llava.llm.hidden_size,
                                   dino_dim=dino.hidden_size),
        max_proposals=8, seg_grid=16, seg_token_id=200, max_seq_len=512)


def llmseg_kimi_vl_a3b() -> LLMSegConfig:
    """LLM-Seg with Kimi-VL-A3B-Instruct's decoder in place of the LLaMA:
    LLM-Seg's own CLIP-L/14 tower and projector, DINOv2-L and selection
    head; ``[SEG]`` the first added token."""
    llm = kimi_vl_a3b_llm()
    return LLMSegConfig(llava=LlavaConfig(llm=llm), select=SelectionHeadConfig(
        llm_dim=llm.hidden_size), seg_token_id=163840)


def llmseg_mla_moe_tiny() -> LLMSegConfig:
    cfg = llmseg_tiny()
    return replace(cfg, llava=replace(cfg.llava, llm=deepseek_v3_tiny()))


@dataclass(frozen=True)
class DataConfig:
    """A copy of ``llmseg_tpu.config.DataConfig``: where the corpora and the
    offline SAM masks are, the mixture and its sub-datasets, and the
    sizes the datasets make."""

    dataset_dir: str = "./dataset"
    sam_masks_dir: str = "./sam_masks"
    dataset: str = "sem_seg||refer_seg||reason_seg"
    sample_rates: Tuple[float, ...] = (9, 3, 1)
    sem_seg_data: str = "ade20k||cocostuff||pascal_part||paco_lvis||mapillary"
    refer_seg_data: str = "refclef||refcoco||refcoco+||refcocog"
    reason_seg_data: str = "ReasonSeg|train"
    val_dataset: str = "ReasonSeg|val"
    explanatory: float = 0.1
    num_classes_per_sample: int = 3
    image_size: int = 896             # DINOv2 input (reference --image_size 896)
    clip_image_size: int = 224
    model_max_length: int = 512
    num_workers: int = 2
    exclude_val: bool = False


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh: data ('dp'), fsdp-style param shard ('fsdp'), tensor ('tp'),
    one process a device (``parallel/mesh.py``): dp x fsdp x tp must be the
    world size, and data -1 takes what fsdp and tensor leave."""

    data: int = -1                    # -1 => all remaining devices
    fsdp: int = 1
    tensor: int = 1


@dataclass(frozen=True)
class TrainConfig:
    """``llmseg_tpu.config.TrainConfig``'s settings, with their defaults.  A
    mesh that does not fit the process group (``ddp.check_mesh``) raises
    instead of being ignored."""

    lr: float = 1e-4                  # stage-2 finetune uses 1e-5
    beta1: float = 0.9
    beta2: float = 0.95
    weight_decay: float = 0.0
    warmup_steps: int = 100
    epochs: int = 10
    steps_per_epoch: int = 500
    batch_size: int = 1               # the global batch (a data rank takes batch_size / (dp x fsdp))
    grad_accum_steps: int = 10
    grad_clip: float = 1.0
    precision: str = "bf16"
    quantize_frozen: bool = False    # QLoRA: the frozen LLaMA projections quantized
    quantize_bits: int = 8           # 8 or 4 (packed nibbles)
    # gradient-checkpoint policy of the LLaMA layers: "dots" keeps the
    # projection matmul outputs and recomputes the rest; "full" recomputes
    # everything; "none" keeps every activation
    remat_policy: str = "dots"
    lora: LoraConfig = field(default_factory=LoraConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    seed: int = 42
    log_dir: str = "./runs/llmseg"
    exp_name: str = "llmseg_tpu"
    save_best_metric: str = "giou"
    eval_every_epochs: int = 1
    print_freq: int = 1
    no_eval: bool = False
    resume: str = ""

    def __post_init__(self):
        from llmseg_tpu_torch.parallel import ddp

        ddp.check_mesh(self.mesh.data, self.mesh.fsdp, self.mesh.tensor)




# ---------------------------------------------------------------------------
# SAM (image encoder, prompt encoder, mask decoder) and AMG
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SamEncoderConfig:
    """SAM ViT image encoder."""

    img_size: int = 1024
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    mlp_ratio: float = 4.0
    out_chans: int = 256           # neck output channels
    use_rel_pos: bool = True
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size  # 64 for ViT-H @1024


@dataclass(frozen=True)
class SamPromptConfig:
    embed_dim: int = 256
    image_embedding_size: int = 64   # grid of the encoder output
    input_image_size: int = 1024
    mask_in_chans: int = 16


@dataclass(frozen=True)
class SamDecoderConfig:
    transformer_dim: int = 256
    transformer_depth: int = 2
    transformer_mlp_dim: int = 2048
    transformer_num_heads: int = 8
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256


@dataclass(frozen=True)
class SamConfig:
    encoder: SamEncoderConfig = field(default_factory=SamEncoderConfig)
    prompt: SamPromptConfig = field(default_factory=SamPromptConfig)
    decoder: SamDecoderConfig = field(default_factory=SamDecoderConfig)
    pixel_mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    pixel_std: Tuple[float, float, float] = (58.395, 57.12, 57.375)
    mask_threshold: float = 0.0


def sam_vit_h() -> SamConfig:
    return SamConfig()


def sam_vit_l() -> SamConfig:
    return SamConfig(encoder=SamEncoderConfig(
        embed_dim=1024, depth=24, num_heads=16,
        global_attn_indexes=(5, 11, 17, 23)))


def sam_vit_b() -> SamConfig:
    return SamConfig(encoder=SamEncoderConfig(
        embed_dim=768, depth=12, num_heads=12,
        global_attn_indexes=(2, 5, 8, 11)))


def sam_tiny() -> SamConfig:
    """Test-only configuration."""
    return SamConfig(
        encoder=SamEncoderConfig(
            img_size=64, patch_size=16, embed_dim=32, depth=2, num_heads=2,
            out_chans=16, window_size=2, global_attn_indexes=(1,)),
        prompt=SamPromptConfig(embed_dim=16, image_embedding_size=4,
                               input_image_size=64, mask_in_chans=4),
        decoder=SamDecoderConfig(transformer_dim=16, transformer_depth=2,
                                 transformer_mlp_dim=32, transformer_num_heads=2,
                                 iou_head_hidden_dim=16),
    )


@dataclass(frozen=True)
class AMGConfig:
    """Everything-mode mask generation; the reference generator's defaults."""

    points_per_side: int = 32
    points_per_batch: int = 64
    pred_iou_thresh: float = 0.88
    stability_score_thresh: float = 0.95
    stability_score_offset: float = 1.0
    box_nms_thresh: float = 0.7
    crop_n_layers: int = 0
    crop_nms_thresh: float = 0.7
    crop_overlap_ratio: float = 512 / 1500
    crop_n_points_downscale_factor: int = 1
    min_mask_region_area: int = 0
    max_masks: int = 512              # static output capacity after filtering


@dataclass(frozen=True)
class ExperimentConfig:
    """``llmseg_tpu.config.ExperimentConfig``: the model, data, training and
    AMG trees."""

    model: LLMSegConfig = field(default_factory=llmseg_7b)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    amg: AMGConfig = field(default_factory=AMGConfig)


def apply_overrides(cfg: Any, overrides: dict) -> Any:
    """Apply ``{'a.b.c': val}`` overrides to a (frozen) dataclass tree; a
    value of another type than the field's (numbers mix freely) raises
    ``TypeError``."""
    for key, val in overrides.items():
        def rec(node, parts):
            if len(parts) == 1:
                cur = getattr(node, parts[0])
                if cur is not None and not isinstance(cur, type(val)) and not (
                        isinstance(cur, (int, float)) and isinstance(val, (int, float))):
                    raise TypeError(f"override {key}: {type(val)} vs {type(cur)}")
                return dataclasses.replace(node, **{parts[0]: val})
            return dataclasses.replace(
                node, **{parts[0]: rec(getattr(node, parts[0]), parts[1:])})
        cfg = rec(cfg, key.split("."))
    return cfg
