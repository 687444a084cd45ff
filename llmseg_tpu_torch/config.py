"""Model configuration: the port's own copy of the JAX package's dataclasses.

Only the trees the ReasonSeg ``predict``, training and SAM everything-mode
(AMG) paths read are kept.  Field names, defaults and presets match
``llmseg_tpu.config`` so one preset name means one architecture in both
packages; the data tree is not part of the port yet.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


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


def llama_7b() -> LlamaConfig:
    return LlamaConfig()


def llama_tiny(vocab_size: int = 256) -> LlamaConfig:
    return LlamaConfig(vocab_size=vocab_size, hidden_size=64,
                       intermediate_size=128, num_layers=2, num_heads=4,
                       num_kv_heads=4, head_dim=16, max_seq_len=512)


@dataclass(frozen=True)
class LoraConfig:
    """LoRA on the attention q/v projections."""

    rank: int = 8
    alpha: float = 16.0
    dropout: float = 0.05
    target_modules: Tuple[str, ...] = ("q_proj", "v_proj")


@dataclass(frozen=True)
class LlavaConfig:
    """CLIP tower + linear projector + LLaMA."""

    vision: ViTConfig = field(default_factory=clip_vit_l14)
    llm: LlamaConfig = field(default_factory=llama_7b)
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
    """Device mesh: data ('dp'), fsdp-style param shard ('fsdp'), tensor ('tp').
    The port trains on one card, so only the one-device mesh is accepted."""

    data: int = -1                    # -1 => all remaining devices
    fsdp: int = 1
    tensor: int = 1


@dataclass(frozen=True)
class TrainConfig:
    """``llmseg_tpu.config.TrainConfig``'s settings that the port reads, with
    their defaults; the others (eval_every_epochs, no_eval) come with the
    entry points that read them.  A mesh of more than one device raises
    instead of being ignored."""

    lr: float = 1e-4                  # stage-2 finetune uses 1e-5
    beta1: float = 0.9
    beta2: float = 0.95
    weight_decay: float = 0.0
    warmup_steps: int = 100
    epochs: int = 10
    steps_per_epoch: int = 500
    batch_size: int = 1               # per device
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
    print_freq: int = 1
    resume: str = ""

    def __post_init__(self):
        m = self.mesh
        if m.data not in (-1, 1) or m.fsdp != 1 or m.tensor != 1:
            raise NotImplementedError(
                f"the port trains on one device; mesh {m} needs DDP/FSDP "
                "(ROADMAP queue 1 item 10: DDP)")


@dataclass(frozen=True)
class ExperimentConfig:
    """The model, data and training trees of
    ``llmseg_tpu.config.ExperimentConfig``; its AMG tree belongs to the entry
    points, not ported yet."""

    model: LLMSegConfig = field(default_factory=llmseg_7b)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


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
