"""The command line's shared plumbing, the counterpart of the JAX package's
``cli/common.py``: one argparse surface over the reference's flags
(training.py:29-118, finetune_llmseg.py:32-120) mapped onto the port's
``ExperimentConfig``, and the tokenizer, dataset, reader, collate and
initial-weight functions every entry shares.

``--device`` (the card by default; ``cpu`` on request) picks the device.
``--multihost`` joins the process group that ``torchrun`` describes
(``parallel/ddp.py``: nccl on ``cuda:LOCAL_RANK``, gloo on the CPU), over
which ``--mesh_dp`` x ``--mesh_fsdp`` x ``--mesh_tp`` lays the mesh
(``parallel/mesh.py``; their product must be the world size, and
``--mesh_dp`` -1 takes what the others leave); ``--batch_size`` is per
data rank, so the global batch is ``batch_size x dp x fsdp`` (never x tp),
as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Dict

import torch

from llmseg_tpu_torch import config as C


def build_parser(name: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(name)
    # model / weights
    p.add_argument("--version", default="", help="HF LLaVA dir (weights + tokenizer)")
    p.add_argument("--clip_dir", default="", help="HF CLIP vision dir")
    p.add_argument("--dinov2_ckpt", default="", help="dinov2_vitl14 .pth")
    p.add_argument("--vision_pretrained", default="", help="SAM .pth (legacy decoder path)")
    p.add_argument("--resume_ckpt", default="", help="llmseg DeepSpeed/.pt checkpoint to import")
    p.add_argument("--model_size", default="7b", choices=["7b", "small", "tiny"])
    p.add_argument("--precision", default="bf16", choices=["fp32", "bf16"])
    p.add_argument("--remat_policy", default="dots", choices=["dots", "full", "none"],
                   help="LLaMA gradient-checkpoint policy: dots keeps the projection "
                        "outputs, full recomputes all (least memory), none disables remat")
    p.add_argument("--quantize_frozen", action="store_true",
                   help="QLoRA layout: quantized frozen LLM base")
    p.add_argument("--quantize_bits", type=int, default=8, choices=[8, 4],
                   help="frozen-base weight width (reference load_8bit/load_4bit equivalent)")
    p.add_argument("--load_8bit", action="store_true",
                   help="int8 weight-only LLM for inference (the reference's load_8bit)")
    p.add_argument("--load_4bit", action="store_true",
                   help="packed-int4 weight-only LLM for inference (the reference's load_4bit)")
    p.add_argument("--w8a8", action="store_true",
                   help="with --load_8bit: also quantize activations per token and run "
                        "int8 x int8 products (beyond the reference's load_8bit; validate "
                        "the ranking on your checkpoint before relying on it)")
    p.add_argument("--calib_batches", type=int, default=8,
                   help="val batches for the --w8a8 SmoothQuant calibration forward "
                        "(stats merge by column max across batches; 0 quantizes unsmoothed)")
    p.add_argument("--model_max_length", type=int, default=512)
    p.add_argument("--out_dim", type=int, default=256)
    p.add_argument("--use_mm_start_end", action="store_true", default=True)
    p.add_argument("--conv_type", default="llava_v1", choices=["llava_v1", "llava_llama_2"])
    # lora
    p.add_argument("--lora_r", type=int, default=8)
    p.add_argument("--lora_alpha", type=int, default=16)
    p.add_argument("--lora_dropout", type=float, default=0.05)
    p.add_argument("--lora_target_modules", default="q_proj,v_proj")
    # data
    p.add_argument("--dataset_dir", default="./dataset")
    p.add_argument("--sam_masks_dir", default="./sam_masks")
    p.add_argument("--dataset", default="sem_seg||refer_seg||reason_seg")
    p.add_argument("--sample_rates", default="9,3,1")
    p.add_argument("--sem_seg_data",
                   default="ade20k||cocostuff||pascal_part||paco_lvis||mapillary")
    p.add_argument("--refer_seg_data", default="refclef||refcoco||refcoco+||refcocog")
    p.add_argument("--vqa_data", default="llava_instruct_150k")
    p.add_argument("--reason_seg_data", default="ReasonSeg|train")
    p.add_argument("--val_dataset", default="ReasonSeg|val")
    p.add_argument("--explanatory", type=float, default=0.1)
    p.add_argument("--num_classes_per_sample", type=int, default=3)
    p.add_argument("--image_size", type=int, default=896)
    p.add_argument("--exclude_val", action="store_true")
    p.add_argument("--workers", type=int, default=2)
    # optimization
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--steps_per_epoch", type=int, default=500)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--grad_accumulation_steps", type=int, default=10)
    p.add_argument("--warmup_steps", type=int, default=100)
    p.add_argument("--beta1", type=float, default=0.9)
    p.add_argument("--beta2", type=float, default=0.95)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--ce_loss_weight", type=float, default=1.0)
    p.add_argument("--align_loss_weight", type=float, default=1.0)
    p.add_argument("--regression_loss_weight", type=float, default=1.0)
    # logging / eval
    p.add_argument("--log_base_dir", default="./runs")
    p.add_argument("--exp_name", default="llmseg_tpu")
    p.add_argument("--print_freq", type=int, default=1)
    p.add_argument("--eval_only", action="store_true")
    p.add_argument("--no_eval", action="store_true")
    p.add_argument("--visualize", action="store_true")
    p.add_argument("--eval_strategy", default="threshold",
                   choices=["argmax", "threshold", "iou_iop", "top_iou"])
    p.add_argument("--eval_threshold", type=float, default=0.5)
    p.add_argument("--val_batch_size", type=int, default=8,
                   help="images per forward during validation (the reference loops "
                        "val_batch_size=1, training.py:384; per-image metrics are the same "
                        "at any batch size)")
    p.add_argument("--auto_resume", action="store_true", default=True)
    # devices
    p.add_argument("--multihost", action="store_true",
                   help="join the process group of torchrun's environment "
                        "(one process a device; the mesh flags lay it out)")
    p.add_argument("--mesh_dp", type=int, default=-1)
    p.add_argument("--mesh_fsdp", type=int, default=1)
    p.add_argument("--mesh_tp", type=int, default=1)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda",
                   help="the device to run on: the card (cuda, the default) or cpu")
    return p


def maybe_init_multihost(args) -> None:
    """With ``--multihost``, join the process group and set ``args.device``
    to this process's device (``ddp.init_from_env``)."""
    if args.multihost:
        from llmseg_tpu_torch.parallel import ddp

        args.device = str(ddp.init_from_env(args.device))


def to_config(args) -> C.ExperimentConfig:
    """The run's config from the parsed flags.  ``--batch_size`` is per
    data rank: the config's batch is the global one, ``batch_size`` times
    dp x fsdp; a mesh that does not fit the world raises ``ValueError``."""
    from llmseg_tpu_torch.parallel import ddp
    from llmseg_tpu_torch.parallel.mesh import mesh_shape

    dp, fsdp, _ = mesh_shape(args.mesh_dp, args.mesh_fsdp, args.mesh_tp, ddp.world_size())
    model = {"7b": C.llmseg_7b, "small": C.llmseg_small, "tiny": C.llmseg_tiny}[args.model_size]()
    model = dataclasses.replace(
        model,
        loss=C.LossConfig(ce_weight=args.ce_loss_weight, align_weight=args.align_loss_weight,
                          regression_weight=args.regression_loss_weight),
        dtype="bfloat16" if args.precision == "bf16" else "float32")
    data = C.DataConfig(
        dataset_dir=args.dataset_dir, sam_masks_dir=args.sam_masks_dir, dataset=args.dataset,
        sample_rates=tuple(float(x) for x in args.sample_rates.split(",")),
        sem_seg_data=args.sem_seg_data, refer_seg_data=args.refer_seg_data,
        reason_seg_data=args.reason_seg_data, val_dataset=args.val_dataset,
        explanatory=args.explanatory, num_classes_per_sample=args.num_classes_per_sample,
        image_size=args.image_size, model_max_length=args.model_max_length,
        clip_image_size=model.llava.vision.img_size,   # follows the preset
        num_workers=args.workers, exclude_val=args.exclude_val)
    train = C.TrainConfig(
        lr=args.lr, beta1=args.beta1, beta2=args.beta2, warmup_steps=args.warmup_steps,
        epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
        batch_size=args.batch_size * dp * fsdp,
        grad_accum_steps=args.grad_accumulation_steps, grad_clip=args.grad_clip,
        precision=args.precision, quantize_frozen=args.quantize_frozen,
        quantize_bits=args.quantize_bits, remat_policy=args.remat_policy,
        lora=C.LoraConfig(rank=args.lora_r, alpha=args.lora_alpha, dropout=args.lora_dropout,
                          target_modules=tuple(args.lora_target_modules.split(","))),
        mesh=C.MeshConfig(data=args.mesh_dp, fsdp=args.mesh_fsdp, tensor=args.mesh_tp),
        seed=args.seed, log_dir=os.path.join(args.log_base_dir, args.exp_name),
        exp_name=args.exp_name, print_freq=args.print_freq, no_eval=args.no_eval)
    return C.ExperimentConfig(model=model, data=data, train=train)


def align_model_to_tokenizer(cfg: C.ExperimentConfig, tokenizer) -> C.ExperimentConfig:
    """Set the model's [SEG] id from the tokenizer and grow the LLM vocab to
    cover every tokenizer id (the reference's seg_token_idx lookup and
    resize_token_embeddings, training.py:121-137,229)."""
    from llmseg_tpu_torch.data.tokenizer import seg_token_id

    llm = dataclasses.replace(
        cfg.model.llava.llm,
        vocab_size=max(cfg.model.llava.llm.vocab_size, tokenizer.vocab_size))
    llava = dataclasses.replace(cfg.model.llava, llm=llm)
    model = dataclasses.replace(cfg.model, llava=llava, seg_token_id=seg_token_id(tokenizer))
    return dataclasses.replace(cfg, model=model)


def build_tokenizer(args, cfg: C.ExperimentConfig):
    from llmseg_tpu_torch.data.tokenizer import ByteTokenizer, HFTokenizer

    if args.version:
        return HFTokenizer(args.version, model_max_length=args.model_max_length,
                           use_mm_start_end=args.use_mm_start_end)
    return ByteTokenizer(model_max_length=args.model_max_length)


def mask_reader_paths(cfg: C.ExperimentConfig) -> Dict[str, str]:
    """The masks.json layout under sam_masks_dir: one file an image corpus,
    written by ``cli.prepare`` or the reference's prepare_datasets."""
    d = cfg.data.sam_masks_dir
    return {
        "reasonseg_train": os.path.join(d, "ReasonSeg_train_masks.json"),
        "reasonseg_val": os.path.join(d, "ReasonSeg_val_masks.json"),
        "coco2014": os.path.join(d, "coco2014_masks.json"),
        "coco2017": os.path.join(d, "coco2017_masks.json"),
        "saiapr": os.path.join(d, "saiapr_masks.json"),
        "ade20k": os.path.join(d, "ade20k_masks.json"),
        "mapillary": os.path.join(d, "mapillary_masks.json"),
        "voc2010": os.path.join(d, "voc2010_masks.json"),
        "egoobjects": os.path.join(d, "egoobjects_masks.json"),
        "llmseg40k_train": os.path.join(d, "llmseg40k_train_masks.json"),
        "llmseg40k_val": os.path.join(d, "llmseg40k_val_masks.json"),
    }


def load_reader(paths: Dict[str, str], key: str, top_k: int = 50):
    from llmseg_tpu_torch.data.mask_reader import SamMaskReader

    return SamMaskReader(paths[key], top_k=top_k)


def _cached_reader(cfg: C.ExperimentConfig, readers_cache: Dict):
    paths = mask_reader_paths(cfg)

    def reader(key):
        if key not in readers_cache:
            readers_cache[key] = load_reader(paths, key)
        return readers_cache[key]
    return reader


def build_train_dataset(args, cfg: C.ExperimentConfig, readers_cache: Dict):
    """The mixture dataset of --dataset / --sample_rates (the reference's
    HybridDataset wiring, training.py:248-280)."""
    from llmseg_tpu_torch.data import datasets as D

    reader = _cached_reader(cfg, readers_cache)
    common = dict(samples_per_epoch=cfg.train.steps_per_epoch * cfg.train.batch_size
                  * cfg.train.grad_accum_steps,
                  num_classes_per_sample=cfg.data.num_classes_per_sample,
                  image_size=cfg.data.image_size, clip_size=cfg.data.clip_image_size,
                  seg_grid=cfg.model.seg_grid, seed=cfg.train.seed, conv_type=args.conv_type)
    parts = []
    for name in cfg.data.dataset.split("||"):
        if name == "sem_seg":
            parts.append(D.SemSegDataset(
                cfg.data.dataset_dir,
                readers={"ade20k": reader("ade20k"), "mapillary": reader("mapillary"),
                         "coco2017": reader("coco2017"), "voc2010": reader("voc2010")},
                sem_seg_data=cfg.data.sem_seg_data, **common))
        elif name == "refer_seg":
            parts.append(D.ReferSegDataset(
                cfg.data.dataset_dir, coco2014_reader=reader("coco2014"),
                saiapr_reader=reader("saiapr"), refer_seg_data=cfg.data.refer_seg_data,
                **common))
        elif name == "reason_seg":
            parts.append(D.ReasonSegDataset(
                cfg.data.dataset_dir,
                mask_readers={"train": reader("reasonseg_train"),
                              "val": reader("reasonseg_val")},
                reason_seg_data=cfg.data.reason_seg_data,
                explanatory=cfg.data.explanatory, **common))
        elif name == "vqa":
            parts.append(D.VQADataset(cfg.data.dataset_dir, coco2017_reader=reader("coco2017"),
                                      vqa_data=args.vqa_data, **common))
        else:
            raise ValueError(f"unknown dataset branch {name}")
    return D.HybridDataset(parts, cfg.data.sample_rates,
                           samples_per_epoch=common["samples_per_epoch"], seed=cfg.train.seed)


def build_val_dataset(args, cfg: C.ExperimentConfig, readers_cache: Dict):
    from llmseg_tpu_torch.data import datasets as D

    reader = _cached_reader(cfg, readers_cache)
    common = dict(image_size=cfg.data.image_size, clip_size=cfg.data.clip_image_size,
                  seg_grid=cfg.model.seg_grid, conv_type=args.conv_type)
    if cfg.data.val_dataset.startswith("ReasonSeg"):
        return D.ValReasonSegDataset(cfg.data.dataset_dir, reader("reasonseg_val"),
                                     val_dataset=cfg.data.val_dataset, **common)
    if cfg.data.val_dataset.startswith("LLMSeg"):
        return D.ValLLMSegDataset(
            os.path.join(cfg.data.dataset_dir, "llm_seg", "validation.json"),
            os.path.join(cfg.data.dataset_dir, "coco/train2017"),
            os.path.join(cfg.data.dataset_dir, "ego_objects/images"),
            reader("llmseg40k_val"), reader("egoobjects"), **common)
    raise ValueError(f"unknown val dataset {cfg.data.val_dataset}")


def build_collate(args, cfg: C.ExperimentConfig, tokenizer, rows_per_sample):
    from llmseg_tpu_torch.data.collate import collate

    def fn(samples):
        return collate(samples, tokenizer, num_image_tokens=cfg.model.llava.num_image_tokens,
                       rows_per_sample=rows_per_sample, max_proposals=cfg.model.max_proposals,
                       conv_type=args.conv_type, use_mm_start_end=args.use_mm_start_end,
                       model_max_length=args.model_max_length)
    return fn


def import_initial_params(args, cfg: C.ExperimentConfig, lora_cfg):
    """The initial model on ``--device`` in the run's dtype: random weights
    from the seed, then the given checkpoints over them in the JAX CLI's
    order (``--version``'s LLaVA, ``--clip_dir``, ``--dinov2_ckpt``,
    ``--resume_ckpt``); each importer casts to the model's dtype."""
    from llmseg_tpu_torch.import_weights import torch_import as TI
    from llmseg_tpu_torch.models import llmseg

    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    model = llmseg.init(cfg.model, seed=cfg.train.seed, device=args.device, dtype=dtype,
                        lora_cfg=lora_cfg)
    if args.version and os.path.isdir(args.version):
        TI.load_llava_into(model, args.version, device=args.device)
    if args.clip_dir and os.path.isdir(args.clip_dir):
        TI.load_clip_into(model, args.clip_dir, device=args.device)
    if args.dinov2_ckpt and os.path.exists(args.dinov2_ckpt):
        TI.load_dinov2_into(model, args.dinov2_ckpt, device=args.device)
    if args.resume_ckpt and os.path.exists(args.resume_ckpt):
        TI.load_llmseg_into(model, args.resume_ckpt, lora_cfg=lora_cfg, device=args.device)
    return model
