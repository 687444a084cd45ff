"""LLaVA supervised finetuning and projector pretraining, the counterpart of
the JAX package's ``cli/sft.py`` (the reference's model/llava/train/train.py
``train()``).

Two regimes, as the reference's HF-Trainer run has them:
  * ``--tune_mm_mlp_adapter``: feature-alignment pretraining, only the
    projector trains, conversation template "plain";
  * ``--lora_enable``: instruction SFT, LoRA on LLaMA's q/v projections and
    the projector, template "vicuna_v1".
With neither, the LLM, LoRA and the projector train (full SFT).

Usage (on the card; add ``--device cpu`` to run on the CPU):
  python -m llmseg_tpu_torch.cli.sft --data_path blip_laion_558k.json \\
      --image_folder imgs --version <hf llava dir> --tune_mm_mlp_adapter --conv_type plain
  python -m llmseg_tpu_torch.cli.sft --data_path llava_instruct_150k.json \\
      --image_folder coco/train2017 --version <hf llava dir> --lora_enable
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("llava_sft")
    p.add_argument("--data_path", required=True, help="json list of {id, image?, conversations}")
    p.add_argument("--image_folder", default="")
    p.add_argument("--version", default="",
                   help="HF LLaVA dir (weights + tokenizer); empty = random init + byte "
                        "tokenizer (tests)")
    p.add_argument("--model_size", default="7b", choices=["7b", "small", "tiny"])
    p.add_argument("--conv_type", default="vicuna_v1", choices=["vicuna_v1", "llava_v1", "plain"])
    p.add_argument("--tune_mm_mlp_adapter", action="store_true")
    p.add_argument("--lora_enable", action="store_true")
    p.add_argument("--lora_r", type=int, default=8)
    p.add_argument("--lora_alpha", type=int, default=16)
    p.add_argument("--mm_use_im_start_end", action="store_true")
    p.add_argument("--image_aspect_ratio", default="pad", choices=["pad", "none"])
    p.add_argument("--model_max_length", type=int, default=512)
    p.add_argument("--precision", default="bf16", choices=["fp32", "bf16"])
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--grad_accumulation_steps", type=int, default=1)
    p.add_argument("--warmup_steps", type=int, default=100)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--max_steps", type=int, default=0,
                   help="stop after N optimizer steps (0 = full epochs)")
    p.add_argument("--output_dir", default="./runs/llava_sft")
    p.add_argument("--print_freq", type=int, default=10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda",
                   help="the device to run on: the card (cuda, the default) or cpu")
    return p


def model_config(model_size: str, vocab_size: int):
    """The LLaVA preset of ``--model_size``, its vocabulary grown to cover
    the tokenizer's ids."""
    from llmseg_tpu_torch import config as C

    cfg = {"7b": C.LlavaConfig, "small": lambda: C.llmseg_small().llava,
           "tiny": C.llava_tiny}[model_size]()
    if vocab_size > cfg.llm.vocab_size:
        cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, vocab_size=vocab_size))
    return cfg


def main(argv=None):
    import numpy as np
    import torch

    from llmseg_tpu_torch import config as C
    from llmseg_tpu_torch.data import llava_sft as S
    from llmseg_tpu_torch.data.tokenizer import ByteTokenizer, HFTokenizer
    from llmseg_tpu_torch.device import require
    from llmseg_tpu_torch.train import checkpoint, optim, sft

    args = build_parser().parse_args(argv)
    device = require(args.device)

    if args.version:
        tokenizer = HFTokenizer(args.version, model_max_length=args.model_max_length,
                                use_mm_start_end=args.mm_use_im_start_end)
    else:
        tokenizer = ByteTokenizer(model_max_length=args.model_max_length)
    cfg = model_config(args.model_size, tokenizer.vocab_size)

    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    lora_cfg = (C.LoraConfig(rank=args.lora_r, alpha=args.lora_alpha)
                if args.lora_enable else None)
    model = sft.init(cfg, seed=args.seed, device=device, dtype=dtype, lora_cfg=lora_cfg)
    if args.version:
        from llmseg_tpu_torch.import_weights import torch_import

        torch_import.load_llava_into(model, args.version, device=device)

    mask = sft.sft_trainable_mask(model, tune_mm_mlp_adapter=args.tune_mm_mlp_adapter,
                                  lora_enable=args.lora_enable)
    trainable = optim.partition(model, mask)
    n_train = sum(p.numel() for p in trainable.values())
    print(f"trainable params: {n_train / 1e6:.2f}M ({len(trainable)} tensors)")

    dataset = S.SFTDataset(args.data_path, tokenizer, image_folder=args.image_folder,
                           conv_type=args.conv_type, image_aspect_ratio=args.image_aspect_ratio,
                           clip_size=cfg.vision.img_size,
                           mm_use_im_start_end=args.mm_use_im_start_end)
    tcfg = C.TrainConfig(lr=args.lr, epochs=args.epochs,
                         steps_per_epoch=max(1, len(dataset) // args.batch_size),
                         warmup_steps=args.warmup_steps, grad_clip=args.grad_clip,
                         grad_accum_steps=args.grad_accumulation_steps)
    step_fn, _ = sft.make_sft_train_step(tcfg, trainable, lora_cfg=lora_cfg, remat="full")

    rng = np.random.default_rng(args.seed)
    step = 0
    for epoch in range(args.epochs):
        order = rng.permutation(len(dataset))
        for i in range(0, len(order) - args.batch_size + 1, args.batch_size):
            insts = [dataset[int(j)] for j in order[i:i + args.batch_size]]
            batch = S.sft_collate(insts, tokenizer, num_image_tokens=cfg.num_image_tokens,
                                  model_max_length=args.model_max_length)
            batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
            t0 = time.time()
            metrics = step_fn(model, batch)
            step += 1
            if step % args.print_freq == 0 or step == 1:
                print(f"epoch {epoch} step {step}: ce={float(metrics['ce_loss']):.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} ({time.time() - t0:.2f}s)")
            if args.max_steps and step >= args.max_steps:
                break
        if args.max_steps and step >= args.max_steps:
            break

    os.makedirs(args.output_dir, exist_ok=True)
    checkpoint.save(args.output_dir, step, dict(model.named_parameters()))
    print(f"saved step {step} to {args.output_dir}")
    return model


if __name__ == "__main__":
    main()
