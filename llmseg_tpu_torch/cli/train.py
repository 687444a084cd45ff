"""Stage-1 training, the counterpart of the JAX package's ``cli/train.py``
(the reference's training.py): the sem / refer / reason mixture, a
ReasonSeg-val evaluation each epoch and the best-gIoU checkpoint; with
``--eval_only`` the evaluation alone, optionally on an int8 / int4 / W8A8
LLaMA.

Usage (on the card; add ``--device cpu`` to run on the CPU):
  python -m llmseg_tpu_torch.cli.train --dataset_dir ... --sam_masks_dir ... \\
      --version <hf-llava-dir> --dinov2_ckpt <pth> --exp_name run1
"""

from __future__ import annotations

import os


def main(argv=None):
    from llmseg_tpu_torch.cli import common
    from llmseg_tpu_torch.models import llmseg
    from llmseg_tpu_torch.train.loader import BatchLoader
    from llmseg_tpu_torch.train.trainer import Trainer
    from llmseg_tpu_torch.utils.logging import MetricLogger

    args = common.build_parser("train").parse_args(argv)
    if args.w8a8 and not args.load_8bit:
        raise SystemExit("--w8a8 is an int8 mode; combine it with "
                         "--load_8bit, not --load_4bit or alone")
    if (args.load_8bit or args.load_4bit) and not args.eval_only:
        raise SystemExit("--load_8bit/--load_4bit are inference-only "
                         "(the reference loads them for eval); "
                         "use --quantize_frozen for QLoRA training")
    common.maybe_init_multihost(args)
    cfg = common.to_config(args)
    lora_cfg = cfg.train.lora

    tokenizer = common.build_tokenizer(args, cfg)
    cfg = common.align_model_to_tokenizer(cfg, tokenizer)
    readers = {}
    train_ds = None if args.eval_only else common.build_train_dataset(args, cfg, readers)
    val_ds = None if cfg.train.no_eval else common.build_val_dataset(args, cfg, readers)

    writer = MetricLogger(cfg.train.log_dir, project="llmseg", exp_name=cfg.train.exp_name)
    trainer = Trainer(cfg, lora_cfg=lora_cfg, device=args.device, writer=writer,
                      model=common.import_initial_params(args, cfg, lora_cfg))
    if args.auto_resume:
        trainer.maybe_resume()
    pin = trainer.device.type == "cuda"

    train_collate = common.build_collate(args, cfg, tokenizer, cfg.data.num_classes_per_sample)
    val_collate = common.build_collate(args, cfg, tokenizer, 1)
    micro_per_epoch = cfg.train.steps_per_epoch * cfg.train.grad_accum_steps
    train_loader = trainer.batch_loader(train_ds, train_collate, micro_per_epoch)

    def val_batches(max_steps=None):
        """Batches of --val_batch_size of this process's shard; the loader
        tiles a short last batch back to full size, and its filler rows
        (the trailing ones) are marked invalid so the metrics cover the
        dataset once."""
        bsz = max(args.val_batch_size, 1)
        n = len(trainer.shard_range(len(val_ds)))
        steps = -(-n // bsz)
        if max_steps is not None:
            steps = min(steps, max_steps)
        loader = BatchLoader(val_ds, val_collate, bsz, steps, pin_memory=pin,
                             process_index=trainer.rank, process_count=trainer.world)
        for j, (batch, extras) in enumerate(loader.epoch(0)):
            n_valid = min(bsz, max(n - j * bsz, 0))
            extras["row_valid"] = [True] * n_valid + [False] * (bsz - n_valid)
            yield batch, extras

    if args.load_8bit or args.load_4bit:
        # weight-only quantization after any restore (the reference's
        # load_8bit / load_4bit), in place, one projection at a time.
        # For --w8a8 and --load_4bit a calibration forward over the first
        # val batches runs first, on the bf16 weights: SmoothQuant's fold
        # for W8A8, the salient-channel protection for int4
        from llmseg_tpu_torch.ops import quant
        from llmseg_tpu_torch.train import optim

        smooth_stats = None
        if (args.w8a8 or args.load_4bit) and val_ds is not None:
            calib = (trainer.to_device(b) for b, _ in val_batches(max(args.calib_batches, 0)))
            smooth_stats = llmseg.calibrate_quant_stats(trainer.model, calib, lora_cfg=lora_cfg)
        # the live LoRA overlay rides through the fold so that it is
        # compensated; the fold rewrites its parameters in place, and they
        # are the trainer's trainable tensors, so nothing is written back.
        # lm_head holds trainable parameters and stays in full precision,
        # as it is a hole of the JAX skeleton
        llm = trainer.model.llava.llm
        quant.quantize_llama_inplace(llm, bits=4 if args.load_4bit else 8, w8a8=args.w8a8,
                                     smooth_stats=smooth_stats,
                                     lora=trainer.model.lora if smooth_stats else None,
                                     head_dim=cfg.model.llava.llm.head_dim,
                                     skip=optim.holds_trainable(llm))

    try:
        if args.eval_only:
            # the exact frozen-tower reparameterisation (DINO's LayerScale
            # fold): inference never pays the per-block multiplies
            llmseg.fold_frozen_inplace(trainer.model)
            vis = os.path.join(cfg.train.log_dir, "eval_vis") if args.visualize else None
            res = trainer.validate(val_batches(), strategy=args.eval_strategy,
                                   threshold=args.eval_threshold, visualize_dir=vis)
            print(f"giou: {res['giou']:.4f}, ciou: {res['ciou']:.4f}")
            return res

        start_epoch = trainer.global_step // cfg.train.steps_per_epoch
        for epoch in range(start_epoch, cfg.train.epochs):
            batches = (batch for batch, _ in train_loader.epoch(epoch))
            train_metrics = trainer.train_epoch(batches, epoch)
            print(f"epoch {epoch}: " + " ".join(f"{k}={v:.4f}" for k, v in train_metrics.items()))
            if val_ds is not None:
                res = trainer.validate(val_batches(), strategy=args.eval_strategy,
                                       threshold=args.eval_threshold)
                print(f"epoch {epoch}: giou={res['giou']:.4f} ciou={res['ciou']:.4f}")
                if trainer.save_best(res):
                    print(f"epoch {epoch}: new best {res['giou']:.4f}")
    finally:
        writer.close()


if __name__ == "__main__":
    main()
