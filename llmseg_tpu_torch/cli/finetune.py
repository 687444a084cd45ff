"""Stage-2 fine-tuning on LLM-Seg40K, the counterpart of the JAX package's
``cli/finetune.py`` (the reference's finetune_llmseg.py): ``LLMSegDataset``,
lr 1e-5, 5 epochs, ``LLMSeg|val`` after each epoch, a weights-only resume
and a shuffled loader.

Usage (on the card; add ``--device cpu`` to run on the CPU):
  python -m llmseg_tpu_torch.cli.finetune --dataset_dir ... --sam_masks_dir ... \\
      --resume_ckpt <stage1 ckpt> --lr 1e-5 --epochs 5
"""

from __future__ import annotations

import os


def main(argv=None):
    from llmseg_tpu_torch.cli import common
    from llmseg_tpu_torch.data import datasets as D
    from llmseg_tpu_torch.train.loader import BatchLoader
    from llmseg_tpu_torch.train.trainer import Trainer

    parser = common.build_parser("finetune")
    parser.set_defaults(lr=1e-5, epochs=5, val_dataset="LLMSeg|val")
    args = parser.parse_args(argv)
    common.maybe_init_multihost(args)
    cfg = common.to_config(args)
    lora_cfg = cfg.train.lora

    tokenizer = common.build_tokenizer(args, cfg)
    cfg = common.align_model_to_tokenizer(cfg, tokenizer)
    readers = {}
    paths = common.mask_reader_paths(cfg)
    train_ds = D.LLMSegDataset(
        os.path.join(cfg.data.dataset_dir, "llm_seg", "train.json"),
        os.path.join(cfg.data.dataset_dir, "coco/train2017"),
        os.path.join(cfg.data.dataset_dir, "ego_objects/images"),
        common.load_reader(paths, "llmseg40k_train"),
        common.load_reader(paths, "egoobjects"),
        image_size=cfg.data.image_size, clip_size=cfg.data.clip_image_size,
        seg_grid=cfg.model.seg_grid, seed=cfg.train.seed, conv_type=args.conv_type)
    val_ds = None if cfg.train.no_eval else common.build_val_dataset(args, cfg, readers)

    trainer = Trainer(cfg, lora_cfg=lora_cfg, device=args.device,
                      model=common.import_initial_params(args, cfg, lora_cfg))
    # fine-tuning resumes the model weights only (reference finetune_llmseg.py:434)
    trainer.maybe_resume(weights_only=True)
    pin = trainer.device.type == "cuda"

    train_collate = common.build_collate(args, cfg, tokenizer, 1)
    val_collate = common.build_collate(args, cfg, tokenizer, 1)
    micro_per_epoch = cfg.train.steps_per_epoch * cfg.train.grad_accum_steps
    loader = trainer.batch_loader(train_ds, train_collate, micro_per_epoch, shuffle=True,
                                  seed=cfg.train.seed)

    def val_batches():
        yield from BatchLoader(val_ds, val_collate, 1, len(val_ds), pin_memory=pin).epoch(0)

    for epoch in range(cfg.train.epochs):
        metrics = trainer.train_epoch((batch for batch, _ in loader.epoch(epoch)), epoch)
        print(f"epoch {epoch}: " + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
        if val_ds is not None:
            res = trainer.validate(val_batches(), strategy=args.eval_strategy,
                                   threshold=args.eval_threshold)
            print(f"epoch {epoch}: giou={res['giou']:.4f} ciou={res['ciou']:.4f}")
            trainer.save_best(res)


if __name__ == "__main__":
    main()
