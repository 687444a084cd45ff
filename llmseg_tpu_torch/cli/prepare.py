"""Offline SAM everything-mode mask extraction, the counterpart of the JAX
package's ``cli/prepare.py`` (the reference's prepare_datasets/: every
prepare_<corpus>.py, split_coco and convert_h5_to_json).

One entry handles any image corpus:
  python -m llmseg_tpu_torch.cli.prepare --image_dir <dir> --output masks.json \\
      --sam_ckpt sam_vit_h_4b8939.pth [--glob '*.jpg'] [--recursive]
      [--num_shards 8 --shard 3]        # split_coco-style round-robin shards
      [--hdf5 out.h5]                   # also the reference's h5 format
      [--device cpu]                    # the card by default

Per image (reference prepare_ReasonSeg.py:55-116): decode with cv2, shrink
the longest side to the SAM input with cv2's INTER_AREA (never enlarge),
AMG on the device, COCO-RLE annotations to masks.json in the reference's
schema {image, target_size, masks: [...]}.
"""

from __future__ import annotations

import argparse
import glob as glob_lib
import json
import os
import time

from llmseg_tpu_torch import config as C


def preprocess_image(image, max_side: int = 1024):
    """reference prepare_ReasonSeg.py:32-40: the longest side down to
    ``max_side`` with cv2.INTER_AREA; never enlarged."""
    h, w = image.shape[:2]
    if max(h, w) <= max_side:
        return image
    import cv2

    scale = max_side / max(h, w)
    return cv2.resize(image, (int(w * scale), int(h * scale)), interpolation=cv2.INTER_AREA)


def _imread_rgb(path: str):
    """One file's (H, W, 3) uint8 RGB image, or None when cv2 cannot read it."""
    import cv2

    img = cv2.imread(path)
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def build_parser() -> argparse.ArgumentParser:
    from llmseg_tpu_torch.models.sam import sam as sam_lib

    p = argparse.ArgumentParser("prepare")
    p.add_argument("--image_dir", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--sam_ckpt", default="")
    p.add_argument("--sam_model", default="vit_h", choices=list(sam_lib.MODEL_REGISTRY))
    p.add_argument("--glob", default="*.jpg")
    p.add_argument("--recursive", action="store_true")
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("--shard", type=int, default=0)
    p.add_argument("--max_side", type=int, default=0,
                   help="longest-side resize; 0 = SAM input size")
    p.add_argument("--points_per_side", type=int, default=32)
    p.add_argument("--points_per_batch", type=int, default=64)
    p.add_argument("--pred_iou_thresh", type=float, default=0.88)
    p.add_argument("--stability_score_thresh", type=float, default=0.95)
    p.add_argument("--box_nms_thresh", type=float, default=0.7)
    p.add_argument("--crop_n_layers", type=int, default=0,
                   help="crop cascade layers (reference crop_n_layers; "
                        "every LLM-Seg prepare script uses 0)")
    p.add_argument("--crop_nms_thresh", type=float, default=0.7)
    p.add_argument("--min_mask_region_area", type=int, default=0)
    p.add_argument("--hdf5", default="", help="also write the reference's h5 format")
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="the device to run on: the card (cuda, the default) or cpu")
    return p


def main(argv=None):
    import torch

    from llmseg_tpu_torch.import_weights import torch_import as TI
    from llmseg_tpu_torch.models.sam import amg as amg_lib
    from llmseg_tpu_torch.models.sam import sam as sam_lib

    args = build_parser().parse_args(argv)
    cfg = sam_lib.MODEL_REGISTRY[args.sam_model]()
    if args.sam_ckpt:
        model = TI.load_sam_into(sam_lib.build(cfg, device=args.device, dtype=torch.bfloat16),
                                 args.sam_ckpt, device=args.device)
    else:
        print("WARNING: no --sam_ckpt; random weights (smoke-test only)")
        model = sam_lib.init(cfg, seed=0, device=args.device, dtype=torch.bfloat16)

    max_side = args.max_side or cfg.encoder.img_size
    amg_cfg = C.AMGConfig(points_per_side=args.points_per_side,
                          points_per_batch=args.points_per_batch,
                          pred_iou_thresh=args.pred_iou_thresh,
                          stability_score_thresh=args.stability_score_thresh,
                          box_nms_thresh=args.box_nms_thresh,
                          crop_n_layers=args.crop_n_layers,
                          crop_nms_thresh=args.crop_nms_thresh,
                          min_mask_region_area=args.min_mask_region_area)
    gen = amg_lib.AutomaticMaskGenerator(model, cfg, amg_cfg, device=args.device)

    pattern = os.path.join(args.image_dir, "**" if args.recursive else "", args.glob)
    files = sorted(glob_lib.glob(pattern, recursive=args.recursive))
    files = files[args.shard::args.num_shards]      # round-robin (reference split_coco.py)
    if args.limit:
        files = files[:args.limit]
    print(f"prepare: {len(files)} images (shard {args.shard}/{args.num_shards})")

    results = []
    t0 = time.time()
    # a pipeline one image deep: image i + 1's device work is enqueued
    # before image i is finished, so i's download and RLE overlap it
    pending = None

    def drain(pending):
        rel, shape, handle = pending
        results.append({"image": rel, "target_size": [shape[0], shape[1]],
                        "masks": gen.finish(handle)})
        if len(results) % 10 == 0:
            dt = (time.time() - t0) / len(results)
            print(f"{len(results)}/{len(files)} images, {dt:.2f}s/image", flush=True)

    for path in files:
        img = _imread_rgb(path)
        if img is None:
            print(f"skip unreadable {path}")
            continue
        img = preprocess_image(img, max_side)
        if pending is not None:
            # the previous image's upscale goes before this submit, so its
            # download and RLE overlap this image's device work
            gen.prefetch(pending[2])
        handle = gen.submit(img)
        if pending is not None:
            drain(pending)
        pending = (os.path.relpath(path, args.image_dir), img.shape, handle)
    if pending is not None:
        drain(pending)

    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    with open(args.output, "w") as f:
        json.dump(results, f)
    print(f"wrote {args.output} ({len(results)} images, {time.time() - t0:.0f}s)")

    if args.hdf5:
        import h5py

        with h5py.File(args.hdf5, "w") as h5:
            for r in results:
                # the reference's h5 format: a stringified dict an image
                # (prepare_ReasonSeg.py:104-115)
                h5.create_dataset(r["image"], data=str(r))
        print(f"wrote {args.hdf5}")


if __name__ == "__main__":
    main()
