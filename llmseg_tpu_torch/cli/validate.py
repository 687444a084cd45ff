"""Evaluation alone, the counterpart of the JAX package's ``cli/validate.py``
(the reference's training.py --eval_only and validate_llmseg.py): any
selection strategy over ReasonSeg-val or LLMSeg40K-val, with optional
visualisation dumps; it is ``cli.train`` with ``--eval_only``.

Usage (on the card; add ``--device cpu`` to run on the CPU):
  python -m llmseg_tpu_torch.cli.validate --dataset_dir ... --sam_masks_dir ... \\
      --resume_ckpt <ckpt> --eval_strategy threshold --visualize
"""

from __future__ import annotations

import sys


def main(argv=None):
    from llmseg_tpu_torch.cli.train import main as train_main

    argv = list(argv if argv is not None else sys.argv[1:])
    if "--eval_only" not in argv:
        argv.append("--eval_only")
    return train_main(argv)


if __name__ == "__main__":
    main()
