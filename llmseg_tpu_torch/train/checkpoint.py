"""Checkpoint save and resume of the training state, the counterpart of
``llmseg_tpu.train.checkpoint`` (Orbax there, ``torch.save`` here).

Layout: ``<log_dir>/ckpt/<step>/state.pt`` holds the trainable parameters
by name, the optimizer state and the step; ``<log_dir>/ckpt/latest`` names
the newest step.  The frozen weights are not saved: they come from the same
initialisation or import as before.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch


def save(log_dir: str, step: int, params: Dict[str, torch.Tensor],
         opt_state: Optional[dict] = None) -> str:
    root = os.path.join(log_dir, "ckpt", str(step))
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "state.pt")
    torch.save({"step": step, "params": {k: v.detach() for k, v in params.items()},
                "opt_state": opt_state}, path)
    with open(os.path.join(log_dir, "ckpt", "latest"), "w") as f:
        f.write(str(step))
    return path


def latest_step(log_dir: str) -> Optional[int]:
    path = os.path.join(log_dir, "ckpt", "latest")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return int(f.read().strip())


def restore(log_dir: str, step: Optional[int] = None, *, map_location=None
            ) -> Tuple[Dict[str, torch.Tensor], Optional[dict], int]:
    """(params by name, optimizer state or None, step)."""
    if step is None:
        step = latest_step(log_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {log_dir}")
    state = torch.load(os.path.join(log_dir, "ckpt", str(step), "state.pt"),
                       map_location=map_location, weights_only=True)
    return state["params"], state["opt_state"], state["step"]
