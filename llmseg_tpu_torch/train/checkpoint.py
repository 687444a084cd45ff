"""Checkpoint save and resume of the training state, the counterpart of
``llmseg_tpu.train.checkpoint`` (Orbax there, ``torch.save`` here).

Layout: ``<log_dir>/ckpt/<step>/state.pt`` holds the trainable parameters
by name, the optimizer state and the step; ``<log_dir>/ckpt/latest`` names
the newest step; ``<log_dir>/ckpt/<step>/meta.json`` the metrics it was saved
with, if any.  The frozen weights are not saved: they come from the same
initialisation or import as before (and, under QLoRA, its quantization).
:class:`BestKeeper` is the best-metric policy, with its breadcrumb
``<log_dir>/best_meta.json``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import torch


def save(log_dir: str, step: int, params: Dict[str, torch.Tensor],
         opt_state: Optional[dict] = None, metrics: Optional[Dict] = None) -> str:
    root = os.path.join(log_dir, "ckpt", str(step))
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "state.pt")
    torch.save({"step": step, "params": {k: v.detach() for k, v in params.items()},
                "opt_state": opt_state}, path)
    with open(os.path.join(log_dir, "ckpt", "latest"), "w") as f:
        f.write(str(step))
    if metrics is not None:
        with open(os.path.join(root, "meta.json"), "w") as f:
            json.dump({"step": step, **metrics}, f)
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


class BestKeeper:
    """Best-only checkpoint policy keyed on a metric: :meth:`update` saves
    the trainable parameters and, when given, the optimizer state (so a
    resume from the best checkpoint restores the whole training state) when
    the metric is strictly greater than the best so far, and records it in
    ``best_meta.json``, which a new keeper reads back.  With ``write``
    false it keeps the best and returns the same answers but writes nothing
    (a data-parallel run's processes other than rank 0)."""

    def __init__(self, log_dir: str, metric: str = "giou", *, write: bool = True):
        self.log_dir = log_dir
        self.metric = metric
        self.write = write
        self.best = -float("inf")
        path = os.path.join(log_dir, "best_meta.json")
        if os.path.exists(path):
            with open(path) as f:
                self.best = json.load(f).get(metric, -float("inf"))

    def update(self, step: int, metrics: Dict, params: Dict[str, torch.Tensor],
               opt_state: Optional[dict] = None) -> bool:
        val = metrics.get(self.metric)
        if val is None or val <= self.best:
            return False
        self.best = val
        if not self.write:
            return True
        save(self.log_dir, step, params, opt_state, metrics)
        with open(os.path.join(self.log_dir, "best_meta.json"), "w") as f:
            json.dump({"step": step, **metrics}, f)
        return True
