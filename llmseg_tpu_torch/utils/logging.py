"""Metric sinks, a copy of ``llmseg_tpu.utils.logging`` (capability parity
with the reference's three sinks: stdout ProgressMeter, TensorBoard, wandb
— reference training.py:342-350, 566-588).  Each sink is optional and its
package is imported only when the sink is asked for."""

from __future__ import annotations

from typing import Dict, Optional


class MetricLogger:
    """Fan-out logger: TensorBoard (tensorboardX) + wandb when available.

    Note the reference logs both gIoU and cIoU to the same "val/giou" tag
    (training.py:674-675, a bug); here they get distinct tags."""

    def __init__(self, log_dir: str, project: Optional[str] = None,
                 exp_name: str = "", use_wandb: bool = False,
                 use_tensorboard: bool = True, rank: int = 0):
        self.rank = rank
        self.tb = None
        self.wandb = None
        if rank != 0:
            return
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self.tb = SummaryWriter(log_dir)
            except ImportError:
                pass
        if use_wandb:
            try:
                import wandb

                wandb.init(project=project or "llmseg", name=exp_name,
                           dir=log_dir)
                self.wandb = wandb
            except ImportError:
                print("wandb requested but not installed; skipping")

    def add_scalar(self, tag: str, value: float, step: int):
        if self.tb is not None:
            self.tb.add_scalar(tag, value, step)
        if self.wandb is not None:
            self.wandb.log({tag: value}, step=step)

    def log_dict(self, metrics: Dict[str, float], step: int,
                 prefix: str = ""):
        for k, v in metrics.items():
            self.add_scalar(f"{prefix}{k}", float(v), step)

    def close(self):
        if self.tb is not None:
            self.tb.close()
        if self.wandb is not None:
            self.wandb.finish()
