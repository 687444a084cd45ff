"""Meters of the training loop, a copy of ``llmseg_tpu.utils.metrics``'s
``Summary``, ``AverageMeter`` and ``ProgressMeter`` (the JAX module also
holds the IoU label code, which loads a native library, and a cross-host
reduction through JAX; neither is part of the port yet)."""

from __future__ import annotations

from enum import Enum

import numpy as np


class Summary(Enum):
    NONE = 0
    AVERAGE = 1
    SUM = 2
    COUNT = 3


class AverageMeter:
    def __init__(self, name: str, fmt: str = ":f",
                 summary_type: Summary = Summary.AVERAGE):
        self.name, self.fmt, self.summary_type = name, fmt, summary_type
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0.0
        self.avg = 0.0

    def update(self, val, n: int = 1):
        """val may be a scalar or an array."""
        val = np.asarray(val, np.float64)
        self.val = val if val.ndim else float(val)
        self.sum = self.sum + val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1e-12)

    def __str__(self):
        val = float(np.mean(self.val))
        avg = float(np.mean(self.avg))
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(name=self.name, val=val, avg=avg)

    def summary(self):
        if self.summary_type is Summary.NONE:
            return ""
        if self.summary_type is Summary.AVERAGE:
            return f"{self.name} {float(np.mean(self.avg)):.3f}"
        if self.summary_type is Summary.SUM:
            return f"{self.name} {float(np.mean(self.sum)):.3f}"
        return f"{self.name} {self.count:.1f}"


class ProgressMeter:
    def __init__(self, num_batches: int, meters, prefix: str = ""):
        fmt = "{:" + str(len(str(num_batches))) + "d}"
        self.batch_fmtstr = "[" + fmt + "/" + fmt.format(num_batches) + "]"
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int):
        entries = [self.prefix + self.batch_fmtstr.format(batch)]
        entries += [str(m) for m in self.meters]
        print("\t".join(entries), flush=True)

    def display_summary(self):
        entries = [" *"] + [m.summary() for m in self.meters]
        print(" ".join(entries), flush=True)
