"""Profiling hooks, the counterpart of ``llmseg_tpu.utils.profiling``: a
``torch.profiler`` trace written as a Chrome trace (Perfetto,
chrome://tracing), and a wall-clock step timer."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True) -> Iterator[None]:
    """Profile the body on the CPU, and on the card where there is one, and
    write ``<log_dir>/trace.json`` when it ends (also when it raises)."""
    if not enabled:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Wall-clock segmenter: timer.mark('data'), timer.mark('step'), ...
    accumulates per-segment seconds; read with .averages()."""

    def __init__(self):
        self._last = time.perf_counter()
        self._acc = {}
        self._n = {}

    def mark(self, name: str):
        now = time.perf_counter()
        self._acc[name] = self._acc.get(name, 0.0) + (now - self._last)
        self._n[name] = self._n.get(name, 0) + 1
        self._last = now

    def averages(self) -> dict:
        return {k: self._acc[k] / max(self._n[k], 1) for k in self._acc}

    def reset(self):
        self.__init__()
