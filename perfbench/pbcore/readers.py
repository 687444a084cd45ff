"""Helpers of the per-layer metric readers (``metrics/<name>.py``).  A
reader's ``read(ctx)`` returns the metric's value, or None where the
traced window has nothing to read.  ``ctx`` carries the configuration
(``cfg``), the traffic (``traffic``), the profiler's ``reading``, the traced
``steps``, the short untimed window's host-clock figures (``host``), the
launches each of the program's kernels gained in the traced window
(``launches``), the kernels' specifications (``kernels``) and
``pbcore.counts`` (``counts``)."""

from __future__ import annotations

import re
from typing import Iterable, Optional, Tuple

GEMM = re.compile(r"gemm|gemv|nvjet|cutlass|xmma|cublas|splitK", re.I)


def roofline(ctx, parts: Iterable[Tuple[str, float, int]]) -> Optional[float]:
    """The share (%) of the device time of the named kernels that their
    bound takes: ``parts`` are (kernel, bound seconds a launch, launches a
    step).  None when a kernel did not run as often as the step has it."""
    bound_s = time_s = 0.0
    for name, per_launch_s, per_step in parts:
        n = ctx.launches.get(name, 0)
        if n == 0 or n != per_step * ctx.steps:
            return None
        bound_s += per_launch_s * n
        time_s += ctx.reading.kernel_time_s(ctx.kernels[name])
    return 100.0 * bound_s / time_s if time_s > 0 else None


def mfu(ctx, flops_per_step: float) -> float:
    """The step's model operations over the step's time (the host clock's
    window) at the card's bf16 peak, in %."""
    return 100.0 * flops_per_step / (ctx.host["step_s"] * ctx.counts.PEAKS["bf16_flop_per_s"])


def idle_pct(ctx) -> float:
    r = ctx.reading
    return 100.0 * (1.0 - r.busy_s / r.window_s)


def glue_ms(ctx) -> float:
    """Device ms a step of the kernels that are neither products (cuBLAS,
    CUTLASS) nor the program's own."""
    own = [s["time_re"] for s in ctx.kernels.values()]
    total = sum(d for name, _, d, cat in ctx.reading.device
                if cat == "kernel" and not GEMM.search(name)
                and not any(rx.search(name) for rx in own))
    return total * 1e-3 / ctx.steps
