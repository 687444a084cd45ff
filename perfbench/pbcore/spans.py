"""The program's own spans and counters (``llmseg_tpu_torch.utils.profiling``),
read by the per-layer metrics, a step at a time.

The program records them only while a ``torch.profiler`` session records.
A run has one such session, the traced window (``trace.capture``), and
``runner.run_cell`` reads the metrics after that window and before the
program is released: so the snapshot sums exactly the window's
``ctx.steps`` steps (set-up, the warm-up and the untraced window record
nothing).  Imported as ``pbcore.program`` imports the kernels.  A
checkout whose program records no spans, or no such span, gives None, and
the metric is left out of the result."""

from __future__ import annotations

from typing import Iterable, Optional


def snapshot() -> Optional[dict]:
    """The program's ``profiling.snapshot()``, or None where it has none."""
    from llmseg_tpu_torch.utils import profiling
    snap = getattr(profiling, "snapshot", None)
    return snap() if snap is not None else None


def span_ms(ctx, names: Iterable[str], field: str) -> Optional[float]:
    """The summed ``field`` (``host_ms``, ``self_ms`` or ``stream_ms``) of
    the spans ``names``, a step; None where one of them recorded nothing,
    or no time of that kind (``stream_ms`` off the card)."""
    snap = snapshot()
    if snap is None:
        return None
    total = 0.0
    for name in names:
        value = snap["spans"].get(name, {}).get(field)
        if value is None:
            return None
        total += value
    return total / ctx.steps


def counter(name: str) -> Optional[int]:
    """The counter ``name`` over the window: 0 where the program has spans
    but never counted it, None where it has none."""
    snap = snapshot()
    return None if snap is None else snap["counters"].get(name, 0)
