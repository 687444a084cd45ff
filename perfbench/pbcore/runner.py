"""One run of one cell: set-up, the measured window (or, with ``trace``, a
short window on the host's clock and a few steps under the profiler), the
device's peak, the program freed, the comparison with the reference, the
import guard."""

from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Dict, Optional

import torch

from pbcore import counts, guard, manifest, program, trace

TRACE_HOST_S = 10.0       # the trace run's window on the host's clock


class RunFailed(RuntimeError):
    """The run cannot give a result (no card, an incomplete profile, JAX
    loaded)."""


def run_cell(workload: str, seed: int, seconds: float, traced: bool, *, t_start: float,
             device="cuda", cell: Optional[manifest.Cell] = None, log=print) -> Dict:
    """The result of one run, as the benchmark prints it."""
    cell = cell or manifest.load(workload)
    entry = cell.entry().Entry(cell.config, cell.traffic, seed, device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    entry.setup()
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    reading = None
    if not traced:
        w = entry.window(seconds)
        got = dict(w["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": got[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    else:
        w = entry.window(min(seconds, TRACE_HOST_S))
        before = program.launches()
        tw = {}
        reading = trace.capture(lambda: tw.update(
            entry.window(0.0, max_steps=cell.work["trace_steps"])))
        steps = tw["steps"]
        moved = {k: v - before.get(k, 0) for k, v in program.launches().items()
                 if v != before.get(k, 0)}
        specs = trace.kernel_specs()
        faults = trace.check_complete(reading, moved, specs)
        faults += [f"{k}: {v} launches and no kernels/{k}.json" for k, v in moved.items()
                   if k not in specs]
        if faults:
            raise RunFailed("the profile is incomplete: " + "; ".join(faults))
        ctx = SimpleNamespace(cfg=cell.config, traffic=cell.traffic, reading=reading,
                              steps=steps, host=w["host"], launches=moved, kernels=specs,
                              counts=counts)
        metrics = {}
        for m in cell.per_layer:
            value = cell.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": torch.cuda.max_memory_allocated() if device == "cuda" else 0}
    if reading is not None:
        dev.update(busy_s=reading.busy_s, window_s=reading.window_s)
    entry.release()
    numbers = entry.check()
    checks = {k: (numbers[k], limit) for k, limit in cell.work["check"].items()}
    found = guard.banned_modules()
    if found:
        raise RunFailed(f"the run loaded {', '.join(found)}")
    for name, (value, limit) in checks.items():
        log(f"check {name} {value!r} limit {limit!r}")
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": w["attempted"], "failed": w["failed"], "metrics": metrics,
              "device": dev}
    if reading is not None:
        result["breakdown"] = reading.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result
