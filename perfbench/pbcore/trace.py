"""The profiler's reading of a traced window.

``capture`` runs a few steps under ``torch.profiler`` (host and device
activity) inside a ``pb.window`` span, writes the chrome trace into a
temporary directory (under ``TMPDIR``) and reads it back: every device
kernel, copy and set in the window, and the host's spans.  ``Reading``
gives the busy time (the union of the device intervals), the window's
length, the device time and event count of each of the program's kernels
(``perfbench/kernels/<name>.json``: the regular expression of the one
device kernel each launch runs once, ``count``, and of every device kernel
a launch runs, ``time``), and the breakdown: the device operations that
took most time, and the idle gaps by what the host was doing.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import torch

KERNELS_DIR = Path(__file__).resolve().parent.parent / "kernels"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
BREAKDOWN_ROWS = 10


def kernel_specs(kernels_dir: Path = KERNELS_DIR) -> Dict[str, Dict]:
    """Every ``kernels/<name>.json``: {name: {"count": regex, "time":
    regex, "per_launch": int}}."""
    out = {}
    for p in sorted(kernels_dir.glob("*.json")):
        spec = json.loads(p.read_text())
        spec["count_re"] = re.compile(spec["count"])
        spec["time_re"] = re.compile(spec["time"])
        out[p.stem] = spec
    return out


def short_name(name: str) -> str:
    """A kernel's name without ``void`` and its argument list."""
    name = name[5:] if name.startswith("void ") else name
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:96]


@dataclass
class Reading:
    window_s: float
    busy_s: float
    device: List[Tuple[str, float, float, str]]        # (name, start_us, dur_us, cat)
    host: List[Tuple[str, float, float]]               # main thread: (name, start_us, dur_us)
    span: Tuple[float, float] = (0.0, 0.0)             # the window, us

    def kernel_events(self, spec: Dict, which: str = "time") -> List[Tuple[str, float, float, str]]:
        rx = spec["time_re" if which == "time" else "count_re"]
        return [e for e in self.device if e[3] == "kernel" and rx.search(e[0])]

    def kernel_time_s(self, spec: Dict) -> float:
        return sum(e[2] for e in self.kernel_events(spec)) * 1e-6

    def breakdown(self) -> Dict:
        by_name: Dict[str, float] = {}
        for name, _, dur, _ in self.device:
            k = short_name(name)
            by_name[k] = by_name.get(k, 0.0) + dur * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ROWS]
        gaps: Dict[str, float] = {}
        spans = self.gaps()
        for (g0, g1), label in zip(spans, self.host_at([(a + b) / 2 for a, b in spans])):
            gaps[label] = gaps.get(label, 0.0) + (g1 - g0) * 1e-6
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ROWS]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in idle]}

    def gaps(self) -> List[Tuple[float, float]]:
        """Idle intervals of the device inside the window, in us."""
        t0, t1 = self.span
        out, cur = [], t0
        for s, e in _union([(e[1], e[1] + e[2]) for e in self.device]):
            if s > cur:
                out.append((cur, min(s, t1)))
            cur = max(cur, e)
        if cur < t1:
            out.append((cur, t1))
        return [(a, b) for a, b in out if b > a]

    def host_at(self, times: List[float]) -> List[str]:
        """The innermost host span or operator of the main thread that
        covers each of the (ascending) times."""
        evs = sorted(self.host, key=lambda e: (e[1], -e[2]))
        out, stack, i = [], [], 0
        for t in times:
            while i < len(evs) and evs[i][1] <= t:
                while stack and stack[-1][1] + stack[-1][2] < evs[i][1]:
                    stack.pop()
                stack.append(evs[i])
                i += 1
            while stack and stack[-1][1] + stack[-1][2] < t:
                stack.pop()
            out.append(stack[-1][0][:96] if stack else "host idle")
        return out


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def read_chrome_trace(path: str) -> Reading:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    window = [e for e in events if e.get("name") == "pb.window" and e.get("ph") == "X"
              and e.get("cat") in ("user_annotation", "cpu_op")]
    if not window:
        raise RuntimeError("the trace has no pb.window span")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    tid = window[0].get("tid")
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            s0, s1 = max(s, w0), min(s + d, w1)
            if s1 > s0:
                device.append((e.get("name", ""), s0, s1 - s0, e["cat"]))
        elif e.get("cat") in ("cpu_op", "user_annotation") and e.get("tid") == tid:
            if s < w1 and s + d > w0 and e is not window[0]:
                host.append((e.get("name", ""), s, d))
    busy = sum(b - a for a, b in _union([(e[1], e[1] + e[2]) for e in device]))
    return Reading(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6, device=device, host=host,
                   span=(w0, w1))


def capture(run_steps: Callable[[], None]) -> Reading:
    """Run ``run_steps`` (which ends with the device idle) under the profiler
    and read its trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("pb.window"):
                run_steps()
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return read_chrome_trace(path)


def check_complete(reading: Reading, launches: Dict[str, int], specs: Dict[str, Dict]) -> List[str]:
    """Where the profile is incomplete: each of the program's kernels with a
    specification must show ``per_launch`` device events of its ``count``
    expression for each launch its counter gained in the window."""
    faults = []
    for name, spec in specs.items():
        got = len(reading.kernel_events(spec, "count"))
        want = spec.get("per_launch", 1) * launches.get(name, 0)
        if got != want:
            faults.append(f"{name}: {got} device events of /{spec['count']}/ for "
                          f"{launches.get(name, 0)} launches")
    return faults
