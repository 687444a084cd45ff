"""Profiling hooks, the counterpart of ``llmseg_tpu.utils.profiling``:
``trace``, a ``torch.profiler`` session written as a Chrome trace
(Perfetto, chrome://tracing), and the program's spans and counters.

A span (``with span("amg.encode"): ...``) and a counter (``count(...)``)
record only while a ``torch.profiler`` session records (``trace``, or any
other ``torch.profiler.profile``) and nothing is being compiled or
exported.  Off, ``span`` returns one shared no-op object: no
``record_function``, no clock read, no allocation.  On, a span enters
``torch.profiler.record_function``, so that it lands in the profiler's
trace as a ``user_annotation`` of the calling thread on the clock of the
device's kernels, and records its host start and end, its parent span and
a request id (given, or the parent's); with ``device=True`` it also
records a pair of CUDA events on the current stream, read when
:func:`snapshot` is taken: the stream's time from the span's start to its
end, idle included, so where the host launches a stage more slowly than
the card runs it, that time is the host's pace, not the kernels'.  The
kernels' own time is the profiler's (their launches inside the span's
``user_annotation``).

The store keeps, for each name, the number of spans and their summed host,
self (host less the child spans) and stream time, the counters, and the
last ``MAX_RECORDS`` spans as :class:`Record`; at most ``MAX_PENDING``
event pairs wait to be read.  :func:`snapshot` reads it, :func:`reset`
empties it.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import torch

MAX_RECORDS = 4096     # raw spans kept, the newest
MAX_PENDING = 1024     # device event pairs waiting to be read


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True) -> Iterator[None]:
    """Profile the body on the CPU, and on the card where there is one, and
    write ``<log_dir>/trace.json`` when it ends (also when it raises).  The
    body's spans are on while it runs."""
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


@dataclass(frozen=True)
class Record:
    """One finished span: host times from ``time.perf_counter_ns``."""
    name: str
    parent: Optional[str]
    request: Optional[int]
    start_ns: int
    end_ns: int
    self_ns: int


class _Store:
    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()      # .stack: the thread's open spans
        self.reset()

    def reset(self):
        self.sums: Dict[str, list] = {}     # name -> [n, host_ns, self_ns, stream_ms | None]
        self.counters: Dict[str, int] = {}
        self.records = collections.deque(maxlen=MAX_RECORDS)
        self.pending = collections.deque()  # (name, start event, end event)

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def add(self, rec: Record, events) -> None:
        with self.lock:
            s = self.sums.setdefault(rec.name, [0, 0, 0, None])
            s[0] += 1
            s[1] += rec.end_ns - rec.start_ns
            s[2] += rec.self_ns
            self.records.append(rec)
            if events is not None:
                self.pending.append((rec.name, *events))
                if len(self.pending) > MAX_PENDING:
                    self._resolve(1)

    def _resolve(self, n: Optional[int] = None) -> None:
        """Read the oldest ``n`` event pairs (all of them by default),
        waiting for the card where it has not reached them.  Lock held."""
        for _ in range(len(self.pending) if n is None else n):
            name, e0, e1 = self.pending.popleft()
            e1.synchronize()
            s = self.sums[name]
            s[3] = (s[3] or 0.0) + e0.elapsed_time(e1)


_STORE = _Store()
_requests = itertools.count(1)


_profiler_enabled = torch.autograd._profiler_enabled     # one C call, the off path's cost
_compiling = torch.compiler.is_compiling


class _Off:
    """The span while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None


_OFF = _Off()


class _Span:
    __slots__ = ("name", "device", "request", "parent", "rf", "events", "t0", "child_ns")

    def __init__(self, name: str, device: bool, request: Optional[int]):
        self.name, self.device, self.request = name, device, request
        self.child_ns = 0

    def __enter__(self):
        st = _STORE.stack()
        self.parent = st[-1] if st else None
        if self.request is None and self.parent is not None:
            self.request = self.parent.request
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.events = None
        if self.device:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        st.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        st = _STORE.stack()
        if st and st[-1] is self:
            st.pop()
        self.rf.__exit__(*exc)
        dur = t1 - self.t0
        if self.parent is not None:
            self.parent.child_ns += dur
        _STORE.add(Record(self.name, self.parent.name if self.parent is not None else None,
                          self.request, self.t0, t1, dur - self.child_ns), self.events)
        return False


def span(name: str, *, device: bool = False, request: Optional[int] = None):
    """A context manager around one stage of the program.  ``device``: also
    time the stage on the current CUDA stream (pass it only where the work
    runs on the card); ``request``: the id its spans share (default: the
    enclosing span's)."""
    if not _profiler_enabled() or _compiling():
        return _OFF
    return _Span(name, device, request)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``, while spans are on."""
    if not _profiler_enabled() or _compiling():
        return
    with _STORE.lock:
        _STORE.counters[name] = _STORE.counters.get(name, 0) + int(n)


def next_request() -> int:
    """A new request id, for the spans of one call or one image."""
    return next(_requests)


def snapshot() -> Dict:
    """{"spans": {name: {"n", "host_ms", "self_ms", "stream_ms"}},
    "counters": {name: int}}, summed over what was recorded since the last
    :func:`reset`; ``stream_ms`` is None for a name no span timed on a
    CUDA stream.  Waits for the card to reach the recorded events."""
    with _STORE.lock:
        _STORE._resolve()
        spans = {k: {"n": n, "host_ms": h * 1e-6, "self_ms": s * 1e-6, "stream_ms": d}
                 for k, (n, h, s, d) in _STORE.sums.items()}
        return {"spans": spans, "counters": dict(_STORE.counters)}


def records() -> List[Record]:
    """The newest finished spans (at most ``MAX_RECORDS``), oldest first."""
    with _STORE.lock:
        return list(_STORE.records)


def reset() -> None:
    """Empty the store (open spans still record when they close)."""
    with _STORE.lock:
        _STORE.reset()
