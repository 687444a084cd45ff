"""Build and load the CUDA kernels in ``llmseg_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) under ``llmseg_tpu_torch/_build/``, at first use, and loaded with
``ctypes``.  :func:`build` compiles several sources at once, one ``nvcc``
process each.  Nothing here builds at import time.

:func:`kernel_op` registers a kernel as a ``torch.library.custom_op`` in
the ``llmseg`` namespace (``torch.ops.llmseg.<name>``), so that
``torch.export`` can trace a path that launches it: its CUDA
implementation launches the kernel, its CPU implementation is the plain
version, its fake implementation gives only the outputs' shapes and dtypes.
The ops of the inference forward are defined beside their plain versions:
kernels A (``flash_fwd``), B (``flash_fwd_1pass``) and J
(``flash_fwd_1pass_t``) in ``ops/attention.py``, Q1 (``quantize_rows``) and
Q2 (``w8a8_linear``) in ``ops/quant.py``.  Importing ``llmseg_tpu_torch.ops``
(so any module of it, this one included) registers all five, which is what
a program exported through them needs before ``torch.export.load``.

:func:`stamp` is the port's one test of whether recorded work has gone
stale: :func:`cached` keeps a value (kernel G's, H's and I's plans, SAM's
positional encoding) while its inputs' stamps hold.  :func:`capture`
records a CUDA graph of a function and keeps every kernel's launch count
true across its capture and replays (:func:`replayed`); :class:`StaticGraph`
is one such graph on static inputs (SAM's encoder, AMG's selection), built
with :func:`warm_up` and looked up a key by :func:`replay_or_capture`,
which the MoE decoder's sequence of graphs shares.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

import torch

from llmseg_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ARCH = "arch=compute_90a,code=sm_90a"

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signature of each source's launcher, in csrc/<name>.cu
SIGNATURES = {
    "flash_fwd": [_P, _P, _P, _P, _LL, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "flash_fwd_1pass": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "flash_bwd_dq": [_P] * 8 + [_I] * 6 + [_P],
    "flash_bwd_dkv": [_P] * 8 + [_I] * 6 + [_P],
    "relpos_fwd": [_P] * 6 + [_I] * 5 + [_P],
    "relpos_window": [_P] * 6 + [_I] * 5 + [_P],
    "factored_decode": [_I] + [_P] * 5,
    "twoway_fused": [_I] + [_P] * 5,
    "flash_fwd_1pass_t": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "quant": [_I] + [_P] * 7 + [_I] * 4 + [_F, _P],
    "w8a8_gemm": [_P] * 7 + [_I] * 4 + [_P],
    "greedy_nms": [_P] * 5 + [_I, _F, _P],
    "moe_combine": [_P] * 5 + [_I] * 4 + [_P],
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_INSTANCES: list = []    # every Kernel made, in order


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _out_of_date(name: str) -> bool:
    lib = BUILD_DIR / f"lib{name}.so"
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in
                 [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])
    return lib.stat().st_mtime < newest


def build(names: Iterable[str] = tuple(SIGNATURES), force: bool = False) -> Dict[str, str]:
    """Compile the named kernels in parallel; returns nvcc's ``-Xptxas -v``
    report (registers, shared memory, spills) per kernel that was built.
    Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        if not force and not _out_of_date(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.so"
        cmd = [nvcc, "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
        else:
            os.replace(tmp, BUILD_DIR / f"lib{name}.so")
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


class Kernel:
    """A launcher with a count of its launches.  ``launch`` calls the C
    function ``source`` of ``csrc/<source>.cu`` (the kernel's name unless
    given: two kernels may share one source) on the current stream and
    raises if it reports an error; the count goes up only for a launch that
    was accepted."""

    def __init__(self, name: str, source: str = ""):
        self.name = name
        self.source = source or name
        self.launches = 0
        _INSTANCES.append(self)

    def launch(self, *args) -> None:
        lib = library(self.source)
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, self.source)(*args, stream)
        if err != 0:
            msg = getattr(lib, f"{self.source}_error_string")(err).decode()
            raise RuntimeError(f"{self.name} launch failed: {msg} ({err})")
        self.launches += 1


def launch_counts() -> Dict[Kernel, int]:
    """Every kernel's launch count."""
    return {k: k.launches for k in _INSTANCES}


def capture(fn: Callable, pool=None):
    """``fn()`` captured as a CUDA graph on the current stream's device:
    (the graph, ``fn``'s output, the launches it holds of each Kernel).  A
    Kernel launches through ctypes on the capturing stream, so the graph
    holds it; the capture itself ran nothing on the card, so what it moved
    of each ``Kernel.launches`` is taken back, and :func:`replayed` adds it
    for every replay.  ``pool``: a memory pool shared with other graphs."""
    before = launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
        out = fn()
    launches = {k: n - before.get(k, 0) for k, n in launch_counts().items()
                if n != before.get(k, 0)}
    for k, n in launches.items():
        k.launches -= n
    return graph, out, launches


def replayed(launches: Dict[Kernel, int]) -> None:
    """Count the launches of one replay of a graph (:func:`capture`)."""
    for k, n in launches.items():
        k.launches += n


def _tensors(out) -> list:
    """The tensors of a tensor, or of a list, tuple or dict of them, nested."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _tensors(o)]
    return []


def warm_up(fn: Callable, device):
    """``fn()`` run eagerly, as a capture's warm-up, on a side stream that
    starts after the current stream's work and that the current stream
    then waits for; its output's tensors are marked as used on the current
    stream, so that it is the first call's result."""
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn()
    cur.wait_stream(side)
    for t in _tensors(out):
        t.record_stream(cur)
    return out


def stamp(tensors: Iterable[torch.Tensor], versions: bool = False) -> tuple:
    """What recorded work was made from: each tensor's storage, dtype, shape
    and stride and, with ``versions``, its version counter, which every
    in-place change moves (for work that holds values made from the
    tensors).  An inference tensor has no version counter: it reads as
    having none, and its in-place changes are not seen."""
    return tuple((t.data_ptr(), t.dtype, t.shape, t.stride(),
                  t._version if versions and not t.is_inference() else None)
                 for t in tensors)


def cached(cache: Optional[Dict], name: str, inputs, fn, extra=()):
    """``fn(*inputs)``, kept in ``cache[name]`` while every input is the
    same tensor, unchanged (:func:`stamp` with versions) and ``extra`` is
    equal; anything else computes it anew.  The entry holds the inputs, so
    their storage is not reused by another tensor while it is kept.
    ``cache`` None: no caching."""
    if cache is None:
        return fn(*inputs)
    key = (stamp(inputs, versions=True), tuple(extra))
    hit = cache.get(name)
    if hit is None or hit[0] != key:
        hit = cache[name] = (key, tuple(inputs), fn(*inputs))
    return hit[2]


class StaticGraph:
    """``fn(keep, *inputs)`` as one CUDA graph on static inputs: buffers of
    the first call's inputs' shapes, dtypes and devices, into which each
    replay copies its inputs.  The first call runs ``fn`` eagerly (the
    warm-up, whose result is ``first``) and then captures it.  ``keep`` is
    a dict, new for each of the two, in which ``fn`` leaves what its
    kernels read besides its inputs and outputs (kernel G's plan); the
    graph keeps the capture's.  ``tensors`` (the weights) are stamped,
    with ``versions`` where the captured work holds values made from them:
    :meth:`current` fails once one has moved or, with versions, changed.
    Counters ``<counter>_captures`` and ``<counter>_replays``."""

    def __init__(self, fn: Callable, *inputs: torch.Tensor, tensors, counter: str,
                 versions: bool = False):
        self.tensors, self.versions, self.counter = list(tensors), versions, counter
        self.stamp = stamp(self.tensors, versions)
        with torch.inference_mode(False), torch.no_grad():
            self.inputs = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
                           for t in inputs]
            for buf, t in zip(self.inputs, inputs):
                buf.copy_(t)
            self.first = warm_up(lambda: fn({}, *self.inputs), inputs[0].device)
            self.keep = {}
            self.graph, self.out, self.launches = capture(lambda: fn(self.keep, *self.inputs))
        profiling.count(f"{counter}_captures")

    def current(self) -> bool:
        return self.stamp == stamp(self.tensors, self.versions)

    def replay(self, *inputs):
        """The captured outputs for ``inputs``, in the graph's own storage:
        read them before the next replay on this stream."""
        for buf, t in zip(self.inputs, inputs):
            buf.copy_(t)
        self.graph.replay()
        replayed(self.launches)
        profiling.count(f"{self.counter}_replays")
        return self.out


def replay_or_capture(graphs, owner, key, make: Callable, *inputs):
    """The result of ``owner``'s graph at ``key`` for ``inputs``.  ``graphs``
    maps owner -> {key: graph} (a ``WeakKeyDictionary``, dropped with the
    owner).  A graph whose ``current()`` holds replays
    (``graph.replay(*inputs)``); otherwise ``make(*inputs)`` warms up and
    captures a new one, whose warm-up result (``graph.first``) is returned
    and no longer kept by the graph."""
    table = graphs.setdefault(owner, {})
    g = table.get(key)
    if g is not None and g.current():
        return g.replay(*inputs)
    g = table[key] = make(*inputs)
    first, g.first = g.first, None   # the graph keeps no caller's tensor
    return first


NAMESPACE = "llmseg"


def kernel_op(name: str, *, cpu: Callable, fake: Callable) -> Callable:
    """Decorator: register the decorated function, whose annotations give
    the schema, as the CUDA implementation of ``llmseg::<name>``, ``cpu``
    (the plain version, same arguments) as its CPU implementation and
    ``fake`` (shapes and dtypes only) for tracing.  Returns the op."""
    def register(cuda_impl: Callable):
        op = torch.library.custom_op(f"{NAMESPACE}::{name}", cuda_impl, mutates_args=(),
                                     device_types="cuda")
        op.register_kernel("cpu", cpu)
        op.register_fake(fake)
        return op
    return register
