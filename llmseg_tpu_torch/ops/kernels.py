"""Build and load the CUDA kernels in ``llmseg_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) under ``llmseg_tpu_torch/_build/``, at first use, and loaded with
``ctypes``.  :func:`build` compiles several sources at once, one ``nvcc``
process each.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ARCH = "arch=compute_90a,code=sm_90a"

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signature of each source's launcher, in csrc/<name>.cu
SIGNATURES = {
    "flash_fwd": [_P, _P, _P, _P, _LL, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "flash_fwd_1pass": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "flash_bwd_dq": [_P] * 8 + [_I] * 6 + [_P],
    "flash_bwd_dkv": [_P] * 8 + [_I] * 6 + [_P],
    "relpos_fwd": [_P] * 6 + [_I] * 5 + [_P],
    "relpos_window": [_P] * 6 + [_I] * 5 + [_P],
    "factored_decode": [_I] + [_P] * 5,
    "twoway_fused": [_I] + [_P] * 5,
    "flash_fwd_1pass_t": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "quant": [_I] + [_P] * 7 + [_I] * 4 + [_F, _P],
}

_LIBS: Dict[str, ctypes.CDLL] = {}


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

    def launch(self, *args) -> None:
        lib = library(self.source)
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, self.source)(*args, stream)
        if err != 0:
            msg = getattr(lib, f"{self.source}_error_string")(err).decode()
            raise RuntimeError(f"{self.name} launch failed: {msg} ({err})")
        self.launches += 1
