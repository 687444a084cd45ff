"""What the harness takes from the program beyond its entry points: the
launch counters of its hand-written kernels."""

from __future__ import annotations

import importlib
from typing import Dict

KERNEL_MODULES = ("attention", "relpos_attention", "twoway_kernel", "quant")


def kernels() -> Dict:
    """{name: ops.kernels.Kernel} of every kernel the program's ops define."""
    from llmseg_tpu_torch.ops.kernels import Kernel
    out = {}
    for mod in KERNEL_MODULES:
        m = importlib.import_module(f"llmseg_tpu_torch.ops.{mod}")
        for v in vars(m).values():
            if isinstance(v, Kernel):
                out[v.name] = v
    return out


def launches() -> Dict[str, int]:
    return {name: k.launches for name, k in kernels().items()}
