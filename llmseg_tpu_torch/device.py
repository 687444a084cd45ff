"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU; a request
for CUDA on a machine without it raises instead of running elsewhere.
"""

from __future__ import annotations

import torch


def require(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
