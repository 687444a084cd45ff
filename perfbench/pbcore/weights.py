"""Weights made from the seed, on the device, in the type they are served in.

A specification is a list of (name, shape, kind).  All the weights come
from one ``torch.Generator`` seeded with the run's seed, in a few large
draws of standard normals (up to ``CHUNK`` values each), in the order of
the specification; each tensor is then scaled by its kind:

* ``fan_in``: std 1/sqrt(fan_in) (LeCun), fan_in = the product of the
  shape after the first axis;
* ``upscale``: as ``fan_in``, then every tap of the 2x2 transposed
  convolution set to the first one (random taps lay a 4 x 4 pattern over
  every low-resolution mask that outweighs the image's own part);
* ``small``: std 0.02 (biases, embeddings, positions);
* ``unit``: std 1 (SAM's tokens, prompt embeddings, Fourier matrix);
* ``scale``: 1 + 0.1 N (norm scales);
* ``layerscale``: 0.1 (1 + 0.1 N).

The same seed gives the same tensors on any device with the same
generator; the program gets them copied into its modules, the reference
makes them again after the program has been freed.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Tuple

import torch

CHUNK = 1 << 28


def _scaled(x: torch.Tensor, shape: Tuple[int, ...], kind: str) -> torch.Tensor:
    x = x.view(shape)
    fan_in = math.prod(shape[1:]) if len(shape) > 1 else 1
    if kind in ("fan_in", "upscale"):
        x = x * fan_in ** -0.5
        if kind == "upscale":
            x = x[..., :1, :1].expand(shape).contiguous()
        return x
    if kind == "small":
        return x * 0.02
    if kind == "unit":
        return x
    if kind == "scale":
        return 1.0 + 0.1 * x
    if kind == "layerscale":
        return 0.1 * (1.0 + 0.1 * x)
    raise ValueError(f"unknown weight kind {kind!r}")


def generate(specs: Iterable, seed: int, device, dtype,
             sink: Callable[[str, torch.Tensor], None]) -> int:
    """Draw every weight of ``specs`` and hand each to ``sink(name,
    tensor)`` (a fresh tensor of ``dtype`` on ``device``).  Returns the
    number of values drawn."""
    specs = list(specs)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    i, total = 0, 0
    while i < len(specs):
        j, n = i, 0
        while j < len(specs) and (n == 0 or n + math.prod(specs[j][1]) <= CHUNK):
            n += math.prod(specs[j][1])
            j += 1
        flat = torch.randn(n, generator=gen, device=device, dtype=dtype)
        off = 0
        for name, shape, kind in specs[i:j]:
            size = math.prod(shape)
            sink(name, _scaled(flat[off:off + size], tuple(shape), kind).to(dtype))
            off += size
        del flat
        total += n
        i = j
    return total


def load_into(module: torch.nn.Module, specs, seed: int, device, dtype) -> None:
    """Copy the seeded weights into ``module``'s parameters, by name; every
    parameter must be specified, with its shape."""
    params = dict(module.named_parameters())
    want = {name: tuple(shape) for name, shape, _ in specs}
    missing = sorted(set(params) - set(want))
    extra = sorted(set(want) - set(params))
    if missing or extra:
        raise ValueError(f"weights do not fit the program: unspecified {missing[:5]}, "
                         f"unknown {extra[:5]}")

    def sink(name, t):
        p = params[name]
        if tuple(p.shape) != tuple(t.shape):
            raise ValueError(f"{name}: program {tuple(p.shape)}, specified {tuple(t.shape)}")
        with torch.no_grad():
            p.copy_(t)

    generate(specs, seed, device, dtype, sink)


def as_dict(specs, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    generate(specs, seed, device, dtype, out.__setitem__)
    return out
