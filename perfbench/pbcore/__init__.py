"""The benchmark's harness: the manifest, seeded weights and inputs, the
measured window, the profiler's reading, the operation and byte counts and
the import guard.  Everything that belongs to one configuration, traffic
mix, entry or per-layer metric lives in files of its own beside it."""

import hashlib


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one stream (weights, one batch, one image, the
    check's sample) derived from the run's seed."""
    text = "/".join([str(int(seed))] + [str(t) for t in tags]).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1
