"""Readings that set a cell's limits, in one process on the card: the
program's numbers on each seed (set-up, a window, the program freed, the
comparison with the float32 reference), and the control's (the reference
computed in fp8 in the program's place) on ``--control-seeds``.  One JSON
line a reading on standard output, with the window's end-to-end figures.

    python3 perfbench/readings.py --workload <name> --seeds 1 2 3 --control-seeds 1 2 3 \\
        [--seconds S]
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=0.0,
                   help="window length (default: as many steps as the check samples)")
    args = p.parse_args()
    import torch
    from pbcore import manifest
    cell = manifest.load(args.workload)
    traffic, config = cell.traffic, cell.config
    Entry = cell.entry().Entry
    steps = 0 if args.seconds else max(traffic.get("check_batches", 0),
                                       traffic.get("check_images", 0), 1)
    overflow = _count_overflow() if cell.work["entry"] == "amg" else None
    for kind, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in seeds:
            t0 = time.perf_counter()
            if overflow:
                overflow.update(masks=0, overflowed=0)
            e = Entry(config, traffic, seed, "cuda")
            e.setup()
            w = e.window(args.seconds, max_steps=steps)
            e.release()
            got = e.check() if kind == "program" else e.control("fp8")
            print(json.dumps({"workload": args.workload, "kind": kind, "seed": seed,
                              "numbers": got, "window": w["metrics"], "host": w["host"],
                              "overflow": overflow,
                              "s": time.perf_counter() - t0}), flush=True)
            del e
            torch.cuda.empty_cache()
    return 0


def _count_overflow() -> dict:
    """Count the survivors whose columns overflow the device RLE (they take
    the bit-packed path), by wrapping the program's decoder of the payload."""
    from llmseg_tpu_torch.models.sam import amg
    tally = {"masks": 0, "overflowed": 0}
    real = amg.device_rle.annotations_from_rle_payload

    def counted(*a, **k):
        out = real(*a, **k)
        tally["masks"] += len(out)
        tally["overflowed"] += sum(d is None for d in out)
        return out

    amg.device_rle.annotations_from_rle_payload = counted
    return tally


if __name__ == "__main__":
    sys.exit(main())
