"""Which collectives gloo carries on CUDA tensors, with two ranks on one
card (nccl refuses two ranks on one device): a MAX all-reduce of float32,
a SUM all-reduce of int32 and float32, list all-gathers of int8, float32
and bf16.  The mesh's quantized path needs each of them.

  python scripts/gloo_cuda_probe.py            # starts both ranks, prints one JSON line

Exits non-zero if a collective fails or gives a wrong value."""

import json
import os
import socket
import subprocess
import sys


def rank_main() -> int:
    import datetime

    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method="env://",
                            timeout=datetime.timedelta(seconds=60))
    r = dist.get_rank()
    dev = torch.device("cuda", 0)
    out = {}

    def check(name, fn):
        try:
            out[name] = bool(fn())
        except Exception as e:  # noqa: BLE001 - reported, then the run fails
            out[name] = f"{type(e).__name__}: {e}"

    def max_f32():
        x = torch.tensor([1.0 + r, -5.0 * r, 3.0], device=dev)
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        return x.tolist() == [2.0, 0.0, 3.0]

    def sum_i32():
        x = torch.full((4, 3), 2 ** 30 - 1 if r == 0 else -(2 ** 30), dtype=torch.int32,
                       device=dev)
        dist.all_reduce(x)
        return bool((x == -1).all())

    def sum_f32():
        x = torch.full((5,), 0.5 + r, device=dev)
        dist.all_reduce(x)
        return bool((x == 2.0).all())

    def gather(dtype):
        def fn():
            x = torch.full((3, 2), r - 2, device=dev).to(dtype)
            parts = [torch.empty_like(x) for _ in range(2)]
            dist.all_gather(parts, x)
            return all(bool((p == i - 2).all()) for i, p in enumerate(parts))
        return fn

    check("all_reduce_max_float32", max_f32)
    check("all_reduce_sum_int32", sum_i32)
    check("all_reduce_sum_float32", sum_f32)
    for dtype in (torch.int8, torch.float32, torch.bfloat16):
        check(f"all_gather_{str(dtype).split('.')[-1]}", gather(dtype))
    dist.destroy_process_group()
    if r == 0:
        print(json.dumps({"probe": "gloo_cuda", "ranks": 2, "device": torch.cuda.get_device_name(0),
                          "results": out}), flush=True)
    return 0 if all(v is True for v in out.values()) else 1


def main() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, __file__, "--rank"],
                              env=dict(os.environ, RANK=str(r), WORLD_SIZE="2",
                                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)))
             for r in range(2)]
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=180))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    return max(abs(c) for c in codes)


if __name__ == "__main__":
    sys.exit(rank_main() if "--rank" in sys.argv else main())
