#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``llmseg_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

  1. build    compile every kernel in llmseg_tpu_torch/csrc with nvcc
              (one process per source, all at once);
  2. kernel   each kernel against its plain PyTorch version (float32 math on
              the same inputs) at the shapes the main path gives it, plus the
              ragged-key, bias/lse, rescue and float32 cases; times of the
              kernel, the plain version and one PyTorch library call
              (scaled_dot_product_attention, a yardstick the port never
              calls), and the card's least time for the same work;
  3. modules  llmseg_tiny predict on the card against the same weights on
              the CPU;
     in_place llmseg_7b widths and sequence lengths at two blocks per
              tower and two LLaMA layers: predict through the kernels
              against predict with all attention on the plain path;
  4. main     llmseg_7b in bf16 (random weights from a seed, LayerScale
              folded), make_batch(4 images, text_len 512) and predict: launch
              counts of every kernel in that run, finite (4, 50) outputs,
              ms/step, img/s and peak memory;
     breakdown  each stage of predict timed alone, and one step's device
              time by kernel family (torch.profiler) with the device's idle
              share;
  5. kernels  one line with every kernel's numbers, then the card's name and
              power limit from nvidia-smi, then {"ok": true, "device": ...}.

Without CUDA it exits 2 and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12      # dense bf16 tensor-core peak
# kernel vs float32 math on the same inputs: |err| <= atol + rtol * |ref|.
# bf16 keeps 8 significant bits (output rounding alone is up to 2^-9 of the
# value) and the kernels round p to bf16 before the second product, as the
# TPU kernels do; float32 differs only in summation order.
BF16_TOL = (1e-2, 1e-2)
F32_TOL = (1e-4, 0.0)
MODULE_LIMIT = 1e-4           # tiny predict, card vs CPU, float32
OUT_DIR = "chiprun_out"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def causal_pairs(T: int, S: int) -> int:
    return sum(min(i + 1, S) for i in range(T))


def kernel_case(A, name, *, BH, T, S, D, causal=None, dtype, adversarial=False,
                bias=False, lse=False, timed=False, seed=0):
    """One comparison of a kernel with its plain version; with ``timed``
    also the kernel's, the plain version's and the library call's times."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = dict(device="cuda", dtype=torch.float32)
    scale = 1.0 / math.sqrt(D)
    if adversarial:
        # near-orthogonal q/k of large norm: the Cauchy bound overshoots the
        # row maximum by far more than 40 (log2), so every row is rescued
        q = torch.zeros(BH, T, D, **dev)
        k = torch.zeros(BH, S, D, **dev)
        q[..., :D // 2] = torch.randn(BH, T, D // 2, generator=g, **dev) * 30
        k[..., D // 2:] = torch.randn(BH, S, D // 2, generator=g, **dev) * 30
        q[..., D // 2] = torch.randn(BH, T, generator=g, **dev) * 0.3
    else:
        q = torch.randn(BH, T, D, generator=g, **dev)
        k = torch.randn(BH, S, D, generator=g, **dev)
    v = torch.randn(BH, S, D, generator=g, **dev)
    q = (q.to(dtype) * torch.tensor(scale * A.LOG2E, dtype=dtype, device="cuda")).contiguous()
    k, v = k.to(dtype).contiguous(), v.to(dtype).contiguous()
    b = (torch.randn(BH, T, S, generator=g, **dev) * A.LOG2E) if bias else None

    if name == "flash_fwd":
        run = lambda: A.flash_fwd(q, k, v, causal=causal, bias=b, with_lse=lse)
        plain = lambda qq, kk, vv, bb: A.flash_fwd_plain(qq, kk, vv, causal=causal,
                                                        bias=bb, with_lse=lse)
    else:
        run = lambda: (A.flash_fwd_1pass(q, k, v), None)
        plain = lambda qq, kk, vv, bb: (A.flash_fwd_1pass_plain(qq, kk, vv, A.key_norm_max(kk)), None)
    o, l2 = run()
    torch.cuda.synchronize()
    # float32 reference in chunks of heads (B's logits are 4 GB at full size)
    atol, rtol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    err = err_lse = excess = 0.0
    step = 8
    for i in range(0, BH, step):
        sl = slice(i, i + step)
        ro, rl = plain(q[sl].float(), k[sl].float(), v[sl].float(),
                       None if b is None else b[sl])
        diff = (o[sl].float() - ro).abs()
        err = max(err, diff.max().item())
        excess = max(excess, (diff - atol - rtol * ro.abs()).max().item())
        if lse:
            err_lse = max(err_lse, (l2[sl] - rl).abs().max().item())
    rec = {"phase": "kernel", "kernel": name, "BH": BH, "T": T, "S": S, "D": D,
           "causal": causal, "dtype": str(dtype).split(".")[-1], "bias": bias,
           "lse": lse, "adversarial": adversarial, "max_abs_err": err,
           "atol": atol, "rtol": rtol}
    if lse:
        rec["lse_max_abs_err"] = err_lse
    ok = math.isfinite(err) and excess <= 0.0 and (not lse or err_lse <= F32_TOL[0])
    if timed:
        rec["ms"] = cuda_ms(run, 20)
        rec["plain_ms"] = cuda_ms(lambda: plain(q, k, v, b), 3)
        q4, k4, v4 = (x.unsqueeze(0) for x in (q, k, v))
        rec["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=bool(causal), scale=1.0 / A.LOG2E), 20)
        pairs = causal_pairs(T, S) if causal else T * S
        nbytes = q.element_size() * BH * D * (2 * T + 2 * S)
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 4.0 * BH * D * pairs)
    rec["ok"] = ok
    emit(rec)
    if not ok:
        raise SystemExit(f"{name} disagrees with its plain version: {rec}")
    return rec


def kernels_in_place(C, llmseg, make_batch, A) -> dict:
    """``llmseg_7b`` at full width and sequence lengths, depth cut to two
    blocks per tower and two LLaMA layers: predict through the kernels
    against predict with every attention sent to the plain path, in float32
    (gated, the kernels' float32 path) and bf16 (reported).  This checks the
    kernels inside the model: layouts, pre-scaling, head padding, dispatch."""
    import torch
    from llmseg_tpu_torch.models import llama, vit

    full = C.llmseg_7b()
    cfg = C.replace(full, dino=C.replace(full.dino, depth=2),
                    llava=C.replace(full.llava, llm=C.replace(full.llava.llm, num_layers=2),
                                    vision=C.replace(full.llava.vision, depth=3)))
    batch = make_batch(cfg, num_images=4, rows_per_image=1, text_len=512, seed=3)

    def plain_attention(q, k, v, *, bias=None, causal=False, scale=None):
        return A.attention_plain(q, k, v, bias=bias, causal=causal, scale=scale)

    rec = {"phase": "in_place", "config": "llmseg_7b, towers 2 blocks, LLaMA 2 layers",
           "limit_float32": MODULE_LIMIT}
    for dtype in (torch.float32, torch.bfloat16):
        model = llmseg.init(cfg, seed=1, device="cuda", dtype=dtype)
        for kern in A.KERNELS:
            kern.launches = 0
        got = llmseg.predict(model, batch)
        launches = {kern.name: kern.launches for kern in A.KERNELS}
        vit.attention, llama.attention = plain_attention, plain_attention
        try:
            ref = llmseg.predict(model, batch)
        finally:
            vit.attention, llama.attention = A.attention, A.attention
        name = str(dtype).split(".")[-1]
        rec[name] = max((got[k].float() - ref[k].float()).abs().max().item()
                        for k in ("pred_similarity", "pred_iou"))
        rec[f"{name}_launches"] = launches
        del model
    rec["ok"] = (rec["float32"] <= MODULE_LIMIT
                 and rec["float32_launches"] == {"flash_fwd": 2, "flash_fwd_1pass": 2})
    if not rec["ok"]:
        raise SystemExit(f"kernels disagree with the plain path inside the model: {rec}")
    return rec


def breakdown(model, batch, step_ms: float) -> dict:
    """Where a predict step's time goes: each stage timed alone with CUDA
    events, and the device time of one step by kernel family from
    torch.profiler (its full table goes to chiprun_out/)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from llmseg_tpu_torch.models import llmseg, vit

    with torch.inference_mode():
        img = model.llava.encode_images(batch["images_clip"])
        stages = {
            "dino_tower": lambda: vit.dino_patch_features(model.dino, batch["images_dino"]),
            "clip_tower": lambda: model.llava.encode_images(batch["images_clip"]),
            "llama": lambda: model.llava(input_ids=batch["input_ids"],
                                         image_pos=batch["image_pos"], image_embeds=img),
        }
        stage_ms = {name: cuda_ms(fn, 3) for name, fn in stages.items()}
    stage_ms["rest"] = step_ms - sum(stage_ms.values())

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        llmseg.predict(model, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    attr = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    families = {"kernel_b": 0.0, "kernel_a": 0.0, "matmul": 0.0, "other": 0.0}
    for e in events:
        us = getattr(e, attr)
        if e.device_type != torch.autograd.DeviceType.CUDA or us <= 0:
            continue   # operators: their kernels are counted as kernels
        name = e.key.lower()
        if "flash_fwd_1pass" in name:
            fam = "kernel_b"
        elif "flash_fwd" in name:
            fam = "kernel_a"
        elif any(s in name for s in ("gemm", "nvjet", "cutlass", "xmma", "sm90")):
            fam = "matmul"
        else:
            fam = "other"
        families[fam] += us / 1e3
    device_ms = sum(families.values())
    with open(os.path.join(OUT_DIR, "chip_smoke_profile.txt"), "w") as f:
        f.write(events.table(sort_by=attr, row_limit=40))
    return {"phase": "breakdown", "stage_ms": stage_ms, "profiled_step_ms": wall_ms,
            "device_ms_by_family": families, "device_ms": device_ms,
            "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms)}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from llmseg_tpu_torch import config as C
    from llmseg_tpu_torch.data.synthetic import make_batch
    from llmseg_tpu_torch.models import llmseg
    from llmseg_tpu_torch.ops import attention as A
    from llmseg_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 references stay float32
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(OUT_DIR, exist_ok=True)

    # 1. build
    t0 = time.time()
    reports = kernels.build(force=True)
    build_s = time.time() - t0
    with open(os.path.join(OUT_DIR, "chip_smoke_ptxas.txt"), "w") as f:
        for name, rep in reports.items():
            f.write(f"== {name}\n{rep}\n")
    emit({"phase": "build", "seconds": build_s, "kernels": sorted(reports),
          "ptxas": {n: [ln.strip() for ln in r.splitlines() if "registers" in ln or "spill" in ln]
                    for n, r in reports.items()}})

    # 2. kernels against their plain versions, at the main path's shapes
    bf16, f32 = torch.bfloat16, torch.float32
    main_a = kernel_case(A, "flash_fwd", BH=4 * 32, T=767, S=767, D=128, causal=True,
                         dtype=bf16, timed=True)
    kernel_case(A, "flash_fwd", BH=4 * 32, T=767, S=700, D=128, causal=False, dtype=bf16)
    kernel_case(A, "flash_fwd", BH=2 * 4, T=300, S=300, D=64, causal=True, dtype=bf16,
                bias=True, lse=True)
    kernel_case(A, "flash_fwd", BH=2, T=300, S=300, D=128, causal=True, dtype=f32,
                bias=True, lse=True)
    kernel_case(A, "flash_fwd", BH=2, T=128, S=100, D=64, causal=False, dtype=f32)
    main_b = kernel_case(A, "flash_fwd_1pass", BH=4 * 16, T=4097, S=4097, D=64,
                         dtype=bf16, timed=True)
    kernel_case(A, "flash_fwd_1pass", BH=16, T=4097, S=4097, D=64, dtype=bf16,
                adversarial=True)
    kernel_case(A, "flash_fwd_1pass", BH=4, T=200, S=300, D=128, dtype=bf16)
    kernel_case(A, "flash_fwd_1pass", BH=2, T=200, S=300, D=64, dtype=f32,
                adversarial=True)
    kernel_case(A, "flash_fwd_1pass", BH=2, T=200, S=300, D=64, dtype=f32)

    # 3. the port's modules on the card against the CPU, tiny config
    tiny = C.llmseg_tiny()
    m_cpu = llmseg.init(tiny, seed=0, device="cpu")
    m_gpu = llmseg.build(tiny, device="cuda")
    m_gpu.load_state_dict(m_cpu.state_dict())
    b_cpu = make_batch(tiny, num_images=2, rows_per_image=2, text_len=32, seed=1, device="cpu")
    b_gpu = {k: v.cuda() for k, v in b_cpu.items()}
    rec = {"phase": "modules", "config": "llmseg_tiny", "limit": MODULE_LIMIT}
    for pool in llmseg.POOL_ROUTES:
        oc = llmseg.predict(m_cpu, b_cpu, device="cpu", pool=pool)
        og = llmseg.predict(m_gpu, b_gpu, pool=pool)
        rec[pool] = max((og[k].cpu() - oc[k]).abs().max().item()
                        for k in ("pred_similarity", "pred_iou"))
    rec["ok"] = all(rec[p] <= MODULE_LIMIT for p in llmseg.POOL_ROUTES)
    emit(rec)
    if not rec["ok"]:
        raise SystemExit("tiny predict on the card disagrees with the CPU")
    del m_cpu, m_gpu
    emit(kernels_in_place(C, llmseg, make_batch, A))

    # 4. the main path: llmseg_7b, bf16, batch 4
    cfg = C.llmseg_7b()
    t0 = time.time()
    model = llmseg.init(cfg, seed=0, device="cuda", dtype=bf16)
    llmseg.fold_frozen_inplace(model)
    batch = make_batch(cfg, num_images=4, rows_per_image=1, text_len=512, seed=0)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    for kern in A.KERNELS:
        kern.launches = 0
    out = llmseg.predict(model, batch)
    torch.cuda.synchronize()
    launches = {kern.name: kern.launches for kern in A.KERNELS}
    expect = {"flash_fwd": cfg.llava.llm.num_layers, "flash_fwd_1pass": cfg.dino.depth}
    sim, iou = out["pred_similarity"], out["pred_iou"]
    finite = bool(torch.isfinite(sim).all() and torch.isfinite(iou).all())
    shape_ok = tuple(sim.shape) == (4, cfg.max_proposals) == tuple(iou.shape)
    steps = 5
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        llmseg.predict(model, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    rec = {"phase": "main", "config": "llmseg_7b", "dtype": "bfloat16", "batch_images": 4,
           "text_len": 512, "seq_len": 512 + cfg.llava.num_image_tokens - 1,
           "setup_s": setup_s, "launches": launches, "expected_launches": expect,
           "shape": list(sim.shape), "finite": finite, "ms_per_step": step_ms,
           "img_per_s": 4 * 1e3 / step_ms,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "sim_range": [sim.min().item(), sim.max().item()],
           "iou_range": [iou.min().item(), iou.max().item()]}
    rec["ok"] = finite and shape_ok and launches == expect
    emit(rec)
    if not rec["ok"]:
        raise SystemExit("main path failed")
    emit(breakdown(model, batch, step_ms))

    # 5. summary
    sources = {"flash_fwd": ("llmseg_tpu_torch/csrc/flash_fwd.cu",
                             "llmseg_tpu/ops/attention.py:100"),
               "flash_fwd_1pass": ("llmseg_tpu_torch/csrc/flash_fwd_1pass.cu",
                                   "llmseg_tpu/ops/attention.py:285")}
    rows = []
    for r in (main_a, main_b):
        src, rep = sources[r["kernel"]]
        rows.append({"name": r["kernel"], "route": "cuda", "source": src, "replaces": rep,
                     "launches": launches[r["kernel"]], "max_abs_err": r["max_abs_err"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    emit({"kernels": rows})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
