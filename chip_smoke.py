#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``llmseg_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

  1. build    compile every kernel in llmseg_tpu_torch/csrc with nvcc
              (one process per source, all at once);
  2. kernel   each kernel against its plain PyTorch version (float32 math on
              the same inputs) at the shapes the main paths give it, plus the
              ragged-key, bias/lse, rescue and float32 cases; times of the
              kernel, the plain version and one PyTorch library call
              (scaled_dot_product_attention, forward or backward, a yardstick
              the port never calls), and the card's least time for the same
              work.  SAM's kernels E and F use random nonzero rel-pos tables
              (the model's are zero at init); kernel G is also held on a
              chunk that replays its recorded launch sequence; kernel H at
              the pixel decoder's shape (8 prompts of 6 tokens), at 64
              prompts of 7 with a base per prompt and with a shared base
              (not factored), kernel I at 64 x 7, each recording its plan
              and replaying it on a new base and new tokens, repeated to
              the bit, with each fused kernel against its record's
              emulation, its device clock and its breakdown by part
              (tw_breakdown), and H and I at 1, 9 prompts and 1, 16
              tokens; kernel J (the transposed
              one-pass forward) at DINOv2-L's shape with adversarial norms;
              A and J also at lengths off their 128-row tiles, with one head,
              A with a broadcast bias and with none, J with rescued rows
              beside rows that are not; C and D at lengths off their tiles
              (1, 65, 129), S != T both ways, one head and D = 64 at the
              training length, and run twice on the same inputs, equal to
              the bit; B at lengths off its tiles, one head, D = 128 with
              rescued rows beside rows that are not, and B against J on the
              same inputs (o and o^T equal to the bit); F at one pair, at an
              evaluate's 3,200 pairs, on zero-padded edge windows, at
              G = 2 and 22, with bitwise repeats; the quant kernels Q1
              (csrc/quant.cu) and Q2 (csrc/w8a8_gemm.cu, the int8 product
              with its rescale) at llmseg_7b's W8A8 shapes (3068 and 6136
              rows, widths 4096 and 11008), at 1, 16, 17 and 129 rows, in
              float32, with a bias or a side term, Q1 on its scalar path,
              Q2 equal to its plain version to the bit; their time a step
              beside their bound, Q2 beside the route it replaced
              (torch._int_mm, then the standalone rescale) and
              torch._int_mm alone, and the padded int8 product exact;
  3. modules  llmseg_tiny predict on the card against the same weights on
              the CPU;
     in_place llmseg_7b widths and sequence lengths at two blocks per
              tower and two LLaMA layers: predict through the kernels
              against predict with all attention on the plain path;
     grad_in_place  the same cut model with LoRA: loss_fn and the gradient
              of every trainable parameter through the kernels (remat
              "dots") against the plain attention path (remat "none");
     sam_in_place  sam_vit_h widths at two encoder blocks (one global):
              the encoder through E and F, and two chunks of 64 prompts
              through G, against the plain paths, float32;
     pixel_in_place  the pixel decoder (models/pixel_decoder.py) at
              llmseg_7b and sam_vit_h widths, two LLaMA layers, towers and
              SAM encoder cut to 2-3 blocks, 8 images, 8 new tokens,
              float32: generation (prefill through A), the SAM encoder (E,
              F) and the decode (H) against the plain paths, with the
              smallest top-1 / top-2 logit gap of the generated steps;
     w8a8_in_place  the cut llmseg_7b in float32 with its LLaMA calibrated
              and quantized W8A8: predict through Q1 and Q2, each call
              against its plain version on the same tensors (Q2 to the
              bit), then against
              predict on the plain versions (within half the quantization
              error: codes flip in cascade from an ulp of the scale);
     qlora_in_place  grad_in_place with an int8 frozen base
              (optim.quantize_skeleton), float32, under its gates; the plain
              run takes the kernel run's side of a selection-head ReLU kink
              where the two differ within rounding;
  4. main     llmseg_7b in bf16 (random weights from a seed, LayerScale
              folded), make_batch(4 images, text_len 512) and predict: launch
              counts of every kernel in that run, finite (4, 50) outputs,
              ms/step, img/s and peak memory;
     onepass_t  the same predict with the non-causal forward switched to
              kernel J (LLMSEG_ATTN_ONEPASS_T's flag): J 24 launches, B 0,
              outputs within the bf16 gate of the default run, ms/step;
     w8a8     the headline lane on the same model: bf16 at batch 8, one
              step each with the LLaMA weight-only int8 and int4, then
              SmoothQuant calibration on a one-image probe, the model
              quantized W8A8 in place, top-1 agreement and max|dsim| on the
              probe against bf16, launches of A, B, Q1 and Q2 a step at
              batch 4 and 8 (none of torch._int_mm or the standalone
              rescale), and ms/step, img/s and peak memory at both;
     valloop  bench.py's val loop (run_valloop) on the port: run_validation
              over eval_step at batch 8, 48 images, strategy "threshold",
              in bf16 (before the W8A8 phase) and in W8A8 (on its model):
              img/s, gIoU, cIoU, the forward-only rate, launches a batch;
              the numpy compose on the same scores must give the same bits;
     import   a reference checkpoint set written from seeded weights at
              llmseg_7b width (LLaMA cut to 4 of 32 layers, DINOv2 and CLIP
              whole, LoRA on q/v, sam_vit_h) into a temporary directory:
              a DINOv2 hub .pth with its 37 x 37 table, a CLIP HF dir, a
              LLaVA HF dir in two .bin shards with their index, an LLM-Seg
              DeepSpeed checkpoint (latest -> global_step10, peft names),
              a SAM .pth; each imported onto the card by
              import_weights.torch_import: every parameter equal to its
              source to the bit, predict equal to the source's to the bit,
              the DINOv2 table within 1e-6 of this file's float64 resize;
              seconds, bytes and peak host RSS of each import;
     serve    on the imported model: predict exported at batch 4,
              text_len 512 in bf16, then quantized in place to W8A8 and
              exported again; both saved, the model freed, both loaded and
              run: equal to eager predict to the bit, launches per call A 4,
              B 24 (and Q1 16, Q2 28), one per op node; export, save and
              load seconds, bytes, ms per call beside eager (median of 5,
              events); SAM's decoder program at sam_vit_h's decoder width,
              64 prompts, single mask, equal to its eager function;
  5. data     the LLM-Seg40K fine-tune path (cli/finetune.py's wiring) on
              a corpus in the reference's layout written from a seed into
              a temporary directory (train and validation json, 480 x 640,
              640 x 480 and 427 x 640 images named under coco/train2017
              and ego_objects/images, three masks.json files of 50 COCO-RLE
              proposals an image); the image decode is stood in for by an
              image made from the seed (the card's machine has no cv2 or
              PIL), everything after it is the package's code:
              LLMSegDataset through BatchLoader (batch 1, 8 micro-steps, 2
              threads, pinned) into Trainer.train_epoch at llmseg_7b, bf16,
              LoRA r8 (steps_per_epoch 4, grad_accum_steps 2), then
              ValLLMSegDataset (13 images, batch 8, filler rows invalid)
              into Trainer.validate; gates: each batch on the card equals,
              copied back, the numpy batch collate gave; a one-thread
              loader equals direct dataset[i] + collate calls; finite
              losses, every LoRA tensor moved; gIoU / cIoU equal the numpy
              compose's; launches A 64, B 24, C 32, D 32 a micro-step and
              A 32, B 24 a val batch; the host ms of one __getitem__ by
              part, collate ms, the loader's wait against the step's ms,
              peak device memory and host RSS;
     train    the LoRA train step at llmseg_7b in bf16 through the Trainer
              (1 image, 1 row, text_len 512, remat "dots"): launch counts per
              step, finite losses, frozen weights bit-identical and trainable
              ones changed, ms/step and peak memory;
     train_breakdown  forward, backward and optimizer times of one step,
              the step under each remat policy, and one step's device time
              by kernel family (torch.profiler) with the idle share;
     qlora    bench.py's train lane (run_trainstep): the Trainer with an
              int8 frozen base, remat "dots", 1 image, 1 row, text_len 512:
              one warm step, three runs of 8 timed steps (the least, the
              spread), peak memory, launches a step, the products "dots"
              saved; then a timed step on an int4 base; buffers bit-identical,
              trainables moved, lm_head and embed_tokens bf16 parameters;
     breakdown  each stage of predict timed alone, and one predict step's
              device time by kernel family with the idle share;
     bwd_device_time  device time (device_ms) of kernels C and D and
              of SDPA's backward at the training shape: SDPA's is C and
              D's library_ms, and C + D on the same clock stands beside it;
     fwd_device_time  device time of kernels A, B and J and of SDPA's
              forward, and of E and F and of SDPA with their bias as a
              mask, at their main shapes (near 50 us the event clock of
              the kernel phase also counts the wrappers' host time); both
              go into the kernels line as device_ms and library_device_ms,
              with J's exp2 bound (16 a clock an SM) as ex2_bound_ms;
  6. pixel    the pixel-decoder entry point, evaluate(), at llmseg_7b +
              sam_vit_h in bf16 (random weights from seeds), 8 images,
              767-token prompts, 32 new tokens: launches per evaluate (A 32,
              E 4, F 28, H 1), finite outputs of the right shapes (the
              masks before the [SEG] select too), ms/evaluate, images/s,
              peak memory and the split into CLIP, prefill, decode steps,
              SAM encoder, and SAM decode with postprocess;
     amg      sam_vit_h in bf16 (random weights from a seed): generate() on
              three synthetic images with the default AMGConfig, then with
              the filters opened, then with NMS off too; launch counts per
              image (E 4, F 28, G 16), annotation schema, ms/image, peak
              memory and one image in parts;
     w8a8_breakdown  the same for a W8A8 step;
     amg_breakdown, pixel_breakdown  one image's (one evaluate's)
              device time by kernel family and the idle share;
  7. kernels  one line with every kernel's numbers, then the card's name and
              power limit from nvidia-smi, then {"ok": true, "device": ...}.

torch.profiler runs only after every timed phase: it leaves host cost on
the calls that follow it, and the paths are partly host-bound.

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
INT8_OPS_PER_S = 1979e12      # dense int8 tensor-core peak
# kernel vs float32 math on the same inputs: |err| <= atol + rtol * |ref|.
# bf16 keeps 8 significant bits (output rounding alone is up to 2^-9 of the
# value) and the kernels round p to bf16 before the second product, as the
# TPU kernels do; float32 differs only in summation order.
BF16_TOL = (1e-2, 1e-2)
F32_TOL = (1e-4, 0.0)
# backward kernels C and D, normwise per output: max|err| <= tol * max|ref|.
# p and ds are rounded to bf16 and summed over up to S (dq) or T (dk, dv)
# terms, so the error of an entry scales with its whole row or column, not
# with the entry: a pointwise atol + rtol*|ref| gate does not fit.  (With
# S = 1, where dq and dk vanish, see bwd_case.)
BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
MODULE_LIMIT = 1e-4           # tiny predict, card vs CPU, float32
GRAD_LIMIT = 1e-4             # grad_in_place, float32, per tensor vs max|ref|
FLIP_LIMIT = 1e-5             # qlora_in_place: a ReLU unit whose gate flips between the
                              # paths has its pre-activation within rounding of zero,
FLIP_UNITS = 4                # and a handful of units flip at most
PLANTED_FAULT = 1e-3          # qlora_in_place's control: LLaMA's attention output scaled
                              # by 1 + this must fail the same gates
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


def kernel_times(prof):
    """The averaged events of a torch.profiler run, the name of their
    device-time attribute (which differs between torch versions), and
    (name, ms) of every device kernel that took time."""
    import torch
    events = prof.key_averages()
    attr = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    kernels = [(e.key, getattr(e, attr) / 1e3) for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and getattr(e, attr) > 0]
    return events, attr, kernels


def device_ms(fn, iters: int) -> float:
    """Device time of ``fn`` per call, for calls whose host work may outlast
    their kernels: the calls are queued behind a spin kernel
    (torch.cuda._sleep) that outlasts their host time, so the events around
    them time the card's work back to back, without the host's gaps.
    (torch.profiler does not serve here: it dropped some or all of the
    kernels launched through ctypes, reading 0.0 ms for kernel A in one
    run.)"""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0   # host and device time of one call, a bound on the host's
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (2 * iters * call_s + 0.005)))   # cycles, at about 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, peak: float = BF16_FLOP_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ex2_bound_ms(count: int) -> float:
    """The least time of ``count`` float32 exp2 on the card's special
    function units: 16 a clock on each SM, at the SM's top clock."""
    import torch
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 1e3 * count / (16 * sms * mhz * 1e6)


def causal_pairs(T: int, S: int) -> int:
    return sum(min(i + 1, S) for i in range(T))


def fwd_inputs(A, BH, T, S, D, dtype, adversarial=False, mixed=False, seed=0):
    """Seeded q (pre-scaled by scale*log2(e)), k and v of a forward kernel
    case, and the generator, for what the case draws next."""
    import torch
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
        if mixed:   # small rows: bound near 1, sums far above the rescue line
            q[:, ::3] = torch.randn(BH, len(range(0, T, 3)), D, generator=g, **dev) * 0.01
    else:
        q = torch.randn(BH, T, D, generator=g, **dev)
        k = torch.randn(BH, S, D, generator=g, **dev)
    v = torch.randn(BH, S, D, generator=g, **dev)
    q = (q.to(dtype) * torch.tensor(scale * A.LOG2E, dtype=dtype, device="cuda")).contiguous()
    return q, k.to(dtype).contiguous(), v.to(dtype).contiguous(), g


def kernel_case(A, name, *, BH, T, S, D, causal=None, dtype, adversarial=False,
                mixed=False, bias=False, lse=False, timed=False, seed=0):
    """One comparison of a kernel with its plain version; with ``timed``
    also the kernel's, the plain version's and the library call's times.
    ``bias``: False, True (one per head) or "broadcast" (one for all heads,
    stride 0); ``mixed``: with ``adversarial``, every third query row is a
    small one that needs no rescue, beside rows that do."""
    import torch
    import torch.nn.functional as F
    q, k, v, g = fwd_inputs(A, BH, T, S, D, dtype, adversarial, mixed, seed)
    dev = dict(device="cuda", dtype=torch.float32)
    b = (torch.randn(1 if bias == "broadcast" else BH, T, S, generator=g, **dev) * A.LOG2E
         if bias else None)

    if name == "flash_fwd":
        run = lambda: A.flash_fwd(q, k, v, causal=causal, bias=b, with_lse=lse)
        plain = lambda qq, kk, vv, bb: A.flash_fwd_plain(qq, kk, vv, causal=causal,
                                                        bias=bb, with_lse=lse)
    elif name == "flash_fwd_1pass_t":   # kernel J: o^T (BH, D, T), held as it comes
        run = lambda: (A.flash_fwd_1pass_t(q, k, v), None)
        plain = lambda qq, kk, vv, bb: (A.flash_fwd_1pass_t_plain(qq, kk, vv, A.key_norm_max(kk)),
                                        None)
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
                       None if b is None else b if b.shape[0] == 1 else b[sl])
        diff = (o[sl].float() - ro).abs()
        err = max(err, diff.max().item())
        excess = max(excess, (diff - atol - rtol * ro.abs()).max().item())
        if lse:
            err_lse = max(err_lse, (l2[sl] - rl).abs().max().item())
    rec = {"phase": "kernel", "kernel": name, "BH": BH, "T": T, "S": S, "D": D,
           "causal": causal, "dtype": str(dtype).split(".")[-1], "bias": bias,
           "lse": lse, "adversarial": adversarial, "mixed": mixed, "max_abs_err": err,
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


def onepass_agree(A) -> None:
    """Kernels B and J run one kernel body and differ in the epilogue only:
    on the same inputs o and o^T must hold the same bits, and a second run
    of B must repeat them (DINOv2's shape, and rescued rows beside rows
    that are not, off the tiles)."""
    import torch
    rec = {"phase": "kernel", "kernel": "flash_fwd_1pass", "check": "B == J^T, B == B, bitwise"}
    for name, (BH, T, S, D, adv) in (("dino", (64, 4097, 4097, 64, False)),
                                     ("mixed", (3, 129, 65, 128, True))):
        q, k, v, _ = fwd_inputs(A, BH, T, S, D, torch.bfloat16, adv, adv, seed=4)
        o = A.flash_fwd_1pass(q, k, v)
        rec[name] = (torch.equal(o, A.flash_fwd_1pass_t(q, k, v).transpose(1, 2))
                     and torch.equal(o, A.flash_fwd_1pass(q, k, v)))
    rec["ok"] = rec["dino"] and rec["mixed"]
    emit(rec)
    if not rec["ok"]:
        raise SystemExit(f"kernels B and J disagree: {rec}")


def bwd_inputs(A, BH, T, S, D, dtype, seed):
    """Seeded q (pre-scaled by scale*log2(e)), k, v and do for the backward."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = dict(device="cuda", dtype=torch.float32, generator=g)
    q = (torch.randn(BH, T, D, **dev).to(dtype)
         * torch.tensor(A.LOG2E / math.sqrt(D), dtype=dtype, device="cuda")).contiguous()
    k, v = (torch.randn(BH, S, D, **dev).to(dtype) for _ in range(2))
    return q, k, v, torch.randn(BH, T, D, **dev).to(dtype)


def bwd_device_times(A, *, BH, T, S, D, causal, dtype, seed=0) -> dict:
    """Device time (device_ms), on the same inputs as bwd_case, of
    the backward alone of F.scaled_dot_product_attention (torch.autograd.grad
    with a fixed do: the yardstick of kernels C and D together, which the
    port never calls) and of C and D.  The SDPA backward's call costs more
    host time than its kernels take, so CUDA events would time the host;
    C and D are timed here on the same clock, so that the two compare."""
    import torch
    import torch.nn.functional as F
    q, k, v, do = bwd_inputs(A, BH, T, S, D, dtype, seed)
    q4, k4, v4 = (x.unsqueeze(0).requires_grad_() for x in (q, k, v))
    o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal, scale=1.0 / A.LOG2E)
    do4 = do.unsqueeze(0)
    out = {"sdpa_backward": device_ms(
        lambda: torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True), 20)}
    o, lse = A.flash_fwd(q, k, v, causal=causal, with_lse=True)
    _, delta = A.flash_bwd_dq(q, k, v, o, do, lse, causal=causal)
    out["flash_bwd_dq"] = device_ms(lambda: A.flash_bwd_dq(q, k, v, o, do, lse, causal=causal), 20)
    out["flash_bwd_dkv"] = device_ms(
        lambda: A.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal), 20)
    return out


def fwd_device_times(A, R) -> dict:
    """Device time (device_ms) of the forward kernels at their main shapes
    and of one library call on the same inputs (library_device_ms): A, B and
    J (B's and J's with the kmax reduction of their C call) against SDPA's
    forward, E and F against SDPA with the rel-pos bias as a float attn_mask
    (built outside the timing).  Near 50 us the event clock of kernel_case
    and relpos_case may also count the wrappers' host time."""
    import torch
    import torch.nn.functional as F
    out = {}
    for name, (BH, T, D, causal) in (("flash_fwd", (128, 767, 128, True)),
                                     ("flash_fwd_1pass", (64, 4097, 64, False)),
                                     ("flash_fwd_1pass_t", (64, 4097, 64, False))):
        q, k, v, _ = fwd_inputs(A, BH, T, T, D, torch.bfloat16)
        run = {"flash_fwd": lambda: A.flash_fwd(q, k, v, causal=True),
               "flash_fwd_1pass": lambda: A.flash_fwd_1pass(q, k, v),
               "flash_fwd_1pass_t": lambda: A.flash_fwd_1pass_t(q, k, v)}[name]
        q4, k4, v4 = (x.unsqueeze(0) for x in (q, k, v))
        out[name] = {"device_ms": device_ms(run, 20),
                     "library_device_ms": device_ms(lambda: F.scaled_dot_product_attention(
                         q4, k4, v4, is_causal=causal, scale=1.0 / A.LOG2E), 20)}
    for name, (BH, G, D) in (("relpos_fwd", (16, 64, 80)), ("relpos_window", (400, 14, 80))):
        q, k, v, rh, rw = relpos_inputs(R, BH, G, D, torch.bfloat16, 0)
        kern = R.relpos_fwd if name == "relpos_fwd" else R.relpos_window
        key = torch.arange(G * G, device="cuda")
        bias = ((rh.float()[:, :, key // G] + rw.float()[:, :, key % G]) / R.LOG2E).to(q.dtype)
        q4, k4, v4, b4 = (x.unsqueeze(0) for x in (q, k, v, bias))
        out[name] = {"device_ms": device_ms(lambda: kern(q, k, v, rh, rw), 20),
                     "library_device_ms": device_ms(lambda: F.scaled_dot_product_attention(
                         q4, k4, v4, attn_mask=b4, scale=1.0 / R.LOG2E), 20)}
        del bias, b4, q4, k4, v4
    return out


def bwd_case(A, *, BH, T, S, D, causal, dtype, timed=False, repeat=False, seed=0):
    """Kernels C and D against flash_bwd_plain (float32 math on the same
    inputs; o and lse from kernel A).  With ``repeat`` a second run of both
    on the same inputs must give dq, delta, dk and dv equal to the bit (no
    atomics: each output row belongs to one CTA).  With ``timed`` also each
    kernel's time, the plain version's, and each kernel's bound: C does 3
    products and D 4, each 2*BH*D*pairs; C reads q, k, v, o, do and lse and
    writes dq and the float32 delta, D reads q, k, v, do, lse and delta (not
    o) and writes dk and dv."""
    import torch
    q, k, v, do = bwd_inputs(A, BH, T, S, D, dtype, seed)
    o, lse = A.flash_fwd(q, k, v, causal=causal, with_lse=True)
    run_c = lambda: A.flash_bwd_dq(q, k, v, o, do, lse, causal=causal)
    dq, delta = run_c()
    run_d = lambda: A.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal)
    dk, dv = run_d()
    torch.cuda.synchronize()
    plain = lambda: A.flash_bwd_plain(q.float(), k.float(), v.float(), o.float(), do.float(),
                                      lse, causal=causal)
    ref = plain()
    name = str(dtype).split(".")[-1]
    err = {n: (got.float() - r).abs().max().item() for n, got, r in
           zip(("dq", "dk", "dv"), (dq, dk, dv), ref)}
    scale = {n: r.abs().max().item() for n, r in zip(("dq", "dk", "dv"), ref)}
    if S == 1:
        # one key a row: ds = p (dp - delta) is zero in exact arithmetic, so
        # dq and dk are the rounding of that difference in either version;
        # their scale is the size of the terms that cancel, max|do v^T|
        # times max|k| (dq) or max|q| (dk)
        dp = (do.float() * v.float()).sum(-1).abs().max().item()
        scale["dq"] = dp * k.float().abs().max().item()
        scale["dk"] = dp * q.float().abs().max().item()
    tol = BWD_TOL[name]
    rec = {"phase": "kernel", "kernel": "flash_bwd_dq+flash_bwd_dkv", "BH": BH, "T": T, "S": S,
           "D": D, "causal": causal, "dtype": name, "max_abs_err": err, "max_abs_ref": scale,
           "tol_vs_max_ref": tol}
    rec["ok"] = all(math.isfinite(err[n]) and err[n] <= tol * scale[n] for n in err)
    if repeat:
        dq2, delta2 = run_c()
        dk2, dv2 = A.flash_bwd_dkv(q, k, v, do, lse, delta2, causal=causal)
        rec["bitwise_repeat"] = all(torch.equal(a, b) for a, b in
                                    zip((dq, delta, dk, dv), (dq2, delta2, dk2, dv2)))
        rec["ok"] = rec["ok"] and rec["bitwise_repeat"]
    out = {}
    if timed:
        ms_c, ms_d = cuda_ms(run_c, 20), cuda_ms(run_d, 20)
        plain_ms = cuda_ms(plain, 3)
        pairs = causal_pairs(T, S) if causal else T * S
        e = q.element_size()
        stats = 2 * 4 * BH * T   # lse and delta, float32 rows
        bc = bound(e * BH * D * (4 * T + 2 * S) + stats, 3 * 2.0 * BH * D * pairs)
        bd = bound(e * BH * D * (2 * T + 4 * S) + stats, 4 * 2.0 * BH * D * pairs)
        rec.update({"ms_c": ms_c, "ms_d": ms_d, "plain_ms": plain_ms,
                    "bound_ms_c": bc[0], "bound_ms_d": bd[0]})
        out = {"flash_bwd_dq": {"ms": ms_c, "bound_ms": bc[0], "bound_by": bc[1],
                                "max_abs_err": err["dq"]},
               "flash_bwd_dkv": {"ms": ms_d, "bound_ms": bd[0], "bound_by": bd[1],
                                 "max_abs_err": max(err["dk"], err["dv"])}}
        for r in out.values():
            r["plain_ms"] = plain_ms
    emit(rec)
    if not rec["ok"]:
        raise SystemExit(f"kernels C/D disagree with flash_bwd_plain: {rec}")
    return out


def cut_config(C):
    """llmseg_7b widths and sequence lengths, towers 2-3 blocks, LLaMA 2 layers."""
    full = C.llmseg_7b()
    return C.replace(full, dino=C.replace(full.dino, depth=2),
                     llava=C.replace(full.llava, llm=C.replace(full.llava.llm, num_layers=2),
                                     vision=C.replace(full.llava.vision, depth=3)))


def plain_attention(q, k, v, *, bias=None, causal=False, scale=None):
    from llmseg_tpu_torch.ops import attention as A
    return A.attention_plain(q, k, v, bias=bias, causal=causal, scale=scale)


def grads_in_place(C, llmseg, make_batch, A) -> dict:
    """The cut model with LoRA rank 8 on q/v: loss_fn and the gradient of
    every trainable parameter through the kernels (A with lse, C, D, under
    remat "dots", whose recompute runs A again) against LLaMA's attention
    on the plain path with remat "none".  float32 gated per tensor at
    GRAD_LIMIT * max|ref|, bf16 reported."""
    import torch
    from llmseg_tpu_torch.models import llama
    from llmseg_tpu_torch.train import optim

    cfg = cut_config(C)
    lora = C.LoraConfig(rank=8)
    batch = make_batch(cfg, num_images=1, rows_per_image=1, text_len=512, seed=4)
    rec = {"phase": "grad_in_place",
           "config": "llmseg_7b, towers 2-3 blocks, LLaMA 2 layers, LoRA rank 8",
           "limit_float32": GRAD_LIMIT}
    for dtype in (torch.float32, torch.bfloat16):
        model = llmseg.init(cfg, seed=2, device="cuda", dtype=dtype, lora_cfg=lora)
        with torch.no_grad():   # LoRA B starts at zero: give it a value so A gets a gradient
            g = torch.Generator(device="cuda").manual_seed(5)
            for name, p in model.named_parameters():
                if name.startswith("lora.") and name.endswith(".b.weight"):
                    p.copy_(torch.randn(p.shape, device="cuda", generator=g) * 0.02)
        trainable = optim.partition(model)

        def grads(remat):
            loss, _ = llmseg.loss_fn(model, batch, lora_cfg=lora, remat=remat)
            loss.backward()
            out = {n: p.grad.float() for n, p in trainable.items()}
            model.zero_grad(set_to_none=True)
            return loss.item(), out

        for kern in A.KERNELS:
            kern.launches = 0
        loss_k, got = grads("dots")
        launches = {kern.name: kern.launches for kern in A.KERNELS}
        llama.attention = plain_attention
        try:
            loss_p, ref = grads("none")
        finally:
            llama.attention = A.attention
        name = str(dtype).split(".")[-1]
        # the selection head's attention key biases have an exact gradient of
        # zero (a key bias shifts a whole softmax row), so both paths give
        # rounding noise: they are held against the largest gradient instead
        zero = {n for n in ref if n.startswith("select.") and n.endswith(".k.bias")}
        top = max(r.abs().max().item() for r in ref.values())
        # 0 / 0 counts as agreement (the final attention sees one text key,
        # so its q and k get exact zeros on both paths)
        ratios = sorted((((got[n] - ref[n]).abs().max()
                          / ref[n].abs().max().clamp_min(1e-30)).item(), n)
                        for n in ref if n not in zero)
        noise = max(max(got[n].abs().max().item(), ref[n].abs().max().item()) for n in zero)
        rec[name] = {"loss_kernels": loss_k, "loss_plain": loss_p,
                     "worst_grad_err_vs_max_ref": ratios[-1][0], "worst_tensors": ratios[-3:],
                     "zero_grad_tensors": len(zero), "zero_grad_max_vs_top": noise / top,
                     "tensors": len(ref), "launches": launches}
        del model, trainable, got, ref
        torch.cuda.empty_cache()
    expect = {"flash_fwd": 4, "flash_fwd_1pass": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2,
              "flash_fwd_1pass_t": 0}
    rec["expected_launches"] = expect
    f = rec["float32"]
    rec["ok"] = (f["worst_grad_err_vs_max_ref"] <= GRAD_LIMIT
                 and f["zero_grad_max_vs_top"] <= GRAD_LIMIT and f["launches"] == expect)
    if not rec["ok"]:
        raise SystemExit(f"gradients through the kernels disagree with the plain path: {rec}")
    return rec


def device_families(fn, out_name: str, decode_family: str = "kernel_g") -> dict:
    """One run of ``fn`` under torch.profiler: device time by kernel family,
    the wall time and the device's idle share; the table goes to
    OUT_DIR/<out_name>.  Kernels G, H and I share their GEMM
    (``fd_gemm*``, csrc/batched_gemm.cuh): its time, G's own kernels
    (``fd_*``, the fused ones of csrc/factored_fused.cuh included) and H's
    and I's (``tw_*``) count to ``decode_family``, the one the traced path
    runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events, attr, kernels = kernel_times(prof)   # operators' time is their kernels'
    families = {"kernel_a": 0.0, "kernel_b": 0.0, "kernel_c": 0.0, "kernel_d": 0.0,
                "kernel_e": 0.0, "kernel_f": 0.0, decode_family: 0.0, "kernel_j": 0.0,
                "kernel_q1": 0.0, "kernel_q2": 0.0, "matmul_int8": 0.0, "matmul": 0.0,
                "other": 0.0}
    for key, ms in kernels:
        name = key.lower()
        if "relpos_fwd" in name:
            fam = "kernel_e"
        elif "relpos_window" in name:
            fam = "kernel_f"
        elif "fd_" in name or "tw_" in name:   # G's, H's or I's launch sequence
            fam = decode_family
        elif "flash_bwd_dq" in name:
            fam = "kernel_c"
        elif "flash_bwd_dkv" in name:
            fam = "kernel_d"
        elif "flash_fwd_1pass_t" in name:
            fam = "kernel_j"
        elif "flash_fwd_1pass" in name:
            fam = "kernel_b"
        elif "flash_fwd" in name:
            fam = "kernel_a"
        elif "quantize_rows" in name:
            fam = "kernel_q1"
        elif "w8a8_gemm" in name or "w8a8_epilogue" in name:   # Q2 (and the old route's rescale)
            fam = "kernel_q2"
        elif any(s in name for s in ("gemm", "nvjet", "cutlass", "xmma", "sm90", "imma")):
            fam = ("matmul_int8" if any(t in name for t in ("s8", "i8", "int8", "imma"))
                   else "matmul")
        else:
            fam = "other"
        families[fam] += ms
    device_ms = sum(families.values())
    with open(os.path.join(OUT_DIR, out_name), "w") as f:
        f.write(events.table(sort_by=attr, row_limit=50))
    return {"profiled_step_ms": wall_ms, "device_ms_by_family": families,
            "device_ms": device_ms, "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms)}


def checksums(tensors) -> "torch.Tensor":
    """Two int64 checksums per tensor of its raw bits: the sum, and the sum
    weighted by position (mod 65521)."""
    import torch
    out = []
    for t in tensors:
        x = t.detach().reshape(-1)
        x = x.view(torch.int16 if x.element_size() == 2 else torch.int32).long()
        w = torch.arange(x.numel(), device=x.device) % 65521 + 1
        out.append(torch.stack([x.sum(), (x * w).sum()]))
    return torch.stack(out).cpu()


def train_phase(C, make_batch, A) -> dict:
    """The LoRA train step at llmseg_7b, bf16, through the Trainer: random
    weights from the config's seed, LoRA rank 8 on q/v, TrainConfig with no
    warmup and no accumulation (remat "dots", the default), one image, one
    row, text_len 512.  2 warm-up steps, then 5 timed."""
    import torch
    from llmseg_tpu_torch.train.trainer import Trainer

    cfg = C.llmseg_7b()
    exp = C.ExperimentConfig(model=cfg, train=C.TrainConfig(
        warmup_steps=0, grad_accum_steps=1, lora=C.LoraConfig(rank=8),
        log_dir=os.path.join(OUT_DIR, "train_runs")))
    t0 = time.time()
    trainer = Trainer(exp)
    batch = make_batch(cfg, num_images=1, rows_per_image=1, text_len=512, seed=0)
    frozen = {n: p for n, p in trainer.model.named_parameters() if not p.requires_grad}
    before = checksums(frozen.values())
    start = {n: p.detach().clone() for n, p in trainer.trainable.items()}
    torch.cuda.synchronize()
    setup_s = time.time() - t0

    # which trainable tensors get a nonzero gradient (a tensor whose exact
    # gradient is zero, like the key bias of an attention, stays put)
    nonzero = {n: torch.zeros((), dtype=torch.bool, device="cuda") for n in trainer.trainable}

    def note_grad(name):
        def hook(p):
            nonzero[name].logical_or_(p.grad.ne(0).any())
        return hook

    hooks = [p.register_post_accumulate_grad_hook(note_grad(n))
             for n, p in trainer.trainable.items()]
    metrics = [trainer.step(batch) for _ in range(2)]
    for h in hooks:
        h.remove()
    torch.cuda.synchronize()

    steps = 5
    for kern in A.KERNELS:
        kern.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics.append(trainer.step(batch))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    per_step = {kern.name: kern.launches / steps for kern in A.KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    L = cfg.llava.llm.num_layers
    expect = {"flash_fwd": 2 * L, "flash_fwd_1pass": cfg.dino.depth,
              "flash_bwd_dq": L, "flash_bwd_dkv": L, "flash_fwd_1pass_t": 0}
    losses = [{k: v.item() for k, v in m.items()} for m in metrics]
    finite = all(math.isfinite(x) for m in losses for x in m.values())
    frozen_same = bool(torch.equal(checksums(frozen.values()), before))
    moved = {n for n, p in trainer.trainable.items() if not torch.equal(p, start[n])}
    with_grad = {n for n, f in nonzero.items() if bool(f)}
    # a bf16 entry x keeps its value under a step smaller than half its ulp,
    # which is at least |x| * 2^-9; AdamW's steps are about lr, so a tensor
    # whose every entry has |x| >= 1024 lr (LayerNorm scales of 1) stays put
    lr = exp.train.lr
    held = {n for n in with_grad - moved
            if trainer.trainable[n].abs().min().item() >= 1024 * lr}
    rec = {"phase": "train", "config": "llmseg_7b", "dtype": "bfloat16", "lora_rank": 8,
           "batch_images": 1, "rows": 1, "text_len": 512, "remat": exp.train.remat_policy,
           "setup_s": setup_s, "ms_per_step": step_ms, "peak_mem_gb": peak_gb,
           "launches_per_step": per_step, "expected_launches_per_step": expect,
           "losses": [m["loss"] for m in losses], "ce_loss": [m["ce_loss"] for m in losses],
           "grad_norm": [m["grad_norm"] for m in losses], "finite": finite,
           "frozen_tensors": len(frozen), "frozen_bit_identical": frozen_same,
           "trainable_tensors": len(start), "trainable_with_grad": len(with_grad),
           "trainable_changed": len(moved), "held_by_bf16_rounding": sorted(held),
           "without_grad": sorted(set(start) - with_grad)}
    rec["ok"] = (finite and frozen_same and with_grad - held <= moved and len(moved) > 0
                 and per_step == {k: float(v) for k, v in expect.items()})
    emit(rec)
    if not rec["ok"]:
        raise SystemExit("train phase failed")

    # where one step's time goes
    from llmseg_tpu_torch.models import llmseg
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _ = llmseg.loss_fn(trainer.model, batch, lora_cfg=trainer.lora_cfg,
                             remat=trainer.remat)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    trainer.opt.step()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    rec_b = {"phase": "train_breakdown", "forward_ms": (t1 - t0) * 1e3,
             "backward_ms": (t2 - t1) * 1e3, "optimizer_ms": (t3 - t2) * 1e3}
    # the same step under the other remat policies (1 warm-up, 2 timed)
    rec_b["ms_per_step_by_remat"] = {exp.train.remat_policy: step_ms}
    for policy in ("full", "none"):
        trainer.remat = policy
        trainer.step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            trainer.step(batch)
        torch.cuda.synchronize()
        rec_b["ms_per_step_by_remat"][policy] = (time.perf_counter() - t0) * 1e3 / 2
    # the profiler last: it adds host cost to what runs after it
    trainer.remat = exp.train.remat_policy
    rec_b.update(device_families(lambda: trainer.step(batch), "chip_smoke_train_profile.txt"))
    emit(rec_b)
    del trainer, frozen, start
    torch.cuda.empty_cache()
    return {"launches_per_step": per_step}


def kernels_in_place(C, llmseg, make_batch, A) -> dict:
    """``llmseg_7b`` at full width and sequence lengths, depth cut to two
    blocks per tower and two LLaMA layers: predict through the kernels
    against predict with every attention sent to the plain path, in float32
    (gated, the kernels' float32 path) and bf16 (reported).  This checks the
    kernels inside the model: layouts, pre-scaling, head padding, dispatch."""
    import torch
    from llmseg_tpu_torch.models import llama, vit

    cfg = cut_config(C)
    batch = make_batch(cfg, num_images=4, rows_per_image=1, text_len=512, seed=3)

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
                 and rec["float32_launches"] == {"flash_fwd": 2, "flash_fwd_1pass": 2,
                                                 "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                                                 "flash_fwd_1pass_t": 0})
    if not rec["ok"]:
        raise SystemExit(f"kernels disagree with the plain path inside the model: {rec}")
    return rec


def stage_times(model, batch, step_ms: float) -> dict:
    """Each stage of a predict step timed alone with CUDA events."""
    import torch
    from llmseg_tpu_torch.models import vit

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
    return stage_ms


# ---------------------------------------------------------------------------
# SAM everything-mode mask generation (AMG): kernels E, F and G
# ---------------------------------------------------------------------------

G_TOL = {"bfloat16": 5e-2, "float32": 1e-4}    # kernel G vs its plain version, max|ref|
SAM_IN_PLACE_LIMIT = 1e-4     # cut sam_vit_h encoder, kernels vs plain, float32, max|ref|
# kernel G vs the plain mask-decoder tail, float32, max|ref|: the CPU tests' limits
SAM_DECODE_LIMIT = {"masks": 2e-4, "iou": 2e-5}
AMG_IMAGES = ((1024, 768), (683, 1024), (1024, 1024))


def relpos_inputs(R, BH, G, D, dtype, seed, padded=False):
    """Seeded q (pre-scaled), k, v and random NONZERO rel-pos tables (the
    model's own are zeros at init, so the main path never shows the bias).
    With ``padded`` (G = 14): the windows that window_partition cuts from
    a 64-wide token grid zero-padded to 70, BH // 25 grids of one head, the
    tables from random rel-pos weights (relpos_tables): the edge windows'
    zero tokens are real keys."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = dict(device="cuda", dtype=torch.float32, generator=g)
    T = G * G
    if padded:
        from llmseg_tpu_torch.models.sam.image_encoder import window_partition
        q, k, v = (window_partition(torch.randn(BH // 25, 64, 64, D, **dev).to(dtype), G)[0]
                   .reshape(BH, T, 1, D) for _ in range(3))
        rel_h, rel_w = ((torch.randn(2 * G - 1, D, **dev) * 0.3).to(dtype) for _ in range(2))
        rh, rw = R.relpos_tables(q, rel_h, rel_w, G)
        q = q * torch.tensor(R.LOG2E / math.sqrt(D), dtype=dtype, device="cuda")
        return tuple(x.reshape(BH, T, D).contiguous() for x in (q, k, v)) + (rh, rw)
    q = (torch.randn(BH, T, D, **dev).to(dtype)
         * torch.tensor(R.LOG2E / math.sqrt(D), dtype=dtype, device="cuda")).contiguous()
    k, v = (torch.randn(BH, T, D, **dev).to(dtype).contiguous() for _ in range(2))
    rh, rw = ((torch.randn(BH, T, G, **dev) * R.LOG2E).to(dtype).contiguous() for _ in range(2))
    return q, k, v, rh, rw


def relpos_case(R, name, *, BH, G, D, dtype, timed=False, seed=0, padded=False, repeat=False):
    """Kernel E (relpos_fwd) or F (relpos_window) against its plain version
    (float32 math on the same inputs, BF16_TOL / F32_TOL), on zero-padded
    windows with ``padded`` (see relpos_inputs); with ``repeat`` a second run
    must give the same bits.  With ``timed``
    also the kernel's, the plain version's and SDPA's times (SDPA with the
    bias materialised as a float attn_mask, built outside the timing) and
    the bound: 4*BH*T*T*D operations, q/k/v/o and rh/rw bytes."""
    import torch
    import torch.nn.functional as F
    T = G * G
    q, k, v, rh, rw = relpos_inputs(R, BH, G, D, dtype, seed, padded)
    kern, plain = ((R.relpos_fwd, R.relpos_fwd_plain) if name == "relpos_fwd"
                   else (R.relpos_window, R.relpos_window_plain))
    run = lambda: kern(q, k, v, rh, rw)
    o = run()
    torch.cuda.synchronize()
    atol, rtol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    err = excess = 0.0
    step = 4 if T > 1024 else BH
    for i in range(0, BH, step):
        sl = slice(i, i + step)
        ro = plain(q[sl].float(), k[sl].float(), v[sl].float(), rh[sl], rw[sl])
        diff = (o[sl].float() - ro).abs()
        err = max(err, diff.max().item())
        excess = max(excess, (diff - atol - rtol * ro.abs()).max().item())
    rec = {"phase": "kernel", "kernel": name, "BH": BH, "T": T, "G": G, "D": D,
           "dtype": str(dtype).split(".")[-1], "rel_pos": "random nonzero tables",
           "padded": padded, "max_abs_err": err, "atol": atol, "rtol": rtol}
    rec["ok"] = math.isfinite(err) and excess <= 0.0
    if repeat:
        rec["bitwise_repeat"] = torch.equal(o, run())
        rec["ok"] = rec["ok"] and rec["bitwise_repeat"]
    if timed:
        rec["ms"] = cuda_ms(run, 20)
        rec["plain_ms"] = cuda_ms(lambda: plain(q, k, v, rh, rw), 3)
        key = torch.arange(T, device="cuda")
        bias = ((rh.float()[:, :, key // G] + rw.float()[:, :, key % G]) / R.LOG2E).to(dtype)
        q4, k4, v4, b4 = (x.unsqueeze(0) for x in (q, k, v, bias))
        rec["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=b4, scale=1.0 / R.LOG2E), 20)
        rec["library_call"] = "SDPA with the materialised bias as attn_mask (bias built outside)"
        del bias, b4
        e = q.element_size()
        rec["bound_ms"], rec["bound_by"] = bound(e * BH * T * (4 * D + 2 * G), 4.0 * BH * T * T * D)
        rec["ex2_bound_ms"] = ex2_bound_ms(BH * T * T)   # an exp2 a logit
    emit(rec)
    if not rec["ok"]:
        raise SystemExit(f"{name} disagrees with its plain version: {rec}")
    return rec


def random_decoder(C, dtype, seed):
    """sam_vit_h's mask decoder, random weights from a seed, with noise on
    the LayerNorm scales and every bias so that none is trivial."""
    import torch
    from llmseg_tpu_torch.models.sam import sam as S
    from llmseg_tpu_torch.models.sam.mask_decoder import MaskDecoder
    dec = MaskDecoder(C.sam_vit_h().decoder, device="cuda", dtype=dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    S.random_init_(dec, g)
    with torch.no_grad():
        for p in dec.parameters():
            if p.ndim == 1:
                p.add_(0.1 * torch.randn(p.shape, device="cuda", generator=g).to(dtype))
    return dec


def record_breakdown(TK, prog, packed, kernel, regions, iters: int = 5) -> dict:
    """A recorded sequence (kernel G's, H's or I's) on a replayed plan, one
    record at a time on the device clock (device_ms), summed by the part of
    the decode that its program tagged it with (``regions``); beside it the
    whole sequence in one call.  The gap between the two is what the single
    launches cost beyond their kernels.  (Running single records again and
    again leaves the buffers in no useful state; the next full run resets
    them.)"""
    tags = prog.regions
    each = [device_ms(lambda i=i: TK.launch_records(packed, i, i + 1, kernel), iters)
            for i in range(len(tags))]
    whole = device_ms(lambda: TK.launch_records(packed, kernel=kernel), iters)
    by = {r: sum(t for t, g in zip(each, tags) if g == r) for r in regions}
    return {"clock": "device (events behind a spin kernel), one record at a time",
            "records": len(each), "regions_ms": by,
            "records_by_region": {r: tags.count(r) for r in regions},
            "records_sum_ms": sum(each), "whole_ms": whole, "gap_ms": whole - sum(each),
            "fused_ms": {f"{i}:{TK.OP_NAMES[rec[0]]}": t for i, (rec, t) in
                         enumerate(zip(prog.records, each)) if rec[0] in TK.FUSED_OUTPUTS},
            "ms_by_op": {op: sum(t for rec, t in zip(prog.records, each)
                                 if TK.OP_NAMES[rec[0]] == op)
                         for op in sorted({TK.OP_NAMES[rec[0]] for rec in prog.records})},
            "ops_by_region": {r: sorted({TK.OP_NAMES[rec[0]] for rec, g in
                                         zip(prog.records, tags) if g == r})
                              for r in regions}}


def g_breakdown(TK, plan, iters: int = 5) -> dict:
    """Kernel G's breakdown by part (record_breakdown, TK.REGIONS)."""
    return record_breakdown(TK, plan.prog, plan.packed, TK.FACTORED_DECODE, TK.REGIONS, iters)


def g_case(C, TK, dtype, *, timed=False, seed=0, prompts=64, repeat=False):
    """Kernel G against factored_decode_plain at the full decoder widths: 64
    prompts (or ``prompts``) of 7 tokens, L = 64*64, C = 256; gated normwise at G_TOL, on a
    chunk that records the launch sequence, on a second chunk that replays
    it (as every later chunk of an AMG image does), on a chunk of another
    base given the same cache (which must record anew), and uncached.  With
    ``repeat``: a second replay of the same chunk must give the same bits.
    With ``timed``: G's time (CUDA events) replaying its recorded sequence, as
    AMG does for every chunk of an image, the same on the device clock
    (device_ms) with its breakdown by part (g_breakdown), and with the
    recording (the
    shared precomputes and the sequence built anew, as for an image's first
    chunk), the plain version's, the plain mask-decoder tail's on the same
    chunk (no single PyTorch call computes G, so library_ms is null), and
    the bound from the useful GEMM
    operations of G's launch sequence and the bytes it must move (shared
    precomputes, weights and tokens read, mask columns and IoU written)."""
    import torch
    name = str(dtype).split(".")[-1]
    P = prompts
    dec = random_decoder(C, dtype, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    base, base2 = ((torch.randn(1, 64, 64, 256, device="cuda", generator=g) * 0.5).to(dtype)
                   for _ in range(2))
    pe = (torch.randn(64, 64, 256, device="cuda", generator=g) * 0.5).to(dtype)
    tokens, tokens2 = ((torch.randn(P, 7, 256, device="cuda", generator=g) * 0.5).to(dtype)
                       for _ in range(2))
    args = (dec.transformer, dec, base, pe, tokens, 8)
    args2 = (dec.transformer, dec, base, pe, tokens2, 8)
    args3 = (dec.transformer, dec, base2, pe, tokens2, 8)
    with torch.inference_mode():
        run = lambda: TK.factored_decode(*args)
        # as AMG runs it: the sequence recorded on an image's first chunk of
        # prompts and replayed on the next; then the same cache given another
        # image's base, which records anew; all held against the plain version
        cache = {}
        got = [TK.factored_decode(*a, cache=cache) for a in (args, args2, args3)] + [run()]
        ref = [TK.factored_decode_plain(*a) for a in (args, args2, args3, args)]
        torch.cuda.synchronize()
        err = {k: max((x[j].float() - r[j].float()).abs().max().item()
                      for x, r in zip(got, ref)) for j, k in enumerate(("masks", "iou"))}
        top = {k: min(r[j].float().abs().max().item() for r in ref)
               for j, k in enumerate(("masks", "iou"))}
        each = [[(x[j].float() - r[j].float()).abs().max().item() for j in range(2)]
                for x, r in zip(got, ref)]
        rec = {"phase": "kernel", "kernel": "factored_decode", "prompts": P, "tokens": 7,
               "L": 4096, "C": 256, "dtype": name, "checked": "recorded, replayed, another base on the same cache, fresh",
               "max_abs_err": err, "max_abs_err_each": each, "max_abs_ref": top,
               "tol_vs_max_ref": G_TOL[name]}
        rec["ok"] = all(math.isfinite(err[k]) and err[k] <= G_TOL[name] * top[k] for k in err)
        if dtype == torch.bfloat16:   # each fused kernel against its record's emulation
            fused = TK.fused_record_errors(TK.g_program(*args)[0])
            rec["fused_records"] = {f"{r['record']}:{r['op']}": max(
                e / max(m, 1e-30) for e, m in zip(r["max_abs_err"], r["max_abs_ref"]))
                for r in fused}
            rec["ok"] = rec["ok"] and len(fused) > 0 and all(
                v <= G_TOL[name] for v in rec["fused_records"].values())
        if repeat:   # the cache holds args3's base: two replays of that chunk
            first = TK.factored_decode(*args3, cache=cache)
            second = TK.factored_decode(*args3, cache=cache)
            rec["bitwise_repeat"] = all(torch.equal(a, b) for a, b in zip(first, second))
            rec["ok"] = rec["ok"] and rec["bitwise_repeat"]
        if timed:
            prog, _, _ = TK.g_program(*args)
            rec["launches_in_sequence"] = len(prog.records)
            rec["ms"] = cuda_ms(lambda: TK.factored_decode(*args, cache=cache), 5)
            rec["device_ms"] = device_ms(lambda: TK.factored_decode(*args, cache=cache), 5)
            rec["breakdown"] = g_breakdown(TK, cache["factored_decode"][2])
            rec["ms_with_recording"] = cuda_ms(run, 5)
            rec["plain_ms"] = cuda_ms(lambda: TK.factored_decode_plain(*args), 3)
            rec["plain_tail_ms"] = cuda_ms(lambda: dec.plain_tail(base, pe[None], tokens), 3)
            rec["library_ms"] = None
            sh = TK.factored_shared(dec.transformer, base.reshape(4096, 256),
                                    pe.reshape(4096, 256),
                                    TK.convt_as_matmul(dec.upscale_conv1)[0].to(dtype))
            shared = [t for t in sh.values() if torch.is_tensor(t)] + \
                [t for blk in sh["blocks"] for t in blk.values()]
            nbytes = (sum(t.numel() * t.element_size() for t in shared)
                      + sum(p.numel() * p.element_size() for p in dec.parameters())
                      + tokens.numel() * tokens.element_size()
                      + sum(t.numel() * t.element_size() for t in got[0]))
            rec["flops"] = prog.flops
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, prog.flops)
    emit(rec)
    if not rec["ok"]:
        raise SystemExit(f"kernel G disagrees with factored_decode_plain: {rec}")
    del dec
    torch.cuda.empty_cache()
    return rec


def sam_kernel_phase(C, R, TK) -> dict:
    """E and F at sam_vit_h's shapes (global layer: 16 heads, 64 x 64 grid,
    D 80; windowed layer: 25 windows x 16 heads, 14 x 14) in bf16, each also
    in float32 at a smaller shape; G at the full decoder widths in bf16 and
    float32."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    main = {"relpos_fwd": relpos_case(R, "relpos_fwd", BH=16, G=64, D=80, dtype=bf16, timed=True),
            "relpos_window": relpos_case(R, "relpos_window", BH=400, G=14, D=80, dtype=bf16,
                                         timed=True, repeat=True)}
    relpos_case(R, "relpos_fwd", BH=4, G=32, D=80, dtype=f32)
    relpos_case(R, "relpos_fwd", BH=4, G=23, D=64, dtype=bf16)     # ragged last key tile
    # E: one head and 16, on the register-held rw path (G = 64) and the
    # general one (23, 40: a ragged last key tile, query rows past T), bitwise
    # repeats
    for G in (64, 23, 40):
        for D in (64, 80):
            for BH in (1, 16):
                relpos_case(R, "relpos_fwd", BH=BH, G=G, D=D, dtype=bf16, repeat=BH == 16,
                            seed=G + D + BH)
    relpos_case(R, "relpos_window", BH=16, G=14, D=80, dtype=f32)
    relpos_case(R, "relpos_window", BH=8, G=5, D=32, dtype=bf16)
    # F: one pair, an evaluate's 3,200 pairs (8 images a launch), zero-padded
    # edge windows, the general path at G = 2 and 22
    relpos_case(R, "relpos_window", BH=1, G=14, D=80, dtype=bf16)
    relpos_case(R, "relpos_window", BH=3200, G=14, D=80, dtype=bf16, repeat=True)
    relpos_case(R, "relpos_window", BH=400, G=14, D=80, dtype=bf16, padded=True)
    relpos_case(R, "relpos_window", BH=8, G=2, D=16, dtype=bf16)
    relpos_case(R, "relpos_window", BH=16, G=22, D=64, dtype=bf16, repeat=True)
    main["factored_decode"] = g_case(C, TK, bf16, timed=True, repeat=True)
    g_case(C, TK, f32)
    for P in (1, 3):   # one prompt a chunk, and an odd count
        g_case(C, TK, bf16, prompts=P)
    return main


def cut_sam(C):
    """sam_vit_h at full widths, depth cut to two blocks: block 0 windowed,
    block 1 global."""
    full = C.sam_vit_h()
    return C.replace(full, encoder=C.replace(full.encoder, depth=2, global_attn_indexes=(1,)))


def sam_in_place(C, S, R, TK, IE) -> dict:
    """The cut sam_vit_h in float32, with random nonzero rel-pos tables: the
    encoder through kernels F and E against the encoder with its attention
    on the plain path (materialised bias); then two 64-prompt chunks of the
    decoder through kernel G, sharing one cache as AMG's chunks of an image
    do (the second replays the first's launch sequence), against the plain
    mask-decoder tail."""
    import torch
    cfg = cut_sam(C)
    model = S.init(cfg, seed=7, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(8)
    with torch.no_grad():
        for blk in model.image_encoder.blocks:
            for t in (blk.attn.rel_pos_h, blk.attn.rel_pos_w):
                t.copy_(torch.randn(t.shape, device="cuda", generator=g) * 0.5)
    x = torch.randn(1, 1024, 1024, 3, device="cuda", generator=g)
    kernels = R.KERNELS + TK.KERNELS
    for kern in kernels:
        kern.launches = 0
    with torch.inference_mode():
        emb = S.encode_image(model, x)
        pts = torch.rand(2, 64, 1, 2, device="cuda", generator=g) * 1024
        labels = torch.ones(64, 1, dtype=torch.int32, device="cuda")
        cache = {}
        got = [S.decode_masks(model, emb, points=p, labels=labels, cache=cache) for p in pts]
        launches = {kern.name: kern.launches for kern in kernels}

        def plain_relpos(q, k, v, rel_h, rel_w, hw, scale=None):
            from llmseg_tpu_torch.ops.attention import attention_plain
            bias = R.decomposed_rel_pos_bias(q.transpose(1, 2), rel_h, rel_w, hw)
            return attention_plain(q, k, v, bias=bias, scale=scale)

        IE.relpos_flash_attention = plain_relpos
        try:
            ref = S.encode_image(model, x)
        finally:
            IE.relpos_flash_attention = R.relpos_flash_attention
        pe = model.prompt_encoder.dense_pe(64)[None]
        want = [model.mask_decoder(emb, pe, *model.prompt_encoder(points=p, labels=labels),
                                   impl="xla") for p in pts]

    def err(j):
        return max(((k[j] - t[j]).abs().max() / t[j].abs().max()).item()
                   for k, t in zip(got, want))

    rec = {"phase": "sam_in_place", "config": "sam_vit_h widths, 2 encoder blocks (1 global)",
           "dtype": "float32", "limit_encoder": SAM_IN_PLACE_LIMIT,
           "limit_decoder": SAM_DECODE_LIMIT, "launches": launches,
           "encoder_err_vs_max_ref": ((emb - ref).abs().max() / ref.abs().max()).item(),
           "decoder_masks_err_vs_max_ref": err(0), "decoder_iou_err_vs_max_ref": err(1)}
    expect = {"relpos_fwd": 1, "relpos_window": 1, "factored_decode": 2, "twoway_decode": 0,
              "twoway_transformer": 0}
    rec["expected_launches"] = expect
    rec["ok"] = (rec["encoder_err_vs_max_ref"] <= SAM_IN_PLACE_LIMIT
                 and rec["decoder_masks_err_vs_max_ref"] <= SAM_DECODE_LIMIT["masks"]
                 and rec["decoder_iou_err_vs_max_ref"] <= SAM_DECODE_LIMIT["iou"]
                 and launches == expect)
    del model
    torch.cuda.empty_cache()
    if not rec["ok"]:
        raise SystemExit(f"SAM through the kernels disagrees with the plain path: {rec}")
    return rec


def amg_images():
    import numpy as np
    rng = np.random.RandomState(11)
    out = []
    for h, w in AMG_IMAGES:
        # smooth blobs plus noise, so masks have structure
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.zeros((h, w, 3), np.float32)
        for _ in range(6):
            cy, cx, r = rng.rand() * h, rng.rand() * w, 60 + rng.rand() * 200
            img += (((yy - cy) ** 2 + (xx - cx) ** 2) < r * r)[..., None] * rng.rand(3) * 120
        img += rng.rand(h, w, 3) * 40
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


ANN_KEYS = {"segmentation", "area", "bbox", "predicted_iou", "point_coords",
            "stability_score", "crop_box"}


def amg_phase(C, S, AMG, kernels_all) -> dict:
    """sam_vit_h in bf16 from a seed, generate() with the default AMGConfig
    on three synthetic images of different sizes, then with the filters
    opened so that NMS, top-K, the upscale and the RLE run, then with NMS
    off too.  Launch counts per image, annotation counts and schema,
    ms/image (2 warm-up images, then the three timed; peak memory of the
    default run), and a breakdown of one image."""
    import torch
    cfg = C.sam_vit_h()
    t0 = time.time()
    model = S.init(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    images = amg_images()
    gen = AMG.AutomaticMaskGenerator(model, cfg)
    opened = AMG.AutomaticMaskGenerator(model, cfg, C.AMGConfig(pred_iou_thresh=-1e9,
                                                                stability_score_thresh=-1.0))
    # random weights give near-identical masks, which NMS at 0.7 folds into
    # one: with NMS off as well, top-K fills to max_masks and the upscale and
    # RLE run on 512 masks
    no_nms = AMG.AutomaticMaskGenerator(model, cfg, C.AMGConfig(
        pred_iou_thresh=-1e9, stability_score_thresh=-1.0, box_nms_thresh=1.0))
    for img in images[:2]:      # warm-up
        gen.generate(img)
    torch.cuda.synchronize()
    per_image, counts, anns_opened = [], [], []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for img in images:
        for kern in kernels_all:
            kern.launches = 0
        anns = gen.generate(img)
        per_image.append({kern.name: kern.launches for kern in kernels_all})
        counts.append(len(anns))
    torch.cuda.synchronize()
    ms_image = (time.perf_counter() - t0) * 1e3 / len(images)
    peak = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    for img in images:
        anns_opened.append(opened.generate(img))
    torch.cuda.synchronize()
    ms_opened = (time.perf_counter() - t0) * 1e3 / len(images)
    no_nms.generate(images[0])     # warm-up
    t0 = time.perf_counter()
    anns_no_nms = [no_nms.generate(img) for img in images]
    torch.cuda.synchronize()
    ms_no_nms = (time.perf_counter() - t0) * 1e3 / len(images)
    anns_opened += anns_no_nms
    expect = {k.name: 0 for k in kernels_all}
    expect.update({"relpos_fwd": 4, "relpos_window": 28, "factored_decode": 16})
    schema = all(set(a) == ANN_KEYS and a["area"] > 0 and a["segmentation"]["size"] == list(img.shape[:2])
                 for anns, img in zip(anns_opened, images + images) for a in anns)
    finite = all(math.isfinite(a["predicted_iou"]) and math.isfinite(a["stability_score"])
                 for anns in anns_opened for a in anns)
    sorted_ok = all([a["area"] for a in anns] == sorted((a["area"] for a in anns), reverse=True)
                    for anns in anns_opened)

    # one image in parts, synced: encoder, amg_select, finish
    img = images[2]
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = no_nms.submit(img)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        no_nms.finish(h)
        t2 = time.perf_counter()
        x = torch.from_numpy(img).cuda()[None]
        xp = S.preprocess(x, cfg)
        enc_ms = cuda_ms(lambda: S.encode_image(model, xp), 3)
    rec = {"phase": "amg", "config": "sam_vit_h", "dtype": "bfloat16",
           "amg": "AMGConfig() (32x32 points, 64 a batch, max_masks 512)",
           "images": [list(i.shape[:2]) for i in images], "setup_s": setup_s,
           "launches_per_image": per_image, "expected_launches_per_image": expect,
           "annotations_default": counts,
           "annotations_opened": [len(a) for a in anns_opened[:len(images)]],
           "annotations_opened_nms_off": [len(a) for a in anns_no_nms],
           "schema_ok": schema, "finite": finite, "sorted_by_area": sorted_ok,
           "ms_per_image": ms_image, "images_per_s": 1e3 / ms_image,
           "ms_per_image_opened": ms_opened, "ms_per_image_opened_nms_off": ms_no_nms,
           "peak_mem_gb": peak,
           "breakdown_opened_nms_off_ms": {"submit (encoder + amg_select)": (t1 - t0) * 1e3,
                                   "encoder alone": enc_ms,
                                   "amg_select (by difference)": (t1 - t0) * 1e3 - enc_ms,
                                   "finish (prefetch, upscale, RLE, assembly)": (t2 - t1) * 1e3}}
    rec["ok"] = (all(p == expect for p in per_image) and schema and finite and sorted_ok
                 and all(len(a) > 0 for a in anns_opened)
                 and all(len(a) > 1 for a in anns_no_nms))
    emit(rec)
    if not rec["ok"]:
        raise SystemExit("amg phase failed")
    return {"model": model, "gen": gen, "images": images, "launches": per_image[0]}


# ---------------------------------------------------------------------------
# The pixel-decoder entry point: kernels H, I and J
# ---------------------------------------------------------------------------

TWOWAY_TOL = G_TOL            # kernels H and I vs their plain versions, max|ref|
PIXEL_IMAGES = 8              # the smallest batch the JAX package sends to _decode_kernel
PIXEL_HW = {"input_hw": (768, 1024), "original_hw": (480, 640)}


def twoway_flops(dec, P: int, N: int, L: int, shared: bool, head: bool) -> float:
    """The useful operations of kernel H (``head``) or I on P prompts of N
    tokens against L image tokens: every product of the transformer
    (layer 0's keys-side projections once for a shared base), of the
    attention scores and values, and of the head (conv1, conv2, the
    hypernetwork product, the MLPs)."""
    twt = dec.transformer
    C = twt.layers[0].norm1.weight.shape[0]
    Ci = twt.layers[0].cross_attn_t2i.q.out_features
    Csa = twt.layers[0].self_attn.q.out_features
    mlp = twt.layers[0].mlp.fc1.out_features
    depth = len(twt.layers)
    tok = P * N
    f = 0.0
    for i in range(depth):
        rows = L if (i == 0 and shared) else P * L
        f += 3 * 2.0 * rows * C * Ci                      # t2i k, v; i2t q
        f += 2.0 * P * L * Ci * C                         # i2t out
        f += 2 * 2.0 * P * L * N * Ci                     # t2i and i2t scores and values
        f += 4 * 2.0 * tok * C * Csa + 2 * 2.0 * tok * N * Csa   # self attention
        f += 4 * 2.0 * tok * C * Ci + 2 * 2.0 * tok * C * mlp    # t2i q/out, i2t k/v, MLP
    f += 2 * 2.0 * P * L * C * Ci + 2 * 2.0 * P * L * N * Ci    # final k, v, attention
    f += 2 * 2.0 * tok * C * Ci
    if head:
        nt = len(dec.hyper_mlps)
        co1, co2 = dec.upscale_conv2.weight.shape[1], dec.upscale_conv2.weight.shape[0]
        f += 2.0 * P * L * C * 4 * co1 + 2.0 * 4 * P * L * co1 * 4 * co2
        f += 2.0 * 4 * P * L * 4 * nt * co2
        f += sum(2.0 * P * lin.in_features * lin.out_features
                 for st in (dec.iou_head, *dec.hyper_mlps) for lin in st.layers)
    return f


def tw_breakdown(TK, plan, iters: int = 5) -> dict:
    """Kernel H's or I's breakdown by part (record_breakdown, TK.TW_REGIONS)
    on a replayed plan."""
    return record_breakdown(TK, plan.prog, plan.packed, plan.kernel, TK.TW_REGIONS, iters)


def twoway_case(C, TK, name, dtype, *, P, N, shared=False, timed=False, seed=0, check=False):
    """Kernel H (``twoway_decode``, through fused_decode_apply with
    factored=False) or I (``twoway_transformer``) against its plain version
    at sam_vit_h's decoder widths, L = 64*64, gated normwise at TWOWAY_TOL:
    max|err| <= tol * max|ref| per output, on a call that records the plan
    and on a second call that replays it on a new base and new tokens.  With
    ``check``: a third call on the second's inputs equal to the bit, and in
    bf16 each fused kernel against its record's emulation on the same
    operands (normwise at TWOWAY_TOL).  With ``timed``: the kernel's time
    replaying its plan (event and device clocks) and with the plan recorded
    anew, its breakdown by part (tw_breakdown), the plain version's and the
    plain route's times (the mask decoder's plain tail for H, the
    transformer's plain route for I; no single PyTorch call computes either,
    so library_ms is null), and the bound from the operations of the
    recorded sequence (the projections folded into the token side in bf16)
    and the bytes read (base, pe, tokens, weights) and written (masks and
    IoU, or queries and keys); beside it the bound of the unfolded
    operations (twoway_flops, the TPU kernel's form)."""
    import torch
    dt = str(dtype).split(".")[-1]
    dec = random_decoder(C, dtype, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)

    def draw():
        return ((torch.randn(1 if shared else P, 64, 64, 256, device="cuda", generator=g) * 0.5
                 ).to(dtype), (torch.randn(P, N, 256, device="cuda", generator=g) * 0.5).to(dtype))

    pe = (torch.randn(64, 64, 256, device="cuda", generator=g) * 0.5).to(dtype)
    (base, tok), (base2, tok2) = draw(), draw()
    if name == "twoway_decode":
        kern, outs, decoder = TK.TWOWAY_DECODE, ("masks", "iou"), dec
        call = lambda b, t: TK.fused_decode_apply(dec.transformer, dec, b, pe, t, 8, factored=False)
        plain_of = lambda b, t: TK.fused_decode_plain(dec.transformer, dec, b, pe, t, 8)
        plain_route = lambda: dec.plain_tail(base, pe, tok)
    else:
        kern, outs, decoder = TK.TWOWAY_TRANSFORMER, ("queries", "keys"), None
        call = lambda b, t: TK.fused_twoway_apply(dec.transformer, b, pe, t, 8)
        plain_of = lambda b, t: TK.fused_twoway_plain(dec.transformer, b, pe, t, 8)
        plain_route = lambda: dec.transformer(base, pe, tok, impl="xla")
    run, plain = (lambda: call(base, tok)), (lambda: plain_of(base, tok))
    with torch.inference_mode():
        before = kern.launches
        got = [call(base, tok), call(base2, tok2)]   # recorded, then replayed
        torch.cuda.synchronize()
        launched = kern.launches - before
        ref = [plain(), plain_of(base2, tok2)]
        err = {k: max((x[j].float() - r[j].float()).abs().max().item() for x, r in zip(got, ref))
               for j, k in enumerate(outs)}
        top = {k: min(r[j].float().abs().max().item() for r in ref) for j, k in enumerate(outs)}
        rec = {"phase": "kernel", "kernel": name, "prompts": P, "tokens": N, "L": 4096,
               "C": 256, "shared_base": shared, "dtype": dt, "checked": "recorded, replayed on "
               "a new base and tokens", "max_abs_err": err, "max_abs_ref": top,
               "tol_vs_max_ref": TWOWAY_TOL[dt], "launches": launched}
        rec["ok"] = launched == 2 and all(math.isfinite(err[k]) and err[k] <= TWOWAY_TOL[dt] * top[k]
                                          for k in err)
        plan = TK._plan(kern, dec.transformer, decoder, base, tok, 8)
        rec["records"] = len(plan.prog.records)
        if check:
            again = call(base2, tok2)
            rec["bitwise_repeat"] = all(torch.equal(a, b) for a, b in zip(again, got[1]))
            rec["ok"] = rec["ok"] and rec["bitwise_repeat"]
            if dtype == torch.bfloat16:   # each fused kernel against its record's emulation
                fused = TK.fused_record_errors(plan.prog, kern)
                rec["fused_records"] = {f"{r['record']}:{r['op']}": max(
                    e / max(m, 1e-30) for e, m in zip(r["max_abs_err"], r["max_abs_ref"]))
                    for r in fused}
                rec["ok"] = rec["ok"] and len(fused) > 0 and all(
                    v <= TWOWAY_TOL[dt] for v in rec["fused_records"].values())
        if timed:
            rec["ms"] = cuda_ms(run, 10)
            rec["device_ms"] = device_ms(run, 10)
            rec["ms_with_recording"] = cuda_ms(lambda: (TK._PLANS.pop(dec.transformer, None),
                                                        run()), 3)
            rec["breakdown"] = tw_breakdown(TK, TK._plan(kern, dec.transformer, decoder, base,
                                                         tok, 8))
            rec["plain_ms"] = cuda_ms(plain, 3)
            rec["plain_route_ms"] = cuda_ms(plain_route, 3)
            rec["library_ms"] = None
            e = base.element_size()
            nbytes = (e * (base.numel() + pe.numel() + tok.numel())
                      + sum(p.numel() * p.element_size() for p in
                            (dec if name == "twoway_decode" else dec.transformer).parameters())
                      + sum(x.numel() * x.element_size() for x in got[0]))
            rec["flops"] = plan.prog.flops
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, rec["flops"])
            rec["flops_unfolded"] = twoway_flops(dec, P, N, 4096, shared, name == "twoway_decode")
            rec["bound_ms_unfolded"] = bound(nbytes, rec["flops_unfolded"])[0]
    emit(rec)
    if not rec["ok"]:
        raise SystemExit(f"{name} disagrees with its plain version: {rec}")
    del dec, plan
    torch.cuda.empty_cache()
    return rec


def pixel_kernel_phase(C, A, TK) -> dict:
    """H at the pixel decoder's shape and at 64 prompts (a base each, and a
    shared one), I at 64 x 7, in bf16 (timed) and float32; J at DINOv2-L's
    shape in bf16 (timed, with its exp2 bound), with adversarial norms, at
    D = 128, in float32, at lengths off its tiles, with one head and with
    rescued rows beside rows that are not."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    main = {"twoway_decode": twoway_case(C, TK, "twoway_decode", bf16, P=8, N=6, timed=True,
                                         check=True)}
    twoway_case(C, TK, "twoway_decode", f32, P=8, N=6)
    main["twoway_decode_64"] = twoway_case(C, TK, "twoway_decode", bf16, P=64, N=7, timed=True,
                                           check=True)
    twoway_case(C, TK, "twoway_decode", f32, P=64, N=7)
    twoway_case(C, TK, "twoway_decode", bf16, P=64, N=7, shared=True, timed=True, check=True)
    twoway_case(C, TK, "twoway_decode", f32, P=8, N=6, shared=True)
    main["twoway_transformer"] = twoway_case(C, TK, "twoway_transformer", bf16, P=64, N=7,
                                             timed=True, check=True)
    twoway_case(C, TK, "twoway_transformer", f32, P=64, N=7)
    # one prompt, 9 (a split of L that leaves CTAs of one tile less), 16
    # tokens (two 64-row blocks of token-to-image rows, 16 token columns a
    # head), one token (I), a shared base under 9 prompts
    for nm, P, N, sh in (("twoway_decode", 1, 6, False), ("twoway_decode", 9, 16, False),
                         ("twoway_decode", 9, 7, True), ("twoway_transformer", 1, 1, False),
                         ("twoway_transformer", 9, 16, False)):
        twoway_case(C, TK, nm, bf16, P=P, N=N, shared=sh, check=True, seed=P + N)
    twoway_case(C, TK, "twoway_transformer", f32, P=9, N=16, seed=2)
    main["flash_fwd_1pass_t"] = kernel_case(A, "flash_fwd_1pass_t", BH=4 * 16, T=4097, S=4097,
                                            D=64, dtype=bf16, timed=True)
    main["flash_fwd_1pass_t"]["ex2_bound_ms"] = ex2_bound_ms(4 * 16 * 4097 * 4097)
    kernel_case(A, "flash_fwd_1pass_t", BH=16, T=4097, S=4097, D=64, dtype=bf16,
                adversarial=True)
    kernel_case(A, "flash_fwd_1pass_t", BH=4, T=200, S=300, D=128, dtype=bf16)
    kernel_case(A, "flash_fwd_1pass_t", BH=2, T=200, S=300, D=64, dtype=f32, adversarial=True)
    kernel_case(A, "flash_fwd_1pass_t", BH=2, T=4097, S=4097, D=64, dtype=f32)
    # lengths off the 128-row tiles, one head, and rescued rows beside rows
    # that are not
    kernel_case(A, "flash_fwd_1pass_t", BH=1, T=65, S=129, D=64, dtype=bf16)
    kernel_case(A, "flash_fwd_1pass_t", BH=3, T=129, S=65, D=128, dtype=bf16)
    kernel_case(A, "flash_fwd_1pass_t", BH=1, T=1, S=1, D=64, dtype=bf16)
    kernel_case(A, "flash_fwd_1pass_t", BH=4, T=1000, S=1000, D=64, dtype=bf16,
                adversarial=True, mixed=True)
    return main


def pixel_images(S, cfg, n: int, seed: int):
    """n seeded uint8 images of 768 x 1024, preprocessed for the SAM encoder."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randint(0, 256, (n, *PIXEL_HW["input_hw"], 3), device="cuda", generator=g)
    return S.preprocess(x, cfg)


def top2_gap(logits) -> float:
    """The smallest gap between the largest and second-largest logit."""
    top = logits.float().topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1]).min().item()


def pixel_in_place(C, S, R, TK, IE, PD, GEN, make_batch, A) -> dict:
    """The pixel decoder at llmseg_7b and sam_vit_h widths, depth cut (two
    LLaMA layers, CLIP 3 blocks, SAM encoder 2 blocks, one global), float32,
    8 images, 8 new tokens: generation (prefill through kernel A), the SAM
    encoder (E, F) and the decode (H, a base per prompt) against the same
    model with every attention on the plain path and the mask decoder's
    plain tail.  Tokens must be equal, hiddens within MODULE_LIMIT of
    max|ref|, masks (before the [SEG] select) and IoU within the decoder
    limits.  The smallest top-1 / top-2 logit gap of the choices made
    (the first token and the 7 after it) is printed beside the largest
    logit error of the steps, which it must exceed."""
    import torch
    from llmseg_tpu_torch.models import llama, llmseg, vit
    from llmseg_tpu_torch.models.llava import splice_image_tokens
    cfg = cut_config(C)
    scfg = cut_sam(C)
    model = llmseg.init(cfg, seed=11, device="cuda")
    sam_model = S.init(scfg, seed=12, device="cuda")
    batch = make_batch(cfg, num_images=PIXEL_IMAGES, rows_per_image=1, text_len=512, seed=6)
    images_sam = pixel_images(S, scfg, PIXEL_IMAGES, seed=7)
    inputs = dict(images_clip=batch["images_clip"], input_ids=batch["input_ids"],
                  image_pos=batch["image_pos"], max_new_tokens=8)
    kernels = A.KERNELS + R.KERNELS + TK.KERNELS

    def path():
        tokens, hiddens = PD.generate_answer(model, **inputs)
        prompts, _ = PD.seg_prompts(model, tokens, hiddens)
        return tokens, hiddens, PD.decode_seg_masks(sam_model, images_sam, prompts, **PIXEL_HW)

    for kern in kernels:
        kern.launches = 0
    tok_k, hid_k, (mask_k, iou_k) = path()
    launches = {kern.name: kern.launches for kern in kernels if kern.launches}

    def plain_relpos(q, k, v, rel_h, rel_w, hw, scale=None):
        bias = R.decomposed_rel_pos_bias(q.transpose(1, 2), rel_h, rel_w, hw)
        return A.attention_plain(q, k, v, bias=bias, scale=scale)

    def plain_decode(sam_model_, images, prompts, input_hw, original_hw):
        emb = S.encode_image(sam_model_, images)
        pe_mod = sam_model_.prompt_encoder
        sparse, dense = pe_mod(text_embeds=prompts[:, None, :], batch=emb.shape[0])
        m, i = sam_model_.mask_decoder(emb, pe_mod.dense_pe(64)[None], sparse, dense,
                                       multimask_output=False, impl="xla")
        return S.postprocess_masks(m, input_hw, original_hw, sam_model_.cfg), i

    saved = (GEN.attention, llama.attention, vit.attention, IE.relpos_flash_attention,
             PD.decode_seg_masks)
    GEN.attention = llama.attention = vit.attention = plain_attention
    IE.relpos_flash_attention = plain_relpos
    PD.decode_seg_masks = torch.inference_mode()(plain_decode)
    llm = model.llava.llm
    try:
        tok_p, hid_p, (mask_p, iou_p) = path()
        with torch.inference_mode():   # the prompt's last hidden state: the first choice
            img = model.llava.encode_images(inputs["images_clip"])
            text = llm.embed_tokens(inputs["input_ids"])
            x = splice_image_tokens(text, img.to(text.dtype), inputs["image_pos"])
            first = llm(inputs_embeds=x)[:, -1:]
    finally:
        (GEN.attention, llama.attention, vit.attention, IE.relpos_flash_attention,
         PD.decode_seg_masks) = saved
    with torch.inference_mode():
        lg_p = llama.logits(llm, hid_p[:, :-1])
        lg_k = llama.logits(llm, hid_k[:, :-1])
        gaps = [top2_gap(lg_p), top2_gap(llama.logits(llm, first))]

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    rec = {"phase": "pixel_in_place", "config": "llmseg_7b (LLaMA 2 layers, towers 2-3 blocks) "
           "+ sam_vit_h (2 encoder blocks, 1 global)", "dtype": "float32",
           "images": PIXEL_IMAGES, "new_tokens": 8, "launches": launches,
           "tokens_equal": bool(torch.equal(tok_k, tok_p)),
           "hidden_err_vs_max_ref": rel(hid_k, hid_p),
           "masks_err_vs_max_ref": rel(mask_k, mask_p), "iou_err_vs_max_ref": rel(iou_k, iou_p),
           "min_top2_logit_gap": min(gaps),
           "max_logit_err": (lg_k - lg_p).abs().max().item(),
           "limits": {"hidden": MODULE_LIMIT, **SAM_DECODE_LIMIT}}
    expect = {"flash_fwd": 2, "relpos_fwd": 1, "relpos_window": 1, "twoway_decode": 1}
    rec["expected_launches"] = expect
    rec["ok"] = (rec["tokens_equal"] and launches == expect
                 and rec["hidden_err_vs_max_ref"] <= MODULE_LIMIT
                 and rec["masks_err_vs_max_ref"] <= SAM_DECODE_LIMIT["masks"]
                 and rec["iou_err_vs_max_ref"] <= SAM_DECODE_LIMIT["iou"]
                 and rec["min_top2_logit_gap"] > rec["max_logit_err"])
    emit(rec)
    del model, sam_model
    torch.cuda.empty_cache()
    if not rec["ok"]:
        raise SystemExit(f"the pixel path through the kernels disagrees with the plain path: {rec}")
    return rec


def pixel_phase(C, llmseg, S, PD, GEN, make_batch, kernels_all) -> dict:
    """The pixel-decoder entry point, ``evaluate``, at llmseg_7b + sam_vit_h
    in bf16 (random weights from seeds), 8 images, text_len 512 (767-token
    prompts), 32 new tokens.  With random weights the model almost never
    emits [SEG], so evaluate's masks are -1e9 and the masks before that
    select are checked too.  1 warm-up, the launch counts of one run, then
    3 timed; peak memory of those; the split of one evaluate, each part
    timed alone with CUDA events (the decode steps, the SAM decode and the
    rest by difference)."""
    import torch
    from llmseg_tpu_torch.models.llava import splice_image_tokens
    bf16 = torch.bfloat16
    cfg, scfg = C.llmseg_7b(), C.sam_vit_h()
    t0 = time.time()
    model = llmseg.init(cfg, seed=0, device="cuda", dtype=bf16)
    sam_model = S.init(scfg, seed=0, device="cuda", dtype=bf16)
    batch = make_batch(cfg, num_images=PIXEL_IMAGES, rows_per_image=1, text_len=512, seed=8)
    images_sam = pixel_images(S, scfg, PIXEL_IMAGES, seed=9)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    new = 32
    inputs = dict(images_clip=batch["images_clip"], input_ids=batch["input_ids"],
                  image_pos=batch["image_pos"])
    run = lambda: PD.evaluate(model, sam_model, images_sam=images_sam, max_new_tokens=new,
                              **inputs, **PIXEL_HW)
    run()
    torch.cuda.synchronize()
    for kern in kernels_all:
        kern.launches = 0
    tokens, masks = run()
    torch.cuda.synchronize()
    launches = {kern.name: kern.launches for kern in kernels_all}
    steps = 3
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        run()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    with torch.inference_mode():
        toks, hiddens = PD.generate_answer(model, max_new_tokens=new, **inputs)
        prompts, has_seg = PD.seg_prompts(model, toks, hiddens)
        pred, iou = PD.decode_seg_masks(sam_model, images_sam, prompts, **PIXEL_HW)
        llm = model.llava.llm
        img = model.llava.encode_images(inputs["images_clip"])
        text = llm.embed_tokens(inputs["input_ids"])
        x = splice_image_tokens(text, img.to(text.dtype), inputs["image_pos"])
        T = x.shape[1]
        split = {"clip": cuda_ms(lambda: model.llava.encode_images(inputs["images_clip"]), 3),
                 "prefill": cuda_ms(lambda: GEN.prefill_cache(llm, x, T + new), 3)}
        gen_ms = cuda_ms(lambda: PD.generate_answer(model, max_new_tokens=new, **inputs), 2)
        split["decode_steps (by difference)"] = gen_ms - split["clip"] - split["prefill"]
        split["sam_encoder"] = cuda_ms(lambda: S.encode_image(sam_model, images_sam), 3)
        split["sam_decode_and_postprocess (by difference)"] = cuda_ms(
            lambda: PD.decode_seg_masks(sam_model, images_sam, prompts, **PIXEL_HW), 3
        ) - split["sam_encoder"]
        split["rest (by difference)"] = ms - gen_ms - split["sam_encoder"] - split[
            "sam_decode_and_postprocess (by difference)"]
    expect = {k.name: 0 for k in kernels_all}
    expect.update({"flash_fwd": cfg.llava.llm.num_layers, "relpos_fwd": 4, "relpos_window": 28,
                   "twoway_decode": 1})
    H, W = PIXEL_HW["original_hw"]
    finite = bool(torch.isfinite(masks).all() and torch.isfinite(pred).all()
                  and torch.isfinite(iou.float()).all())
    shapes = (tuple(tokens.shape) == (PIXEL_IMAGES, new) and tuple(masks.shape) == (PIXEL_IMAGES, H, W)
              and tuple(pred.shape) == (PIXEL_IMAGES, 1, H, W) and tuple(iou.shape) == (PIXEL_IMAGES, 1))
    rec = {"phase": "pixel", "config": "llmseg_7b + sam_vit_h", "dtype": "bfloat16",
           "images": PIXEL_IMAGES, "text_len": 512, "prompt_len": T, "new_tokens": new,
           **{k: list(v) for k, v in PIXEL_HW.items()}, "setup_s": setup_s,
           "launches": launches, "expected_launches": expect, "shapes_ok": shapes,
           "finite": finite, "rows_with_seg": int(has_seg.sum()),
           "tokens_repeat": bool(torch.equal(tokens, toks)),
           "premask_range": [pred.float().min().item(), pred.float().max().item()],
           "ms_per_evaluate": ms, "images_per_s": PIXEL_IMAGES * 1e3 / ms,
           "peak_mem_gb": peak_gb, "split_ms": split}
    rec["ok"] = launches == expect and shapes and finite and rec["tokens_repeat"]
    emit(rec)
    if not rec["ok"]:
        raise SystemExit("pixel phase failed")
    return {"run": run, "launches": launches, "keep": (model, sam_model)}


# ---------------------------------------------------------------------------
# W8A8: kernels Q1 (csrc/quant.cu) and Q2 (csrc/w8a8_gemm.cu)
# ---------------------------------------------------------------------------

Q_SC_RTOL = 2e-6              # Q1's RMS-form scale vs its plain version (the mean of x^2
                              # summed in another order; torch.rsqrt vs 1 / sqrt)
Q2_ULPS = 1                   # the standalone rescale vs its plain version, in units of the
                              # output's last place (Q2 itself is held to the bit)
QUANT_CASCADE = 0.5           # w8a8_in_place: the kernels' predict vs the plain quant path's,
                              # as a share of the quantization error (see w8a8_in_place)
SEQ_7B = 512 + 256 - 1        # llmseg_7b's rows per image at text_len 512


def ulps(got, ref):
    """|got - ref| in units in the last place of their type (the bit
    patterns of two finite values of one sign)."""
    import torch
    view = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    return (got.view(view).long() - ref.view(view).long()).abs()


def q1_case(Q, *, R, C, dtype, rms, timed=False, seed=0) -> dict:
    """Kernel Q1 against its plain version: int8 values equal; the scale
    equal (plain form) or within Q_SC_RTOL (RMS form)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed + R + C)
    x = torch.randn(R, C, device="cuda", generator=g) * 3
    x[0, :4] = torch.tensor([127.0, 2.5, -3.5, 0.5])    # exact ties in the plain form
    x = x.to(dtype)
    gamma = (1 + 0.3 * torch.randn(C, device="cuda", generator=g)).to(dtype) if rms else None
    xq, sc = Q.quantize_rows(x, gamma, 1e-6)
    rq, rsc = Q.quantize_rows_plain(x, gamma, 1e-6)
    torch.cuda.synchronize()
    rec = {"kernel": "quantize_rows", "R": R, "C": C, "dtype": str(dtype).split(".")[-1],
           "form": "rms" if rms else "plain",
           "max_abs_err": (xq.int() - rq.int()).abs().max().item(),
           "sc_max_rel_err": ((sc - rsc).abs() / rsc.abs()).max().item()}
    rec["ok"] = rec["max_abs_err"] == 0 and (rec["sc_max_rel_err"] <= Q_SC_RTOL if rms
                                             else bool(torch.equal(sc, rsc)))
    if timed:
        run = lambda: Q.quantize_rows(x, gamma, 1e-6)            # noqa: E731
        nbytes = R * C * (x.element_size() + 1) + R * 4 + (C * gamma.element_size() if rms else 0)
        rec.update(ms=cuda_ms(run, 20), device_ms=device_ms(run, 20),
                   plain_ms=cuda_ms(lambda: Q.quantize_rows_plain(x, gamma, 1e-6), 5),
                   library_ms=None)
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 0)
    emit(rec)
    if not rec["ok"]:
        raise SystemExit(f"kernel Q1 disagrees with its plain version: {rec}")
    return rec


def same_bits(got, ref) -> bool:
    import torch
    view = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    return got.dtype == ref.dtype and bool(torch.equal(got.view(view), ref.view(view)))


def w8a8_inputs(R, K, N, out_dtype, extra, seed):
    """Random int8 operands over the whole range, scales as a model's, and
    a bias or a side term."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed + R + K + N)
    xq = torch.randint(-127, 128, (R, K), device="cuda", generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (N, K), device="cuda", generator=g, dtype=torch.int8)
    sc = torch.rand(R, 1, device="cuda", generator=g) * 1e-3
    ws = torch.rand(N, device="cuda", generator=g) * 1e-2
    bias = torch.randn(N, device="cuda", generator=g).to(out_dtype) if extra == "bias" else None
    side = torch.randn(R, N, device="cuda", generator=g) if extra == "side" else None
    return xq, sc, w, ws, bias, out_dtype, side


def w8a8_case(Q, *, R, K, N, out_dtype, extra=None, timed=False, seed=0) -> dict:
    """Kernel Q2 (w8a8_linear) against its plain version, equal to the bit;
    timed: its event and device clocks beside the route it replaced
    (torch._int_mm, then the standalone rescale), torch._int_mm alone (the
    library call), the plain version, and its bound (int8 operations at the
    card's peak, or the operands' and output's bytes)."""
    import torch
    args = w8a8_inputs(R, K, N, out_dtype, extra, seed)
    got = Q.w8a8_linear(*args)
    ref = Q.w8a8_linear_plain(*args)
    torch.cuda.synchronize()
    rec = {"kernel": "w8a8_linear", "R": R, "K": K, "N": N,
           "out_dtype": str(out_dtype).split(".")[-1], "extra": extra,
           "max_abs_err": (got.float() - ref.float()).abs().max().item(),
           "bitwise": same_bits(got, ref)}
    rec["ok"] = rec["bitwise"]
    if timed:
        xq, sc, w, ws, bias, _, side = args
        wt = w.t()
        run = lambda: Q.w8a8_linear(*args)                                    # noqa: E731
        old = lambda: Q.w8a8_epilogue(torch._int_mm(xq, wt), sc, ws, bias,    # noqa: E731
                                      out_dtype, side)
        lib = lambda: torch._int_mm(xq, wt)                                   # noqa: E731
        rec.update(ms=cuda_ms(run, 20), device_ms=device_ms(run, 20),
                   int_mm_q2_device_ms=device_ms(old, 20), library_ms=cuda_ms(lib, 20),
                   library_device_ms=device_ms(lib, 20),
                   plain_ms=cuda_ms(lambda: Q.w8a8_linear_plain(*args), 5))
        nbytes = R * K + N * K + R * N * got.element_size() + 4 * (R + N)
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 2 * R * K * N, INT8_OPS_PER_S)
        rec["int8_peak_share"] = 1e3 * 2 * R * K * N / INT8_OPS_PER_S / rec["device_ms"]
    emit(rec)
    if not rec["ok"]:
        raise SystemExit(f"kernel Q2 disagrees with its plain version: {rec}")
    return rec


def q2_case(Q, *, R, N, out_dtype, extra=None, seed=0) -> dict:
    """The standalone rescale (the yardstick's, csrc/quant.cu) against its
    plain version: within Q2_ULPS of the output type."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed + R + N)
    acc = torch.randint(-2 ** 24, 2 ** 24, (R, N), device="cuda", generator=g, dtype=torch.int32)
    sc = torch.rand(R, 1, device="cuda", generator=g) * 1e-3
    ws = torch.rand(N, device="cuda", generator=g) * 1e-2
    bias = torch.randn(N, device="cuda", generator=g).to(out_dtype) if extra == "bias" else None
    side = torch.randn(R, N, device="cuda", generator=g) if extra == "side" else None
    got = Q.w8a8_epilogue(acc, sc, ws, bias, out_dtype, side)
    ref = Q.w8a8_epilogue_plain(acc, sc, ws, bias, out_dtype, side)
    torch.cuda.synchronize()
    d = ulps(got, ref)
    rec = {"kernel": "w8a8_epilogue", "R": R, "N": N, "out_dtype": str(out_dtype).split(".")[-1],
           "extra": extra, "max_abs_err": (got.float() - ref.float()).abs().max().item(),
           "max_ulps": d.max().item(), "values_off_by_one_ulp": int((d == 1).sum().item())}
    rec["ok"] = rec["max_ulps"] <= Q2_ULPS
    emit(rec)
    if not rec["ok"]:
        raise SystemExit(f"the standalone rescale disagrees with its plain version: {rec}")
    return rec


def quant_kernel_phase(Q) -> dict:
    """Q1 and Q2 at llmseg_7b's W8A8 shapes (3068 rows at batch 4, 6136 at
    8; K, N in {4096, 11008}), at row counts off any tile (1, 16, 17, 129),
    in float32, with a bias and a side term, Q1 also on its scalar path (a
    width that is not a whole number of 16-byte vectors); the standalone
    rescale, still the yardstick's, against its plain version; the plain
    int8 product's row padding; each kernel's time a step (32 layers: Q1 at
    two RMS sites and two plain ones, Q2 at q, k, v, o (4096 x 4096), gate,
    up (4096 -> 11008) and down (11008 -> 4096)) beside its bound, Q2's
    beside the route it replaced and torch._int_mm alone."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    r4, r8 = 4 * SEQ_7B, 8 * SEQ_7B
    q1 = {(c, rms): q1_case(Q, R=r4, C=c, dtype=bf16, rms=rms, timed=True)
          for c, rms in ((4096, True), (4096, False), (11008, False))}
    q2 = {(k, n): w8a8_case(Q, R=r4, K=k, N=n, out_dtype=bf16, timed=True)
          for k, n in ((4096, 11008), (4096, 4096), (11008, 4096))}
    for c, rms in ((4096, True), (4096, False), (11008, False)):
        q1_case(Q, R=r8, C=c, dtype=bf16, rms=rms)
    for k, n in ((4096, 4096), (4096, 11008), (11008, 4096)):
        w8a8_case(Q, R=r8, K=k, N=n, out_dtype=bf16)
    for r in (1, 17, 129):
        for c in (4096, 11008):
            for rms in (False, True):
                q1_case(Q, R=r, C=c, dtype=bf16, rms=rms)
            q2_case(Q, R=r, N=c, out_dtype=bf16)
    for r in (1, 16, 17, 129):
        for k, n in ((4096, 11008), (11008, 4096), (64, 128)):
            w8a8_case(Q, R=r, K=k, N=n, out_dtype=bf16)
    q1_case(Q, R=129, C=4096, dtype=f32, rms=True)
    q1_case(Q, R=17, C=11008, dtype=f32, rms=False)
    q1_case(Q, R=5, C=100, dtype=bf16, rms=True)
    q2_case(Q, R=129, N=4096, out_dtype=f32)
    q2_case(Q, R=17, N=4096, out_dtype=bf16, extra="bias")
    q2_case(Q, R=129, N=11008, out_dtype=bf16, extra="side")
    q2_case(Q, R=7, N=100, out_dtype=bf16)
    for out_dtype in (bf16, f32):   # w8a8_in_place runs the float32 output
        for extra in ("bias", "side"):
            w8a8_case(Q, R=129, K=4096, N=4096, out_dtype=out_dtype, extra=extra)
            w8a8_case(Q, R=r4, K=11008, N=4096, out_dtype=out_dtype, extra=extra)
        w8a8_case(Q, R=17, K=64, N=128, out_dtype=out_dtype)

    # the plain version's int8 product: exact at 1, 16 and 17 rows (padded
    # below 17)
    g = torch.Generator(device="cuda").manual_seed(9)
    pad_exact = True
    for r in (1, 16, 17):
        xq = torch.randint(-127, 128, (r, 4096), device="cuda", generator=g, dtype=torch.int8)
        w = torch.randint(-127, 128, (1024, 4096), device="cuda", generator=g, dtype=torch.int8)
        pad_exact &= bool(torch.equal(Q._int_mm(xq, w).double(), xq.double() @ w.double().t()))
    shapes = {"qkvo": (4096, 4096), "gate_up": (4096, 11008), "down": (11008, 4096)}
    per_layer = {"qkvo": 4, "gate_up": 2, "down": 1}

    def step(key):
        return 32 * sum(per_layer[p] * q2[shapes[p]][key] for p in shapes)

    rec = {"phase": "quant_kernels", "clock": "device (events behind a spin kernel)",
           "int_mm_pads_exact": pad_exact,
           "q1_step_device_ms": 32 * (2 * q1[(4096, True)]["device_ms"]
                                      + q1[(4096, False)]["device_ms"]
                                      + q1[(11008, False)]["device_ms"]),
           "q1_step_bound_ms": 32 * (2 * q1[(4096, True)]["bound_ms"] + q1[(4096, False)]["bound_ms"]
                                     + q1[(11008, False)]["bound_ms"]),
           "q2_step_device_ms": step("device_ms"),
           "int_mm_q2_step_device_ms": step("int_mm_q2_device_ms"),
           "int_mm_step_device_ms": step("library_device_ms"),
           "q2_step_bound_ms": step("bound_ms"),
           "q2_int8_peak_share": {f"{k}x{n}": q2[(k, n)]["int8_peak_share"] for k, n in q2}}
    rec["ok"] = pad_exact
    emit(rec)
    if not rec["ok"]:
        raise SystemExit("the padded int8 product is not exact")
    return {"quantize_rows": q1[(4096, True)], "w8a8_linear": q2[(4096, 11008)]}


def w8a8_in_place(C, llmseg, make_batch, Q) -> dict:
    """``llmseg_7b`` cut to two blocks per tower and two LLaMA layers, float32,
    LLaMA calibrated and quantized W8A8: predict through Q1 and Q2, each
    call held against its plain version on the same in-model tensors (int8
    values equal, the scale within Q_SC_RTOL, Q2 equal to the bit); then
    predict with both swapped for their plain versions.  The two predicts
    are not equal: the RMS form's scale differs by an ulp, a rounding tie
    falls the other way, and the next layer quantizes inputs that differ by
    that code, so codes flip in cascade; their difference is held within
    QUANT_CASCADE of the quantization error against the float32 model
    (a layout or scale fault gives a difference of the order of the
    outputs)."""
    import torch
    cfg = cut_config(C)
    batch = make_batch(cfg, num_images=4, rows_per_image=1, text_len=512, seed=3)
    model = llmseg.init(cfg, seed=1, device="cuda", dtype=torch.float32)
    ref = llmseg.predict(model, batch)
    Q.quantize_llama_inplace(model.llava.llm, bits=8, w8a8=True,
                             smooth_stats=llmseg.calibrate_quant_stats(model, batch),
                             head_dim=cfg.llava.llm.head_dim)
    kept = Q.quantize_rows, Q.w8a8_linear
    worst = {"q1_max_abs_err": 0, "q1_sc_max_rel_err": 0.0, "q2_calls_off": 0,
             "q2_max_abs_err": 0.0}

    def rows(x, gamma=None, eps=1e-6):
        xq, sc = kept[0](x, gamma, eps)
        rq, rsc = Q.quantize_rows_plain(x, gamma, eps)
        worst["q1_max_abs_err"] = max(worst["q1_max_abs_err"],
                                      (xq.int() - rq.int()).abs().max().item())
        worst["q1_sc_max_rel_err"] = max(worst["q1_sc_max_rel_err"],
                                         ((sc - rsc).abs() / rsc.abs()).max().item())
        return xq, sc

    def linear(*args):
        y = kept[1](*args)
        ref_y = Q.w8a8_linear_plain(*args)
        worst["q2_calls_off"] += not same_bits(y, ref_y)
        worst["q2_max_abs_err"] = max(worst["q2_max_abs_err"],
                                      (y.float() - ref_y.float()).abs().max().item())
        return y

    for kern in Q.KERNELS:
        kern.launches = 0
    Q.quantize_rows, Q.w8a8_linear = rows, linear
    try:
        got = llmseg.predict(model, batch)
        launches = {kern.name: kern.launches for kern in Q.KERNELS}
        Q.quantize_rows, Q.w8a8_linear = Q.quantize_rows_plain, Q.w8a8_linear_plain
        plain = llmseg.predict(model, batch)
    finally:
        Q.quantize_rows, Q.w8a8_linear = kept
    keys = ("pred_similarity", "pred_iou")
    rec = {"phase": "w8a8_in_place", "config": "llmseg_7b, towers 2 blocks, LLaMA 2 layers",
           "dtype": "float32", "launches": launches, **worst,
           "max_abs_diff_vs_plain": max((got[k] - plain[k]).abs().max().item() for k in keys),
           "quant_error_vs_float32": max((plain[k] - ref[k]).abs().max().item() for k in keys),
           "limit_share_of_quant_error": QUANT_CASCADE}
    rec["ok"] = (launches == {"quantize_rows": 8, "w8a8_linear": 14}
                 and worst["q1_max_abs_err"] == 0 and worst["q1_sc_max_rel_err"] <= Q_SC_RTOL
                 and worst["q2_calls_off"] == 0
                 and rec["quant_error_vs_float32"] > 0
                 and rec["max_abs_diff_vs_plain"]
                 <= QUANT_CASCADE * rec["quant_error_vs_float32"])
    if not rec["ok"]:
        raise SystemExit(f"W8A8 through Q1 and Q2 disagrees with the plain quant path: {rec}")
    return rec


def timed_predict(llmseg, model, batch, steps: int = 5) -> dict:
    """ms/step, img/s and peak memory of ``steps`` predict calls after one
    untimed call."""
    import torch
    llmseg.predict(model, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        out = llmseg.predict(model, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    n = batch["images_dino"].shape[0]
    return {"ms_per_step": ms, "img_per_s": n * 1e3 / ms,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "finite": bool(torch.isfinite(out["pred_similarity"]).all()
                           and torch.isfinite(out["pred_iou"]).all())}


def probe_agreement(sim, sim_bf16) -> dict:
    """bench.py's probe numbers (top-1 agreement, max|dsim|) and the rank,
    in the quantized similarities, of the bf16 top-1 proposal of each row
    (0: the same top-1)."""
    top = sim_bf16.argmax(-1, keepdim=True)
    return {"top1_agreement": (sim.argmax(-1) == top[:, 0]).float().mean().item(),
            "max_abs_dsim": (sim - sim_bf16).abs().max().item(),
            "rank_of_bf16_top1": (sim > sim.gather(-1, top)).sum(-1).tolist()}


def w8a8_phase(C, llmseg, make_batch, Q, A, model, batch, bf16_batch4: dict) -> dict:
    """The W8A8 headline lane (bench.py's run(quant_bits=8, w8a8=True)) on
    the main phase's bf16 llmseg_7b, quantized in place: bf16 at batch 8;
    one step each with the LLaMA weight-only int8 and int4 (quantized
    copies beside the bf16 one); the bf16 similarities on a one-image probe
    (text_len 512); SmoothQuant calibration on the probe; the in-place W8A8
    quantization; the probe again (top-1 agreement, max|dsim|); the launches
    of one step at batch 4; ms/step, img/s and peak memory at batch 4 and 8."""
    import torch
    cfg = model.cfg
    L = cfg.llava.llm.num_layers
    probe = make_batch(cfg, num_images=1, rows_per_image=1, text_len=512, seed=5)
    batch8 = make_batch(cfg, num_images=8, rows_per_image=1, text_len=512, seed=1)
    rec = {"phase": "w8a8", "config": "llmseg_7b", "dtype": "bfloat16", "text_len": 512,
           "seq_len": SEQ_7B, "bf16": {"batch4": bf16_batch4,
                                       "batch8": timed_predict(llmseg, model, batch8)}}
    sim_bf16 = llmseg.predict(model, probe)["pred_similarity"].float()
    top2 = sim_bf16.topk(2, -1).values
    rec["bf16_probe_top2_gap"] = (top2[:, 0] - top2[:, 1]).tolist()
    llm = model.llava.llm
    for bits in (8, 4):
        t0 = time.time()
        model.llava.llm = Q.quantize_llama(llm, bits=bits)
        torch.cuda.synchronize()
        quant_s = time.time() - t0
        sim = llmseg.predict(model, probe)["pred_similarity"].float()
        rec[f"int{bits}"] = {"quantize_s": quant_s, **probe_agreement(sim, sim_bf16),
                             **timed_predict(llmseg, model, batch, steps=1)}
        model.llava.llm = llm
    torch.cuda.empty_cache()
    t0 = time.time()
    stats = llmseg.calibrate_quant_stats(model, probe)
    torch.cuda.synchronize()
    rec["calibrate_s"] = time.time() - t0
    t0 = time.time()
    Q.quantize_llama_inplace(model.llava.llm, bits=8, w8a8=True, smooth_stats=stats,
                             head_dim=cfg.llava.llm.head_dim)
    torch.cuda.synchronize()
    rec["quantize_s"] = time.time() - t0
    del stats, llm
    torch.cuda.empty_cache()
    rec.update(probe_agreement(llmseg.predict(model, probe)["pred_similarity"].float(),
                               sim_bf16))
    kernels = A.KERNELS + Q.KERNELS + (Q.W8A8_EPILOGUE,)
    rec["expected_launches"] = {"flash_fwd": L, "flash_fwd_1pass": cfg.dino.depth,
                                "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "flash_fwd_1pass_t": 0,
                                "quantize_rows": 4 * L, "w8a8_linear": 7 * L,
                                "w8a8_epilogue": 0, "torch._int_mm": 0}
    int_mm, kept_int_mm = [], torch._int_mm
    torch._int_mm = lambda *a: int_mm.append(a) or kept_int_mm(*a)
    try:
        for name, b in (("launches", batch), ("launches_batch8", batch8)):
            for kern in kernels:
                kern.launches = 0
            int_mm.clear()
            out = llmseg.predict(model, b)
            torch.cuda.synchronize()
            rec[name] = {kern.name: kern.launches for kern in kernels}
            rec[name]["torch._int_mm"] = len(int_mm)
    finally:
        torch._int_mm = kept_int_mm
    sim8 = out["pred_similarity"]
    out = llmseg.predict(model, batch)
    sim4 = out["pred_similarity"]
    rec["shape"] = list(sim4.shape)
    rec["w8a8"] = {"batch4": timed_predict(llmseg, model, batch),
                   "batch8": timed_predict(llmseg, model, batch8)}
    rec["ok"] = (rec["launches"] == rec["expected_launches"]
                 and rec["launches_batch8"] == rec["expected_launches"]
                 and list(sim8.shape) == [8, cfg.max_proposals]
                 and rec["shape"] == [4, cfg.max_proposals]
                 and all(r["finite"] for r in (rec["w8a8"]["batch4"], rec["w8a8"]["batch8"],
                                               rec["int8"], rec["int4"])))
    emit(rec)
    if not rec["ok"]:
        raise SystemExit("the W8A8 lane failed")
    return rec


VAL_BATCH, VAL_IMAGES = 8, 48     # bench.py's run_valloop: batch 8, 48 images


def valloop_data(make_batch, cfg):
    """bench.py's run_valloop data: one (480, 640, K) proposal stack at
    density 0.3 and one (480, 640) ground truth at 0.3 from RandomState(0),
    shared by every image, and make_batch(seed=i) in bf16 for batch i.  The
    batches are made on the card before any clock starts (bench.py makes
    them inside its timed loop; here each draws 19 M normals on the host)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(0)
    segs_origin = (rng.rand(480, 640, cfg.max_proposals) < 0.3).astype(np.uint8)
    gt = (rng.rand(480, 640) < 0.3).astype(np.float32)
    extras = {"segs_origin": [segs_origin] * VAL_BATCH, "masks_list": [[gt]] * VAL_BATCH,
              "image_paths": [None] * VAL_BATCH, "conversations": [[""]] * VAL_BATCH}
    batches = [make_batch(cfg, num_images=VAL_BATCH, rows_per_image=1, text_len=512,
                          dtype=torch.bfloat16, seed=i) for i in range(VAL_IMAGES // VAL_BATCH)]
    return batches, extras


def valloop_phase(E, TS, model, data, kernels, mode: str) -> dict:
    """bench.py's val-loop lane on the port: ``evaluate.run_validation``
    (strategy "threshold") over ``train_step.eval_step`` at batch 8 on 48
    images, after one warm batch: img/s, gIoU and cIoU, the launches of
    each kernel a batch; the same loop with the forward alone (the scores
    read, no compose), whose rate beside the first shows the compose's
    share; the same loop with the numpy compose on the host
    (``plain=True``, pipelined alike), whose rate shows what the device
    compose saves; and the gate: the same 48 images' scores through the
    numpy plain compose give the same gIoU and cIoU to the bit."""
    import torch
    batches, extras = data
    n_batches = len(batches)
    E.run_validation(TS.eval_step, model, [(batches[0], extras)])
    torch.cuda.synchronize()
    scores = []

    def step(m, b):
        out = TS.eval_step(m, b)
        scores.append(out)
        return out

    for kern in kernels:
        kern.launches = 0
    t0 = time.perf_counter()
    res = E.run_validation(step, model, [(b, extras) for b in batches], strategy="threshold")
    dt = time.perf_counter() - t0
    launches = {kern.name: kern.launches / n_batches for kern in kernels}
    # the forward alone, read as the loop reads it (one batch behind)
    t0 = time.perf_counter()
    pending = None
    for b in batches:
        _, done = E._to_host(TS.eval_step(model, b))
        if pending is not None:
            pending.synchronize()
        pending = done
    torch.cuda.synchronize()
    dt_fwd = time.perf_counter() - t0
    # the loop with the numpy compose in place of the device's
    t0 = time.perf_counter()
    host = E.run_validation(TS.eval_step, model, [(b, extras) for b in batches],
                            strategy="threshold", plain=True)
    dt_host = time.perf_counter() - t0
    plain = E.run_validation(lambda m, i: scores[i], None,
                             [(i, extras) for i in range(n_batches)], strategy="threshold",
                             plain=True)
    kept = sum(int((s["prop_valid"] & (s["pred_iou"].float() > 0.5)).sum()) for s in scores)
    metric = ("val_loop_images_per_sec[llmseg_7b,batch8"
              + (",int8-w8a8]" if mode == "w8a8" else "]"))
    rec = {"phase": "valloop", "config": "llmseg_7b", "mode": mode, "batch": VAL_BATCH,
           "images": VAL_IMAGES, "strategy": "threshold", metric: VAL_IMAGES / dt,
           "img_per_s": VAL_IMAGES / dt, "seconds": dt,
           "forward_only_img_per_s": VAL_IMAGES / dt_fwd, "forward_only_seconds": dt_fwd,
           "compose_share": 1.0 - dt_fwd / dt,
           "numpy_compose_img_per_s": VAL_IMAGES / dt_host, "numpy_compose_seconds": dt_host,
           "numpy_compose_share": 1.0 - dt_fwd / dt_host, "numpy_compose_result": host,
           **res, "plain": plain,
           "proposals_kept": kept, "launches_per_batch": launches}
    rec["ok"] = (res == plain and all(math.isfinite(v) for v in res.values())
                 and len(scores) == n_batches)
    emit(rec)
    if not rec["ok"]:
        raise SystemExit(f"the val loop's device compose disagrees with the numpy path: {rec}")
    return rec


def relu_gate_flips(runs):
    """The selection head's ReLU inputs whose sign differs between two runs
    (``runs``: two lists of (name, pre-activation) of ``relu_inputs``, in
    the order of the calls): {name: flipped entries}, and the largest
    |pre-activation| of a flipped entry over the largest of its call."""
    out, worst = {}, 0.0
    for (name, a), (name_b, b) in zip(*runs):
        assert name == name_b, (name, name_b)
        flip = (a > 0) != (b > 0)
        if flip.any():
            out[name] = out.get(name, 0) + int(flip.sum())
            worst = max(worst, (a[flip].abs().max() / a.abs().max()).item())
    return out, worst


def relu_inputs(select):
    """(name, nn.Linear) of every product of the selection head that a ReLU
    follows."""
    named = dict(select.named_modules())
    names = [f"blocks.{i}.mlp.fc1" for i in range(len(select.blocks))]
    names += [f"{head}.layers.{i}" for head in ("iou_head", "embedding_head")
              for i in range(len(getattr(select, head).layers) - 1)]
    return [(n, named[n]) for n in names + ["text_fc1"]]


def qlora_in_place(C, llmseg, make_batch, A) -> dict:
    """grads_in_place with an int8 frozen base (``optim.quantize_skeleton``)
    in float32: loss_fn and the gradient of every trainable parameter
    through the kernels under remat "dots" (whose recompute runs A and the
    int8 products again) against LLaMA's attention on the plain path with
    remat "none", gated as grads_in_place.  A selection-head ReLU whose
    input sits within rounding of zero takes its kink one way on one path
    and the other way on the other, and every gradient upstream of it jumps
    (the int8 base's values put one embedding-head unit there): the plain
    run takes the kernel run's side of each kink (its forward value's sign
    flipped, the gradient passed straight through), and the flipped inputs
    must be within FLIP_LIMIT of their call's largest and at most
    FLIP_UNITS (``relu_gate_flips``).  Since the reference then follows the
    kernel run's kinks, a control shows that the gates still see a fault:
    the kernel run again with A's output scaled by 1 + PLANTED_FAULT, and
    its plain run, must fail them."""
    import torch
    from llmseg_tpu_torch.models import llama
    from llmseg_tpu_torch.ops import quant as Q
    from llmseg_tpu_torch.train import optim

    cfg = cut_config(C)
    lora = C.LoraConfig(rank=8)
    batch = make_batch(cfg, num_images=1, rows_per_image=1, text_len=512, seed=4)
    model = llmseg.init(cfg, seed=2, device="cuda", dtype=torch.float32, lora_cfg=lora)
    with torch.no_grad():
        g = torch.Generator(device="cuda").manual_seed(5)
        for name, p in model.named_parameters():
            if name.startswith("lora.") and name.endswith(".b.weight"):
                p.copy_(torch.randn(p.shape, device="cuda", generator=g) * 0.02)
    trainable = optim.partition(model)
    optim.quantize_skeleton(model, bits=8)
    quantized = sum(Q.is_quantized(m) for m in model.modules())

    def grads(remat, attention, gates=None):
        pre = []

        def keep(name):
            def hook(mod, args, out):
                pre.append((name, out.detach()))
                if gates is not None:
                    gate_name, side = gates[len(pre) - 1]
                    assert gate_name == name, (gate_name, name)
                    flip = (out > 0) != (side > 0)
                    return out + (torch.where(flip, -out, out) - out).detach()
            return hook

        hooks = [m.register_forward_hook(keep(n)) for n, m in relu_inputs(model.select)]
        llama.attention = attention
        try:
            loss, _ = llmseg.loss_fn(model, batch, lora_cfg=lora, remat=remat)
        finally:
            llama.attention = A.attention
            for h in hooks:
                h.remove()
        loss.backward()
        out = {n: p.grad.float() for n, p in trainable.items()}
        model.zero_grad(set_to_none=True)
        return loss.item(), out, pre

    def judge(kernel_run, plain_run):
        (loss_k, got, pre_k), (loss_p, ref, pre_p) = kernel_run, plain_run
        flips, flip_pre = relu_gate_flips((pre_p, pre_k))
        zero = {n for n in ref if n.startswith("select.") and n.endswith(".k.bias")}
        top = max(r.abs().max().item() for r in ref.values())
        ratios = sorted((((got[n] - ref[n]).abs().max()
                          / ref[n].abs().max().clamp_min(1e-30)).item(), n)
                        for n in ref if n not in zero)
        noise = max(max(got[n].abs().max().item(), ref[n].abs().max().item()) for n in zero)
        r = {"loss_kernels": loss_k, "loss_plain": loss_p,
             "worst_grad_err_vs_max_ref": ratios[-1][0], "worst_tensors": ratios[-3:],
             "zero_grad_tensors": len(zero), "zero_grad_max_vs_top": noise / top,
             "tensors": len(ref), "relu_gate_flips": flips,
             "flipped_units": sum(flips.values()), "flipped_pre_vs_layer_max": flip_pre}
        r["gates_pass"] = (flip_pre <= FLIP_LIMIT and r["flipped_units"] <= FLIP_UNITS
                           and r["worst_grad_err_vs_max_ref"] <= GRAD_LIMIT
                           and r["zero_grad_max_vs_top"] <= GRAD_LIMIT)
        return r

    for kern in A.KERNELS:
        kern.launches = 0
    run_k = grads("dots", A.attention)
    launches = {kern.name: kern.launches for kern in A.KERNELS}
    found = judge(run_k, grads("none", plain_attention, gates=run_k[2]))

    def faulty(*args, **kwargs):
        return A.attention(*args, **kwargs) * (1.0 + PLANTED_FAULT)

    run_f = grads("dots", faulty)
    control = judge(run_f, grads("none", plain_attention, gates=run_f[2]))
    control = {k: control[k] for k in ("loss_kernels", "worst_grad_err_vs_max_ref",
                                       "worst_tensors", "relu_gate_flips", "flipped_units",
                                       "flipped_pre_vs_layer_max", "gates_pass")}
    expect = {"flash_fwd": 4, "flash_fwd_1pass": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2,
              "flash_fwd_1pass_t": 0}
    rec = {"phase": "qlora_in_place",
           "config": "llmseg_7b, towers 2-3 blocks, LLaMA 2 layers, LoRA rank 8, int8 base",
           "dtype": "float32", "limit": GRAD_LIMIT, "quantized_modules": quantized,
           **found, "launches": launches, "expected_launches": expect,
           "flip_limit": FLIP_LIMIT, "flip_units_limit": FLIP_UNITS,
           "planted_fault": {"attention_output_scale": 1.0 + PLANTED_FAULT, **control}}
    rec["ok"] = (quantized == 7 * cfg.llava.llm.num_layers and found["gates_pass"]
                 and not control["gates_pass"] and launches == expect)
    del model, trainable, run_k, run_f
    torch.cuda.empty_cache()
    if not rec["ok"]:
        raise SystemExit(f"QLoRA gradients through the kernels disagree with the plain path, "
                         f"or the gates miss a planted fault: {rec}")
    return rec


def paired_steps(C, cfg, qlora, batch, pairs: int = 8) -> dict:
    """The QLoRA Trainer's step against the bf16 LoRA step of the train
    phase (its Trainer built again beside it, one warm step), each step
    timed alone, in pairs whose order alternates: the ms of each, the
    ratios QLoRA / LoRA of the pairs, and their median.  Pairs taken in
    turns see the same drift of the host, which moves each step by more
    than the ratio's range between runs."""
    import statistics
    import torch
    from llmseg_tpu_torch.train.trainer import Trainer

    lora = Trainer(C.ExperimentConfig(model=cfg, train=C.TrainConfig(
        warmup_steps=0, grad_accum_steps=1, lora=C.LoraConfig(rank=8),
        log_dir=os.path.join(OUT_DIR, "train_runs"))))
    lora.step(batch)

    def timed(trainer):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step(batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    ms_q, ms_b = [], []
    for i in range(pairs):
        if i % 2:
            ms_q.append(timed(qlora))
            ms_b.append(timed(lora))
        else:
            ms_b.append(timed(lora))
            ms_q.append(timed(qlora))
    del lora
    torch.cuda.empty_cache()
    ratios = [q / b for q, b in zip(ms_q, ms_b)]
    return {"qlora_int8_ms": ms_q, "bf16_lora_ms": ms_b, "ratios": ratios,
            "median_ratio": statistics.median(ratios)}


def qlora_phase(C, make_batch, A) -> dict:
    """bench.py's train lane (run_trainstep) on the port: the Trainer with
    an int8 frozen base (quantize_frozen, quantize_bits 8), remat "dots",
    no accumulation (and no warmup, so that the first updates move the
    trainables), LoRA rank 8, llmseg_7b in bf16, 1 image, 1 row, text_len
    512.  One warm step, then 8 timed steps three times: the least ms/step
    and the spread, peak memory, launches a step; which of LLaMA's products
    remat "dots" saved in one step; the step against the bf16 LoRA step
    (the train phase's Trainer, built again), timed in 8 pairs in turns,
    and the median of the pairs' ratios; then an int4 base: one warm step
    and one timed, with its peak memory.
    Gates: finite losses, the int8 / int4 buffers bit-identical after the
    steps, every trainable with a gradient changed (but for entries that
    bf16 cannot move, as the train phase), lm_head and embed_tokens bf16
    parameters."""
    import torch
    from torch.utils.checkpoint import CheckpointPolicy
    from llmseg_tpu_torch.models import llama
    from llmseg_tpu_torch.ops import quant as Q
    from llmseg_tpu_torch.train.trainer import Trainer

    cfg = C.llmseg_7b()
    batch = make_batch(cfg, num_images=1, rows_per_image=1, text_len=512, seed=0)
    L = cfg.llava.llm.num_layers
    rec = {"phase": "qlora", "config": "llmseg_7b", "dtype": "bfloat16", "lora_rank": 8,
           "batch_images": 1, "rows": 1, "text_len": 512, "remat": "dots"}
    for bits in (8, 4):
        exp = C.ExperimentConfig(model=cfg, train=C.TrainConfig(
            quantize_frozen=True, quantize_bits=bits, remat_policy="dots",
            grad_accum_steps=1, warmup_steps=0, lora=C.LoraConfig(rank=8),
            log_dir=os.path.join(OUT_DIR, "qlora_runs")))
        torch.cuda.synchronize()
        t0 = time.time()
        trainer = Trainer(exp)
        torch.cuda.synchronize()
        setup_s = time.time() - t0
        llm = trainer.model.llava.llm
        buffers = [b for b in trainer.model.buffers() if b.dtype in (torch.int8, torch.uint8)]
        before = checksums(buffers)
        start = {n: p.detach().clone() for n, p in trainer.trainable.items()}
        nonzero = {n: torch.zeros((), dtype=torch.bool, device="cuda") for n in trainer.trainable}

        def note_grad(name):
            def hook(p):
                nonzero[name].logical_or_(p.grad.ne(0).any())
            return hook

        hooks = [p.register_post_accumulate_grad_hook(note_grad(n))
                 for n, p in trainer.trainable.items()]
        metrics = [trainer.step(batch)]
        for h in hooks:
            h.remove()
        torch.cuda.synchronize()
        r = {"setup_s": setup_s, "quantized_modules": sum(Q.is_quantized(m) for m in llm.modules())}
        if bits == 8:
            for kern in A.KERNELS:
                kern.launches = 0
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(8):
                    metrics.append(trainer.step(batch))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3 / 8)
            r["launches_per_step"] = {k.name: k.launches / 24 for k in A.KERNELS}
            r["expected_launches_per_step"] = {
                "flash_fwd": 2 * L, "flash_fwd_1pass": cfg.dino.depth,
                "flash_bwd_dq": L, "flash_bwd_dkv": L, "flash_fwd_1pass_t": 0}
            r["ms_per_step_runs"] = times
            r["train_step_ms[llmseg_7b,qlora_int8,remat_dots,batch1]"] = min(times)
            r["ms_per_step"] = min(times)
            r["spread_ms"] = max(times) - min(times)
            r["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
            # which products remat "dots" keeps: one step, the first pass
            saved = {}
            policy = llama._save_dots

            def recording(ctx, op, *args, **kwargs):
                decision = policy(ctx, op, *args, **kwargs)
                if decision == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
                    key = f"{op} {tuple(args[0].shape)}x{tuple(args[1].shape)}"
                    saved[key] = saved.get(key, 0) + 1
                return decision

            llama._save_dots = recording
            try:
                metrics.append(trainer.step(batch))
            finally:
                llama._save_dots = policy
            r["dots_saved_per_step"] = saved
            r["dots_saved_int8_products"] = sum(
                n for k, n in saved.items() if k.startswith("aten.mm.dtype"))
            r["expected_dots_saved_int8_products"] = 7 * L
            r["paired_with_bf16_lora"] = paired_steps(C, cfg, trainer, batch)
        else:   # one timed step after the warm one
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            metrics.append(trainer.step(batch))
            torch.cuda.synchronize()
            r["ms_per_step"] = (time.perf_counter() - t0) * 1e3
            r["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.synchronize()
        losses = [{k: v.item() for k, v in m.items()} for m in metrics]
        moved = {n for n, p in trainer.trainable.items() if not torch.equal(p, start[n])}
        with_grad = {n for n, f in nonzero.items() if bool(f)}
        lr = exp.train.lr
        held = {n for n in with_grad - moved
                if trainer.trainable[n].abs().min().item() >= 1024 * lr}
        r.update({
            "losses": [m["loss"] for m in losses], "finite": all(
                math.isfinite(x) for m in losses for x in m.values()),
            "quantized_buffers": len(buffers),
            "buffers_bit_identical": bool(torch.equal(checksums(buffers), before)),
            "trainable_tensors": len(start), "trainable_with_grad": len(with_grad),
            "trainable_changed": len(moved), "held_by_bf16_rounding": sorted(held),
            "without_grad": sorted(set(start) - with_grad),
            "lm_head_embed_bf16_parameters": all(
                isinstance(p, torch.nn.Parameter) and p.dtype == torch.bfloat16
                and p.requires_grad for p in (llm.lm_head.weight, llm.embed_tokens.weight))})
        r["ok"] = (r["finite"] and r["buffers_bit_identical"] and with_grad - held <= moved
                   and len(moved) > 0 and r["lm_head_embed_bf16_parameters"]
                   and r["quantized_modules"] == 7 * L
                   and r.get("launches_per_step") == r.get("expected_launches_per_step")
                   and r.get("dots_saved_int8_products")
                   == r.get("expected_dots_saved_int8_products"))
        rec[f"int{bits}"] = r
        del trainer, llm, buffers, start, metrics, hooks
        torch.cuda.empty_cache()
    rec["ok"] = rec["int8"]["ok"] and rec["int4"]["ok"]
    emit(rec)
    if not rec["ok"]:
        raise SystemExit("the QLoRA lane failed")
    return rec


# ---------------------------------------------------------------------------
# import and serve: reference checkpoints into the port, predict as a program
# ---------------------------------------------------------------------------

IMPORT_LLAMA_LAYERS = 4       # phases import and serve: an artifact holds its weights
HUB_GRID = 37                 # dinov2_vitl14's torch.hub position table (518 px)
POS_LIMIT = 1e-6              # the imported DINOv2 table vs keys_cubic_f64 here
SERVE_PROMPTS = 64            # SAM decoder program's prompt batch


def _lin_sd(sd, ref, mod) -> None:
    """ref.weight (and ref.bias) from a module with ``weight`` (and
    ``bias``): nn.Linear, the port's norms and patch convolutions."""
    sd[f"{ref}.weight"] = mod.weight
    if getattr(mod, "bias", None) is not None:
        sd[f"{ref}.bias"] = mod.bias


def ref_llama(llm, prefix: str = "model.") -> dict:
    """HF LLaMA names of a port ``Llama``'s weights.  These writers invert
    the reference's key maps here, independently of the port's importers."""
    sd = {f"{prefix}embed_tokens.weight": llm.embed_tokens.weight,
          f"{prefix}norm.weight": llm.norm.weight}
    if llm.lm_head is not None:
        sd["lm_head.weight"] = llm.lm_head.weight
    for i, layer in enumerate(llm.layers):
        b = f"{prefix}layers.{i}"
        sd[f"{b}.input_layernorm.weight"] = layer.input_norm.weight
        sd[f"{b}.post_attention_layernorm.weight"] = layer.post_norm.weight
        for n in ("q", "k", "v", "o"):
            sd[f"{b}.self_attn.{n}_proj.weight"] = getattr(layer.attn, n).weight
        for n in ("gate", "up", "down"):
            sd[f"{b}.mlp.{n}_proj.weight"] = getattr(layer.mlp, n).weight
    return sd


def ref_clip(tower, prefix: str = "vision_model.") -> dict:
    """HF CLIPVisionModel names of a port CLIP ``ViT``."""
    sd = {f"{prefix}embeddings.patch_embedding.weight": tower.patch_embed.weight,
          f"{prefix}embeddings.class_embedding": tower.cls_token.reshape(-1),
          f"{prefix}embeddings.position_embedding.weight": tower.pos_embed[0]}
    _lin_sd(sd, f"{prefix}pre_layrnorm", tower.pre_norm)
    _lin_sd(sd, f"{prefix}post_layernorm", tower.norm)
    for i, blk in enumerate(tower.blocks):
        b = f"{prefix}encoder.layers.{i}"
        _lin_sd(sd, f"{b}.layer_norm1", blk.norm1)
        _lin_sd(sd, f"{b}.layer_norm2", blk.norm2)
        for n in ("q", "k", "v"):
            _lin_sd(sd, f"{b}.self_attn.{n}_proj", getattr(blk.attn, n))
        _lin_sd(sd, f"{b}.self_attn.out_proj", blk.attn.out)
        _lin_sd(sd, f"{b}.mlp.fc1", blk.mlp.fc1)
        _lin_sd(sd, f"{b}.mlp.fc2", blk.mlp.fc2)
    return sd


def ref_dinov2(tower, pos_hub) -> dict:
    """torch.hub dinov2 names of a port DINOv2 ``ViT`` (unfolded), with the
    hub's position table ``pos_hub`` in place of the model's."""
    import torch
    sd = {"cls_token": tower.cls_token, "pos_embed": pos_hub}
    _lin_sd(sd, "patch_embed.proj", tower.patch_embed)
    _lin_sd(sd, "norm", tower.norm)
    for i, blk in enumerate(tower.blocks):
        b, a = f"blocks.{i}", blk.attn
        sd[f"{b}.attn.qkv.weight"] = torch.cat([a.q.weight, a.k.weight, a.v.weight], 0)
        sd[f"{b}.attn.qkv.bias"] = torch.cat([a.q.bias, a.k.bias, a.v.bias])
        _lin_sd(sd, f"{b}.attn.proj", a.out)
        _lin_sd(sd, f"{b}.norm1", blk.norm1)
        _lin_sd(sd, f"{b}.norm2", blk.norm2)
        _lin_sd(sd, f"{b}.mlp.fc1", blk.mlp.fc1)
        _lin_sd(sd, f"{b}.mlp.fc2", blk.mlp.fc2)
        sd[f"{b}.ls1.gamma"] = blk.ls1
        sd[f"{b}.ls2.gamma"] = blk.ls2
    return sd


def ref_llmseg(model) -> dict:
    """LISAForCausalLM's checkpoint names under peft (the DeepSpeed
    ``module``): the LLaMA with LoRA on q/v (``base_layer`` and
    ``lora_A/B.default``), the projector, the text projection and the
    ``lisa_*`` head; the frozen towers are not saved."""
    base = ref_llama(model.llava.llm)
    _lin_sd(base, "model.mm_projector", model.llava.mm_projector)
    s = model.select
    _lin_sd(base, "model.text_hidden_fcs.0.0", s.text_fc1)
    _lin_sd(base, "model.text_hidden_fcs.0.2", s.text_fc2)
    base["model.lisa_dino_conv.weight"] = s.dino_conv.weight[:, :, None, None]
    base["model.lisa_dino_conv.bias"] = s.dino_conv.bias

    def att(ref, m):
        for n in ("q", "k", "v", "out"):
            _lin_sd(base, f"{ref}.{n}_proj", getattr(m, n))

    for i, blk in enumerate(s.blocks):
        b = f"model.lisa_attention_layers.{i}"
        att(f"{b}.self_attn", blk.self_attn)
        att(f"{b}.cross_attn_token_to_image", blk.cross_t2i)
        att(f"{b}.cross_attn_image_to_token", blk.cross_i2t)
        for n in ("norm1", "norm2", "norm3", "norm4"):
            _lin_sd(base, f"{b}.{n}", getattr(blk, n))
        _lin_sd(base, f"{b}.mlp.lin1", blk.mlp.fc1)
        _lin_sd(base, f"{b}.mlp.lin2", blk.mlp.fc2)
    att("model.lisa_final_attn", s.final_attn)
    _lin_sd(base, "model.lisa_norm_final_attn", s.norm_final)
    for j, n in ((0, 0), (2, 1)):
        _lin_sd(base, f"model.lisa_iou_head.{j}", s.iou_head.layers[n])
        _lin_sd(base, f"model.lisa_embedding_head.{j}", s.embedding_head.layers[n])
    sd = {}
    for k, v in base.items():
        if k.startswith("model.layers.") and (".q_proj." in k or ".v_proj." in k):
            k = k.replace("_proj.", "_proj.base_layer.")
        sd["base_model.model." + k] = v
    for i, pairs in enumerate(model.lora.layers):
        for n, pair in pairs.items():
            b = f"base_model.model.model.layers.{i}.self_attn.{n}_proj"
            sd[f"{b}.lora_A.default.weight"] = pair.a.weight
            sd[f"{b}.lora_B.default.weight"] = pair.b.weight
    return sd


def ref_sam(sam) -> dict:
    """build_sam's checkpoint names of a port ``Sam``; the transposed-conv
    taps back to torch's (in, out, kh, kw), unflipped."""
    sd = {}
    e = sam.image_encoder
    _lin_sd(sd, "image_encoder.patch_embed.proj", e.patch_embed)
    sd["image_encoder.pos_embed"] = e.pos_embed
    for i, blk in enumerate(e.blocks):
        b = f"image_encoder.blocks.{i}"
        _lin_sd(sd, f"{b}.norm1", blk.norm1)
        _lin_sd(sd, f"{b}.norm2", blk.norm2)
        _lin_sd(sd, f"{b}.attn.qkv", blk.attn.qkv)
        _lin_sd(sd, f"{b}.attn.proj", blk.attn.proj)
        sd[f"{b}.attn.rel_pos_h"] = blk.attn.rel_pos_h
        sd[f"{b}.attn.rel_pos_w"] = blk.attn.rel_pos_w
        _lin_sd(sd, f"{b}.mlp.lin1", blk.mlp.fc1)
        _lin_sd(sd, f"{b}.mlp.lin2", blk.mlp.fc2)
    for j, n in enumerate(("conv1", "ln1", "conv2", "ln2")):
        _lin_sd(sd, f"image_encoder.neck.{j}", getattr(e.neck, n))
    p = sam.prompt_encoder
    sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = p.pe.gaussian
    for i in range(4):
        sd[f"prompt_encoder.point_embeddings.{i}.weight"] = p.point_embeddings[i:i + 1]
    sd["prompt_encoder.not_a_point_embed.weight"] = p.not_a_point_embed
    sd["prompt_encoder.no_mask_embed.weight"] = p.no_mask_embed
    for j, n in ((0, "conv1"), (1, "ln1"), (3, "conv2"), (4, "ln2"), (6, "conv3")):
        _lin_sd(sd, f"prompt_encoder.mask_downscaling.{j}", getattr(p.mask_downscale, n))
    d, t = sam.mask_decoder, "mask_decoder.transformer"
    sd["mask_decoder.iou_token.weight"] = d.iou_token
    sd["mask_decoder.mask_tokens.weight"] = d.mask_tokens

    def att(ref, m):
        for n in ("q", "k", "v", "out"):
            _lin_sd(sd, f"{ref}.{n}_proj", getattr(m, n))

    for i, layer in enumerate(d.transformer.layers):
        b = f"{t}.layers.{i}"
        att(f"{b}.self_attn", layer.self_attn)
        att(f"{b}.cross_attn_token_to_image", layer.cross_attn_t2i)
        att(f"{b}.cross_attn_image_to_token", layer.cross_attn_i2t)
        for n in ("norm1", "norm2", "norm3", "norm4"):
            _lin_sd(sd, f"{b}.{n}", getattr(layer, n))
        _lin_sd(sd, f"{b}.mlp.lin1", layer.mlp.fc1)
        _lin_sd(sd, f"{b}.mlp.lin2", layer.mlp.fc2)
    att(f"{t}.final_attn_token_to_image", d.transformer.final_attn)
    _lin_sd(sd, f"{t}.norm_final_attn", d.transformer.norm_final)
    for j, n in ((0, "upscale_conv1"), (1, "upscale_ln"), (3, "upscale_conv2")):
        _lin_sd(sd, f"mask_decoder.output_upscaling.{j}", getattr(d, n))
    for j in (0, 3):
        w = sd[f"mask_decoder.output_upscaling.{j}.weight"]
        sd[f"mask_decoder.output_upscaling.{j}.weight"] = w.flip(2, 3).permute(1, 0, 2, 3)
    for i, mlp in enumerate(d.hyper_mlps):
        for j, lin in enumerate(mlp.layers):
            _lin_sd(sd, f"mask_decoder.output_hypernetworks_mlps.{i}.layers.{j}", lin)
    for j, lin in enumerate(d.iou_head.layers):
        _lin_sd(sd, f"mask_decoder.iou_prediction_head.layers.{j}", lin)
    return sd


def host_copy(sd: dict, dtype=None) -> dict:
    """Each tensor as its own compact host tensor (cast to ``dtype`` if
    given), as a checkpoint file holds it."""
    return {k: v.detach().to("cpu", dtype=dtype or v.dtype, copy=True).contiguous()
            for k, v in sd.items()}


def write_checkpoints(root: str, src, sam, pos_hub) -> dict:
    """The reference's checkpoint set, written under ``root``: a DINOv2 hub
    ``.pth`` and a CLIP HF dir in float32 (as published), a LLaVA HF dir in
    bf16 in two ``.bin`` shards with ``pytorch_model.bin.index.json``, an
    LLM-Seg DeepSpeed checkpoint (``ckpt_model/latest`` ->
    ``global_step10/mp_rank_00_model_states.pt``, the state dict under
    ``module``) in bf16, and a SAM ``.pth`` in float32.  Returns each
    component's path."""
    import torch
    f32 = torch.float32
    paths = {"dinov2": os.path.join(root, "dinov2_vitl14.pth"),
             "clip": os.path.join(root, "clip-vit-large-patch14"),
             "llava": os.path.join(root, "llava-7b"),
             "llmseg": os.path.join(root, "ckpt_model"),
             "sam": os.path.join(root, "sam_vit_h.pth")}
    torch.save(host_copy(ref_dinov2(src.dino, pos_hub), f32), paths["dinov2"])
    os.makedirs(paths["clip"])
    torch.save(host_copy(ref_clip(src.llava.vision_tower), f32),
               os.path.join(paths["clip"], "pytorch_model.bin"))
    os.makedirs(paths["llava"])
    llava = ref_llama(src.llava.llm)
    _lin_sd(llava, "model.mm_projector", src.llava.mm_projector)
    names = list(llava)
    shards = [names[:len(names) // 2], names[len(names) // 2:]]
    weight_map = {}
    for i, part in enumerate(shards):
        fname = f"pytorch_model-{i + 1:05d}-of-{len(shards):05d}.bin"
        torch.save(host_copy({k: llava[k] for k in part}), os.path.join(paths["llava"], fname))
        weight_map.update({k: fname for k in part})
    with open(os.path.join(paths["llava"], "pytorch_model.bin.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    step = os.path.join(paths["llmseg"], "global_step10")
    os.makedirs(step)
    torch.save({"module": host_copy(ref_llmseg(src))},
               os.path.join(step, "mp_rank_00_model_states.pt"))
    with open(os.path.join(paths["llmseg"], "latest"), "w") as f:
        f.write("global_step10")
    torch.save(host_copy(ref_sam(sam), f32), paths["sam"])
    return paths


def keys_cubic_f64(pos, src: int, dst: int):
    """``jax.image.resize(method="bicubic")`` of a (1, 1 + src^2, C) table's
    grid, in float64, from the definition: Keys' cubic (a = -0.5) at
    half-pixel sample positions, taps outside the input dropped and the
    rest renormalised, applied along rows then columns."""
    import numpy as np
    s = (np.arange(dst) + 0.5) * src / dst - 0.5
    w = np.zeros((dst, src))
    for o in range(dst):
        for i in range(src):
            x = abs(s[o] - i)
            w[o, i] = (1.5 * x ** 3 - 2.5 * x ** 2 + 1 if x < 1
                       else -0.5 * x ** 3 + 2.5 * x ** 2 - 4 * x + 2 if x < 2 else 0.0)
    w /= w.sum(1, keepdims=True)
    grid = pos[0, 1:].double().cpu().numpy().reshape(src, src, -1)
    out = np.einsum("oh,pw,hwc->opc", w, w, grid)
    return out.reshape(1, dst * dst, -1)


def rss_bytes() -> int:
    """This process's resident set now (``/proc/self/statm``)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def with_peak_rss(fn):
    """Run ``fn`` while a thread samples the resident set every 5 ms;
    returns (fn's result, the peak in GB)."""
    import threading
    peak, stop = [rss_bytes()], threading.Event()

    def watch():
        while not stop.wait(0.005):
            peak[0] = max(peak[0], rss_bytes())

    t = threading.Thread(target=watch, daemon=True)
    t.start()
    try:
        out = fn()
    finally:
        stop.set()
        t.join()
    return out, max(peak[0], rss_bytes()) / 1e9


def dir_bytes(path: str) -> int:
    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(path) for n in ns)


def import_phase(C, llmseg, S, TI, make_batch, *, base=None, sam_cfg=None,
                 hub_grid: int = HUB_GRID, text_len: int = 512, device="cuda") -> dict:
    """Write the reference checkpoint set from seeded weights at llmseg_7b
    width (LLaMA cut to IMPORT_LLAMA_LAYERS layers, the towers whole, LoRA
    on q/v with a nonzero B, sam_vit_h), import each file through the port
    onto the card, and hold every parameter and predict to their source.
    ``base``, ``sam_cfg``, ``hub_grid``, ``text_len`` and ``device`` let a
    CPU test run it small."""
    import gc
    import resource
    import shutil
    import tempfile
    import torch
    bf16 = torch.bfloat16
    base = base or C.llmseg_7b()
    sam_cfg = sam_cfg or C.sam_vit_h()
    cfg = C.replace(base, llava=C.replace(base.llava, llm=C.replace(
        base.llava.llm, num_layers=min(IMPORT_LLAMA_LAYERS, base.llava.llm.num_layers))))
    lora_cfg = C.LoraConfig()
    src = llmseg.init(cfg, seed=21, device=device, dtype=bf16, lora_cfg=lora_cfg)
    g = torch.Generator(device=device).manual_seed(22)
    with torch.no_grad():
        for pairs in src.lora.layers:
            for pair in pairs.values():
                pair.b.weight.normal_(0.0, 0.02, generator=g)
        pos_hub = torch.randn((1, 1 + hub_grid * hub_grid, cfg.dino.hidden_size),
                              generator=g, device=device) * 0.02
        src.dino.pos_embed.copy_(TI.interpolate_pos_embed(pos_hub.cpu(), hub_grid,
                                                          cfg.dino.grid))
    sam_src = S.init(sam_cfg, seed=23, device=device)
    root = tempfile.mkdtemp(prefix="llmseg_ckpt_")
    rec = {"phase": "import", "config": "llmseg_7b", "cut": {
        "llama_layers": f"{cfg.llava.llm.num_layers} of {base.llava.llm.num_layers}",
        "dinov2": "whole", "clip": "whole", "sam": "sam_vit_h whole"},
        "hub_grid": hub_grid, "grid": cfg.dino.grid}
    try:
        t0 = time.time()
        paths = write_checkpoints(root, src, sam_src, pos_hub)
        gc.collect()
        rec["write_s"] = time.time() - t0
        rec["bytes"] = {k: dir_bytes(p) for k, p in paths.items()}
        rec["rss_before_gb"] = rss_bytes() / 1e9
        dst = llmseg.build(cfg, device=device, dtype=bf16, lora_cfg=lora_cfg)
        sam_dst = S.build(sam_cfg, device=device)
        kw = dict(device=device)
        steps = (("dinov2", lambda: TI.load_dinov2_into(dst, paths["dinov2"], **kw)),
                 ("clip", lambda: TI.load_clip_into(dst, paths["clip"], **kw)),
                 ("llava", lambda: TI.load_llava_into(dst, paths["llava"], **kw)),
                 ("llmseg", lambda: TI.load_llmseg_into(dst, paths["llmseg"],
                                                        lora_cfg=lora_cfg, **kw)),
                 ("sam", lambda: TI.load_sam_into(sam_dst, paths["sam"], **kw)))
        rec["seconds"], rec["peak_rss_gb"] = {}, {}
        for name, step in steps:
            gc.collect()
            t0 = time.time()
            _, rec["peak_rss_gb"][name] = with_peak_rss(lambda: (step(), sync(device)))
            rec["seconds"][name] = time.time() - t0
        rec["rss_after_gb"] = rss_bytes() / 1e9
        rec["process_peak_rss_gb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
        ours = TI.interpolate_pos_embed(TI.load_torch_state(paths["dinov2"])["pos_embed"],
                                        hub_grid, cfg.dino.grid)
        rec["pos_max_abs_err"] = float(abs(ours[:, 1:].double().numpy() - keys_cubic_f64(
            pos_hub, hub_grid, cfg.dino.grid)).max())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    src_p, dst_p = dict(src.named_parameters()), dict(dst.named_parameters())
    differ = [n for n in src_p if n not in dst_p or not torch.equal(src_p[n], dst_p[n])]
    sam_p = dict(sam_dst.named_parameters())
    differ += ["sam." + n for n, p in sam_src.named_parameters() if not torch.equal(p, sam_p[n])]
    batch = make_batch(cfg, num_images=4, rows_per_image=1, text_len=text_len, seed=24,
                       dtype=bf16, device=device)
    ref = llmseg.predict(src, batch, lora_cfg=lora_cfg, device=device)
    got = llmseg.predict(dst, batch, lora_cfg=lora_cfg, device=device)
    rec["params"] = len(src_p) + len(sam_p)
    rec["params_differ"] = differ[:5]
    rec["predict_equal"] = all(torch.equal(ref[k], got[k]) for k in ref)
    rec["ok"] = (not differ and len(src_p) == len(dst_p) and rec["predict_equal"]
                 and rec["pos_max_abs_err"] <= POS_LIMIT)
    emit(rec)
    if not rec["ok"]:
        raise SystemExit("the imported checkpoints differ from their source")
    del src, sam_src, ref, got
    torch.cuda.empty_cache()
    return {"model": dst, "sam": sam_dst, "cfg": cfg, "lora_cfg": lora_cfg, "batch": batch}


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def event_ms(fn, runs: int = 5) -> float:
    """Median over ``runs`` calls of one call's time on CUDA events."""
    import torch
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def serve_phase(C, llmseg, Q, A, SV, SX, imported) -> dict:
    """Export predict at batch 4, text_len 512, in bf16 and then in W8A8 on
    the imported model, save both, free the model, load and run them: equal
    to eager predict to the bit, the kernels launched once per op node.
    Then SAM's decoder program at sam_vit_h's decoder width, 64 prompts."""
    import gc
    import shutil
    import tempfile
    import torch
    model, batch, lora_cfg = imported["model"], imported["batch"], imported["lora_cfg"]
    dev = batch["input_ids"].device
    n_layers = model.cfg.llava.llm.num_layers
    shape = dict(num_images=4, rows=4, text_len=batch["input_ids"].shape[1])
    shapes = SV.predict_arg_shapes(model.cfg, **shape)
    served = {k: batch[k] for k in shapes}
    kern = {k.name: k for k in A.KERNELS + Q.KERNELS}
    expect = {"bf16": {"flash_fwd": n_layers, "flash_fwd_1pass": model.cfg.dino.depth},
              "w8a8": {"flash_fwd": n_layers, "flash_fwd_1pass": model.cfg.dino.depth,
                       "quantize_rows": 4 * n_layers, "w8a8_linear": 7 * n_layers}}
    root = tempfile.mkdtemp(prefix="llmseg_serve_")
    rec = {"phase": "serve", "config": "llmseg_7b", "cut": f"LLaMA {n_layers} of 32 layers",
           "dtype": "bfloat16",
           **shape, "lora": True}
    eager, paths = {}, {}
    try:
        for mode in ("bf16", "w8a8"):
            if mode == "w8a8":
                Q.quantize_llama_inplace(model.llava.llm, bits=8, w8a8=True)
            eager[mode] = llmseg.predict(model, batch, lora_cfg=lora_cfg, device=dev)
            rec[f"{mode}_eager_ms"] = event_ms(
                lambda: llmseg.predict(model, batch, lora_cfg=lora_cfg, device=dev))
            t0 = time.time()
            ep = SV.export_predict(model, **shape, lora_cfg=lora_cfg)
            rec[f"{mode}_export_s"] = time.time() - t0
            rec[f"{mode}_op_nodes"] = {
                name: sum(1 for n in ep.graph.nodes if str(n.target) == f"llmseg.{name}.default")
                for name in expect[mode]}
            paths[mode] = os.path.join(root, f"predict_{mode}.pt2")
            t0 = time.time()
            torch.export.save(ep, paths[mode])
            rec[f"{mode}_save_s"] = time.time() - t0
            rec[f"{mode}_bytes"] = os.path.getsize(paths[mode])
            del ep
        del model, imported["model"]
        gc.collect()
        torch.cuda.empty_cache()
        ok = True
        for mode in ("bf16", "w8a8"):
            t0 = time.time()
            fn = SV.load_predict(paths[mode])
            sync(dev)
            rec[f"{mode}_load_s"] = time.time() - t0
            for k in kern.values():
                k.launches = 0
            out = fn(served)
            sync(dev)
            launches = {name: kern[name].launches for name in kern}
            want = dict.fromkeys(kern, 0) | expect[mode]
            rec[f"{mode}_launches"] = launches
            rec[f"{mode}_equal"] = all(torch.equal(out[k], eager[mode][k]) for k in eager[mode])
            rec[f"{mode}_loaded_ms"] = event_ms(lambda: fn(served))
            ok = ok and (launches == want and rec[f"{mode}_equal"]
                         and rec[f"{mode}_op_nodes"] == expect[mode])
            del fn, out
            torch.cuda.empty_cache()
        sam = imported["sam"]
        g = torch.Generator(device=dev).manual_seed(25)
        S_, D = sam.cfg.prompt.image_embedding_size, sam.cfg.prompt.embed_dim
        args = (torch.randn((1, S_, S_, D), generator=g, device=dev),
                torch.rand((SERVE_PROMPTS, 1, 2), generator=g, device=dev)
                * sam.cfg.encoder.img_size,
                torch.ones((SERVE_PROMPTS, 1), dtype=torch.int32, device=dev),
                torch.randn((SERVE_PROMPTS, 4 * S_, 4 * S_, 1), generator=g, device=dev),
                torch.tensor(1.0, device=dev))
        t0 = time.time()
        SX.save_decoder(os.path.join(root, "decoder.pt2"), sam, batch=SERVE_PROMPTS,
                        return_single_mask=True)
        rec["decoder_export_save_s"] = time.time() - t0
        rec["decoder_bytes"] = os.path.getsize(os.path.join(root, "decoder.pt2"))
        dec = SX.load_decoder(os.path.join(root, "decoder.pt2"))
        got = dec(*args)
        with torch.no_grad():
            ref = SX.DecoderProgram(sam, return_single_mask=True)(*args)
        rec["decoder_equal"] = all(torch.equal(a, b) for a, b in zip(got, ref))
        rec["decoder_shapes"] = [list(t.shape) for t in got]
        rec["decoder_ms"] = event_ms(lambda: dec(*args))
        rec["ok"] = ok and rec["decoder_equal"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit(rec)
    if not rec["ok"]:
        raise SystemExit("a loaded program differs from eager predict or missed its kernels")
    return rec


# ---------------------------------------------------------------------------
# data: an LLM-Seg40K-layout corpus through the data layer, the loader and
# the Trainer
# ---------------------------------------------------------------------------

DATA_SHAPES = ((480, 640), (640, 480), (427, 640))   # the corpus's image sizes
DATA_PROPOSALS = 50           # COCO-RLE proposals an image (the readers' top_k)
DATA_TRAIN_IMAGES, DATA_VAL_IMAGES = 6, 7           # 2 questions an image, the last val image 1
DATA_TRAIN_STEPS, DATA_VAL_LIMIT, DATA_VAL_BATCH = 8, 16, 8


def write_llmseg_corpus(root: str, seed: int, shapes=DATA_SHAPES,
                        proposals: int = DATA_PROPOSALS) -> dict:
    """An LLM-Seg40K-layout corpus written from ``seed`` under ``root``:
    ``dataset/llm_seg/{train,validation}.json`` as ``{image: {from_dataset,
    qa_pairs: [{question, answer, rle_seg}]}}``, images named under
    ``dataset/coco/train2017`` and ``dataset/ego_objects/images`` (their
    sizes cycle through ``shapes``; no file is written: ``standin_imread``
    makes them), and ``sam_masks/{llmseg40k_train,llmseg40k_val,
    egoobjects}_masks.json`` with ``proposals`` COCO-RLE masks an image
    (rectangles and discs; the ground truth is the union of one or two of
    them and a blob of its own).  Returns the paths and each image path's
    (h, w)."""
    import numpy as np
    from llmseg_tpu_torch.ops import rle
    rng = np.random.RandomState(seed)
    data, masks_dir = os.path.join(root, "dataset"), os.path.join(root, "sam_masks")
    dirs = {"coco": os.path.join(data, "coco", "train2017"),
            "ego_objects": os.path.join(data, "ego_objects", "images")}
    os.makedirs(os.path.join(data, "llm_seg"))
    os.makedirs(masks_dir)
    mask_docs = {"llmseg40k_train": [], "llmseg40k_val": [], "egoobjects": []}
    shape_of, docs = {}, {"train": {}, "validation": {}}
    n = 0
    for split, count in (("train", DATA_TRAIN_IMAGES), ("validation", DATA_VAL_IMAGES)):
        for i in range(count):
            h, w = shapes[n % len(shapes)]
            src = "coco" if n % 2 == 0 else "ego_objects"
            name = f"{n:012d}.jpg" if src == "coco" else f"ego_{n:06d}.jpg"
            n += 1
            shape_of[os.path.join(dirs[src], name)] = (h, w)
            yy, xx = np.mgrid[:h, :w]
            props, anns = [], []
            for k in range(proposals):
                m = np.zeros((h, w), np.uint8)
                y0, x0 = rng.randint(0, h - 8), rng.randint(0, w - 8)
                if k % 2:
                    r = rng.randint(4, min(h, w) // 3)
                    m[(yy - y0) ** 2 + (xx - x0) ** 2 < r * r] = 1
                else:
                    m[y0:y0 + rng.randint(8, h // 2), x0:x0 + rng.randint(8, w // 2)] = 1
                props.append(m)
                r_, area, bbox = rle.encode_stats(m)
                anns.append({"segmentation": r_, "area": area, "bbox": bbox,
                             "predicted_iou": 0.9, "stability_score": 0.95})
            key = ("egoobjects" if src == "ego_objects" else
                   "llmseg40k_train" if split == "train" else "llmseg40k_val")
            mask_docs[key].append({"image": name, "target_size": [h, w], "masks": anns})
            pairs = []
            for j in range(1 if (split == "validation" and i == count - 1) else 2):
                gt = props[rng.randint(proposals)].copy()
                if j:
                    gt |= props[rng.randint(proposals)]
                y0, x0 = rng.randint(0, h - 40), rng.randint(0, w - 40)
                gt[y0:y0 + 40, x0:x0 + 40] = 1
                pairs.append({"question": f"What in the picture could hold object {n}.{j}?",
                              "answer": "The box over there [SEG].",
                              "rle_seg": rle.encode(gt)})
            docs[split][name] = {"from_dataset": src, "qa_pairs": pairs}
    paths = {"train": os.path.join(data, "llm_seg", "train.json"),
             "val": os.path.join(data, "llm_seg", "validation.json"), **dirs}
    for split, key in (("train", "train"), ("validation", "val")):
        with open(paths[key], "w") as f:
            json.dump(docs[split], f)
    for key, doc in mask_docs.items():
        paths[key] = os.path.join(masks_dir, f"{key}_masks.json")
        with open(paths[key], "w") as f:
            json.dump(doc, f)
    return {"paths": paths, "shapes": shape_of}


def standin_imread(shapes: dict, seed: int):
    """A stand-in for ``datasets._imread_rgb`` (cv2's decode, which the
    card's machine lacks): each path's uint8 RGB image of its size, made
    from ``seed`` and the path; an unknown path raises as a missing file."""
    import zlib

    import numpy as np

    def imread(path: str):
        if path not in shapes:
            raise FileNotFoundError(path)
        h, w = shapes[path]
        rng = np.random.RandomState((seed + zlib.crc32(path.encode())) % 2 ** 32)
        yy, xx = np.mgrid[:h, :w]
        smooth = np.stack([(xx * 255) // w, (yy * 255) // h, ((xx + yy) * 255) // (h + w)], -1)
        return np.clip(smooth + rng.randint(-40, 41, (h, w, 3)), 0, 255).astype(np.uint8)
    return imread


def same_tree(a, b) -> bool:
    """Equal structure and values; numpy arrays and tensors equal in dtype,
    shape and every bit."""
    import numpy as np
    import torch
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    if isinstance(b, torch.Tensor):
        b = b.cpu().numpy()
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and a.tobytes() == b.tobytes())
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same_tree(x, y) for x, y in zip(a, b)))
    return type(a) is type(b) and a == b


class SplitTimer:
    """Wall time spent in named functions, installed as wrappers on module
    attributes for the ``with`` block and put back after it."""

    def __init__(self, targets: dict):
        self.targets, self.seconds, self.saved = targets, {}, []

    def __enter__(self):
        for name, (mod, attr) in self.targets.items():
            raw = vars(mod)[attr]           # a class's staticmethod stays one
            fn = getattr(mod, attr)
            self.saved.append((mod, attr, raw))
            self.seconds[name] = 0.0

            def timed(*a, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    self.seconds[_name] += time.perf_counter() - t0
            setattr(mod, attr, staticmethod(timed) if isinstance(raw, staticmethod) else timed)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self.saved):
            setattr(mod, attr, fn)


def data_phase(C, A, *, base=None, device="cuda", shapes=DATA_SHAPES,
               proposals: int = DATA_PROPOSALS, seed: int = 0) -> dict:
    """The LLM-Seg40K fine-tune path (``cli/finetune.py``'s wiring) on the
    port: a corpus in the reference's layout written from ``seed``
    (``write_llmseg_corpus``), ``datasets._imread_rgb`` stood in for by
    ``standin_imread`` (everything after the decode is the package's code),
    ``ByteTokenizer`` with the model's ``[SEG]`` id and vocab aligned as
    ``cli/common.align_model_to_tokenizer`` does, and ``llmseg_7b`` (or
    ``base``) in bf16 with LoRA r8 on q/v through the ``Trainer``:
    ``BatchLoader(LLMSegDataset, collate, 1, 8 steps, 2 threads, pinned)``
    into ``train_epoch`` (steps_per_epoch 4, grad_accum_steps 2), then
    ``ValLLMSegDataset`` (limit 16, batch 8, the filler rows of the last
    batch marked invalid as ``cli/train.py`` does) into ``validate``.
    Gates: every batch that reaches the device equals, copied back, the
    numpy batch collate gave for it; a one-thread loader equals direct
    ``dataset[i]`` + collate calls in order; the losses are finite and
    every LoRA tensor moved; the val loop's gIoU and cIoU equal the numpy
    compose's on the same scores to the bit (and so do the other selection
    strategies' on those scores); on the card, the launches of
    A, B, C and D a micro-step and of A and B a val batch.  Prints the host
    ms of one ``__getitem__`` by part, collate ms, the loader's wait
    (``data_ms``, ``val_data_ms``) against the step's ms, peak device
    memory, and host RSS before and at its peak.  ``base``, ``device``, ``shapes`` and ``proposals`` let a CPU test
    run it small."""
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch
    from llmseg_tpu_torch.data import collate as collate_lib
    from llmseg_tpu_torch.data import datasets as D
    from llmseg_tpu_torch.data import image_ops, mask_reader
    from llmseg_tpu_torch.data.tokenizer import ByteTokenizer, seg_token_id
    from llmseg_tpu_torch.ops import rle
    from llmseg_tpu_torch.train import evaluate as E
    from llmseg_tpu_torch.train.loader import BatchLoader
    from llmseg_tpu_torch.train.trainer import Trainer

    cuda = torch.device(device).type == "cuda"
    base = base or C.llmseg_7b()
    exp = C.ExperimentConfig(model=base, train=C.TrainConfig(
        warmup_steps=0, steps_per_epoch=DATA_TRAIN_STEPS // 2, grad_accum_steps=2,
        lora=C.LoraConfig(rank=8), log_dir=os.path.join(OUT_DIR, "data_runs")))
    tok = ByteTokenizer(model_max_length=exp.data.model_max_length)
    llm = C.replace(base.llava.llm, vocab_size=max(base.llava.llm.vocab_size, tok.vocab_size))
    cfg = C.replace(base, llava=C.replace(base.llava, llm=llm), seg_token_id=seg_token_id(tok))
    exp = C.replace(exp, model=cfg)
    root = tempfile.mkdtemp(prefix="llmseg40k_")
    saved_imread = D._imread_rgb
    try:
        t0 = time.perf_counter()
        corpus = write_llmseg_corpus(root, seed, shapes, proposals)
        write_s = time.perf_counter() - t0
        p = corpus["paths"]
        D._imread_rgb = standin_imread(corpus["shapes"], seed)
        readers = {k: mask_reader.SamMaskReader(p[k], top_k=DATA_PROPOSALS, verbose=False)
                   for k in ("llmseg40k_train", "llmseg40k_val", "egoobjects")}
        sizes = dict(image_size=exp.data.image_size, clip_size=exp.data.clip_image_size,
                     seg_grid=cfg.seg_grid)
        if not cuda:        # a small run on the CPU: the model's own sizes
            sizes = dict(image_size=cfg.dino.img_size, clip_size=cfg.llava.vision.img_size,
                         seg_grid=cfg.seg_grid)

        def train_ds():
            return D.LLMSegDataset(p["train"], p["coco"], p["ego_objects"],
                                   readers["llmseg40k_train"], readers["egoobjects"],
                                   seed=exp.train.seed, **sizes)

        def collate(rows):
            return lambda samples: collate_lib.collate(
                samples, tok, num_image_tokens=cfg.llava.num_image_tokens,
                rows_per_sample=rows, max_proposals=cfg.max_proposals,
                model_max_length=exp.data.model_max_length)

        # one __getitem__ by part, one thread
        ds = train_ds()
        parts = {"rle_decode": (rle, "decode"),
                 "pad_to_square": (mask_reader.SamMaskReader, "pad_to_square"),
                 "seg_resize": (D, "resize_segs_bilinear"),
                 "iou_iop_labels": (D, "compute_all_iou_iop"),
                 "preprocess_dino": (image_ops, "preprocess_dino"),
                 "preprocess_clip": (image_ops, "preprocess_clip")}
        n_timed = 3
        with SplitTimer(parts) as split:
            t0 = time.perf_counter()
            samples = [ds[i] for i in range(n_timed)]
            getitem_ms = (time.perf_counter() - t0) * 1e3 / n_timed
        split_ms = {k: v * 1e3 / n_timed for k, v in split.seconds.items()}
        t0 = time.perf_counter()
        batch0 = collate(1)(samples[:1])
        collate_ms = (time.perf_counter() - t0) * 1e3
        seg_rows = int((batch0[0]["input_ids"] == cfg.seg_token_id).any(1).sum())

        # gate 2: one thread, the loader's batches are dataset[i] + collate in order
        loader1 = BatchLoader(train_ds(), collate(1), 1, 3, shuffle=True,
                              seed=exp.train.seed, num_threads=1)
        direct_ds = train_ds()
        direct = [collate(1)([direct_ds[i]]) for i in loader1._indices(0)]
        loader_equals_direct = same_tree(list(loader1.epoch(0)), direct)

        def run():
            trainer = Trainer(exp, device=device)
            start = {n: q.detach().clone() for n, q in trainer.trainable.items()
                     if n.startswith("lora.")}
            kept, seen, step_ms, data_ms = [], [], [], []

            def keep(samples):          # the producer thread's collate
                item = collate(1)(samples)
                kept.append({k: v.copy() for k, v in item[0].items()})
                return item

            step = trainer.step

            def timed_step(batch):
                seen.append({k: v.cpu() for k, v in batch.items()})     # waits for the copy
                t0 = time.perf_counter()
                out = step(batch)
                sync(device)
                step_ms.append((time.perf_counter() - t0) * 1e3)
                return out

            def waited(it, into=data_ms):
                """``it``, with the time each item was waited for."""
                while True:
                    t0 = time.perf_counter()
                    try:
                        item = next(it)
                    except StopIteration:
                        return
                    into.append((time.perf_counter() - t0) * 1e3)
                    yield item

            trainer.step = timed_step       # popped below: it holds the trainer in a cycle
            loader = BatchLoader(train_ds(), keep, 1, DATA_TRAIN_STEPS, shuffle=True,
                                 seed=exp.train.seed, num_threads=2, pin_memory=cuda)
            for kern in A.KERNELS:
                kern.launches = 0
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            losses = trainer.train_epoch(waited(loader.epoch(0)), epoch=0)
            sync(device)
            epoch_s = time.perf_counter() - t0
            train_launches = {k.name: k.launches for k in A.KERNELS}
            moved = {n for n, q in start.items() if not torch.equal(trainer.trainable[n], q)}

            # validation: batches of 8, the filler rows of the last one marked invalid
            val_ds = D.ValLLMSegDataset(p["val"], p["coco"], p["ego_objects"],
                                        readers["llmseg40k_val"], readers["egoobjects"],
                                        limit=DATA_VAL_LIMIT, **sizes)
            n_val = len(val_ds)
            steps = -(-n_val // DATA_VAL_BATCH)
            extras_seen, scores = [], []

            def val_batches():
                vl = BatchLoader(val_ds, collate(1), DATA_VAL_BATCH, steps, num_threads=2,
                                 pin_memory=cuda)
                for j, (b, extras) in enumerate(vl.epoch(0)):
                    n_valid = min(DATA_VAL_BATCH, max(n_val - j * DATA_VAL_BATCH, 0))
                    extras["row_valid"] = [True] * n_valid + [False] * (DATA_VAL_BATCH - n_valid)
                    extras_seen.append(extras)
                    yield b, extras

            eval_step = trainer.eval_step

            def kept_eval(model, b):
                out = eval_step(model, b)
                scores.append(out)
                return out

            trainer.eval_step = kept_eval
            for kern in A.KERNELS:
                kern.launches = 0
            val_data_ms = []
            t0 = time.perf_counter()
            res = trainer.validate(waited(val_batches(), val_data_ms))
            val_s = time.perf_counter() - t0
            val_launches = {k.name: k.launches for k in A.KERNELS}
            for name in ("step", "eval_step"):      # the 7B model goes with the trainer
                vars(trainer).pop(name)
            replay = [(i, e) for i, e in enumerate(extras_seen)]
            plain = E.run_validation(lambda m, i: scores[i], None, replay, plain=True)
            # the other strategies on the same scores: the device compose
            # against the numpy one
            by_strategy = {s: (E.run_validation(lambda m, i: scores[i], None, replay, strategy=s),
                               E.run_validation(lambda m, i: scores[i], None, replay, strategy=s,
                                                plain=True))
                           for s in E.SELECTORS if s != "threshold"}
            peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
            arrived = len(seen) == len(kept) == DATA_TRAIN_STEPS and all(
                same_tree({k: v.numpy() for k, v in s.items()}, h) for s, h in zip(seen, kept))
            return dict(losses=losses, epoch_s=epoch_s, step_ms=step_ms, data_ms=data_ms,
                        train_launches=train_launches, val_launches=val_launches,
                        lora_tensors=len(start), lora_moved=len(moved), res=res, plain=plain,
                        by_strategy=by_strategy, n_val=n_val, val_batches=steps, val_s=val_s,
                        val_data_ms=val_data_ms, peak_gb=peak_gb,
                        batches_arrived_intact=arrived, global_step=trainer.global_step)

        rss_before_gb = rss_bytes() / 1e9
        out, peak_rss_gb = with_peak_rss(run)
    finally:
        D._imread_rgb = saved_imread
        shutil.rmtree(root, ignore_errors=True)

    L, depth = cfg.llava.llm.num_layers, cfg.dino.depth
    expect_train = {"flash_fwd": 2 * L, "flash_fwd_1pass": depth, "flash_bwd_dq": L,
                    "flash_bwd_dkv": L, "flash_fwd_1pass_t": 0}
    expect_train = {k: DATA_TRAIN_STEPS * v for k, v in expect_train.items()}
    expect_val = {"flash_fwd": L, "flash_fwd_1pass": depth, "flash_bwd_dq": 0,
                  "flash_bwd_dkv": 0, "flash_fwd_1pass_t": 0}
    expect_val = {k: out["val_batches"] * v for k, v in expect_val.items()}
    if not cuda:
        expect_train = {k: 0 for k in expect_train}
        expect_val = {k: 0 for k in expect_val}
    steady = out["step_ms"][2:] or out["step_ms"]
    rec = {"phase": "data", "config": "llmseg_7b" if base == C.llmseg_7b() else "custom",
           "layout": "LLM-Seg40K (llm_seg/train.json, validation.json; coco/train2017, "
                     "ego_objects/images; sam_masks/*_masks.json)",
           "decode": "stand-in: each image path's uint8 RGB made from the seed "
                     "(standin_imread); the card's machine has no cv2 or PIL to decode a file",
           "image_shapes": [list(s) for s in shapes], "proposals": proposals,
           "corpus_write_s": write_s, "seg_token_id": cfg.seg_token_id,
           "rows_with_seg_token": seg_rows,
           "getitem_ms": getitem_ms, "getitem_ms_by_part": split_ms,
           "getitem_ms_other": getitem_ms - sum(split_ms.values()),
           "collate_ms": collate_ms,
           "train_steps": DATA_TRAIN_STEPS, "grad_accum_steps": 2,
           "global_step": out["global_step"], "epoch_s": out["epoch_s"],
           "step_ms": out["step_ms"], "data_ms": out["data_ms"],
           "step_ms_mean_after_2": sum(steady) / len(steady),
           "data_ms_mean_after_2": (sum(out["data_ms"][2:]) / max(len(out["data_ms"]) - 2, 1)),
           "losses": out["losses"],
           "lora_tensors": out["lora_tensors"], "lora_moved": out["lora_moved"],
           "launches_train": out["train_launches"], "expected_launches_train": expect_train,
           "val_images": out["n_val"], "val_batches": out["val_batches"], "val_s": out["val_s"],
           "val_data_ms": out["val_data_ms"],
           "val": out["res"], "val_plain": out["plain"],
           "val_by_strategy": {k: {"device": d, "plain": q}
                               for k, (d, q) in out["by_strategy"].items()},
           "launches_val": out["val_launches"], "expected_launches_val": expect_val,
           "peak_mem_gb": out["peak_gb"], "host_rss_before_gb": rss_before_gb,
           "peak_host_rss_gb": peak_rss_gb,
           "batches_arrived_intact": out["batches_arrived_intact"],
           "loader_equals_direct_calls": loader_equals_direct}
    if cuda:
        rec["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                      "--format=csv,noheader"], capture_output=True,
                                     text=True).stdout.strip()
    rec["ok"] = (out["batches_arrived_intact"] and loader_equals_direct
                 and all(math.isfinite(v) for v in out["losses"].values())
                 and out["lora_moved"] == out["lora_tensors"] > 0
                 and out["res"] == out["plain"]
                 and all(d == q for d, q in out["by_strategy"].values())
                 and all(math.isfinite(v) for v in out["res"].values())
                 and out["train_launches"] == expect_train and out["val_launches"] == expect_val
                 and out["global_step"] == DATA_TRAIN_STEPS // 2 and seg_rows == 1)
    emit(rec)
    if not rec["ok"]:
        raise SystemExit("the data phase failed")
    return rec


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from llmseg_tpu_torch import config as C
    from llmseg_tpu_torch import serving as SV
    from llmseg_tpu_torch.data.synthetic import make_batch
    from llmseg_tpu_torch.import_weights import torch_import as TI
    from llmseg_tpu_torch.models import generate as GEN
    from llmseg_tpu_torch.models import llmseg
    from llmseg_tpu_torch.models import pixel_decoder as PD
    from llmseg_tpu_torch.models.sam import amg as AMG
    from llmseg_tpu_torch.models.sam import export as SX
    from llmseg_tpu_torch.models.sam import image_encoder as IE
    from llmseg_tpu_torch.models.sam import sam as S
    from llmseg_tpu_torch.ops import attention as A
    from llmseg_tpu_torch.ops import kernels
    from llmseg_tpu_torch.ops import quant as Q
    from llmseg_tpu_torch.ops import relpos_attention as R
    from llmseg_tpu_torch.ops import twoway_kernel as TK
    from llmseg_tpu_torch.train import evaluate as E
    from llmseg_tpu_torch.train import train_step as TS

    all_kernels = A.KERNELS + R.KERNELS + TK.KERNELS + Q.KERNELS
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

    # 2. kernels against their plain versions, at the main paths' shapes
    bf16, f32 = torch.bfloat16, torch.float32
    timed = {}
    main_a = kernel_case(A, "flash_fwd", BH=4 * 32, T=767, S=767, D=128, causal=True,
                         dtype=bf16, timed=True)
    kernel_case(A, "flash_fwd", BH=4 * 32, T=767, S=700, D=128, causal=False, dtype=bf16)
    kernel_case(A, "flash_fwd", BH=2 * 4, T=300, S=300, D=64, causal=True, dtype=bf16,
                bias=True, lse=True)
    kernel_case(A, "flash_fwd", BH=2, T=300, S=300, D=128, causal=True, dtype=f32,
                bias=True, lse=True)
    kernel_case(A, "flash_fwd", BH=2, T=128, S=100, D=64, causal=False, dtype=f32)
    # lengths off the 128-row tiles (1, 65, 129), one head, a bias broadcast
    # over the heads, and no bias with the lse
    kernel_case(A, "flash_fwd", BH=3, T=65, S=129, D=64, causal=False, dtype=bf16, lse=True)
    kernel_case(A, "flash_fwd", BH=2, T=129, S=65, D=128, causal=True, dtype=bf16, lse=True)
    kernel_case(A, "flash_fwd", BH=1, T=1, S=1, D=128, causal=True, dtype=bf16, lse=True)
    kernel_case(A, "flash_fwd", BH=1, T=767, S=767, D=128, causal=True, dtype=bf16)
    kernel_case(A, "flash_fwd", BH=4, T=300, S=200, D=128, causal=False, dtype=bf16,
                bias="broadcast", lse=True)
    kernel_case(A, "flash_fwd", BH=8, T=300, S=300, D=64, causal=True, dtype=bf16, lse=True)
    main_b = kernel_case(A, "flash_fwd_1pass", BH=4 * 16, T=4097, S=4097, D=64,
                         dtype=bf16, timed=True)
    kernel_case(A, "flash_fwd_1pass", BH=16, T=4097, S=4097, D=64, dtype=bf16,
                adversarial=True)
    kernel_case(A, "flash_fwd_1pass", BH=4, T=200, S=300, D=128, dtype=bf16)
    kernel_case(A, "flash_fwd_1pass", BH=2, T=200, S=300, D=64, dtype=f32,
                adversarial=True)
    kernel_case(A, "flash_fwd_1pass", BH=2, T=200, S=300, D=64, dtype=f32)
    # B off its 128-row tiles (1, 65, 129), S != T both ways, one head, D =
    # 128, rescued rows beside rows that are not; then B against J
    kernel_case(A, "flash_fwd_1pass", BH=1, T=1, S=1, D=64, dtype=bf16)
    kernel_case(A, "flash_fwd_1pass", BH=3, T=65, S=129, D=64, dtype=bf16)
    kernel_case(A, "flash_fwd_1pass", BH=2, T=129, S=65, D=128, dtype=bf16)
    kernel_case(A, "flash_fwd_1pass", BH=1, T=4097, S=4097, D=64, dtype=bf16)
    kernel_case(A, "flash_fwd_1pass", BH=4, T=300, S=200, D=128, dtype=bf16,
                adversarial=True, mixed=True)
    onepass_agree(A)
    main_cd = bwd_case(A, BH=32, T=767, S=767, D=128, causal=True, dtype=bf16, timed=True,
                       repeat=True)
    bwd_case(A, BH=8, T=300, S=200, D=64, causal=False, dtype=bf16)
    bwd_case(A, BH=4, T=300, S=300, D=128, causal=True, dtype=f32)
    bwd_case(A, BH=4, T=200, S=130, D=64, causal=False, dtype=f32)
    # lengths off the 128-row blocks and 64-row tiles of C and D (1, 65,
    # 129), S != T both ways, one head, D = 64 at the training length
    for causal, bh, t, s, d in ((True, 2, 1, 1, 128), (False, 3, 65, 65, 64),
                                (True, 2, 129, 129, 128), (False, 3, 65, 129, 64),
                                (False, 2, 129, 65, 128), (True, 2, 65, 129, 128),
                                (True, 3, 129, 65, 64), (True, 8, 767, 767, 64),
                                (True, 1, 767, 767, 128)):
        bwd_case(A, BH=bh, T=t, S=s, D=d, causal=causal, dtype=bf16, repeat=t == 767)
    timed.update({r["kernel"]: r for r in (main_a, main_b)})
    timed.update(main_cd)
    timed.update(sam_kernel_phase(C, R, TK))
    timed.update(pixel_kernel_phase(C, A, TK))
    timed.update(quant_kernel_phase(Q))

    # 3. the port's modules on the card against the CPU, tiny config
    tiny = C.llmseg_tiny()
    m_cpu = llmseg.init(tiny, seed=0, device="cpu")
    m_gpu = llmseg.build(tiny, device="cuda")
    m_gpu.load_state_dict(m_cpu.state_dict())
    b_cpu = make_batch(tiny, num_images=2, rows_per_image=2, text_len=32, seed=1,
                       device="cpu")
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
    emit(grads_in_place(C, llmseg, make_batch, A))
    emit(qlora_in_place(C, llmseg, make_batch, A))
    emit(sam_in_place(C, S, R, TK, IE))
    emit(w8a8_in_place(C, llmseg, make_batch, Q))
    pixel_in_place(C, S, R, TK, IE, PD, GEN, make_batch, A)

    # 4. the main path: llmseg_7b, bf16, batch 4
    cfg = C.llmseg_7b()
    t0 = time.time()
    model = llmseg.init(cfg, seed=0, device="cuda", dtype=bf16)
    llmseg.fold_frozen_inplace(model)
    batch = make_batch(cfg, num_images=4, rows_per_image=1, text_len=512, seed=0)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    for kern in all_kernels:
        kern.launches = 0
    out = llmseg.predict(model, batch)
    torch.cuda.synchronize()
    launches = {kern.name: kern.launches for kern in A.KERNELS}
    expect = {"flash_fwd": cfg.llava.llm.num_layers, "flash_fwd_1pass": cfg.dino.depth,
              "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "flash_fwd_1pass_t": 0}
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
    stage_ms = stage_times(model, batch, step_ms)

    # the same predict with the non-causal forward on kernel J
    A.ONEPASS_T = True
    try:
        for kern in all_kernels:
            kern.launches = 0
        out_t = llmseg.predict(model, batch)
        torch.cuda.synchronize()
        launches_t = {kern.name: kern.launches for kern in A.KERNELS}
        t0 = time.perf_counter()
        for _ in range(steps):
            llmseg.predict(model, batch)
        torch.cuda.synchronize()
        step_ms_t = (time.perf_counter() - t0) * 1e3 / steps
    finally:
        A.ONEPASS_T = False
    expect_t = dict(expect, flash_fwd_1pass=0, flash_fwd_1pass_t=cfg.dino.depth)
    atol, rtol = BF16_TOL
    diff = {k: (out_t[k].float() - out[k].float()).abs() for k in ("pred_similarity", "pred_iou")}
    rec_t = {"phase": "onepass_t", "config": "llmseg_7b", "dtype": "bfloat16", "batch_images": 4,
             "launches": launches_t, "expected_launches": expect_t, "ms_per_step": step_ms_t,
             "ms_per_step_default": step_ms, "atol": atol, "rtol": rtol,
             "max_abs_diff_vs_default": {k: d.max().item() for k, d in diff.items()}}
    rec_t["ok"] = launches_t == expect_t and all(
        bool(torch.isfinite(d).all()) and (d - atol - rtol * out[k].float().abs()).max().item() <= 0
        for k, d in diff.items())
    emit(rec_t)
    if not rec_t["ok"]:
        raise SystemExit("predict through kernel J disagrees with the default run")
    launches["flash_fwd_1pass_t"] = launches_t["flash_fwd_1pass_t"]
    del out, out_t
    torch.cuda.empty_cache()

    # the val loop at batch 8 in bf16, on the same model
    val_data = valloop_data(make_batch, cfg)
    valloop_phase(E, TS, model, val_data, A.KERNELS + Q.KERNELS, "bf16")

    # the W8A8 headline lane on the same model, quantized in place
    w8a8 = w8a8_phase(C, llmseg, make_batch, Q, A, model, batch,
                      {k: rec[k] for k in ("ms_per_step", "img_per_s", "peak_mem_gb")})
    launches.update({k.name: w8a8["launches"][k.name] for k in Q.KERNELS})
    # the val loop in W8A8, on the model the W8A8 phase quantized
    valloop_phase(E, TS, model, val_data, A.KERNELS + Q.KERNELS, "w8a8")
    del model, val_data
    torch.cuda.empty_cache()

    # reference checkpoints into the port, then predict and SAM's decoder as
    # exported programs, saved, loaded and run
    serve_phase(C, llmseg, Q, A, SV, SX, import_phase(C, llmseg, S, TI, make_batch))
    torch.cuda.empty_cache()

    # 5. the LLM-Seg40K fine-tune path from a corpus in the reference's
    # layout: the data layer, the loader, the Trainer and the val loop
    data_phase(C, A)
    torch.cuda.empty_cache()

    # the train step, timed, then profiled; then QLoRA
    train = train_phase(C, make_batch, A)
    launches.update({k: int(train["launches_per_step"][k])
                     for k in ("flash_bwd_dq", "flash_bwd_dkv")})
    qlora_phase(C, make_batch, A)

    # 6. the pixel-decoder entry point, then SAM everything-mode mask
    # generation at sam_vit_h
    pixel = pixel_phase(C, llmseg, S, PD, GEN, make_batch, all_kernels)
    launches.update({k: pixel["launches"][k] for k in ("twoway_decode", "twoway_transformer")})
    amg = amg_phase(C, S, AMG, all_kernels)
    launches.update({k: amg["launches"][k] for k in ("relpos_fwd", "relpos_window",
                                                     "factored_decode")})

    # profiled after every timed phase: an AMG image, a predict step by kernel
    # family, and the library yardstick of kernels C and D
    emit({"phase": "amg_breakdown", "config": "sam_vit_h",
          **device_families(lambda: amg["gen"].generate(amg["images"][2]),
                            "chip_smoke_amg_profile.txt")})
    del amg
    torch.cuda.empty_cache()
    model = llmseg.fold_frozen_inplace(llmseg.init(cfg, seed=0, device="cuda", dtype=bf16))
    emit({"phase": "breakdown", "stage_ms": stage_ms,
          **device_families(lambda: llmseg.predict(model, batch), "chip_smoke_profile.txt")})
    probe = make_batch(cfg, num_images=1, rows_per_image=1, text_len=512, seed=5)
    Q.quantize_llama_inplace(model.llava.llm, bits=8, w8a8=True,
                             smooth_stats=llmseg.calibrate_quant_stats(model, probe),
                             head_dim=cfg.llava.llm.head_dim)
    torch.cuda.empty_cache()
    emit({"phase": "w8a8_breakdown",
          **device_families(lambda: llmseg.predict(model, batch), "chip_smoke_w8a8_profile.txt")})
    del model
    emit({"phase": "pixel_breakdown", "config": "llmseg_7b + sam_vit_h",
          **device_families(pixel["run"], "chip_smoke_pixel_profile.txt",
                            decode_family="kernel_h")})
    del pixel
    torch.cuda.empty_cache()
    dev_cd = bwd_device_times(A, BH=32, T=767, S=767, D=128, causal=True, dtype=bf16)
    emit({"phase": "bwd_device_time", "clock": "device (events behind a spin kernel)", **dev_cd,
          "c_plus_d": dev_cd["flash_bwd_dq"] + dev_cd["flash_bwd_dkv"]})
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        timed[name]["library_ms"] = dev_cd["sdpa_backward"]
        timed[name]["device_ms"] = dev_cd[name]
    dev_fwd = fwd_device_times(A, R)
    emit({"phase": "fwd_device_time", "clock": "device (events behind a spin kernel)", **dev_fwd})
    for name, r in dev_fwd.items():
        timed[name].update(r)

    # 7. summary: A and B launches per predict, J per predict with its flag,
    # C and D per train step, E, F and G per AMG image, H and I per evaluate
    sources = {"flash_fwd": ("llmseg_tpu_torch/csrc/flash_fwd.cu",
                             "llmseg_tpu/ops/attention.py:100"),
               "flash_fwd_1pass": ("llmseg_tpu_torch/csrc/flash_fwd_1pass.cu",
                                   "llmseg_tpu/ops/attention.py:285"),
               "flash_bwd_dq": ("llmseg_tpu_torch/csrc/flash_bwd_dq.cu",
                                "llmseg_tpu/ops/attention.py:458"),
               "flash_bwd_dkv": ("llmseg_tpu_torch/csrc/flash_bwd_dkv.cu",
                                 "llmseg_tpu/ops/attention.py:516"),
               "relpos_fwd": ("llmseg_tpu_torch/csrc/relpos_fwd.cu",
                              "llmseg_tpu/ops/relpos_attention.py:39"),
               "relpos_window": ("llmseg_tpu_torch/csrc/relpos_window.cu",
                                 "llmseg_tpu/ops/relpos_attention.py:88"),
               "factored_decode": ("llmseg_tpu_torch/csrc/factored_decode.cu",
                                   "llmseg_tpu/ops/twoway_kernel.py:709"),
               "twoway_decode": ("llmseg_tpu_torch/csrc/twoway_fused.cu",
                                 "llmseg_tpu/ops/twoway_kernel.py:214"),
               "twoway_transformer": ("llmseg_tpu_torch/csrc/twoway_fused.cu",
                                      "llmseg_tpu/ops/twoway_kernel.py:192"),
               "flash_fwd_1pass_t": ("llmseg_tpu_torch/csrc/flash_fwd_1pass_t.cu",
                                     "llmseg_tpu/ops/attention.py:374"),
               "quantize_rows": ("llmseg_tpu_torch/csrc/quant.cu",
                                 "llmseg_tpu/ops/quant.py:138 quantize_activation (k = 0), "
                                 ":168 rms_quantize_activation (XLA code)"),
               "w8a8_linear": ("llmseg_tpu_torch/csrc/w8a8_gemm.cu",
                               "llmseg_tpu/ops/quant.py:194 qdense_act: the int8 dot and its "
                               "rescale (XLA code)")}
    rows = []
    for name, (src, rep) in sources.items():
        r = timed[name]
        err = r["max_abs_err"]
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                     "launches": launches[name],
                     "max_abs_err": max(err.values()) if isinstance(err, dict) else err,
                     "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                     **{k: r[k] for k in ("device_ms", "library_device_ms", "ex2_bound_ms",
                                          "int_mm_q2_device_ms") if k in r}})
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
