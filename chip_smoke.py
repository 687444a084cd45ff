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
              then Q1's split forms (a) and (b), Q2's int32 output and the
              standalone rescale at llmseg_7b's tp = 2 row split (2048 and
              5504 wide, 4096 out; 3068 and 1534 rows), at tp = 4's blocks
              and off the tiles, to the bit, timed beside their bounds,
              their plain versions and torch's one call where it exists;
     sft_kernels  A (with lse), C and D at the LLaVA SFT step's shape,
              (B*H, T, S, D) = (32, 512, 512, 128) causal bf16, against
              their plain versions, timed beside their bounds, the plain
              versions and SDPA (events and the device clock);
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
              smallest top-1 / top-2 logit gap of the generated steps; then
              with row 0's CLIP image and text in every row, the first
              emitted token declared [SEG] and evaluate on both routes: a
              [SEG] in every row, masks over -1e8 and within MODULE_LIMIT;
     w8a8_in_place  the cut llmseg_7b in float32 with its LLaMA calibrated
              and quantized W8A8: predict through Q1 and Q2, each call
              against its plain version on the same tensors (Q2 to the
              bit), then against
              predict on the plain versions (within half the quantization
              error: codes flip in cascade from an ulp of the scale);
     sft_in_place  LLaVA-7B widths, CLIP 2 blocks, LLaMA 2 layers,
              float32: sft_loss and every trainable gradient through A
              (forward and full-remat recompute), C and D against the plain
              attention path, LoRA r8 and projector-only, within
              GRAD_LIMIT; A 4, C 2, D 2 launches;
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
     cli      the port's command line as a user runs it, one line a run:
              cli.finetune (llmseg_7b, bf16, LoRA r8, 2 steps of 2
              micro-steps, LLMSeg|val at batch 1) on the data phase's
              corpus, cli.validate of that run (its best checkpoint
              resumed) at batch 8 in bf16 and with --load_8bit --w8a8
              --calib_batches 1, cli.prepare at vit_h (random weights,
              filters opened) on three synthetic images at crop layers 0
              and 1 (the decodes stood in for); gates: finite losses,
              every LoRA tensor moved, a best checkpoint, the resumed LoRA
              equal to the saved one, gIoU / cIoU in [0, 1], launches A 64,
              B 24, C 32, D 32 a micro-step, A 32, B 24 (Q1 128, Q2 224) a
              val batch, no torch._int_mm, E 4, F 28, G 16 a frame, the
              masks.json schema read back, each 7B model freed, the peak
              at most the data phase's + 1 GB; seconds and peak memory a
              run, ms/image of prepare;
     sft      LLaVA SFT through cli.sft.main in bf16 on a corpus written
              from a seed (6 image rows, 2 text-only, 2-3 turns; the PIL
              decode stood in for): --lora_enable 4 steps and
              --tune_mm_mlp_adapter --conv_type plain 2 steps at 7b, full
              SFT 2 steps at the size its reckoned peak allows (small);
              one line a run: seconds, ms a step, peak memory, launches of
              A, C, D a step (A 64, C 32, D 32 at 7B), first and last
              ce_loss, frozen checksums unchanged, trainables moved, the
              saved checkpoint read back equal and deleted;
     ddp      the Trainer's data-parallel path (parallel/ddp.py) at world
              size 1, nccl, a TCP store on 127.0.0.1: two steps of the cut
              llmseg_7b (LoRA r8, bf16) equal to the bit, gradients and
              parameters, to the same steps outside a process group;
     mesh_in_place  the (dp, fsdp, tp) mesh (parallel/mesh.py), two ranks
              on this card over gloo (nccl refuses two ranks a device),
              started as subprocesses on a TCP store on 127.0.0.1, each
              printing its own lines: the cut llmseg_7b in float32 (LoRA
              r8, zero-init trainables drawn nonzero, remat "dots"), two
              Trainer steps at tp=2 and at fsdp=2 on global batches of 2
              images against the same steps of one process: loss terms,
              grad_norm, every trainable gradient gathered whole and the
              parameters after within MESH_LIMIT, the ranks' replicated
              parameters equal to the bit, A, C, D at H / tp heads;
     mesh     llmseg_7b in bf16 on the same two ranks: tp=2 at all 32
              layers (predict at batch 4 against one process's within the
              bf16 gate, then two steps of 1 image, both ranks on it) and
              fsdp=2 with LLaMA cut to MESH_FSDP_LAYERS (two steps, 1
              image a rank); then one step with the collectives clocked;
              seconds a step after the first, peak memory and launches a
              rank, the loss gap to one process (finite, within
              MESH_LOSS_GAP); the one-process references run first;
     qmesh_in_place  a quantized LLaMA on the same two ranks, the cut
              llmseg_7b in float32: W8A8 predict at tp=2 equal to one
              process's to the bit, a rank's launches of Q1 (its RMS form,
              forms (a) and (b) at o and down), Q2 (w8a8_linear, its int32
              output at o and down) and the standalone rescale counted;
              QLoRA int8 at tp=2 and int4 at fsdp=2, two steps each within
              MESH_LIMIT of one process (mesh_in_place's gates);
     qmesh    llmseg_7b in bf16: W8A8 predict at tp=2 (32 layers, batch 2)
              folded from a calibration forward on the mesh, ranks equal
              and within the bf16 gate of one process's; a QLoRA int8 step
              at tp=2 (32 layers) and an int4 step at fsdp=2 (LLaMA cut to
              MESH_FSDP_LAYERS): the loss gap within MESH_LOSS_GAP, seconds
              a step, the collectives' share, peak memory a rank;
     mpt      Llava.forward_mpt at llava_tiny + mpt_tiny (ALiBi; MQA with
              qk_ln and clip_qkv) on the card against the CPU, float32,
              within MPT_LIMIT;
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
              SAM encoder, and SAM decode with postprocess; then with row
              0's CLIP image and text in every row, its first emitted token
              declared [SEG] and evaluate run again: each row's mask
              finite, over -1e8, equal to its pre-select mask, the same
              launches, ms beside the run without [SEG];
     amg      sam_vit_h in bf16 (random weights from a seed): generate() on
              three synthetic images with the default AMGConfig, then with
              the filters opened, then with NMS off too; launch counts per
              image (E 4, F 28, G 16), annotation schema, ms/image, peak
              memory and one image in parts;
     amg_crops  the crop cascade with survivors: crop_sam (sam_tiny's
              64-px input at patch 2, a 32 x 32 grid, the least at which a
              frame takes E, F and G; SAM's decoder widths) in float32 from
              seeded weights (seeded_sam, the upscale's taps tied), copied
              to the card; generate() on a 48 x 64 image at crop layers 1
              and 2, min_mask_region_area 0 and 20, against the same
              generator on the CPU: every annotation equal (the scores
              within kernel G's float32 IoU limit), crop masks staged,
              upscaled and deduplicated, full-frame and crop masks among
              the survivors, E 1, F 1, G 4 a frame; cli.prepare over three
              images at crop layers 1 (generators in float32) on the card
              against the CPU, equal; generate in bf16 against the CPU in
              bf16, the median IoU of masks matched by box at least
              CROP_BF16_MEDIAN_IOU;
     rle      AMG finish with NMS off on the amg images, once on the native
              RLE codec (llmseg_tpu_torch/native, built with g++) and once
              on the numpy path: the annotations equal, ms of each;
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

import contextlib
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
# The crop cascade with survivors: a narrow SAM whose frames take E, F and G
# ---------------------------------------------------------------------------

# sam_tiny's 64-pixel input at patch 2: a 32 x 32 grid, the least at which a
# frame's decode takes kernel G (1024 image tokens, twoway_kernel.should_fuse)
# and its global block kernel E (T > 512; the windowed block takes F), with
# SAM's decoder widths (256, 8 heads), which G's bf16 route takes
CROP_SAM = {"encoder": dict(img_size=64, patch_size=2, embed_dim=32, depth=2, num_heads=2,
                            window_size=14, global_attn_indexes=(1,)),
            "prompt": dict(image_embedding_size=32, input_image_size=64)}
CROP_WEIGHTS = dict(seed=5, amp=0.1, tied_upscale=True)    # crop masks survive under these
CROP_CASES = ((1, 0), (2, 0), (1, 20), (2, 20))   # (crop_n_layers, min_mask_region_area)
CROP_AMG = dict(points_per_side=8, points_per_batch=16, pred_iou_thresh=-1e9,
                stability_score_thresh=-1.0, box_nms_thresh=0.95, max_masks=64)
CROP_PREP_SHAPES = ((48, 64), (64, 40), (64, 64))  # prepare's images, none over the input
CROP_BF16_MEDIAN_IOU = 0.5    # bf16, card vs CPU: the median IoU of masks matched by box
CROP_BF16_COUNT = 4           # and the annotation counts' difference


def crop_sam(C):
    """``CROP_SAM`` built from ``C``'s dataclasses: the port's config
    module, or one with classes of the same names and fields."""
    return C.SamConfig(encoder=C.SamEncoderConfig(**CROP_SAM["encoder"]),
                       prompt=C.SamPromptConfig(**CROP_SAM["prompt"]))


def seeded_sam(cfg=None, *, seed: int = 1, amp: float = 0.5, tied_upscale: bool = False):
    """A SAM on the CPU, in float32: ``sam.init(cfg, seed)`` (``sam_tiny`` by
    default) plus seeded noise of ``amp`` on every parameter; weights under
    which AMG's crops of a 48 x 64 image keep masks clear of their inner
    edges (the reference's 20-pixel band), so that the cross-crop dedup has
    work.  ``tied_upscale`` gives each of the mask decoder's two transposed
    convolutions one kernel for all four taps: random taps lay a 4 x 4
    pattern over every low-res mask that outweighs the image's part some
    50 to 1, so at a 32 x 32 grid every mask's box spans its frame."""
    import torch
    from llmseg_tpu_torch import config as C
    from llmseg_tpu_torch.models.sam import sam as S
    m = S.init(cfg or C.sam_tiny(), device="cpu", seed=seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(amp * torch.randn(p.shape, generator=g))
        if tied_upscale:
            for conv in (m.mask_decoder.upscale_conv1, m.mask_decoder.upscale_conv2):
                conv.weight.copy_(conv.weight[..., :1, :1].expand_as(conv.weight))
    return m


def crop_image(hw=(48, 64), seed: int = 1):
    """The seeded uint8 image the crop cascade's tests run on."""
    import numpy as np
    return np.random.RandomState(seed).randint(0, 255, (*hw, 3), np.uint8)


def score_gap(a, b) -> float:
    """The larger of two annotations' score gaps, each of max(1, |b|)."""
    return max(abs(a[k] - b[k]) / max(1.0, abs(b[k]))
               for k in ("predicted_iou", "stability_score"))


def annotation_diffs(got, ref, score_tol: float) -> list:
    """Where two annotation lists differ: their counts, then each key of each
    annotation exactly, but the two scores within ``score_tol`` of
    max(1, |ref|).  Empty when they agree."""
    if len(got) != len(ref):
        return [{"count": [len(got), len(ref)]}]
    out = []
    for i, (a, b) in enumerate(zip(got, ref)):
        for k in sorted(set(a) | set(b)):
            if k in ("predicted_iou", "stability_score"):
                if k not in a or k not in b or abs(a[k] - b[k]) > score_tol * max(1.0, abs(b[k])):
                    out.append({"index": i, "key": k, "got": a.get(k), "ref": b.get(k)})
            elif a.get(k) != b.get(k):
                out.append({"index": i, "key": k})
    return out


def match_by_box(got, ref) -> list:
    """For each annotation of ``got``, the IoU of its mask with that of the
    ``ref`` annotation whose box overlaps its box most, the best mask among
    boxes that overlap it equally (0 when ``ref`` is empty)."""
    import numpy as np
    from llmseg_tpu_torch.ops import rle

    def box_iou(a, b):
        ax, ay, aw, ah = a
        bx, by, bw, bh = b
        iw = max(0.0, min(ax + aw, bx + bw) - max(ax, bx))
        ih = max(0.0, min(ay + ah, by + bh) - max(ay, by))
        inter = iw * ih
        return inter / max(aw * ah + bw * bh - inter, 1e-9)

    def mask_iou(a, b):
        ma, mb = rle.decode(a["segmentation"]), rle.decode(b["segmentation"])
        return float(np.logical_and(ma, mb).sum() / max(np.logical_or(ma, mb).sum(), 1))

    out = []
    for a in got:
        ious = [box_iou(a["bbox"], r["bbox"]) for r in ref]
        best = max(ious, default=None)
        out.append(0.0 if best is None else max(
            mask_iou(a, r) for r, i in zip(ref, ious) if i == best))
    return out


def crop_expected_per_frame(cfg, amg, names, cuda: bool) -> dict:
    """Kernel launches a frame of the crop cascade on this device: E for
    each global block whose T is over kernel F's, F for the others, G for
    each chunk of prompts once the decode takes the fused route."""
    from llmseg_tpu_torch.ops import relpos_attention, twoway_kernel
    enc = cfg.encoder
    g = enc.img_size // enc.patch_size
    glob = len(enc.global_attn_indexes) if g * g > relpos_attention.WINDOW_MAX_T else 0
    chunks = -(-amg.points_per_side ** 2 // amg.points_per_batch)
    fused = twoway_kernel.should_fuse(amg.points_per_batch, g * g, None, "cuda")
    per = {"relpos_fwd": glob, "relpos_window": enc.depth - glob,
           "factored_decode": chunks if fused else 0}
    return {n: (per.get(n, 0) if cuda else 0) for n in names}


def amg_crops_phase(C, S, AMG, CP, kernels_all, *, device="cuda", cfg=None,
                    weights=CROP_WEIGHTS, cases=CROP_CASES) -> dict:
    """AMG's crop cascade with survivors, on the card against the CPU.
    ``crop_sam`` (float32) from ``seeded_sam(**weights)``, copied to the
    card; the same weights stay on the CPU as the reference.  For each
    (crop_n_layers, min_mask_region_area) of ``cases``, ``generate`` on
    ``crop_image()`` (8 x 8 points, 16 a batch, filters opened, box NMS at
    0.95) through the card's submit, prefetch and finish, then the CPU's on
    the same image (its submit shared by the cases of one crop depth, whose
    finish alone differs): every annotation equal (crop_box, bbox, area,
    RLE, point exactly; the scores within kernel G's float32 limit on its
    IoU output, SAM_DECODE_LIMIT["iou"], of max(1, |value|)); the crops'
    survivors staged, upscaled and deduplicated (staged > annotations), the
    full frame and at least one crop among the survivors; E, F and G
    launched on every frame, as many times as ``crop_expected_per_frame``
    says.  Then ``cli.prepare`` (``--crop_n_layers 1``, the same filters)
    over images of CROP_PREP_SHAPES made from a seed (the decode stood in
    for) from a checkpoint of those weights, its generators upcast to
    float32, once with ``--device`` the card and once the CPU: the masks.json
    documents equal, crops and full frames among the survivors.  Then
    ``generate`` at one crop layer in bf16 on the card against the CPU in
    bf16: the median IoU of masks matched by box (both ways) at
    least CROP_BF16_MEDIAN_IOU, the counts within CROP_BF16_COUNT, a
    full-frame mask among the survivors; beside it, the CPU's bf16 run
    against its float32 run (what bf16 alone moves).  One line a run with
    its ms beside the CPU's."""
    import copy
    import shutil
    import tempfile

    import numpy as np
    import torch
    cuda = torch.device(device).type == "cuda"
    cfg = cfg or crop_sam(C)
    ref_model = seeded_sam(cfg, **weights)
    model = copy.deepcopy(ref_model).to(device)
    image = crop_image()
    names = [k.name for k in kernels_all]
    frames = []

    def per_frame(fn):
        def run(self, *a, **kw):
            for k in kernels_all:
                k.launches = 0
            out = fn(self, *a, **kw)
            frames.append({k.name: k.launches for k in kernels_all})
            return out
        return run

    def launches_ok(expect):
        lit = [n for n in ("relpos_fwd", "relpos_window", "factored_decode") if expect[n]]
        return (bool(frames) and all(f == expect for f in frames)
                and (not cuda or len(lit) == 3))

    def survivors(anns, hw):
        full = [0, 0, hw[1], hw[0]]
        boxes = [a["crop_box"] for a in anns]
        return boxes.count(full), sum(b != full for b in boxes)

    t_phase = time.perf_counter()
    # the CPU tests hold the scores of two CPU libraries within 1e-5 of
    # max(1, |value|); the card's float32 decode takes kernel G's limit on
    # its IoU output against the plain version
    tol = SAM_DECODE_LIMIT["iou"]
    records, ref_handles, float32_refs = [], {}, {}
    for layers, area in cases:
        amg = C.AMGConfig(**CROP_AMG, min_mask_region_area=area, crop_n_layers=layers)
        expect = crop_expected_per_frame(cfg, amg, names, cuda)
        gen = AMG.AutomaticMaskGenerator(model, cfg, amg, device=device)
        frames.clear()
        with Wrapped((AMG.AutomaticMaskGenerator, "_submit_one", per_frame)):
            t0 = time.perf_counter()
            handle = gen.prefetch(gen.submit(image))
            anns = gen.finish(handle)
            sync(device)
            ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ref_gen = AMG.AutomaticMaskGenerator(ref_model, cfg, amg, device="cpu")
        if layers not in ref_handles:
            ref_handles[layers] = ref_gen.prefetch(ref_gen.submit(image))
        ref = float32_refs[layers, area] = ref_gen.finish(ref_handles[layers])
        cpu_ms = (time.perf_counter() - t0) * 1e3
        diffs = annotation_diffs(anns, ref, tol)
        staged = sum(n for _, n, _, _, _ in handle["staged"])
        full, from_crops = survivors(anns, image.shape[:2])
        rec = {"phase": "amg_crops", "run": f"generate_layers_{layers}_min_area_{area}",
               "dtype": "float32", "frames": len(handle["crops"]),
               "launches_per_frame": frames[0] if frames else {},
               "expected_launches_per_frame": expect, "launches_ok": launches_ok(expect),
               "staged": staged, "annotations": len(anns), "full_frame": full,
               "from_crops": from_crops, "equal_to_cpu": not diffs, "diffs": diffs[:8],
               "max_score_gap": max(map(score_gap, anns, ref), default=0.0)
               if len(anns) == len(ref) else None, "score_tol": tol,
               "ms": ms, "cpu_ms": cpu_ms}
        if diffs:
            rec["matched_iou_min"] = min(match_by_box(anns, ref) or [0.0])
        rec["ok"] = (rec["equal_to_cpu"] and rec["launches_ok"] and staged > len(anns)
                     and full > 0 and from_crops > 0)
        records.append(rec)

    # cli.prepare over a corpus, from a checkpoint of the same weights
    root = tempfile.mkdtemp(prefix="llmseg_crops_")
    rng = np.random.RandomState(1)
    images = {f"img{i}.jpg": rng.randint(0, 255, (*hw, 3), np.uint8)
              for i, hw in enumerate(CROP_PREP_SHAPES)}
    saved_imread, saved_vit_h = CP._imread_rgb, S.MODEL_REGISTRY["vit_h"]

    def upcast(fn):
        def run(self, model, *a, **kw):
            fn(self, model.float(), *a, **kw)
        return run

    try:
        ckpt = os.path.join(root, "sam.pth")
        torch.save(host_copy(ref_sam(ref_model)), ckpt)
        img_dir = os.path.join(root, "images")
        os.makedirs(img_dir)
        for name in images:
            open(os.path.join(img_dir, name), "wb").close()     # found by the glob
        CP._imread_rgb = lambda path: images[os.path.basename(path)]
        S.MODEL_REGISTRY["vit_h"] = lambda: cfg
        argv = ["--image_dir", img_dir, "--sam_ckpt", ckpt, "--crop_n_layers", "1",
                "--points_per_side", str(CROP_AMG["points_per_side"]),
                "--points_per_batch", str(CROP_AMG["points_per_batch"]),
                "--pred_iou_thresh=-1e9", "--stability_score_thresh=-1",
                "--box_nms_thresh", str(CROP_AMG["box_nms_thresh"])]
        docs, times = {}, {}
        expect = crop_expected_per_frame(cfg, C.AMGConfig(**CROP_AMG, crop_n_layers=1), names,
                                         cuda)
        frames.clear()
        for side, dev in (("card", device), ("cpu", "cpu")):
            out = os.path.join(root, f"masks_{side}.json")
            wraps = [(AMG.AutomaticMaskGenerator, "__init__", upcast)]
            if side == "card":
                wraps.append((AMG.AutomaticMaskGenerator, "_submit_one", per_frame))
            with Wrapped(*wraps):
                t0 = time.perf_counter()
                CP.main(argv + ["--output", out, "--device", dev])
                sync(dev)
                times[side] = (time.perf_counter() - t0) * 1e3
            with open(out) as f:
                docs[side] = json.load(f)
    finally:
        CP._imread_rgb, S.MODEL_REGISTRY["vit_h"] = saved_imread, saved_vit_h
        shutil.rmtree(root, ignore_errors=True)
    got, ref = docs["card"], docs["cpu"]
    diffs = [] if [(d["image"], d["target_size"]) for d in got] == [
        (d["image"], d["target_size"]) for d in ref] else [{"images": "differ"}]
    for g, r in zip(got, ref):
        diffs += [dict(d, image=g["image"]) for d in annotation_diffs(g["masks"], r["masks"], tol)]
    counts = [survivors(d["masks"], d["target_size"]) for d in got]
    rec = {"phase": "amg_crops", "run": "prepare_crop_layers_1", "dtype": "float32",
           "images": [list(hw) for hw in CROP_PREP_SHAPES], "frames": len(frames),
           "launches_per_frame": frames[0] if frames else {},
           "expected_launches_per_frame": expect, "launches_ok": launches_ok(expect),
           "annotations": [len(d["masks"]) for d in got],
           "full_frame": [c[0] for c in counts], "from_crops": [c[1] for c in counts],
           "equal_to_cpu": not diffs, "diffs": diffs[:8],
           "max_score_gap": max((score_gap(a, b) for g, r in zip(got, ref)
                                 if len(g["masks"]) == len(r["masks"])
                                 for a, b in zip(g["masks"], r["masks"])), default=0.0),
           "score_tol": tol, "ms_per_image": times["card"] / len(images),
           "cpu_ms_per_image": times["cpu"] / len(images)}
    rec["ok"] = (rec["equal_to_cpu"] and rec["launches_ok"]
                 and len(frames) == len(images) * 5 and len(got) == len(images)
                 and sum(rec["from_crops"]) > 0 and sum(rec["full_frame"]) > 0)
    records.append(rec)

    amg = C.AMGConfig(**CROP_AMG, crop_n_layers=1)
    m16 = copy.deepcopy(ref_model).bfloat16()
    gen = AMG.AutomaticMaskGenerator(copy.deepcopy(m16).to(device), cfg, amg, device=device)
    t0 = time.perf_counter()
    anns = gen.generate(image)
    sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    ref = AMG.AutomaticMaskGenerator(m16, cfg, amg, device="cpu").generate(image)
    fwd, back = match_by_box(anns, ref), match_by_box(ref, anns)
    full, from_crops = survivors(anns, image.shape[:2])
    f32 = float32_refs.get((1, 0))
    moved = match_by_box(ref, f32) + match_by_box(f32, ref) if f32 is not None else []
    rec = {"phase": "amg_crops", "run": "generate_layers_1_bf16", "dtype": "bfloat16",
           "annotations": len(anns), "cpu_annotations": len(ref), "full_frame": full,
           "from_crops": from_crops, "cpu_from_crops": survivors(ref, image.shape[:2])[1],
           "matched_iou_min": min(fwd + back, default=0.0),
           "matched_iou_median": float(np.median(fwd + back)) if fwd + back else 0.0,
           "equal_to_cpu": not annotation_diffs(anns, ref, tol), "ms": ms,
           "cpu_bf16_vs_float32_matched_iou_median":
               float(np.median(moved)) if moved else None,
           "limits": {"matched_iou_median": CROP_BF16_MEDIAN_IOU,
                      "count": CROP_BF16_COUNT}}
    rec["ok"] = (abs(len(anns) - len(ref)) <= CROP_BF16_COUNT
                 and rec["matched_iou_median"] >= CROP_BF16_MEDIAN_IOU and full > 0)
    records.append(rec)
    for r in records:
        emit(r)
    enc = cfg.encoder
    rec = {"phase": "amg_crops", "run": "all", "seconds": time.perf_counter() - t_phase,
           "config": f"{enc.img_size}-px input at patch {enc.patch_size} "
                     f"({enc.grid} x {enc.grid} grid), encoder {enc.embed_dim} wide, "
                     f"decoder {cfg.decoder.transformer_dim} wide",
           "weights": dict(weights),
           "runs": {r["run"]: r["ok"] for r in records}}
    rec["ok"] = all(r["ok"] for r in records)
    emit(rec)
    if not rec["ok"]:
        raise SystemExit("the amg_crops phase failed")
    return {"records": records, "launches_per_frame": records[0]["launches_per_frame"]}


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


def pixel_images(S, cfg, n: int, seed: int, device="cuda", input_hw=PIXEL_HW["input_hw"]):
    """n seeded uint8 images of ``input_hw`` (768 x 1024), preprocessed for
    the SAM encoder."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(0, 256, (n, *input_hw, 3), device=device, generator=g)
    return S.preprocess(x, cfg)


def first_row_everywhere(inputs: dict) -> dict:
    """``inputs`` with every row's CLIP image and text made row 0's, so that
    every row generates the same tokens (the SAM images stay one a row)."""
    return dict(inputs, **{k: inputs[k][:1].expand_as(inputs[k]).contiguous()
                           for k in ("images_clip", "input_ids")})


def top2_gap(logits) -> float:
    """The smallest gap between the largest and second-largest logit."""
    top = logits.float().topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1]).min().item()


def pixel_in_place(C, S, R, TK, IE, PD, GEN, make_batch, A, *, device="cuda", cfg=None,
                   scfg=None, images: int = PIXEL_IMAGES, hw=PIXEL_HW,
                   text_len: int = 512) -> dict:
    """The pixel decoder at llmseg_7b and sam_vit_h widths, depth cut (two
    LLaMA layers, CLIP 3 blocks, SAM encoder 2 blocks, one global), float32,
    8 images, 8 new tokens: generation (prefill through kernel A), the SAM
    encoder (E, F) and the decode (H, a base per prompt) against the same
    model with every attention on the plain path and the mask decoder's
    plain tail.  Tokens must be equal, hiddens within MODULE_LIMIT of
    max|ref|, masks (before the [SEG] select) and IoU within the decoder
    limits.  The smallest top-1 / top-2 logit gap of the choices made
    (the first token and the 7 after it) is printed beside the largest
    logit error of the steps, which it must exceed.  Then every row takes
    row 0's CLIP image and text (``first_row_everywhere``; random weights
    give the rows no token in common), ``evaluate`` runs once, the first
    token it emitted is declared [SEG] and ``evaluate`` runs again on both
    routes: the same tokens, a [SEG] in every row, every mask
    value over -1e8 and the masks within MODULE_LIMIT of max|ref|.  ``device``, ``cfg``, ``scfg``, ``images``,
    ``hw`` and ``text_len`` let a CPU test run it small (no launches
    there)."""
    import torch
    from llmseg_tpu_torch.models import llama, llmseg, vit
    from llmseg_tpu_torch.models.llava import splice_image_tokens
    cuda = torch.device(device).type == "cuda"
    cfg = cfg or cut_config(C)
    scfg = scfg or cut_sam(C)
    model = llmseg.init(cfg, seed=11, device=device)
    sam_model = S.init(scfg, seed=12, device=device)
    batch = make_batch(cfg, num_images=images, rows_per_image=1, text_len=text_len, seed=6,
                       device=device)
    images_sam = pixel_images(S, scfg, images, seed=7, device=device, input_hw=hw["input_hw"])
    inputs = dict(images_clip=batch["images_clip"], input_ids=batch["input_ids"],
                  image_pos=batch["image_pos"], max_new_tokens=8)
    kernels = A.KERNELS + R.KERNELS + TK.KERNELS
    base_cfg, seg_cfg = model.cfg, model.cfg

    def path():
        tokens, hiddens = PD.generate_answer(model, **inputs)
        prompts, _ = PD.seg_prompts(model, tokens, hiddens)
        return tokens, hiddens, PD.decode_seg_masks(sam_model, images_sam, prompts, **hw)

    same = first_row_everywhere(inputs)

    def planted():
        model.cfg = seg_cfg
        try:
            return PD.evaluate(model, sam_model, images_sam=images_sam, device=device,
                               **same, **hw)
        finally:
            model.cfg = base_cfg

    def counted(fn):
        for kern in kernels:
            kern.launches = 0
        out = fn()
        return out, {kern.name: kern.launches for kern in kernels if kern.launches}

    (tok_k, hid_k, (mask_k, iou_k)), launches = counted(path)
    tok_same = planted()[0]
    seg = int(tok_same[0, 0])
    seg_cfg = C.replace(base_cfg, seg_token_id=seg)
    (seg_tok_k, seg_masks_k), seg_launches = counted(planted)

    def plain_relpos(q, k, v, rel_h, rel_w, grid, scale=None):
        bias = R.decomposed_rel_pos_bias(q.transpose(1, 2), rel_h, rel_w, grid)
        return A.attention_plain(q, k, v, bias=bias, scale=scale)

    def plain_decode(sam_model_, images, prompts, input_hw, original_hw):
        emb = S.encode_image(sam_model_, images)
        pe_mod = sam_model_.prompt_encoder
        sparse, dense = pe_mod(text_embeds=prompts[:, None, :], batch=emb.shape[0])
        m, i = sam_model_.mask_decoder(emb, pe_mod.dense_pe(emb.shape[1])[None], sparse, dense,
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
        seg_tok_p, seg_masks_p = planted()
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
           "images": images, "new_tokens": 8, "launches": launches,
           "tokens_equal": bool(torch.equal(tok_k, tok_p)),
           "hidden_err_vs_max_ref": rel(hid_k, hid_p),
           "masks_err_vs_max_ref": rel(mask_k, mask_p), "iou_err_vs_max_ref": rel(iou_k, iou_p),
           "min_top2_logit_gap": min(gaps),
           "max_logit_err": (lg_k - lg_p).abs().max().item(),
           "limits": {"hidden": MODULE_LIMIT, **SAM_DECODE_LIMIT}}
    expect = {"flash_fwd": 2, "relpos_fwd": 1, "relpos_window": 1, "twoway_decode": 1} \
        if cuda else {}
    rec["expected_launches"] = expect
    rec["ok"] = (rec["tokens_equal"] and launches == expect
                 and rec["hidden_err_vs_max_ref"] <= MODULE_LIMIT
                 and rec["masks_err_vs_max_ref"] <= SAM_DECODE_LIMIT["masks"]
                 and rec["iou_err_vs_max_ref"] <= SAM_DECODE_LIMIT["iou"]
                 and rec["min_top2_logit_gap"] > rec["max_logit_err"])
    emit(rec)
    has_seg = (seg_tok_k == seg).any(1)
    rec_seg = {"phase": "pixel_in_place", "run": "planted_seg", "seg_token_id": seg,
               "rows_with_seg": int(has_seg.sum()), "rows": images, "launches": seg_launches,
               "expected_launches": expect,
               "tokens_equal": bool(torch.equal(seg_tok_k, seg_tok_p)
                                    and torch.equal(seg_tok_k, tok_same)),
               "mask_min": seg_masks_k.float().min().item(),
               "finite": bool(torch.isfinite(seg_masks_k).all()),
               "masks_err_vs_max_ref": rel(seg_masks_k, seg_masks_p), "limit": MODULE_LIMIT}
    rec_seg["ok"] = (bool(has_seg.all()) and seg_launches == expect
                     and rec_seg["tokens_equal"] and rec_seg["finite"]
                     and rec_seg["mask_min"] > -1e8
                     and rec_seg["masks_err_vs_max_ref"] <= MODULE_LIMIT)
    emit(rec_seg)
    del model, sam_model
    if cuda:
        torch.cuda.empty_cache()
    if not (rec["ok"] and rec_seg["ok"]):
        raise SystemExit(f"the pixel path through the kernels disagrees with the plain path: "
                         f"{rec} {rec_seg}")
    return {"pixel_in_place": rec, "planted_seg": rec_seg}


def pixel_phase(C, llmseg, S, PD, GEN, make_batch, kernels_all) -> dict:
    """The pixel-decoder entry point, ``evaluate``, at llmseg_7b + sam_vit_h
    in bf16 (random weights from seeds), 8 images, text_len 512 (767-token
    prompts), 32 new tokens.  With random weights the model almost never
    emits [SEG], so evaluate's masks are -1e9 and the masks before that
    select are checked too.  1 warm-up, the launch counts of one run, then
    3 timed; peak memory of those; the split of one evaluate, each part
    timed alone with CUDA events (the decode steps, the SAM decode and the
    rest by difference).  Then every row takes row 0's CLIP image and text
    (``first_row_everywhere``: random weights give the rows no token in
    common), evaluate runs once, its first emitted token is declared [SEG]
    and evaluate runs again, counted once and timed 3 times:
    the same tokens, a [SEG] in every row, every row's mask finite, over
    -1e8 and equal to the same run's mask before the select, the same
    launches."""
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

    # every row with row 0's CLIP image and text (the SAM images stay one a
    # row), the first token emitted declared [SEG], evaluate again: the select keeps every row's mask; the mask before the select
    # is taken from the same run
    same = first_row_everywhere(inputs)
    run_same = lambda: PD.evaluate(model, sam_model, images_sam=images_sam,
                                   max_new_tokens=new, **same, **PIXEL_HW)
    tokens_same = run_same()[0]
    seg = int(tokens_same[0, 0])
    base_cfg, pre = model.cfg, []

    def keep(fn):
        def decode(*a, **kw):
            out = fn(*a, **kw)
            pre.append(out[0])
            return out
        return decode

    model.cfg = C.replace(base_cfg, seg_token_id=seg)
    try:
        for kern in kernels_all:
            kern.launches = 0
        with Wrapped((PD, "decode_seg_masks", keep)):
            seg_tokens, seg_masks = run_same()
        torch.cuda.synchronize()
        seg_launches = {kern.name: kern.launches for kern in kernels_all}
        t0 = time.perf_counter()
        for _ in range(steps):
            run_same()
        torch.cuda.synchronize()
        seg_ms = (time.perf_counter() - t0) * 1e3 / steps
    finally:
        model.cfg = base_cfg
    has_seg = (seg_tokens == seg).any(1)
    rec_seg = {"phase": "pixel", "run": "planted_seg", "config": "llmseg_7b + sam_vit_h",
               "dtype": "bfloat16", "inputs": "row 0's CLIP image and text in every row",
               "seg_token_id": seg, "rows_with_seg": int(has_seg.sum()),
               "images": PIXEL_IMAGES, "launches": seg_launches, "expected_launches": expect,
               "tokens_repeat": bool(torch.equal(seg_tokens, tokens_same)),
               "finite": bool(torch.isfinite(seg_masks).all()),
               "mask_range": [seg_masks.float().min().item(), seg_masks.float().max().item()],
               "equal_to_preselect": bool(torch.equal(seg_masks, pre[0][:, 0])),
               "ms_per_evaluate": seg_ms, "ms_per_evaluate_no_seg": ms}
    rec_seg["ok"] = (bool(has_seg.all()) and seg_launches == expect
                     and rec_seg["tokens_repeat"] and rec_seg["finite"]
                     and rec_seg["mask_range"][0] > -1e8 and rec_seg["equal_to_preselect"])
    emit(rec_seg)
    if not (rec["ok"] and rec_seg["ok"]):
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


def split_forms_case(Q, *, R, C, dtype, timed=False, seed=0) -> dict:
    """Q1's split forms of a mesh's row split against their plain versions,
    to the bit: (a) the rows' max |x|; (b) the int8 values for a row scale
    taken over a wider row (x and another block, as the MAX over tp gives
    it), with exact ties.  Timed: each form's event and device clocks, its
    plain version, its bound (bytes), and for (a) the one PyTorch call of
    the same function (``torch.linalg.vector_norm`` of order inf)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed + R + C)
    x = torch.randn(R, C, device="cuda", generator=g) * 3
    x[0, :4] = torch.tensor([127.0, 2.5, -3.5, 0.5])
    x = x.to(dtype)
    other = (torch.randn(R, C, device="cuda", generator=g) * 4).to(dtype)
    amax = Q.row_absmax(x)
    sc = Q._div(torch.maximum(amax, Q.row_absmax_plain(other)).clamp_min(1e-6), 127.0)
    sc[0] = 1.0
    xq = Q.quantize_rows_scaled(x, sc)
    torch.cuda.synchronize()
    recs = {}
    for name, got, ref in (("row_absmax", amax, Q.row_absmax_plain(x)),
                           ("quantize_rows_scaled", xq, Q.quantize_rows_scaled_plain(x, sc))):
        rec = {"kernel": name, "R": R, "C": C, "dtype": str(dtype).split(".")[-1],
               "max_abs_err": (got.double() - ref.double()).abs().max().item(),
               "bitwise": bool(torch.equal(got, ref))}
        rec["ok"] = rec["bitwise"]
        recs[name] = rec
    if timed:
        e = x.element_size()
        a, b = recs["row_absmax"], recs["quantize_rows_scaled"]
        run_a = lambda: Q.row_absmax(x)                                   # noqa: E731
        run_b = lambda: Q.quantize_rows_scaled(x, sc)                     # noqa: E731
        lib_a = lambda: torch.linalg.vector_norm(x, float("inf"), dim=-1,  # noqa: E731
                                                 keepdim=True, dtype=torch.float32)
        a.update(ms=cuda_ms(run_a, 20), device_ms=device_ms(run_a, 20),
                 plain_ms=cuda_ms(lambda: Q.row_absmax_plain(x), 5),
                 library_ms=cuda_ms(lib_a, 20), library_device_ms=device_ms(lib_a, 20))
        a["bound_ms"], a["bound_by"] = bound(R * C * e + R * 4, 0)
        b.update(ms=cuda_ms(run_b, 20), device_ms=device_ms(run_b, 20),
                 plain_ms=cuda_ms(lambda: Q.quantize_rows_scaled_plain(x, sc), 5),
                 library_ms=None)
        b["bound_ms"], b["bound_by"] = bound(R * C * (e + 1) + R * 4, 0)
    for rec in recs.values():
        emit(rec)
        if not rec["ok"]:
            raise SystemExit(f"Q1's split form disagrees with its plain version: {rec}")
    return recs


def int32_case(Q, *, R, K, N, timed=False, seed=0) -> dict:
    """Q2's int32 output against the exact int8 product, to the bit; timed:
    beside ``torch._int_mm`` (the library call), its bound (int8
    operations at the card's peak, or the operands' and output's bytes)."""
    import torch
    xq, _, w, *_ = w8a8_inputs(R, K, N, torch.float32, None, seed)
    got = Q.w8a8_int_mm(xq, w)
    ref = Q._int_mm(xq, w)
    torch.cuda.synchronize()
    rec = {"kernel": "w8a8_int32", "R": R, "K": K, "N": N,
           "max_abs_err": (got.double() - ref.double()).abs().max().item(),
           "bitwise": bool(torch.equal(got, ref))}
    rec["ok"] = rec["bitwise"]
    if timed:
        wt = w.t()
        run = lambda: Q.w8a8_int_mm(xq, w)                              # noqa: E731
        lib = lambda: torch._int_mm(xq, wt)                             # noqa: E731
        rec.update(ms=cuda_ms(run, 20), device_ms=device_ms(run, 20),
                   library_ms=cuda_ms(lib, 20), library_device_ms=device_ms(lib, 20),
                   plain_ms=cuda_ms(lambda: Q._int_mm(xq, w), 5))
        rec["bound_ms"], rec["bound_by"] = bound(R * K + N * K + 4 * R * N, 2 * R * K * N,
                                                 INT8_OPS_PER_S)
    emit(rec)
    if not rec["ok"]:
        raise SystemExit(f"Q2's int32 output disagrees with the exact product: {rec}")
    return rec


def epilogue_timed(Q, *, R, N, out_dtype) -> dict:
    """The standalone rescale on the row split's path (after the int32 sum
    over tp): its values against its plain version (ulps, and whether every
    bit agrees), its clocks, its plain version's, its bound (bytes)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(R + N)
    acc = torch.randint(-2 ** 24, 2 ** 24, (R, N), device="cuda", generator=g, dtype=torch.int32)
    sc = torch.rand(R, 1, device="cuda", generator=g) * 1e-3
    ws = torch.rand(N, device="cuda", generator=g) * 1e-2
    got = Q.w8a8_epilogue(acc, sc, ws, None, out_dtype)
    ref = Q.w8a8_epilogue_plain(acc, sc, ws, None, out_dtype)
    torch.cuda.synchronize()
    run = lambda: Q.w8a8_epilogue(acc, sc, ws, None, out_dtype)          # noqa: E731
    rec = {"kernel": "w8a8_epilogue", "R": R, "N": N, "out_dtype": str(out_dtype).split(".")[-1],
           "max_abs_err": (got.float() - ref.float()).abs().max().item(),
           "max_ulps": ulps(got, ref).max().item(), "bitwise": same_bits(got, ref),
           "ms": cuda_ms(run, 20), "device_ms": device_ms(run, 20),
           "plain_ms": cuda_ms(lambda: Q.w8a8_epilogue_plain(acc, sc, ws, None, out_dtype), 5),
           "library_ms": None}
    rec["bound_ms"], rec["bound_by"] = bound(R * N * (4 + got.element_size()) + 4 * (R + N), 0)
    rec["ok"] = rec["max_ulps"] <= Q2_ULPS
    emit(rec)
    if not rec["ok"]:
        raise SystemExit(f"the standalone rescale disagrees with its plain version: {rec}")
    return rec


def mesh_quant_kernel_phase(Q) -> dict:
    """Q1's split forms, Q2's int32 output and the standalone rescale at
    llmseg_7b's tp = 2 row split (o's input 2048 wide, down's 5504, their
    4096 outputs) at batch 4 (3068 rows; timed) and batch 2 (1534, the
    qmesh phase's), at tp = 4's blocks (1024, 2752: a partial 256-column
    tile of Q2) and off the tiles (1, 17 rows; 100 wide: Q1's scalar path),
    in bf16 and float32."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    r4, r2 = 4 * SEQ_7B, 2 * SEQ_7B
    forms = split_forms_case(Q, R=r4, C=5504, dtype=bf16, timed=True)
    for r, c in ((r4, 2048), (r2, 2048), (r2, 5504), (17, 2752), (1, 1024), (5, 100)):
        split_forms_case(Q, R=r, C=c, dtype=bf16)
    split_forms_case(Q, R=129, C=2048, dtype=f32)
    i32 = int32_case(Q, R=r4, K=5504, N=4096, timed=True)
    for r, k, n in ((r4, 2048, 4096), (r2, 5504, 4096), (r2, 4096, 2752), (17, 2752, 4096),
                    (1, 4096, 5504), (129, 64, 128)):
        int32_case(Q, R=r, K=k, N=n)
    epi = epilogue_timed(Q, R=r4, N=4096, out_dtype=bf16)
    epilogue_timed(Q, R=r2, N=4096, out_dtype=f32)
    return {**forms, "w8a8_int32": i32, "w8a8_epilogue": epi}


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


class Wrapped:
    """``owner.attr`` replaced for the ``with`` block by ``around(original)``
    (a class's staticmethod stays one) and put back after it, for each
    ``(owner, attr, around)``."""

    def __init__(self, *targets):
        self.targets, self.saved = targets, []

    def __enter__(self):
        for owner, attr, around in self.targets:
            raw = vars(owner)[attr]
            self.saved.append((owner, attr, raw))
            fn = around(getattr(owner, attr))
            setattr(owner, attr, staticmethod(fn) if isinstance(raw, staticmethod) else fn)
        return self

    def __exit__(self, *exc):
        for owner, attr, raw in reversed(self.saved):
            setattr(owner, attr, raw)


class SplitTimer(Wrapped):
    """Wall time spent in named functions (``{name: (owner, attr)}``),
    summed in ``seconds`` while the ``with`` block runs."""

    def __init__(self, targets: dict):
        self.seconds = {name: 0.0 for name in targets}

        def timer(name):
            def around(fn):
                def timed(*a, **kw):
                    t0 = time.perf_counter()
                    try:
                        return fn(*a, **kw)
                    finally:
                        self.seconds[name] += time.perf_counter() - t0
                return timed
            return around

        super().__init__(*((owner, attr, timer(name))
                           for name, (owner, attr) in targets.items()))


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


# ---------------------------------------------------------------------------
# cli: the port's command line (llmseg_tpu_torch.cli) driven as a user runs it
# ---------------------------------------------------------------------------

CLI_STEPS, CLI_ACCUM, CLI_VAL_BATCH = 2, 2, 8


def cli_phase(C, kernels_all, *, data_peak_gb=None, device="cuda", model_size="7b",
              extra_argv=(), shapes=DATA_SHAPES, proposals=DATA_PROPOSALS, prep_images=None,
              points_per_side=32, seed=0) -> list:
    """The port's entry points as a user calls them, each through its
    ``main(argv)``: ``cli.finetune`` (``llmseg_7b``, bf16, LoRA r8, 2 steps
    of 2 micro-steps, one epoch, ``LLMSeg|val`` at batch 1 on the corpus's
    13 val questions) on ``write_llmseg_corpus``'s corpus, then
    ``cli.validate`` of the same run (its best checkpoint auto-resumed) at
    batch 8, in bf16 and with ``--load_8bit --w8a8 --calib_batches 1``, then
    ``cli.prepare`` at ``vit_h`` (random weights: no checkpoint) over three
    seeded images no larger than the SAM input, the filters opened, at
    ``--crop_n_layers`` 0 and 1.  The image decodes are stood in for
    (``standin_imread`` for the datasets, ``amg_images()`` for prepare's
    files): the card's machine has no cv2 or PIL; everything after the
    decode is the CLI's own code.  Gates: finite losses, every LoRA tensor
    moved, a best checkpoint written; the resumed LoRA equal to the saved
    one to the bit; gIoU and cIoU in [0, 1]; the launches of A, B, C, D a
    micro-step and of A, B, Q1, Q2 a val batch, no ``torch._int_mm``; E, F
    and G a frame; at least one annotation an image, the reference schema,
    crop boxes inside the image, masks.json read back by the port's
    ``SamMaskReader``; each 7B model freed before the next is built (device
    memory back to where the phase began) and the phase's peak at most the
    data phase's plus 1 GB.  One line a sub-run with its seconds and peak
    device memory.  ``device``, ``model_size``, ``extra_argv``, ``shapes``,
    ``proposals``, ``prep_images`` and ``points_per_side`` let a CPU test
    run it small."""
    import gc
    import shutil
    import tempfile

    import numpy as np
    import torch
    from llmseg_tpu_torch.cli import common as CC
    from llmseg_tpu_torch.cli import finetune as CF
    from llmseg_tpu_torch.cli import prepare as CP
    from llmseg_tpu_torch.cli import validate as CV
    from llmseg_tpu_torch.data import datasets as D
    from llmseg_tpu_torch.data.mask_reader import SamMaskReader
    from llmseg_tpu_torch.models.sam import amg as AMG
    from llmseg_tpu_torch.train.trainer import Trainer

    cuda = torch.device(device).type == "cuda"
    cfg = {"7b": C.llmseg_7b, "tiny": C.llmseg_tiny}[model_size]()
    L, depth = cfg.llava.llm.num_layers, cfg.dino.depth
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip() if cuda else None
    names = [k.name for k in kernels_all]

    def expect(**per):
        return {n: (per.get(n, 0) if cuda else 0) for n in names}

    def counts():
        return {k.name: k.launches for k in kernels_all}

    def zero():
        for k in kernels_all:
            k.launches = 0

    def mem():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            return torch.cuda.memory_allocated() / 1e9
        return None

    seen = {}        # what the wrappers saw, by run

    def lora(trainer):
        return {n: p.detach().cpu().clone() for n, p in trainer.trainable.items()
                if n.startswith("lora.")}

    def counted(tag):
        """Trainer.train_epoch / validate with the launches of their own
        run, counted from zero, and their result."""
        def around(fn):
            def run(self, *a, **kw):
                zero()
                out = fn(self, *a, **kw)
                sync(self.device)
                seen.setdefault(tag, []).append({"out": out, "launches": counts()})
                return out
            return run
        return around

    def first_weights(fn):
        def run(*a, **kw):
            model = fn(*a, **kw)
            seen["initial_lora"] = {n: p.detach().cpu().clone() for n, p in
                                    model.named_parameters() if n.startswith("lora.")}
            return model
        return run

    def kept_best(fn):
        def run(self, metrics):
            saved = fn(self, metrics)
            if saved:
                seen["saved_lora"] = lora(self)
            return saved
        return run

    def resumed(fn):
        def run(self, *a, **kw):
            out = fn(self, *a, **kw)
            if out:
                seen.setdefault("resumed_lora", []).append(lora(self))
            return out
        return run

    def sub_run(name, fn):
        """fn() with its seconds, peak device memory and what stays
        allocated after it; also the clock at its end."""
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        end = time.perf_counter()
        rec = {"phase": "cli", "run": name, "seconds": end - t0,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None}
        rec["allocated_after_gb"] = mem()
        return rec, out, end

    root = tempfile.mkdtemp(prefix="llmseg_cli_")
    saved_imread, saved_prep_imread = D._imread_rgb, CP._imread_rgb
    records = []
    base_gb = mem()
    t_phase = time.perf_counter()
    try:
        corpus = write_llmseg_corpus(root, seed, shapes, proposals)
        D._imread_rgb = standin_imread(corpus["shapes"], seed)
        base = ["--model_size", model_size, "--precision", "bf16", "--lora_r", "8",
                "--dataset_dir", os.path.join(root, "dataset"),
                "--sam_masks_dir", os.path.join(root, "sam_masks"),
                "--log_base_dir", os.path.join(root, "runs"), "--exp_name", "cli",
                "--device", device, *extra_argv]
        run_dir = os.path.join(root, "runs", "cli")
        wraps = Wrapped((Trainer, "train_epoch", counted("train")),
                        (Trainer, "validate", counted("val")),
                        (Trainer, "save_best", kept_best),
                        (Trainer, "maybe_resume", resumed),
                        (CC, "import_initial_params", first_weights))

        # 1. finetune
        argv = base + ["--steps_per_epoch", str(CLI_STEPS), "--grad_accumulation_steps",
                       str(CLI_ACCUM), "--epochs", "1", "--warmup_steps", "0"]
        with wraps:
            rec, _, _ = sub_run("finetune", lambda: CF.main(argv))
        (train,), (val,) = seen.pop("train"), seen.pop("val")
        micro = CLI_STEPS * CLI_ACCUM
        n_val = len(D.ValLLMSegDataset(corpus["paths"]["val"], corpus["paths"]["coco"],
                                       corpus["paths"]["ego_objects"],
                                       SamMaskReader(corpus["paths"]["llmseg40k_val"],
                                                     verbose=False),
                                       SamMaskReader(corpus["paths"]["egoobjects"],
                                                     verbose=False)))
        init, saved = seen.pop("initial_lora"), seen.get("saved_lora", {})
        rec.update({
            "argv": argv, "losses": train["out"], "val": val["out"], "val_images": n_val,
            "lora_tensors": len(init),
            "lora_moved": sum(not torch.equal(init[n], saved[n]) for n in saved),
            "lora_unmoved": [n for n in saved if torch.equal(init[n], saved[n])],
            "best_written": os.path.isfile(os.path.join(run_dir, "best_meta.json")),
            "launches_train": train["launches"],
            "expected_launches_train": expect(flash_fwd=micro * 2 * L,
                                              flash_fwd_1pass=micro * depth,
                                              flash_bwd_dq=micro * L, flash_bwd_dkv=micro * L),
            "launches_val": val["launches"],
            "expected_launches_val": expect(flash_fwd=n_val * L, flash_fwd_1pass=n_val * depth)})
        rec["ok"] = (all(math.isfinite(v) for v in train["out"].values())
                     and "resumed_lora" not in seen
                     and rec["lora_moved"] == rec["lora_tensors"] > 0 and rec["best_written"]
                     and rec["launches_train"] == rec["expected_launches_train"]
                     and rec["launches_val"] == rec["expected_launches_val"])
        records.append(rec)

        # 2. validate, bf16 then W8A8, each resuming the run's best checkpoint
        batches = -(-n_val // CLI_VAL_BATCH)
        for name, flags, q in (("validate", [], False),
                               ("validate_w8a8", ["--load_8bit", "--w8a8", "--calib_batches",
                                                  "1"], True)):
            argv = base + ["--val_dataset", "LLMSeg|val", "--val_batch_size",
                           str(CLI_VAL_BATCH)] + flags
            int_mm, kept_int_mm = [], torch._int_mm
            torch._int_mm = lambda *a: int_mm.append(a) or kept_int_mm(*a)
            try:
                with wraps:
                    rec, res, _ = sub_run(name, lambda: CV.main(argv))
            finally:
                torch._int_mm = kept_int_mm
            (val,), (got_lora,) = seen.pop("val"), seen.pop("resumed_lora")
            seen.pop("initial_lora")
            per = dict(flash_fwd=batches * L, flash_fwd_1pass=batches * depth)
            if q:
                per.update(quantize_rows=batches * 4 * L, w8a8_linear=batches * 7 * L)
            rec.update({"argv": argv, "giou": res["giou"], "ciou": res["ciou"],
                        "val_batches": batches, "launches": val["launches"],
                        "expected_launches": expect(**per), "torch._int_mm": len(int_mm),
                        "resumed_lora_equals_saved": set(got_lora) == set(saved) and all(
                            torch.equal(got_lora[n], saved[n]) for n in saved)})
            if q:
                rec["bf16"] = {"giou": records[-1]["giou"], "ciou": records[-1]["ciou"]}
            rec["ok"] = (0 <= res["giou"] <= 1 and 0 <= res["ciou"] <= 1
                         and rec["launches"] == rec["expected_launches"]
                         and (rec["torch._int_mm"] == 0 or not cuda)
                         and rec["resumed_lora_equals_saved"])
            records.append(rec)
        seen.clear()

        # 3. prepare at vit_h, crop layers 0 and 1
        images = prep_images if prep_images is not None else amg_images()
        img_dir = os.path.join(root, "images")
        os.makedirs(img_dir)
        by_name = {}
        for i, img in enumerate(images):
            by_name[f"img{i}.jpg"] = img
            open(os.path.join(img_dir, f"img{i}.jpg"), "wb").close()    # found by the glob
        CP._imread_rgb = lambda path: by_name[os.path.basename(path)]
        per_frame = dict(relpos_fwd=4, relpos_window=28, factored_decode=16)
        for layers in (0, 1):
            out = os.path.join(root, f"masks_{layers}.json")
            argv = ["--image_dir", img_dir, "--output", out, "--device", device,
                    "--points_per_side", str(points_per_side), "--pred_iou_thresh=-1e9",
                    "--stability_score_thresh=-1", "--crop_n_layers", str(layers)]
            submits, started = [], []

            def per_submit(fn):
                def run(self, image):
                    zero()
                    handle = fn(self, image)
                    submits.append(counts())
                    return handle
                return run

            def timed_init(fn):
                def run(self, *a, **kw):
                    fn(self, *a, **kw)
                    sync(device)
                    started.append(time.perf_counter())
                return run

            with Wrapped((AMG.AutomaticMaskGenerator, "submit", per_submit),
                         (AMG.AutomaticMaskGenerator, "__init__", timed_init)):
                rec, _, end = sub_run(f"prepare_crop_layers_{layers}", lambda: CP.main(argv))
            with open(out) as f:
                doc = json.load(f)
            frames = 1 + sum(4 ** i for i in range(1, layers + 1))
            reader = SamMaskReader(out, verbose=False)
            read_back = all(reader.extract_sam_segs(d["image"])["segs_origin"].shape[:2]
                            == tuple(d["target_size"]) for d in doc if d["masks"])
            schema = all(set(a) == ANN_KEYS and a["area"] > 0
                         and a["segmentation"]["size"] == d["target_size"]
                         and 0 <= a["crop_box"][0] and 0 <= a["crop_box"][1]
                         and a["crop_box"][0] + a["crop_box"][2] <= d["target_size"][1]
                         and a["crop_box"][1] + a["crop_box"][3] <= d["target_size"][0]
                         for d in doc for a in d["masks"])
            rec.update({
                "argv": argv, "images": [list(i.shape[:2]) for i in images], "frames": frames,
                "ms_per_image": (end - started[0]) * 1e3 / len(images),
                "annotations": [len(d["masks"]) for d in doc],
                "from_crops": [sum(a["crop_box"] != [0, 0, *d["target_size"][::-1]]
                                   for a in d["masks"]) for d in doc],
                "launches_per_image": submits,
                "expected_launches_per_image": expect(**{k: frames * v
                                                         for k, v in per_frame.items()}),
                "schema_ok": schema, "read_back": read_back})
            rec["ok"] = (len(doc) == len(images) and all(rec["annotations"]) and schema
                         and read_back and len(submits) == len(images)
                         and all(s == rec["expected_launches_per_image"] for s in submits))
            records.append(rec)
    finally:
        D._imread_rgb, CP._imread_rgb = saved_imread, saved_prep_imread
        shutil.rmtree(root, ignore_errors=True)
    peak = max((r["peak_mem_gb"] for r in records), default=None) if cuda else None
    for r in records:
        r["card"] = card
        r["freed"] = (not cuda) or r["allocated_after_gb"] <= base_gb + 0.5
        r["ok"] = r["ok"] and r["freed"]
        emit(r)
    rec = {"phase": "cli", "run": "all", "seconds": time.perf_counter() - t_phase,
           "peak_mem_gb": peak, "data_phase_peak_mem_gb": data_peak_gb, "card": card,
           "runs": {r["run"]: r["ok"] for r in records}}
    rec["ok"] = all(r["ok"] for r in records) and (
        peak is None or data_peak_gb is None or peak <= data_peak_gb + 1.0)
    emit(rec)
    if not rec["ok"]:
        raise SystemExit("the cli phase failed")
    return records


# ---------------------------------------------------------------------------
# LLaVA SFT, data parallelism, the native RLE codec, MPT
# ---------------------------------------------------------------------------

SFT_SHAPE = dict(BH=32, T=512, S=512, D=128)    # LLaMA-7B over the 512-token spliced sequence
SFT_IMAGES = ((480, 640), (640, 480), (427, 640), (512, 512), (375, 500), (500, 333))
SFT_TEXT_ROWS = 2
SFT_LORA_STEPS, SFT_PROJECTOR_STEPS, SFT_FULL_STEPS = 4, 2, 2
SFT_LR = 1e-4
# full SFT at 7B, reckoned before choosing its size: weights, gradients, the
# clip's scaled copy of the gradients and AdamW's two moments, all in the
# port's state dtype (the parameters', bf16), plus foreach AdamW's
# temporaries (one more parameter-sized buffer) and full-remat activations
SFT_FULL_LIMIT_GB = 70.0


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def sft_kernel_phase(A) -> dict:
    """Kernels A (with lse, as the training forward calls it), C and D at
    the SFT step's shape against their plain versions, with their times on
    the event clock beside their bounds, the plain versions' and SDPA's,
    and the device clock (``device_ms``) of A, C, D and SDPA's forward and
    backward on the same inputs."""
    import torch
    import torch.nn.functional as F
    a = kernel_case(A, "flash_fwd", **SFT_SHAPE, causal=True, dtype=torch.bfloat16, lse=True,
                    timed=True, seed=3)
    cd = bwd_case(A, **SFT_SHAPE, causal=True, dtype=torch.bfloat16, timed=True, repeat=True,
                  seed=3)
    dev = bwd_device_times(A, **SFT_SHAPE, causal=True, dtype=torch.bfloat16, seed=3)
    q, k, v, _ = fwd_inputs(A, SFT_SHAPE["BH"], SFT_SHAPE["T"], SFT_SHAPE["S"], SFT_SHAPE["D"],
                            torch.bfloat16, seed=3)
    q4, k4, v4 = (x.unsqueeze(0) for x in (q, k, v))
    dev["flash_fwd"] = device_ms(lambda: A.flash_fwd(q, k, v, causal=True, with_lse=True), 20)
    dev["sdpa_forward"] = device_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, scale=1.0 / A.LOG2E), 20)
    rec = {"phase": "sft_kernels", "shape": "(B*H, T, S, D) = (32, 512, 512, 128), causal, bf16",
           "card": card_name(), "clock": "ms: events; device_ms: events behind a spin kernel",
           "flash_fwd": {k: a[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms", "max_abs_err")},
           **{name: dict(r) for name, r in cd.items()},
           "device_ms": dev, "ok": True}
    rec["flash_fwd"]["device_ms"] = dev["flash_fwd"]
    rec["flash_fwd"]["library_device_ms"] = dev["sdpa_forward"]
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        rec[name]["device_ms"] = dev[name]
        rec[name]["library_device_ms"] = dev["sdpa_backward"]
    emit(rec)
    return rec


def sft_cut_config(C):
    """LLaVA-7B widths (CLIP-L at 224, LLaMA-7B), CLIP 2 blocks, LLaMA 2 layers."""
    full = C.LlavaConfig()
    return C.replace(full, llm=C.replace(full.llm, num_layers=2),
                     vision=C.replace(full.vision, depth=2))


def sft_batch(cfg, *, rows: int = 2, seed: int = 0, device="cuda", model_max_length=512):
    """A collated SFT batch from a seed: row 0 with an image at position 5,
    row 1 text-only (its splice in the padded tail), half the targets
    supervised."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    n = cfg.num_image_tokens
    T = model_max_length - (n - 1)
    ids = rng.randint(4, cfg.llm.vocab_size - 4, size=(rows, T))
    labels = ids.copy()
    labels[:, :T // 2] = -100
    image_pos = np.full((rows,), T - 1, np.int32)
    image_pos[0] = 5
    has_image = np.zeros((rows,), bool)
    has_image[0] = True
    s = cfg.vision.img_size
    arrays = {"images_clip": rng.randn(rows, s, s, 3).astype(np.float32),
              "input_ids": ids.astype(np.int32), "labels": labels.astype(np.int64),
              "image_pos": image_pos, "has_image": has_image}
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def sft_in_place(C, A) -> dict:
    """The cut LLaVA (``sft_cut_config``), float32: ``sft_loss`` and the
    gradient of every trainable parameter through kernels A (forward and
    its full-remat recompute), C and D against LLaMA's attention on the
    plain path without remat, in the LoRA (rank 8) and projector-only
    regimes.  Gate: each tensor within GRAD_LIMIT of max|ref|, the losses
    within GRAD_LIMIT relative, A 4, C 2, D 2 launches a step (CLIP's 257
    tokens take the plain path, as in JAX)."""
    import torch
    from llmseg_tpu_torch.models import llama
    from llmseg_tpu_torch.train import optim, sft

    cfg = sft_cut_config(C)
    lora = C.LoraConfig(rank=8)
    batch = sft_batch(cfg, seed=6)
    rec = {"phase": "sft_in_place", "config": "LLaVA-7B widths, CLIP 2 blocks, LLaMA 2 layers",
           "dtype": "float32", "limit": GRAD_LIMIT}
    L = cfg.llm.num_layers
    expect = {"flash_fwd": 2 * L, "flash_fwd_1pass": 0, "flash_bwd_dq": L,
              "flash_bwd_dkv": L, "flash_fwd_1pass_t": 0}
    ok = True
    for regime, flags in (("lora", dict(lora_enable=True)),
                          ("projector", dict(tune_mm_mlp_adapter=True))):
        lcfg = lora if regime == "lora" else None
        model = sft.init(cfg, seed=2, device="cuda", dtype=torch.float32, lora_cfg=lcfg)
        if lcfg is not None:
            with torch.no_grad():   # LoRA B starts at zero: give it a value so A gets a gradient
                g = torch.Generator(device="cuda").manual_seed(5)
                for name, p in model.named_parameters():
                    if name.startswith("lora.") and name.endswith(".b.weight"):
                        p.copy_(torch.randn(p.shape, device="cuda", generator=g) * 0.02)
        trainable = optim.partition(model, sft.sft_trainable_mask(model, **flags))

        def grads(remat):
            loss = sft.sft_loss(model, batch, lora_cfg=lcfg, remat=remat)
            loss.backward()
            out = {n: p.grad.detach().clone() for n, p in trainable.items()}
            model.zero_grad(set_to_none=True)
            return loss.item(), out

        for kern in A.KERNELS:
            kern.launches = 0
        loss_k, got = grads("full")
        launches = {kern.name: kern.launches for kern in A.KERNELS}
        llama.attention = plain_attention
        try:
            loss_p, ref = grads("none")
        finally:
            llama.attention = A.attention
        ratios = sorted((((got[n] - ref[n]).abs().max()
                          / ref[n].abs().max().clamp_min(1e-30)).item(), n) for n in ref)
        r = {"loss_kernels": loss_k, "loss_plain": loss_p, "tensors": len(ref),
             "worst_grad_err_vs_max_ref": ratios[-1][0], "worst_tensors": ratios[-3:],
             "launches": launches, "expected_launches": expect}
        r["ok"] = (abs(loss_k - loss_p) <= GRAD_LIMIT * abs(loss_p) and ratios[-1][0] <= GRAD_LIMIT
                   and launches == expect and len(ref) > 0)
        ok = ok and r["ok"]
        rec[regime] = r
        del model, trainable, got, ref
        torch.cuda.empty_cache()
    rec["ok"] = ok
    emit(rec)
    if not ok:
        raise SystemExit(f"SFT gradients through the kernels disagree with the plain path: {rec}")
    return rec


def write_sft_corpus(root: str, seed: int, *, images=SFT_IMAGES, text_rows=SFT_TEXT_ROWS,
                     plain: bool = False) -> dict:
    """A LLaVA SFT json list under ``root`` written from ``seed``: one row
    an image of ``images`` (2 or 3 turns: every other row opens with a turn
    of the model's, which the template drops; the <image> token in the
    first human turn) and ``text_rows`` text-only rows of 3 turns; with ``plain`` (the feature-alignment
    template) one (<image>, caption) pair an image and no text-only row.
    No image file is written: returns the json path, the image folder and
    each image path's size for ``standin_imread``."""
    import numpy as np
    rng = np.random.RandomState(seed)
    words = ("a red cat on a mat near the window under warm light with two cups and "
             "a small plant beside an open book").split()

    def sentence(n):
        return " ".join(words[i] for i in rng.randint(0, len(words), size=n))

    folder = os.path.join(root, "images")
    items, shapes = [], {}
    for i, hw in enumerate(images):
        name = f"{i:04d}.jpg"
        shapes[os.path.join(folder, name)] = hw
        if plain:
            conv = [{"from": "human", "value": "<image>"},
                    {"from": "gpt", "value": sentence(8 + i)}]
        else:
            conv = [{"from": "human", "value": f"{sentence(4)} <image> {sentence(3)}?"},
                    {"from": "gpt", "value": sentence(10 + 3 * i)}]
            if i % 2:   # a leading turn of the model's, which the template drops
                conv.insert(0, {"from": "gpt", "value": sentence(5)})
        items.append({"id": str(i), "image": name, "conversations": conv})
    for i in range(0 if plain else text_rows):
        conv = [{"from": "gpt", "value": sentence(4)},
                {"from": "human", "value": sentence(6) + "?"},
                {"from": "gpt", "value": sentence(12)}]
        items.append({"id": f"t{i}", "conversations": conv})
    path = os.path.join(root, "plain.json" if plain else "sft.json")
    with open(path, "w") as f:
        json.dump(items, f)
    return {"path": path, "folder": folder, "shapes": shapes}


def sft_full_peak_gb(cfg) -> dict:
    """The reckoning of full SFT's peak at a config: parameters (LLaMA,
    projector, CLIP) in bf16, and for the trainable ones (LLaMA and the
    projector) their gradients, the clip's scaled copy, AdamW's two moments
    and one foreach temporary, each bf16; activations under full remat at
    one row of 512 tokens (each layer's input kept, one layer's
    intermediates, the float32 logits and their gradient)."""
    llm, vis = cfg.llm, cfg.vision
    d, f, V = llm.hidden_size, llm.intermediate_size, llm.vocab_size
    per_layer = 4 * d * d + 3 * d * f + 2 * d
    n_llm = llm.num_layers * per_layer + 2 * V * d + d
    n_proj = cfg.mm_hidden_size * d + d
    n_clip = vis.depth * 12 * vis.hidden_size ** 2
    T, b = 512, 2
    weights = b * (n_llm + n_proj + n_clip)
    train = b * (n_llm + n_proj)
    acts = b * T * d * llm.num_layers + b * T * (10 * d + 2 * f) + 2 * 4 * T * V
    parts = {"weights": weights, "grads": train, "clip_copy": train, "adamw_moments": 2 * train,
             "foreach_temp": train, "activations": acts}
    return {"parts_gb": {k: v / 1e9 for k, v in parts.items()},
            "total_gb": sum(parts.values()) / 1e9}


def sft_phase(C, A, *, device="cuda", sizes=("7b", "7b", None), images=SFT_IMAGES,
              text_rows=SFT_TEXT_ROWS, mml: int = 512, seed: int = 0) -> list:
    """LLaVA SFT through the port's command line, ``cli.sft.main`` with
    ``--version`` empty (random weights from the seed, the byte tokenizer),
    bf16, on a corpus written from ``seed`` (``write_sft_corpus``: 6 rows
    with an image, 2 text-only, 2-3 turns each; the decode stood in for by
    ``standin_imread`` in ``llava_sft._imread_rgb``, as the card's machine
    has no PIL): (a) ``--lora_enable``, 4 steps, (b)
    ``--tune_mm_mlp_adapter --conv_type plain`` on a caption corpus of the
    same images, 2 steps, (c) full SFT, 2 steps, at 7B if
    ``sft_full_peak_gb`` says it fits in SFT_FULL_LIMIT_GB, else at
    ``small``.  A line a run: seconds, ms a step after the first, peak
    memory, launches of A, C, D a step, the first and last ``ce_loss``,
    frozen checksums unchanged and trainable ones changed, the saved
    checkpoint read back equal to the model, then deleted."""
    import shutil
    import tempfile

    import torch
    from llmseg_tpu_torch.cli import sft as CS
    from llmseg_tpu_torch.data import llava_sft as LS
    from llmseg_tpu_torch.train import checkpoint as ckpt_lib
    from llmseg_tpu_torch.train import sft

    cuda = torch.device(device).type == "cuda"
    card = card_name() if cuda else None
    reckon = sft_full_peak_gb(C.LlavaConfig())
    full_size = sizes[2] or ("7b" if reckon["total_gb"] <= SFT_FULL_LIMIT_GB else "small")
    runs = (("lora", sizes[0], ["--lora_enable"], SFT_LORA_STEPS, False),
            ("projector", sizes[1], ["--tune_mm_mlp_adapter", "--conv_type", "plain"],
             SFT_PROJECTOR_STEPS, True),
            ("full", full_size, [], SFT_FULL_STEPS, False))
    root = tempfile.mkdtemp(prefix="llmseg_sft_")
    saved_imread = LS._imread_rgb
    saved_init, saved_make = sft.init, sft.make_sft_train_step
    records = []
    try:
        for name, size, flags, steps, plain in runs:
            corpus = write_sft_corpus(root, seed, images=images, text_rows=text_rows,
                                      plain=plain)
            LS._imread_rgb = standin_imread(corpus["shapes"], seed)
            seen = {"steps": []}

            def init(*a, **kw):
                seen["model"] = saved_init(*a, **kw)
                return seen["model"]

            def make(*a, **kw):
                model = seen["model"]
                seen["before"] = {n: checksums([p]) for n, p in model.named_parameters()}
                step, opt = saved_make(*a, **kw)

                def timed(m, batch):
                    for kern in A.KERNELS:
                        kern.launches = 0
                    sync(device)
                    t0 = time.perf_counter()
                    out = step(m, batch)
                    sync(device)
                    seen["steps"].append({"ms": (time.perf_counter() - t0) * 1e3,
                                          "ce_loss": float(out["ce_loss"]),
                                          "grad_norm": float(out["grad_norm"]),
                                          "launches": {k.name: k.launches for k in A.KERNELS}})
                    return out
                return timed, opt

            sft.init, sft.make_sft_train_step = init, make
            out_dir = os.path.join(root, f"out_{name}")
            argv = ["--data_path", corpus["path"], "--image_folder", corpus["folder"],
                    "--model_size", size, "--precision", "bf16", "--model_max_length", str(mml),
                    "--max_steps", str(steps), "--print_freq", "1", "--output_dir", out_dir,
                    "--lr", str(SFT_LR), "--warmup_steps", "0", "--device", device, *flags]
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model = CS.main(argv)
            sync(device)
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
            mask = sft.sft_trainable_mask(model, tune_mm_mlp_adapter="--tune_mm_mlp_adapter" in flags,
                                          lora_enable="--lora_enable" in flags)
            after = {n: checksums([p]) for n, p in model.named_parameters()}
            frozen_same = all(torch.equal(after[n], seen["before"][n])
                              for n, t in mask.items() if not t)
            moved = {n for n, t in mask.items() if t and not torch.equal(after[n], seen["before"][n])}
            # a bf16 entry x keeps its value under a step below half its ulp,
            # at least |x| 2^-9; AdamW's first steps are about lr, so a tensor
            # whose every entry has |x| >= 1024 lr (RMSNorm scales of 1) stays
            held = sorted(n for n, p in model.named_parameters() if mask[n] and n not in moved
                          and p.abs().min().item() >= 1024 * SFT_LR)
            t1 = time.perf_counter()
            params, _, step = ckpt_lib.restore(out_dir, map_location="cpu")
            read_back = (step == steps and set(params) == set(after) and all(
                torch.equal(checksums([params[n].to(device)]), after[n]) for n in after))
            read_s = time.perf_counter() - t1
            ckpt_bytes = dir_bytes(out_dir)
            del params
            shutil.rmtree(out_dir, ignore_errors=True)
            L = model.cfg.llm.num_layers
            expect = {"flash_fwd": 2 * L if cuda else 0, "flash_fwd_1pass": 0,
                      "flash_bwd_dq": L if cuda else 0, "flash_bwd_dkv": L if cuda else 0,
                      "flash_fwd_1pass_t": 0}
            st = seen["steps"]
            rec = {"phase": "sft", "run": name, "model_size": size, "argv": argv, "card": card,
                   "seconds": seconds, "steps": len(st),
                   "ms_per_step_after_first": [s["ms"] for s in st[1:]],
                   "peak_mem_gb": peak, "launches_per_step": [s["launches"] for s in st],
                   "expected_launches_per_step": expect,
                   "ce_loss_first": st[0]["ce_loss"], "ce_loss_last": st[-1]["ce_loss"],
                   "grad_norm": [s["grad_norm"] for s in st],
                   "trainable_tensors": sum(mask.values()), "trainable_changed": len(moved),
                   "held_by_bf16_rounding": held,
                   "frozen_tensors": len(mask) - sum(mask.values()),
                   "frozen_checksums_unchanged": frozen_same,
                   "checkpoint_bytes": ckpt_bytes, "checkpoint_read_back_equal": read_back,
                   "read_back_s": read_s}
            if name == "full":
                rec["full_sft_7b_reckoning"] = {**reckon, "limit_gb": SFT_FULL_LIMIT_GB}
            rec["ok"] = (len(st) == steps and all(math.isfinite(s["ce_loss"]) for s in st)
                         and frozen_same and len(moved) > 0 and read_back
                         and len(moved) + len(held) == rec["trainable_tensors"]
                         and all(s["launches"] == expect for s in st))
            emit(rec)
            records.append(rec)
            del model, seen
            if cuda:
                torch.cuda.empty_cache()
            if not rec["ok"]:
                raise SystemExit(f"the sft phase failed: {rec}")
    finally:
        LS._imread_rgb = saved_imread
        sft.init, sft.make_sft_train_step = saved_init, saved_make
        shutil.rmtree(root, ignore_errors=True)
    return records


def ddp_phase(C, make_batch, A, *, device="cuda", steps: int = 2, cfg=None,
              log_dir=os.path.join(OUT_DIR, "ddp_runs")) -> dict:
    """The Trainer's data-parallel path (``parallel/ddp.py``) at world size
    1: nccl on the card (gloo on the CPU), its store a TCP one on
    127.0.0.1.  Two Trainer steps of the cut model (``cut_config``, LoRA
    rank 8, bf16, remat "dots") through the DDP path against the same two
    steps of a Trainer outside any process group, from the same weights
    and batches: the gradients each step and the parameters after, equal
    to the bit; the loss terms equal; launches a step."""
    import datetime
    import socket

    import torch
    import torch.distributed as dist
    from llmseg_tpu_torch.models import llmseg
    from llmseg_tpu_torch.parallel import ddp
    from llmseg_tpu_torch.train.trainer import Trainer

    cfg = cfg or cut_config(C)
    dtype = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    exp = C.ExperimentConfig(model=cfg, train=C.TrainConfig(
        warmup_steps=0, grad_accum_steps=1, lora=C.LoraConfig(rank=8),
        precision="bf16" if dtype == torch.bfloat16 else "fp32",
        log_dir=log_dir))
    text_len = min(512, cfg.max_seq_len - cfg.llava.num_image_tokens)
    batches = [make_batch(cfg, num_images=1, rows_per_image=2, text_len=text_len, seed=20 + i,
                          device=device) for i in range(steps)]

    def run():
        model = llmseg.init(cfg, seed=3, device=device, dtype=dtype, lora_cfg=exp.train.lora)
        trainer = Trainer(exp, model=model, device=device)
        grads, launches, terms = [], [], []
        step = trainer.opt.step

        def recording(norm=None):
            grads.append({n: p.grad.detach().clone() for n, p in trainer.trainable.items()})
            return step(norm)

        trainer.opt.step = recording
        for b in batches:
            for kern in A.KERNELS:
                kern.launches = 0
            m = trainer.step(b)
            sync(device)
            launches.append({kern.name: kern.launches for kern in A.KERNELS})
            terms.append({k: v.item() for k, v in m.items()})
        params = {n: p.detach().clone() for n, p in trainer.trainable.items()}
        return grads, params, terms, launches

    t0 = time.perf_counter()
    ref = run()
    single_s = time.perf_counter() - t0
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    saved_env = {k: os.environ.get(k) for k in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                                               "WORLD_SIZE", "LOCAL_RANK")}
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK="0",
                      WORLD_SIZE="1", LOCAL_RANK="0")
    try:
        dev = ddp.init_from_env(device, timeout=datetime.timedelta(seconds=120))
        backend = dist.get_backend()
        t0 = time.perf_counter()
        got = run()
        ddp_s = time.perf_counter() - t0
        world = ddp.world_size()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    grads_equal = all(set(g) == set(r) and all(torch.equal(g[n], r[n]) for n in r)
                      for g, r in zip(got[0], ref[0])) and len(got[0]) == steps
    params_equal = set(got[1]) == set(ref[1]) and all(torch.equal(got[1][n], ref[1][n])
                                                      for n in ref[1])
    rec = {"phase": "ddp", "config": "llmseg_7b widths, towers 2-3 blocks, LLaMA 2 layers, "
           "LoRA rank 8", "dtype": str(dtype).split(".")[-1], "backend": backend,
           "world_size": world, "device": str(dev), "store": f"tcp 127.0.0.1:{port}",
           "steps": steps, "grads_equal_to_the_bit": grads_equal,
           "params_equal_to_the_bit": params_equal, "terms_equal": got[2] == ref[2],
           "terms": got[2], "launches_per_step": got[3], "launches_single": ref[3],
           "seconds_single": single_s, "seconds_ddp": ddp_s,
           "card": card_name() if torch.device(device).type == "cuda" else None}
    rec["ok"] = (grads_equal and params_equal and rec["terms_equal"] and world == 1
                 and got[3] == ref[3]
                 and all(math.isfinite(v) for t in got[2] for v in t.values()))
    emit(rec)
    if not rec["ok"]:
        raise SystemExit(f"the ddp phase failed: {rec}")
    return rec


MESH_LIMIT = 1e-4             # mesh_in_place, float32: the cut models' gate, relative
MESH_LOSS_GAP = 5e-2          # mesh, bf16: a step's loss against one process's, relative
MESH_FSDP_LAYERS = 8          # mesh's fsdp sub-run: LLaMA cut to this depth (gloo's gathers)
MESH_WAIT_S = 600             # the ranks are killed after this
MESH_POS = {"flash_fwd": 7, "flash_bwd_dq": 8, "flash_bwd_dkv": 8}   # BH among the launch args


def split_images(batch: dict, d: int, n: int) -> dict:
    """Data rank ``d``'s share of a global batch of one row an image, as
    the JAX package's ``shard_batch`` splits the leading axis over (dp,
    fsdp)."""
    k = batch["images_dino"].shape[0] // n
    out = {key: v[d * k:(d + 1) * k] for key, v in batch.items()}
    out["row_to_image"] = out["row_to_image"] - d * k
    return out


class LaunchShapes:
    """While active, the BH argument of every launch of kernels A, C and D
    (``seen``: (name, BH) in launch order)."""

    def __init__(self, A):
        self.kerns = [k for k in A.KERNELS if k.name in MESH_POS]
        self.seen = []

    def __enter__(self):
        for kern in self.kerns:
            def launch(*args, _kern=kern, _orig=kern.launch):
                self.seen.append((_kern.name, args[MESH_POS[_kern.name]]))
                return _orig(*args)
            kern.launch = launch
        return self

    def __exit__(self, *exc):
        for kern in self.kerns:
            del kern.launch

    def heads(self, rows: int) -> dict:
        """{kernel: the head counts it ran at}, for ``rows`` rows."""
        out = {}
        for name, bh in self.seen:
            out.setdefault(name, set()).add(bh // rows)
        return {k: sorted(v) for k, v in out.items()}


class CollectiveClock(Wrapped):
    """While active, the seconds spent in the mesh's collectives (each
    call between two synchronisations of the card, so that it is the
    collective's own time) and their count."""

    NAMES = ("all_gather", "all_reduce", "reduce_scatter")

    def __init__(self, M, device):
        self.seconds = {n: 0.0 for n in self.NAMES}
        self.calls = {n: 0 for n in self.NAMES}

        def around(name):
            def wrap(fn):
                def timed(*args, **kw):
                    sync(device)
                    t0 = time.perf_counter()
                    out = fn(*args, **kw)
                    sync(device)
                    self.seconds[name] += time.perf_counter() - t0
                    self.calls[name] += 1
                    return out
                return timed
            return wrap

        super().__init__(*[(M, n, around(n)) for n in self.NAMES])


def mesh_subrun(C, A, spec: dict, device: str, axes=(-1, 1, 1)) -> dict:
    """One sub-run of the mesh phases on mesh ``axes`` (dp, fsdp, tp; the
    default is one process): the model from ``spec``'s seed (LoRA rank 8;
    with ``spec["jitter"]`` every trainable tensor that starts at zero,
    LoRA B and the selection head's biases, drawn nonzero, so that A has a
    gradient and each tensor after a step is held at its own scale, not at
    AdamW's step's), the ``Trainer``, ``predict`` on this data rank's images of
    ``spec["predict"]`` if given, a step on each of ``spec["batches"]``
    (global batches, split by data rank), with ``spec["timed"]`` the last
    one with the collectives clocked; with ``spec["bits"]`` (8 or 4) the
    Trainer's frozen LLaMA quantized (QLoRA).  Returns the loss terms, the
    launches and head counts a step, the times, the peak memory, and as
    asked the whole gradients and trainable parameters (on the CPU)."""
    import gc

    import torch
    from llmseg_tpu_torch.models import llmseg
    from llmseg_tpu_torch.parallel import mesh as M
    from llmseg_tpu_torch.train import optim
    from llmseg_tpu_torch.train.trainer import Trainer

    dp, fsdp, tp = axes
    dtype = getattr(torch, spec["dtype"])
    lora = C.LoraConfig(rank=8)
    exp = C.ExperimentConfig(model=spec["cfg"], train=C.TrainConfig(
        warmup_steps=0, grad_accum_steps=1, lora=lora,
        precision="fp32" if dtype == torch.float32 else "bf16",
        quantize_frozen=bool(spec.get("bits")), quantize_bits=spec.get("bits") or 8,
        mesh=C.MeshConfig(data=dp, fsdp=fsdp, tensor=tp), log_dir=spec["log_dir"]))
    t0 = time.perf_counter()
    model = llmseg.init(spec["cfg"], seed=spec["seed"], device=device, dtype=dtype,
                        lora_cfg=lora)
    if spec.get("jitter"):
        with torch.no_grad():
            g = torch.Generator(device=device).manual_seed(5)
            for name, p in model.named_parameters():
                if optim.is_trainable(name) and not p.any():
                    p.copy_(torch.randn(p.shape, device=device, generator=g) * 0.02)
    trainer = Trainer(exp, model=model, device=device)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    sync(device)
    d, n = trainer.rank, trainer.world
    res = {"setup_s": time.perf_counter() - t0, "data_rank": d, "data_size": n,
           "resident_gb": (torch.cuda.memory_allocated() / 1e9
                           if torch.device(device).type == "cuda" else None)}

    def counts():
        return {kern.name: kern.launches for kern in A.KERNELS}

    def zero():
        for kern in A.KERNELS:
            kern.launches = 0

    if spec.get("predict") is not None:
        batch = trainer.to_device(split_images(spec["predict"], d, n))
        zero()
        with LaunchShapes(A) as shapes:
            t0 = time.perf_counter()
            out = llmseg.predict(model, batch, device=device)
            sync(device)
            res["predict_s"] = time.perf_counter() - t0
        res["predict"] = {k: out[k].float().cpu() for k in ("pred_similarity", "pred_iou")}
        res["predict_launches"] = counts()
        res["predict_heads"] = shapes.heads(batch["input_ids"].shape[0])
        del out

    grads = []
    if spec.get("grads"):
        step = trainer.opt.step

        def recording(norm=None):
            grads.append({n_: M.gather_tensor(p.grad.detach(), trainer.specs[n_], trainer.mesh)
                          .float().cpu() for n_, p in trainer.trainable.items()})
            return step(norm)

        trainer.opt.step = recording
    res.update(terms=[], launches=[], heads=[], step_s=[])
    for i, b in enumerate(spec["batches"]):
        batch = trainer.to_device(split_images(b, d, n))
        zero()
        clock = CollectiveClock(M, device) if spec.get("timed") and i == len(
            spec["batches"]) - 1 else contextlib.nullcontext()
        with LaunchShapes(A) as shapes, clock:
            t0 = time.perf_counter()
            m = trainer.step(batch)
            sync(device)
            res["step_s"].append(time.perf_counter() - t0)
        res["terms"].append({k: v.item() for k, v in m.items()})
        res["launches"].append(counts())
        res["heads"].append(shapes.heads(batch["input_ids"].shape[0]))
    if spec.get("timed"):
        res["collective_s"], res["collective_calls"] = clock.seconds, clock.calls
    if torch.device(device).type == "cuda":
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["grads"] = grads
    replicated = [n_ for n_ in trainer.trainable if not any(trainer.specs[n_])]
    res["replicated"] = {n_: trainer.trainable[n_].detach().cpu() for n_ in replicated}
    if spec.get("params"):
        res["params"] = {n_: p.detach().float().cpu() for n_, p in trainer.full_params().items()}
    del trainer, model, batch
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return res


def mesh_rank(root: str, device: str) -> int:
    """One rank of the mesh phases (``mesh_phase`` starts two): joins the
    process group of the environment on gloo, runs each sub-run of
    ``<root>/inputs.pt`` on its mesh, writes ``<root>/<run>_rank<r>.pt``
    and prints a line a sub-run."""
    import datetime

    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from llmseg_tpu_torch import config as C
    from llmseg_tpu_torch.ops import attention as A
    from llmseg_tpu_torch.parallel import ddp

    dev = ddp.init_from_env(device, timeout=datetime.timedelta(seconds=120), backend="gloo")
    rank = ddp.rank()
    try:
        for spec in torch.load(os.path.join(root, "inputs.pt"), weights_only=False):
            run = qmesh_predict_subrun if spec.get("kind") == "w8a8_predict" else mesh_subrun
            res = run(C, A, spec, str(dev), spec["mesh"])
            torch.save(res, os.path.join(root, f"{spec['name']}_rank{rank}.pt"))
            emit({"phase": "mesh_rank", "rank": rank, "run": spec["name"], "device": str(dev),
                  "mesh": dict(zip(("dp", "fsdp", "tp"), spec["mesh"])),
                  **{k: res.get(k) for k in ("data_rank", "setup_s", "step_s", "collective_s",
                                             "resident_gb", "peak_gb", "terms", "launches",
                                             "heads", "predict_launches", "predict_heads",
                                             "predict_s", "quantize_s", "calibrate_s")
                     if k in res}})
    finally:
        torch.distributed.destroy_process_group()
    return 0


def mesh_ranks(root: str, device: str, world: int = 2) -> list:
    """Start ``world`` ranks of ``mesh_rank`` (a TCP store on 127.0.0.1,
    every rank on this card: LOCAL_RANK 0), wait for them (killing any
    left after MESH_WAIT_S), print their lines, and fail if one fails."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke as CS; "
            "sys.exit(CS.mesh_rank(sys.argv[2], sys.argv[3]))")
    procs, outs = [], [os.path.join(root, f"rank{r}.log") for r in range(world)]
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        with open(outs[rank], "w") as out:
            procs.append(subprocess.Popen([sys.executable, "-c", code, here, root, device],
                                          env=env, stdout=out, stderr=subprocess.STDOUT))
    deadline = time.time() + MESH_WAIT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.time(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = []
    for path in outs:
        with open(path) as f:
            logs.append(f.read())
        print(logs[-1], end="", flush=True)
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise SystemExit(f"mesh ranks {failed} failed (return codes "
                         f"{[p.returncode for p in procs]})")
    return logs


def _rel(got, ref) -> float:
    """Relative Frobenius distance; 0 / 0 counts as agreement."""
    num, den = (got - ref).norm().item(), ref.norm().item()
    return 0.0 if num == 0 else num / max(den, 1e-30)


def _zero_grad_tensor(name: str) -> bool:
    # the selection head's attention key biases: their exact gradient is
    # zero (a key bias shifts a whole softmax row), so both runs give noise
    return name.startswith("select.") and name.endswith(".k.bias")


def expect_step(A, cfg, cuda: bool) -> dict:
    """Launches of kernels A-D and J in one LoRA train step."""
    if not cuda:
        return {k.name: 0 for k in A.KERNELS}
    L = cfg.llava.llm.num_layers
    return {"flash_fwd": 2 * L, "flash_fwd_1pass": cfg.dino.depth, "flash_bwd_dq": L,
            "flash_bwd_dkv": L, "flash_fwd_1pass_t": 0}


def heads_ok(heads, cfg, tp, cuda: bool, kernels=tuple(MESH_POS)) -> bool:
    want = cfg.llava.llm.num_heads // tp
    return not cuda or heads == {k: [want] for k in kernels}


def bitwise_replicated(pair) -> bool:
    a, b = (r["replicated"] for r in pair)
    return set(a) == set(b) and all(torch_equal(a[n], b[n]) for n in a)


def torch_equal(a, b) -> bool:
    import torch
    return bool(torch.equal(a, b))


def mesh_in_place_gates(pair, ref, A, cfg, tp, lr, cuda, mode=None) -> dict:
    """A cut model's two steps on the mesh (``pair``: both ranks' sub-runs)
    against one process's (``ref``): the loss terms, every trainable
    gradient gathered whole and the trainables after, within MESH_LIMIT,
    as ``mesh_phase`` states; the record without its phase and run."""
    import torch
    r0 = pair[0]
    terms = max(abs(g[k] - f[k]) / max(abs(f[k]), 1e-30)
                for g, f in zip(r0["terms"], ref["terms"]) for k in f)
    top = max(g.abs().max().item() for step in ref["grads"] for g in step.values())
    # LLaMA's trainables (embed_tokens, lm_head, LoRA), whose work the
    # mesh splits, per tensor; the selection head, whole on every rank
    # and after LLaMA, as one vector: some of its gradients (attention
    # q and k, the last embedding layer's bias) are small differences
    # of large terms, which float32 rounding of the mesh's sums moves
    # by up to 6e-4 of themselves (an H100 at tp=2 and fsdp=2);
    # its key biases, whose exact gradient is zero, against the top
    grad_errs, head_errs, head_tensors, zero_errs = [], [], [], []
    for gs, fs in zip(r0["grads"], ref["grads"]):
        head = [n_ for n_ in fs if n_.startswith("select.") and not _zero_grad_tensor(n_)]
        head_errs.append(_rel(torch.cat([gs[n_].flatten() for n_ in head]),
                              torch.cat([fs[n_].flatten() for n_ in head])))
        head_tensors += [(_rel(gs[n_], fs[n_]), n_) for n_ in head]
        grad_errs += [(_rel(gs[n_], f), n_) for n_, f in fs.items()
                      if not n_.startswith("select.")]
        zero_errs += [(gs[n_] - f).abs().max().item() / top for n_, f in fs.items()
                      if _zero_grad_tensor(n_)]
    grad_errs.sort()
    head_tensors.sort()
    param_errs = sorted((_rel(p, ref["params"][n_]), n_) for n_, p in r0["params"].items()
                        if not _zero_grad_tensor(n_))
    zero_moves = max((p - ref["params"][n_]).abs().max().item()
                     for n_, p in r0["params"].items() if _zero_grad_tensor(n_))
    rec = {"config": "llmseg_7b widths, towers 2-3 blocks, LLaMA 2 layers, LoRA rank 8, "
           "zero-init trainables drawn nonzero, remat dots"
           + ("" if mode is None else f", {mode}"),
           "dtype": "float32", "backend": "gloo", "ranks_on_one_card": 2,
           "limit": MESH_LIMIT, "steps": len(ref["terms"]),
           "global_images_a_step": 2, "images_a_rank": 2 // r0["data_size"],
           "terms": r0["terms"], "terms_one_process": ref["terms"],
           "worst_term_err": terms, "worst_llama_grad_err": grad_errs[-1][0],
           "worst_llama_grad_tensors": grad_errs[-3:], "head_grad_err": head_errs,
           "head_worst_tensors": head_tensors[-3:],
           "zero_grad_err_vs_top": max(zero_errs),
           "worst_param_err": param_errs[-1][0], "worst_param_tensors": param_errs[-2:],
           "zero_grad_params_moved_apart": zero_moves,
           "replicated_equal_to_the_bit": bitwise_replicated(pair),
           "launches_per_step": r0["launches"], "expected": expect_step(A, cfg, cuda),
           "heads": r0["heads"]}
    rec["ok"] = (terms <= MESH_LIMIT and grad_errs[-1][0] <= MESH_LIMIT
                 and max(head_errs) <= MESH_LIMIT and max(zero_errs) <= MESH_LIMIT
                 and param_errs[-1][0] <= MESH_LIMIT
                 and zero_moves <= 4 * lr and rec["replicated_equal_to_the_bit"]
                 and all(lc == rec["expected"] for r in pair for lc in r["launches"])
                 and all(heads_ok(h, cfg, tp, cuda) for r in pair for h in r["heads"]))
    return rec


def mesh_full_gates(pair, one, A, cfg, full, tp, dtype, cuda, text_len,
                    predict_images=None) -> dict:
    """A 7B run's steps (and ``predict``) on the mesh (``pair``) against one
    process's (``one``): the loss gap within MESH_LOSS_GAP, the times, the
    collectives' share, the peak memory, the launches and head counts, as
    ``mesh_phase`` states; the record without its phase and run."""
    import torch
    r0 = pair[0]
    gaps = [abs(g["loss"] - f["loss"]) / abs(f["loss"]) for g, f in zip(r0["terms"],
                                                                      one["terms"])]
    coll = r0.get("collective_s") or {}
    rec = {"config": "llmseg_7b" + (
           "" if cfg.llava.llm.num_layers == full.llava.llm.num_layers else
           f", LLaMA cut to {cfg.llava.llm.num_layers} of "
           f"{full.llava.llm.num_layers} layers (gloo's gathers)"),
           "dtype": dtype, "backend": "gloo", "ranks_on_one_card": 2,
           "mesh": dict(zip(("dp", "fsdp", "tp"), (1, 2 // tp, tp))),
           "images_a_step_a_rank": 1, "text_len": text_len,
           "loss_gap": gaps, "loss_gap_limit": MESH_LOSS_GAP,
           "terms": r0["terms"], "terms_one_process": one["terms"],
           "s_per_step_after_first": [r["step_s"][1:] for r in pair],
           "s_per_step_one_process": one["step_s"][1:],
           "collective_s": [r.get("collective_s") for r in pair],
           "collective_calls": r0.get("collective_calls"),
           "collective_share_of_the_last_step": (sum(coll.values()) / r0["step_s"][-1]
                                                 if coll else None),
           "peak_gb_a_rank": [r.get("peak_gb") for r in pair],
           "resident_gb_a_rank": [r.get("resident_gb") for r in pair],
           "peak_gb_one_process": one.get("peak_gb"),
           "launches_per_step_a_rank": [r["launches"] for r in pair],
           "expected": expect_step(A, cfg, cuda), "heads": r0["heads"],
           "heads_expected": cfg.llava.llm.num_heads // tp,
           "replicated_equal_to_the_bit": bitwise_replicated(pair),
           "note": "two ranks share one card over gloo: these times measure no scaling"}
    ok = (all(math.isfinite(g) and g <= MESH_LOSS_GAP for g in gaps)
          and all(math.isfinite(v) for r in pair for t in r["terms"] for v in t.values())
          and all(lc == rec["expected"] for r in pair for lc in r["launches"])
          and all(heads_ok(h, cfg, tp, cuda) for r in pair for h in r["heads"])
          and rec["replicated_equal_to_the_bit"])
    if "predict" in one:
        atol, rtol = BF16_TOL if cuda else F32_TOL
        diffs = {}
        for k, f in one["predict"].items():
            d_ = (r0["predict"][k] - f).abs()
            diffs[k] = {"max_abs": d_.max().item(),
                        "worst_over_gate": (d_ - atol - rtol * f.abs()).max().item()}
        rec.update(predict_batch=predict_images, atol=atol, rtol=rtol,
                   predict_vs_one_process=diffs,
                   predict_ranks_equal=all(torch.equal(pair[0]["predict"][k],
                                                       pair[1]["predict"][k])
                                           for k in one["predict"]),
                   predict_launches=r0["predict_launches"],
                   predict_s=[r["predict_s"] for r in pair],
                   predict_s_one_process=one["predict_s"],
                   predict_heads=r0["predict_heads"])
        ok = ok and all(v["worst_over_gate"] <= 0 for v in diffs.values()) and (
            rec["predict_ranks_equal"]
            and heads_ok(r0["predict_heads"], cfg, tp, cuda, ("flash_fwd",))
            and all(math.isfinite(v) for f in r0["predict"].values()
                    for v in (f.min().item(), f.max().item())))
    rec["ok"] = bool(ok)
    return rec


def mesh_phase(C, make_batch, A, *, device="cuda", in_place_cfg=None, full_cfg=None,
               fsdp_layers: int = MESH_FSDP_LAYERS, text_len: int = 512,
               predict_images: int = 4) -> dict:
    """The (dp, fsdp, tp) mesh (``parallel/mesh.py``) with both ranks on
    this card over gloo (nccl refuses two ranks on one device).  The one-
    process references run first, here, and are freed before the ranks
    start.

    mesh_in_place: the cut model (``cut_config``), float32, LoRA rank 8
    (its B and the selection head's biases drawn nonzero), remat "dots":
    two Trainer steps at tp=2 and at fsdp=2 on two global batches of 2
    images against the same two steps of one process: the loss terms and
    grad_norm, every trainable gradient gathered to its whole shape
    (relative Frobenius) and the trainable parameters after, within
    MESH_LIMIT: LLaMA's trainables per tensor, the selection head (whole
    on every rank, after LLaMA) as one vector, each of its tensors'
    distance printed, its attention key biases (exact gradient zero)
    against the step's largest gradient; the two ranks' replicated
    trainable parameters equal to the bit; kernels A, C, D launched at
    H / tp heads, B on the towers.

    mesh: llmseg_7b in bf16 (all 32 layers at tp=2; the fsdp sub-run's
    LLaMA cut to ``fsdp_layers``, its line says so): tp=2 predict at batch
    4 against one process's within the bf16 gate, then two steps at 1
    image a step (both ranks on it); fsdp=2 two steps at 1 image a rank;
    the second step of each with its collectives clocked.  Printed: seconds a
    step after the first, peak memory a rank, launches a step a rank, the
    loss gap to one process (gated at MESH_LOSS_GAP and finite)."""
    import shutil
    import tempfile

    import torch

    cuda = torch.device(device).type == "cuda"
    in_cfg = in_place_cfg or cut_config(C)
    full = full_cfg or C.llmseg_7b()
    fsdp_cfg = C.replace(full, llava=C.replace(full.llava, llm=C.replace(
        full.llava.llm, num_layers=min(fsdp_layers, full.llava.llm.num_layers))))
    bf16 = "bfloat16" if cuda else "float32"
    root = tempfile.mkdtemp(prefix="mesh_")

    def batches(cfg, images, seed):
        return [make_batch(cfg, num_images=images, rows_per_image=1, text_len=text_len,
                           seed=seed + i, device="cpu") for i in range(2)]

    log = os.path.join(root, "log")
    base = dict(jitter=False, grads=False, params=False, timed=False, log_dir=log)
    in_place = dict(base, cfg=in_cfg, dtype="float32", seed=6, batches=batches(in_cfg, 2, 30),
                    jitter=True, grads=True, params=True)
    runs = [dict(in_place, name="in_place_tp2", mesh=(1, 1, 2)),
            dict(in_place, name="in_place_fsdp2", mesh=(1, 2, 1)),
            dict(base, name="full_tp2", mesh=(1, 1, 2), cfg=full, dtype=bf16, seed=0,
                 batches=batches(full, 1, 40), timed=True,
                 predict=make_batch(full, num_images=predict_images, rows_per_image=1,
                                    text_len=text_len, seed=45, device="cpu")),
            dict(base, name="full_fsdp2", mesh=(1, 2, 1), cfg=fsdp_cfg, dtype=bf16, seed=0,
                 batches=batches(fsdp_cfg, 2, 50), timed=True)]
    try:
        t0 = time.perf_counter()
        refs = {"in_place": mesh_subrun(C, A, in_place, device)}
        refs["full_tp2"] = mesh_subrun(C, A, runs[2], device)
        refs["full_fsdp2"] = mesh_subrun(C, A, runs[3], device)
        ref_s = time.perf_counter() - t0
        torch.save(runs, os.path.join(root, "inputs.pt"))
        t0 = time.perf_counter()
        mesh_ranks(root, device)
        ranks_s = time.perf_counter() - t0
        got = {r["name"]: [torch.load(os.path.join(root, f"{r['name']}_rank{k}.pt"),
                                      weights_only=False) for k in range(2)] for r in runs}
    finally:
        shutil.rmtree(root, ignore_errors=True)

    llm = in_cfg.llava.llm
    lr = C.TrainConfig().lr
    card = card_name() if cuda else None
    records = {}
    ref = refs["in_place"]
    for name, tp in (("in_place_tp2", 2), ("in_place_fsdp2", 1)):
        rec = {"phase": "mesh_in_place", "run": name,
               **mesh_in_place_gates(got[name], ref, A, in_cfg, tp, lr, cuda)}
        rec.update(mesh=dict(zip(("dp", "fsdp", "tp"), runs[0 if tp == 2 else 1]["mesh"])),
                   heads_expected=llm.num_heads // tp, seconds_ranks=ranks_s,
                   seconds_references=ref_s, card=card)
        emit(rec)
        records[name] = rec
    for name, tp, cfg in (("full_tp2", 2, full), ("full_fsdp2", 1, fsdp_cfg)):
        rec = {"phase": "mesh", "run": name, **mesh_full_gates(
            got[name], refs[name], A, cfg, full, tp, bf16, cuda, text_len, predict_images)}
        rec["card"] = card
        emit(rec)
        records[name] = rec
    failed = [name for name, rec in records.items() if not rec["ok"]]
    if failed:
        raise SystemExit(f"the mesh phases' gates failed: {failed}")
    return records


# ---------------------------------------------------------------------------
# A quantized LLaMA on the mesh: W8A8 predict through Q1's split forms, Q2's
# int32 output and the standalone rescale; QLoRA int8 and int4 steps
# ---------------------------------------------------------------------------


def qmesh_predict_subrun(C, A, spec: dict, device: str, axes=(-1, 1, 1)) -> dict:
    """W8A8 ``predict`` on mesh ``axes`` (one process by default): the model
    from ``spec``'s seed, sharded, with ``spec["calib"]`` calibrated on this
    data rank's images (``calibrate_quant_stats`` on the mesh) and
    SmoothQuant-folded, quantized in place (W8A8, lm_head included), then
    ``predict`` on this data rank's images of ``spec["predict"]`` twice: the
    first call counts the launches of Q1, Q2 and the mesh's split forms,
    the second is timed and must repeat the first to the bit."""
    import gc

    import torch
    from llmseg_tpu_torch.models import llmseg
    from llmseg_tpu_torch.ops import quant as Q
    from llmseg_tpu_torch.parallel import mesh as M

    dp, fsdp, tp = axes
    cfg, dtype = spec["cfg"], getattr(torch, spec["dtype"])
    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    model = llmseg.init(cfg, seed=spec["seed"], device=device, dtype=dtype)
    mesh = M.make_mesh(C.MeshConfig(data=dp, fsdp=fsdp, tensor=tp))
    M.shard_params(model, mesh)
    d, n = mesh.data_rank, mesh.data_size
    res = {"setup_s": time.perf_counter() - t0, "data_rank": d, "data_size": n}

    def on_device(b):
        return {k: v.to(device) for k, v in split_images(b, d, n).items()}

    stats = None
    if spec.get("calib") is not None:
        t0 = time.perf_counter()
        stats = llmseg.calibrate_quant_stats(model, on_device(spec["calib"]))
        sync(device)
        res["calibrate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    Q.quantize_llama_inplace(model.llava.llm, bits=8, w8a8=True, smooth_stats=stats,
                             head_dim=cfg.llava.llm.head_dim)
    sync(device)
    res["quantize_s"] = time.perf_counter() - t0
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res["resident_gb"] = torch.cuda.memory_allocated() / 1e9
    batch = on_device(spec["predict"])
    kernels = A.KERNELS + Q.KERNELS + Q.MESH_KERNELS
    for kern in kernels:
        kern.launches = 0
    first = llmseg.predict(model, batch, device=device)
    sync(device)
    res["predict_launches"] = {kern.name: kern.launches for kern in kernels}
    t0 = time.perf_counter()
    out = llmseg.predict(model, batch, device=device)
    sync(device)
    res["predict_s"] = time.perf_counter() - t0
    keys = ("pred_similarity", "pred_iou")
    res["repeat_equal"] = all(torch.equal(first[k], out[k]) for k in keys)
    res["predict"] = {k: out[k].float().cpu() for k in keys}
    if cuda:
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del model, batch, out, first
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return res


def qmesh_phase(C, make_batch, A, Q, *, device="cuda", in_place_cfg=None, full_cfg=None,
                fsdp_layers: int = MESH_FSDP_LAYERS, text_len: int = 512,
                predict_images: int = 2) -> dict:
    """A quantized LLaMA on the (dp, fsdp, tp) mesh with both ranks on this
    card over gloo, after the one-process references (``mesh_phase``'s
    recipe).

    qmesh_in_place: the cut model (``cut_config``), float32.  W8A8
    ``predict`` at tp=2 (unfolded, 4 images) equal to one process's on the
    card to the bit, with the launches a rank of Q1 (RMS form at q/k/v and
    gate/up, forms (a) and (b) at o and down), Q2 (w8a8_linear at the
    column split, its int32 output at the row split) and the standalone
    rescale; then QLoRA (LoRA rank 8, its B and the selection head's
    biases drawn nonzero, remat "dots") int8 at tp=2 and int4 at fsdp=2:
    two Trainer steps each against one process's, the loss terms, every
    trainable gradient gathered whole and the trainables after, within
    MESH_LIMIT (``mesh_phase``'s gates), kernels A, C, D at H / tp heads.

    qmesh: llmseg_7b in bf16.  W8A8 ``predict`` at tp=2 (32 layers, batch
    ``predict_images``) with the SmoothQuant fold from a calibration
    forward on the mesh, against one process's (its own calibration):
    ranks equal, max |diff|, seconds a call, peak memory a rank, the
    launches; a QLoRA int8 step at tp=2 (32 layers) and an int4 step at
    fsdp=2 (LLaMA cut to ``fsdp_layers``): the loss gap to one process
    within MESH_LOSS_GAP, seconds a step, the share of the last step in
    gloo's collectives, peak memory a rank."""
    import shutil
    import tempfile

    import torch

    cuda = torch.device(device).type == "cuda"
    in_cfg = in_place_cfg or cut_config(C)
    full = full_cfg or C.llmseg_7b()
    fsdp_cfg = C.replace(full, llava=C.replace(full.llava, llm=C.replace(
        full.llava.llm, num_layers=min(fsdp_layers, full.llava.llm.num_layers))))
    bf16 = "bfloat16" if cuda else "float32"
    root = tempfile.mkdtemp(prefix="qmesh_")

    def batches(cfg, images, seed):
        return [make_batch(cfg, num_images=images, rows_per_image=1, text_len=text_len,
                           seed=seed + i, device="cpu") for i in range(2)]

    def one_batch(cfg, images, seed):
        return make_batch(cfg, num_images=images, rows_per_image=1, text_len=text_len,
                          seed=seed, device="cpu")

    log = os.path.join(root, "log")
    base = dict(jitter=False, grads=False, params=False, timed=False, log_dir=log)
    in_place = dict(base, cfg=in_cfg, dtype="float32", seed=6, batches=batches(in_cfg, 2, 60),
                    jitter=True, grads=True, params=True)
    runs = [dict(name="in_place_w8a8_tp2", kind="w8a8_predict", mesh=(1, 1, 2), cfg=in_cfg,
                 dtype="float32", seed=7, predict=one_batch(in_cfg, 4, 65)),
            dict(in_place, name="in_place_int8_tp2", mesh=(1, 1, 2), bits=8),
            dict(in_place, name="in_place_int4_fsdp2", mesh=(1, 2, 1), bits=4),
            dict(name="full_w8a8_tp2", kind="w8a8_predict", mesh=(1, 1, 2), cfg=full,
                 dtype=bf16, seed=0, predict=one_batch(full, predict_images, 70),
                 calib=one_batch(full, predict_images, 75)),
            dict(base, name="full_int8_tp2", mesh=(1, 1, 2), cfg=full, dtype=bf16, seed=0,
                 bits=8, batches=batches(full, 1, 80), timed=True),
            dict(base, name="full_int4_fsdp2", mesh=(1, 2, 1), cfg=fsdp_cfg, dtype=bf16, seed=0,
                 bits=4, batches=batches(fsdp_cfg, 2, 90), timed=True)]
    try:
        t0 = time.perf_counter()
        refs = {}
        for r in runs:
            one = qmesh_predict_subrun if r.get("kind") == "w8a8_predict" else mesh_subrun
            refs[r["name"]] = one(C, A, r, device)
        ref_s = time.perf_counter() - t0
        torch.save(runs, os.path.join(root, "inputs.pt"))
        t0 = time.perf_counter()
        mesh_ranks(root, device)
        ranks_s = time.perf_counter() - t0
        got = {r["name"]: [torch.load(os.path.join(root, f"{r['name']}_rank{k}.pt"),
                                      weights_only=False) for k in range(2)] for r in runs}
    finally:
        shutil.rmtree(root, ignore_errors=True)

    card = card_name() if cuda else None
    mesh_of = {r["name"]: dict(zip(("dp", "fsdp", "tp"), r["mesh"])) for r in runs}
    keys = ("pred_similarity", "pred_iou")
    records = {}

    def expect_w8a8(cfg, tp):
        """Launches of one W8A8 predict a rank: A at every LLaMA layer, B at
        every DINOv2 block, Q1's RMS form at q/k/v and gate/up, Q2 at the
        column split's five products (predict forms no logits); at tp > 1
        the row split's o and down through Q1 (a), (b), Q2's int32 output
        and the rescale, else through Q1's plain form and Q2."""
        if not cuda:
            return {k.name: 0 for k in A.KERNELS + Q.KERNELS + Q.MESH_KERNELS}
        L = cfg.llava.llm.num_layers
        split = 2 * L if tp > 1 else 0
        return {"flash_fwd": L, "flash_fwd_1pass": cfg.dino.depth, "flash_bwd_dq": 0,
                "flash_bwd_dkv": 0, "flash_fwd_1pass_t": 0,
                "quantize_rows": 4 * L - split, "w8a8_linear": 7 * L - split,
                "row_absmax": split, "quantize_rows_scaled": split, "w8a8_int32": split,
                "w8a8_epilogue": split}

    for name, cfg in (("in_place_w8a8_tp2", in_cfg), ("full_w8a8_tp2", full)):
        pair, one = got[name], refs[name]
        r0 = pair[0]
        diff = {k: (r0["predict"][k] - one["predict"][k]).abs().max().item() for k in keys}
        rec = {"phase": "qmesh_in_place" if name.startswith("in_place") else "qmesh",
               "run": name, "config": ("llmseg_7b widths, towers 2-3 blocks, LLaMA 2 layers"
                                       if name.startswith("in_place") else "llmseg_7b"),
               "dtype": "float32" if name.startswith("in_place") else bf16,
               "mode": "W8A8" + (", SmoothQuant fold from a calibration forward on the mesh"
                                 if "calib" in runs[[r["name"] for r in runs].index(name)]
                                 else ", unfolded"),
               "backend": "gloo", "ranks_on_one_card": 2, "mesh": mesh_of[name],
               "images_a_rank": r0["predict"]["pred_similarity"].shape[0],
               "max_abs_diff_vs_one_process": diff,
               "equal_to_one_process_to_the_bit": all(
                   torch.equal(r0["predict"][k], one["predict"][k]) for k in keys),
               "ranks_equal": all(torch.equal(pair[0]["predict"][k], pair[1]["predict"][k])
                                  for k in keys),
               "repeat_equal": all(r["repeat_equal"] for r in pair) and one["repeat_equal"],
               "launches_a_rank": r0["predict_launches"],
               "launches_one_process": one["predict_launches"],
               "expected": expect_w8a8(cfg, 2), "expected_one_process": expect_w8a8(cfg, 1),
               "predict_s": [r["predict_s"] for r in pair], "predict_s_one_process":
               one["predict_s"], "calibrate_s": [r.get("calibrate_s") for r in pair],
               "quantize_s": [r["quantize_s"] for r in pair],
               "peak_gb_a_rank": [r.get("peak_gb") for r in pair],
               "resident_gb_a_rank": [r.get("resident_gb") for r in pair],
               "peak_gb_one_process": one.get("peak_gb"), "card": card,
               "seconds_ranks": ranks_s, "seconds_references": ref_s}
        finite = all(math.isfinite(v) for r in pair for f in r["predict"].values()
                     for v in (f.min().item(), f.max().item()))
        ok = (finite and rec["ranks_equal"] and rec["repeat_equal"]
              and all(r["predict_launches"] == rec["expected"] for r in pair)
              and one["predict_launches"] == rec["expected_one_process"])
        if name.startswith("in_place"):
            ok = ok and rec["equal_to_one_process_to_the_bit"]
        else:
            # each side calibrates on its own: the mesh's float sums over tp
            # move the statistics by ulps, so codes may flip; the bf16 gate
            atol, rtol = BF16_TOL if cuda else F32_TOL
            worst = max((r0["predict"][k] - one["predict"][k]).abs().sub(
                atol + rtol * one["predict"][k].abs()).max().item() for k in keys)
            rec.update(atol=atol, rtol=rtol, worst_over_gate=worst)
            ok = ok and worst <= 0
        rec["ok"] = bool(ok)
        emit(rec)
        records[name] = rec

    lr = C.TrainConfig().lr
    llm = in_cfg.llava.llm
    for name, tp in (("in_place_int8_tp2", 2), ("in_place_int4_fsdp2", 1)):
        pair, ref = got[name], refs[name]
        rec = {"phase": "qmesh_in_place", **mesh_in_place_gates(
            pair, ref, A, in_cfg, tp, lr, cuda, mode=f"QLoRA int{8 if '8' in name else 4}")}
        rec.update(run=name, mesh=mesh_of[name], heads_expected=llm.num_heads // tp,
                   seconds_ranks=ranks_s, seconds_references=ref_s, card=card)
        emit(rec)
        records[name] = rec
    for name, tp, cfg in (("full_int8_tp2", 2, full), ("full_int4_fsdp2", 1, fsdp_cfg)):
        rec = {"phase": "qmesh", **mesh_full_gates(got[name], refs[name], A, cfg, full, tp,
                                                   bf16, cuda, text_len)}
        rec.update(run=name, mode=f"QLoRA int{8 if '8' in name else 4}", card=card)
        emit(rec)
        records[name] = rec
    failed = [name for name, rec in records.items() if not rec["ok"]]
    if failed:
        raise SystemExit(f"the quantized mesh phases' gates failed: {failed}")
    return records


def rle_phase(gen, images, device="cuda") -> dict:
    """AMG ``finish`` with NMS off (``gen`` opened that way) on each image,
    once on the native RLE codec and once on the numpy path
    (``LLMSEG_NO_NATIVE``) from the same ``submit``: the annotations equal,
    and the ms of each."""
    from llmseg_tpu_torch.native import rle as native
    t0 = time.perf_counter()
    native.build(force=True)
    build_s = time.perf_counter() - t0
    per = []
    ok = True
    saved = os.environ.pop("LLMSEG_NO_NATIVE", None)
    try:
        for img in images:
            h = gen.submit(img)
            gen.prefetch(h)
            sync(device)
            t0 = time.perf_counter()
            anns_native = gen.finish(h)
            t1 = time.perf_counter()
            os.environ["LLMSEG_NO_NATIVE"] = "1"
            try:
                anns_numpy = gen.finish(h)
            finally:
                os.environ.pop("LLMSEG_NO_NATIVE")
            t2 = time.perf_counter()
            same = anns_native == anns_numpy
            ok = ok and same and len(anns_native) > 1
            per.append({"hw": list(img.shape[:2]), "annotations": len(anns_native),
                        "finish_native_ms": (t1 - t0) * 1e3, "finish_numpy_ms": (t2 - t1) * 1e3,
                        "equal": same})
    finally:
        if saved is not None:
            os.environ["LLMSEG_NO_NATIVE"] = saved
    rec = {"phase": "rle", "amg": "filters opened, NMS off (box_nms_thresh 1.0)",
           "native_build_s": build_s, "images": per, "ok": ok}
    emit(rec)
    if not ok:
        raise SystemExit(f"the rle phase failed: {rec}")
    return rec


MPT_LIMIT = 1e-4              # forward_mpt at mpt_tiny, card vs CPU, float32, max|ref|


def mpt_phase(C, device="cuda") -> dict:
    """``Llava.forward_mpt`` (CLIP tower, projector, splice, MPT) at
    ``llava_tiny`` + ``mpt_tiny`` on the card against the same weights on
    the CPU, float32; ALiBi and MultiQueryAttention (kv_n_heads 1) with a
    padding mask on the bare MPT too."""
    import numpy as np
    import torch
    from llmseg_tpu_torch.models import mpt as M
    from llmseg_tpu_torch.models.llava import Llava
    from llmseg_tpu_torch.models.llmseg import random_init_

    lcfg = C.llava_tiny()
    # float32 products stay float32 on the card (no TF32), as main() sets
    # for every phase
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = {"phase": "mpt", "config": "llava_tiny + mpt_tiny", "limit": MPT_LIMIT}
    rng = np.random.RandomState(7)
    ids = torch.from_numpy(rng.randint(4, 200, size=(2, 40)))
    images = torch.from_numpy(rng.randn(2, 28, 28, 3).astype(np.float32))
    pos = torch.tensor([1, 3], dtype=torch.int32)
    mask = torch.ones(2, 40, dtype=torch.bool)
    mask[1, -7:] = False
    errs = {}
    for name, mcfg in (("alibi", C.mpt_tiny(lcfg.llm.vocab_size)),
                       ("mqa_qk_ln_clip", C.replace(C.mpt_tiny(lcfg.llm.vocab_size),
                                                    kv_n_heads=1, qk_ln=True, clip_qkv=0.3))):
        cpu = random_init_(Llava(lcfg, mpt_cfg=mcfg, device="cpu"),
                           torch.Generator().manual_seed(3))
        gpu = Llava(lcfg, mpt_cfg=mcfg, device=device)
        gpu.load_state_dict(cpu.state_dict())
        with torch.no_grad():
            h_ref = cpu.forward_mpt(input_ids=ids, image_pos=pos, images=images)
            h = gpu.forward_mpt(input_ids=ids.to(device), image_pos=pos.to(device),
                                images=images.to(device))
            l_ref = M.logits(cpu.llm, cpu.llm(input_ids=ids, attention_mask=mask))
            lg = M.logits(gpu.llm, gpu.llm(input_ids=ids.to(device),
                                            attention_mask=mask.to(device)))
        errs[name] = {"hidden": ((h.cpu() - h_ref).abs().max() / h_ref.abs().max()).item(),
                      "logits_masked": ((lg.cpu() - l_ref).abs().max()
                                        / l_ref.abs().max()).item()}
    rec["max_err_vs_max_ref"] = errs
    rec["ok"] = all(v <= MPT_LIMIT for e in errs.values() for v in e.values())
    emit(rec)
    if not rec["ok"]:
        raise SystemExit(f"forward_mpt on the card disagrees with the CPU: {rec}")
    return rec


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from llmseg_tpu_torch import config as C
    from llmseg_tpu_torch import serving as SV
    from llmseg_tpu_torch.cli import prepare as CP
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
    timed.update(mesh_quant_kernel_phase(Q))
    sft_kernels = sft_kernel_phase(A)

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
    sft_in_place(C, A)
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
    # layout: the data layer, the loader, the Trainer and the val loop; then
    # the same through the port's command line, with validate and prepare
    data = data_phase(C, A)
    torch.cuda.empty_cache()
    cli_phase(C, all_kernels + (Q.W8A8_EPILOGUE,), data_peak_gb=data["peak_mem_gb"])
    torch.cuda.empty_cache()

    # LLaVA SFT through cli.sft (the slice's path: A, C, D every step), the
    # Trainer's data-parallel path at world size 1, and MPT
    sft = sft_phase(C, A)
    sft_launches = sft[0]["launches_per_step"][-1]
    ddp_phase(C, make_batch, A)
    mesh = mesh_phase(C, make_batch, A)
    qmesh = qmesh_phase(C, make_batch, A, Q)
    mpt_phase(C)
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
    rle_phase(AMG.AutomaticMaskGenerator(amg["model"], C.sam_vit_h(), C.AMGConfig(
        pred_iou_thresh=-1e9, stability_score_thresh=-1.0, box_nms_thresh=1.0)), amg["images"])
    # the crop cascade with survivors, on a SAM whose frames take E, F and G
    crops = amg_crops_phase(C, S, AMG, CP, all_kernels)

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
                               "rescale (XLA code)"),
               "row_absmax": ("llmseg_tpu_torch/csrc/quant.cu",
                              "llmseg_tpu/ops/quant.py:161 quantize_activation's row max, "
                              "all-reduced over tp by GSPMD at o and down (XLA code)"),
               "quantize_rows_scaled": ("llmseg_tpu_torch/csrc/quant.cu",
                                        "llmseg_tpu/ops/quant.py:164 quantize_activation's "
                                        "int8 values for the row scale (XLA code)"),
               "w8a8_int32": ("llmseg_tpu_torch/csrc/w8a8_gemm.cu",
                              "llmseg_tpu/ops/quant.py:199 qdense_act's s8 x s8 -> s32 dot, "
                              "its partial sums summed over tp by GSPMD (XLA code)"),
               "w8a8_epilogue": ("llmseg_tpu_torch/csrc/quant.cu",
                                 "llmseg_tpu/ops/quant.py:203 qdense_act's rescale after the "
                                 "int32 sum (XLA code)")}
    # this slice's path: the quantized mesh at tp = 2, a rank's W8A8 predict
    # (batch 2, 7B) and its QLoRA int8 step (32 layers)
    q_pred = qmesh["full_w8a8_tp2"]["launches_a_rank"]
    q_step = qmesh["full_int8_tp2"]["launches_per_step_a_rank"][0][-1]
    for name in ("row_absmax", "quantize_rows_scaled", "w8a8_int32", "w8a8_epilogue"):
        launches[name] = q_pred[name]
    rows = []
    for name, (src, rep) in sources.items():
        r = timed[name]
        err = r["max_abs_err"]
        if name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            # this slice's path: a cli.sft LoRA step at 7B, and the kernel at its shape
            r = dict(r, sft_launches_per_step=sft_launches[name],
                     sft_shape={k: sft_kernels[name][k] for k in (
                         "ms", "bound_ms", "plain_ms", "library_ms", "device_ms",
                         "library_device_ms") if k in sft_kernels[name]})
        if name in ("flash_fwd", "flash_fwd_1pass", "flash_bwd_dq", "flash_bwd_dkv"):
            # the mesh phase: a tp=2 step at 7B on one rank, A, C, D at H / 2 heads
            tp2 = mesh["full_tp2"]
            r = dict(r, mesh_tp2_launches_per_step_a_rank=tp2["launches_per_step_a_rank"][0][-1][
                name], **({"mesh_tp2_heads": tp2["heads"][-1][name]} if name in MESH_POS else {}))
        if name in crops["launches_per_frame"] and name in ("relpos_fwd", "relpos_window",
                                                            "factored_decode"):
            # the crop cascade with survivors: a frame of crop_sam
            r = dict(r, amg_crops_launches_per_frame=crops["launches_per_frame"][name])
        if name in q_pred:
            r = dict(r, qmesh_tp2_predict_launches_a_rank=q_pred[name],
                     **({"qmesh_tp2_qlora_step_launches_a_rank": q_step[name]}
                        if name in q_step else {}))
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                     "launches": launches[name],
                     "max_abs_err": max(err.values()) if isinstance(err, dict) else err,
                     "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                     **{k: r[k] for k in ("device_ms", "library_device_ms", "ex2_bound_ms",
                                          "int_mm_q2_device_ms", "sft_launches_per_step",
                                          "sft_shape", "mesh_tp2_launches_per_step_a_rank",
                                          "mesh_tp2_heads", "qmesh_tp2_predict_launches_a_rank",
                                          "qmesh_tp2_qlora_step_launches_a_rank",
                                          "amg_crops_launches_per_frame") if k in r}})
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
