"""Times kernels A, B, J, C, D, E, F, G, H and I of the port, predict
(through B, and through J), one LoRA train step, one AMG image and one
pixel-decoder evaluate, for one checkout.

Run on a machine with one CUDA card, once per checkout, in turns, so that
two trees compare within one call (parent, change, change, parent):

    python3 scripts/compare_trees.py <checkout root> <label> [parts]

``parts`` is a comma-separated subset of
``fwd,predict,bwd,train,onepass,window,amg_kernels,twoway`` (all by default).  It builds the
kernels of that checkout that the parts run and prints one JSON line:
  fwd      A at (128, 767, 767, 128) causal and J at (64, 4097, 4097, 64),
           bf16, on the event clock (ms a call, back to back), and A's host
           time a call;
  predict  llmseg_7b predict (bf16, 4 images, text_len 512, LayerScale
           folded) with the non-causal forward on J: ms/step over 5 steps,
           and one step's device time under torch.profiler, in all and for
           J's kernels;
  bwd      C and D at (32, 767, 767, 128) causal, bf16, on the event clock
           and on the device clock (events around a burst of calls queued
           behind a spin kernel, so that the host's gaps are not counted);
  train    the LoRA train step at llmseg_7b (bf16, rank 8, 1 image, 1 row,
           text_len 512, remat "dots", through the Trainer): ms/step over
           3 steps, and one step's device time under torch.profiler, in all
           and for C's and D's kernels (the profiler may drop kernels
           launched through ctypes, so those two are lower bounds);
  onepass  B at (64, 4097, 4097, 64), bf16, on the device clock, its kmax
           (max_j |k_j|) included wherever the checkout computes it; the
           default llmseg_7b predict (the non-causal forward on B): ms/step
           over 5 steps and one step's device time under torch.profiler, in
           all and for B's kernels;
  window   F at (400, 196, 196, 80) and (3200, 196, 196, 80) (an AMG image's
           windowed layer, and an evaluate's, 8 images a launch), bf16,
           random nonzero tables, on the device clock; one default AMG image
           at sam_vit_h (bf16, seed 0, the third of chip_smoke's synthetic
           images): ms over 3 images after 2 of warm-up, and one image's
           device time under torch.profiler, in all and for F's kernels;
  amg_kernels  E at (16, 4096, 4096, 80) (an AMG image's global layer), bf16,
           random nonzero tables, and G on a replayed chunk (sam_vit_h's
           decoder, random weights, 64 prompts of 7 tokens, L = 4096, bf16),
           both on the device clock; one default AMG image as in window: ms
           over 3 images after 2 of warm-up, and one image's device time
           under torch.profiler, in all and for E's and G's kernels;
  twoway   H (sam_vit_h's decoder, random weights, bf16, L = 4096) at 8
           prompts of 6 tokens with a base each (the pixel evaluate's
           decode), at 64 x 7 with a base each and with one shared base
           (factored=False), and I at 64 x 7, each on the device clock and
           on the event clock (the wrapper's host time included); one
           pixel-decoder evaluate (llmseg_7b + sam_vit_h, bf16, 8 images,
           text_len 512, 32 new tokens, as chip_smoke's pixel phase): ms
           over 3 after 1 of warm-up, and one evaluate's device time under
           torch.profiler, in all and for H's kernels (the decode's
           ``tw_`` and ``fd_`` kernels: no other decoder runs there).
It imports only the checkout's ``llmseg_tpu_torch``."""
import json, math, os, sys, time
root = os.path.abspath(sys.argv[1])
parts = set((sys.argv[3] if len(sys.argv) > 3
              else "fwd,predict,bwd,train,onepass,window,amg_kernels,twoway").split(","))
sys.path.insert(0, root)
os.chdir(root)
import torch
from torch.profiler import ProfilerActivity, profile
from llmseg_tpu_torch import config as C
from llmseg_tpu_torch.data.synthetic import make_batch
from llmseg_tpu_torch.models import llmseg
from llmseg_tpu_torch.ops import attention as A, kernels

names = set()
if parts & {"fwd", "predict"}:
    names |= {"flash_fwd", "flash_fwd_1pass", "flash_fwd_1pass_t"}
if parts & {"bwd", "train"}:
    names |= {"flash_fwd", "flash_fwd_1pass", "flash_bwd_dq", "flash_bwd_dkv"}
if "onepass" in parts:
    names |= {"flash_fwd", "flash_fwd_1pass"}
if parts & {"window", "amg_kernels"}:
    names |= {"relpos_fwd", "relpos_window", "factored_decode"}
if "twoway" in parts:
    names |= {"flash_fwd", "relpos_fwd", "relpos_window", "twoway_fused"}
kernels.build(sorted(names), force=True)


def ev_ms(fn, it):
    fn(); torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(it):
        fn()
    e.record(); torch.cuda.synchronize()
    return s.elapsed_time(e) / it


def dev_ms(fn, it):
    """As chip_smoke.device_ms: the calls queued behind a spin kernel that
    outlasts their host time, timed by events around them."""
    fn(); torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(); torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (2 * it * call_s + 0.005)))
    s.record()
    for _ in range(it):
        fn()
    e.record(); torch.cuda.synchronize()
    return s.elapsed_time(e) / it


def host_us(fn, it=200):
    fn(); torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(it):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / it


def inputs(BH, T, D):
    g = torch.Generator(device="cuda").manual_seed(0)
    kw = dict(device="cuda", dtype=torch.float32, generator=g)
    q, k, v = (torch.randn(BH, T, D, **kw).to(torch.bfloat16) for _ in range(3))
    q = (q * torch.tensor(A.LOG2E / math.sqrt(D), dtype=torch.bfloat16, device="cuda")).contiguous()
    return q, k.contiguous(), v.contiguous()


def profiled(fn, families):
    """Device ms of one call of fn under torch.profiler, in all and for the
    kernels whose names contain each family's substrings."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    attr = ("self_device_time_total" if hasattr(ev[0], "self_device_time_total")
            else "self_cuda_time_total")
    times = [(e.key, getattr(e, attr) / 1e3) for e in ev if getattr(e, attr) > 0]
    out = {"device_ms": sum(t for _, t in times)}
    for fam, subs in families.items():
        out[fam] = sum(t for k, t in times if any(s in k for s in subs))
    return out


out = {"tree": sys.argv[2], "parts": sorted(parts)}
if "fwd" in parts:
    qa, ka, va = inputs(128, 767, 128)
    run_a = lambda: A.flash_fwd(qa, ka, va, causal=True)
    qj, kj, vj = inputs(64, 4097, 64)
    run_j = lambda: A.flash_fwd_1pass_t(qj, kj, vj)
    out["a_ms"], out["j_ms"] = ev_ms(run_a, 50), ev_ms(run_j, 20)
    out["a_host_us"] = host_us(run_a)
    del qa, ka, va, qj, kj, vj

if "bwd" in parts:
    q, k, v = inputs(32, 767, 128)
    do = torch.randn(q.shape, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(1)).to(q.dtype)
    o, lse = A.flash_fwd(q, k, v, causal=True, with_lse=True)
    run_c = lambda: A.flash_bwd_dq(q, k, v, o, do, lse, causal=True)
    _, delta = run_c()
    run_d = lambda: A.flash_bwd_dkv(q, k, v, do, lse, delta, causal=True)
    out["c_ms"], out["d_ms"] = ev_ms(run_c, 50), ev_ms(run_d, 50)
    out["c_device_ms"], out["d_device_ms"] = dev_ms(run_c, 20), dev_ms(run_d, 20)
    del q, k, v, do, o, lse, delta

if "onepass" in parts:
    qb, kb, vb = inputs(64, 4097, 64)
    out["b_device_ms"] = dev_ms(lambda: A.flash_fwd_1pass(qb, kb, vb), 20)
    del qb, kb, vb

if "amg_kernels" in parts:
    from llmseg_tpu_torch.ops import relpos_attention as R
    from llmseg_tpu_torch.ops import twoway_kernel as TK
    from llmseg_tpu_torch.models.sam import sam as SAM_
    from llmseg_tpu_torch.models.sam.mask_decoder import MaskDecoder
    g = torch.Generator(device="cuda").manual_seed(0)
    kw = dict(device="cuda", dtype=torch.float32, generator=g)
    qe, ke, ve = (torch.randn(16, 4096, 80, **kw).to(torch.bfloat16) for _ in range(3))
    qe = (qe * torch.tensor(A.LOG2E / math.sqrt(80), dtype=torch.bfloat16,
                            device="cuda")).contiguous()
    rhe, rwe = ((torch.randn(16, 4096, 64, **kw) * A.LOG2E).to(torch.bfloat16).contiguous()
                for _ in range(2))
    out["e_device_ms"] = dev_ms(lambda: R.relpos_fwd(qe, ke, ve, rhe, rwe), 20)
    del qe, ke, ve, rhe, rwe
    dec = MaskDecoder(C.sam_vit_h().decoder, device="cuda", dtype=torch.bfloat16)
    SAM_.random_init_(dec, g)
    base, pe = ((torch.randn(*sh, **kw) * 0.5).to(torch.bfloat16)
                for sh in ((1, 64, 64, 256), (64, 64, 256)))
    tok = (torch.randn(64, 7, 256, **kw) * 0.5).to(torch.bfloat16)
    gcache = {}
    with torch.inference_mode():
        out["g_device_ms"] = dev_ms(lambda: TK.factored_decode(dec.transformer, dec, base, pe,
                                                               tok, 8, cache=gcache), 10)
        out["g_ms"] = ev_ms(lambda: TK.factored_decode(dec.transformer, dec, base, pe, tok, 8,
                                                       cache=gcache), 10)
    del dec, gcache, base, pe, tok
    torch.cuda.empty_cache()

if "twoway" in parts:
    from llmseg_tpu_torch.ops import twoway_kernel as TK
    from llmseg_tpu_torch.models.sam import sam as SAM_
    from llmseg_tpu_torch.models.sam.mask_decoder import MaskDecoder
    g = torch.Generator(device="cuda").manual_seed(0)
    kw = dict(device="cuda", dtype=torch.float32, generator=g)
    dec = MaskDecoder(C.sam_vit_h().decoder, device="cuda", dtype=torch.bfloat16)
    SAM_.random_init_(dec, g)
    with torch.no_grad():
        for prm in dec.parameters():
            if prm.ndim == 1:
                prm.add_(0.1 * torch.randn(prm.shape, **kw).to(torch.bfloat16))
    pe = (torch.randn(64, 64, 256, **kw) * 0.5).to(torch.bfloat16)
    with torch.inference_mode():
        for label, P, N, Bi, head in (("h8x6", 8, 6, 8, True), ("h64x7", 64, 7, 64, True),
                                      ("h64x7_shared", 64, 7, 1, True),
                                      ("i64x7", 64, 7, 64, False)):
            base = (torch.randn(Bi, 64, 64, 256, **kw) * 0.5).to(torch.bfloat16)
            tok = (torch.randn(P, N, 256, **kw) * 0.5).to(torch.bfloat16)
            if head:
                run = lambda: TK.fused_decode_apply(dec.transformer, dec, base, pe, tok, 8,
                                                    factored=False)
            else:
                run = lambda: TK.fused_twoway_apply(dec.transformer, base, pe, tok, 8)
            out[f"{label}_device_ms"] = dev_ms(run, 10)
            out[f"{label}_ms"] = ev_ms(run, 10)
            del base, tok
    del dec, pe
    torch.cuda.empty_cache()
    from llmseg_tpu_torch.models import pixel_decoder as PD
    from llmseg_tpu_torch.models.sam import sam as SAM
    pcfg, scfg = C.llmseg_7b(), C.sam_vit_h()
    pmodel = llmseg.init(pcfg, seed=0, device="cuda", dtype=torch.bfloat16)
    sam_model = SAM.init(scfg, seed=0, device="cuda", dtype=torch.bfloat16)
    pbatch = make_batch(pcfg, num_images=8, rows_per_image=1, text_len=512, seed=8)
    gi = torch.Generator(device="cuda").manual_seed(9)
    images_sam = SAM.preprocess(torch.randint(0, 256, (8, 768, 1024, 3), device="cuda",
                                              generator=gi), scfg)
    evaluate = lambda: PD.evaluate(pmodel, sam_model, images_sam=images_sam, max_new_tokens=32,
                                   images_clip=pbatch["images_clip"],
                                   input_ids=pbatch["input_ids"], image_pos=pbatch["image_pos"],
                                   input_hw=(768, 1024), original_hw=(480, 640))
    evaluate()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        evaluate()
    torch.cuda.synchronize()
    out["evaluate_ms"] = (time.perf_counter() - t0) * 1e3 / 3

if parts & {"window", "amg_kernels"}:
    from llmseg_tpu_torch.ops import relpos_attention as R
    for BH in ((400, 3200) if "window" in parts else ()):
        g = torch.Generator(device="cuda").manual_seed(0)
        kw = dict(device="cuda", dtype=torch.float32, generator=g)
        qf, kf, vf = (torch.randn(BH, 196, 80, **kw).to(torch.bfloat16) for _ in range(3))
        qf = (qf * torch.tensor(A.LOG2E / math.sqrt(80), dtype=torch.bfloat16,
                                device="cuda")).contiguous()
        rh, rw = ((torch.randn(BH, 196, 14, **kw) * A.LOG2E).to(torch.bfloat16).contiguous()
                  for _ in range(2))
        out[f"f{BH}_device_ms"] = dev_ms(lambda: R.relpos_window(qf, kf, vf, rh, rw), 20)
        del qf, kf, vf, rh, rw
    import numpy as np
    from llmseg_tpu_torch.models.sam import amg as AMG, sam as SAM
    scfg = C.sam_vit_h()
    sam_model = SAM.init(scfg, seed=0, device="cuda", dtype=torch.bfloat16)
    gen = AMG.AutomaticMaskGenerator(sam_model, scfg)
    rng = np.random.RandomState(11)
    yy, xx = np.mgrid[0:1024, 0:1024]
    img = np.zeros((1024, 1024, 3), np.float32)
    for _ in range(6):
        cy, cx, r = rng.rand() * 1024, rng.rand() * 1024, 60 + rng.rand() * 200
        img += (((yy - cy) ** 2 + (xx - cx) ** 2) < r * r)[..., None] * rng.rand(3) * 120
    img = np.clip(img + rng.rand(1024, 1024, 3) * 40, 0, 255).astype(np.uint8)
    for _ in range(2):
        gen.generate(img)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        gen.generate(img)
    torch.cuda.synchronize()
    out["amg_image_ms"] = (time.perf_counter() - t0) * 1e3 / 3

if parts & {"predict", "onepass"}:
    cfg = C.llmseg_7b()
    model = llmseg.fold_frozen_inplace(llmseg.init(cfg, seed=0, device="cuda",
                                                   dtype=torch.bfloat16))
    batch = make_batch(cfg, num_images=4, rows_per_image=1, text_len=512, seed=0)
if "onepass" in parts:
    llmseg.predict(model, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        llmseg.predict(model, batch)
    torch.cuda.synchronize()
    out["predict_ms"] = (time.perf_counter() - t0) * 1e3 / 5
if "predict" in parts:
    A.ONEPASS_T = True
    llmseg.predict(model, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        llmseg.predict(model, batch)
    torch.cuda.synchronize()
    out["predict_onepass_t_ms"] = (time.perf_counter() - t0) * 1e3 / 5
    A.ONEPASS_T = False

if "train" in parts:
    from llmseg_tpu_torch.train.trainer import Trainer
    cfg = C.llmseg_7b()
    exp = C.ExperimentConfig(model=cfg, train=C.TrainConfig(
        warmup_steps=0, grad_accum_steps=1, lora=C.LoraConfig(rank=8),
        log_dir=os.path.join(root, "chiprun_out", "compare_train_runs")))
    trainer = Trainer(exp)
    tbatch = make_batch(cfg, num_images=1, rows_per_image=1, text_len=512, seed=0)
    for _ in range(2):
        trainer.step(tbatch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        trainer.step(tbatch)
    torch.cuda.synchronize()
    out["train_step_ms"] = (time.perf_counter() - t0) * 1e3 / 3

# the profiler last: it adds host cost to what follows
if "onepass" in parts:
    prof = profiled(lambda: llmseg.predict(model, batch),
                    {"kernel_b": ("flash_fwd_1pass_bf16", "key_norm_max")})
    out["predict_device_ms"] = prof["device_ms"]
    out["kernel_b_family_device_ms"] = prof["kernel_b"]
if parts & {"window", "amg_kernels"}:
    prof = profiled(lambda: gen.generate(img), {"kernel_e": ("relpos_fwd",),
                                                "kernel_f": ("relpos_window",),
                                                "kernel_g": ("fd_",)})
    out["amg_image_device_ms"] = prof["device_ms"]
    for k in ("kernel_e", "kernel_f", "kernel_g"):
        out[f"{k}_family_device_ms"] = prof[k]
if "twoway" in parts:
    prof = profiled(evaluate, {"kernel_h": ("tw_", "fd_")})
    out["evaluate_device_ms"] = prof["device_ms"]
    out["kernel_h_family_device_ms"] = prof["kernel_h"]
if "predict" in parts:
    A.ONEPASS_T = True
    prof = profiled(lambda: llmseg.predict(model, batch),
                    {"kernel_j": ("flash_fwd_1pass_t", "key_norm_max")})
    A.ONEPASS_T = False
    out["predict_onepass_t_device_ms"] = prof["device_ms"]
    out["kernel_j_family_device_ms"] = prof["kernel_j"]
if "train" in parts:
    prof = profiled(lambda: trainer.step(tbatch),
                    {"kernel_c": ("flash_bwd_dq",), "kernel_d": ("flash_bwd_dkv",)})
    out["train_step_device_ms"] = prof["device_ms"]
    out["train_kernel_c_device_ms"] = prof["kernel_c"]
    out["train_kernel_d_device_ms"] = prof["kernel_d"]
print(json.dumps(out), flush=True)
