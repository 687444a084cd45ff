"""Times kernels A and J of the port and predict through J, for one checkout.

Run on a machine with one CUDA card, once per checkout, in turns, so that
two trees compare within one call (parent, change, change, parent):

    python3 scripts/compare_trees.py <checkout root> <label>

It builds kernels A, B and J of that checkout, prints one JSON line: A at
(128, 767, 767, 128) causal and J at (64, 4097, 4097, 64), bf16, on the
event clock (ms a call, back to back), A's host time a call, and
llmseg_7b predict (bf16, 4 images, text_len 512, LayerScale folded) with
the non-causal forward on J: ms/step over 5 steps, and one step's device
time under torch.profiler, in all and for J's kernels.  It imports only
the checkout's ``llmseg_tpu_torch``."""
import json, math, os, sys, time
root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)
import torch
from torch.profiler import ProfilerActivity, profile
from llmseg_tpu_torch import config as C
from llmseg_tpu_torch.data.synthetic import make_batch
from llmseg_tpu_torch.models import llmseg
from llmseg_tpu_torch.ops import attention as A, kernels

kernels.build(["flash_fwd", "flash_fwd_1pass", "flash_fwd_1pass_t"], force=True)


def ev_ms(fn, it):
    fn(); torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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


out = {"tree": sys.argv[2]}
qa, ka, va = inputs(128, 767, 128)
run_a = lambda: A.flash_fwd(qa, ka, va, causal=True)
qj, kj, vj = inputs(64, 4097, 64)
run_j = lambda: A.flash_fwd_1pass_t(qj, kj, vj)
out["a_ms"], out["j_ms"] = ev_ms(run_a, 50), ev_ms(run_j, 20)
out["a_host_us"] = host_us(run_a)

cfg = C.llmseg_7b()
model = llmseg.fold_frozen_inplace(llmseg.init(cfg, seed=0, device="cuda", dtype=torch.bfloat16))
batch = make_batch(cfg, num_images=4, rows_per_image=1, text_len=512, seed=0)
A.ONEPASS_T = True
llmseg.predict(model, batch)
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(5):
    llmseg.predict(model, batch)
torch.cuda.synchronize()
out["predict_onepass_t_ms"] = (time.perf_counter() - t0) * 1e3 / 5
# the profiler last: it adds host cost to what follows
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    llmseg.predict(model, batch)
    torch.cuda.synchronize()
ev = prof.key_averages()
attr = "self_device_time_total" if hasattr(ev[0], "self_device_time_total") else "self_cuda_time_total"
times = [(e.key, getattr(e, attr) / 1e3) for e in ev if getattr(e, attr) > 0]
out["predict_onepass_t_device_ms"] = sum(t for _, t in times)
out["kernel_j_family_device_ms"] = sum(t for k, t in times
                                       if "flash_fwd_1pass_t" in k or "key_norm_max" in k)
print(json.dumps(out), flush=True)
