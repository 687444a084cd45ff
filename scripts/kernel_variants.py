"""Times design choices of kernels C, D, E, F, G, H and I against the ones
the port keeps.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/kernel_variants.py [names]

It builds, beside the kept kernels, variants made from the same sources by
replacing text in them (a variant's constants, or the edits of a
``scripts/<variant>.edits`` file):
  flash_bwd_dq_64rows      kernel C with 64 query rows a CTA (one consumer
                           warpgroup and a producer warp) instead of 128;
  flash_bwd_dkv_bq32       kernel D with 32-row query tiles instead of 64;
  relpos_window_bias_mma   kernel F adding the rel-pos bias on the tensor
                           cores (two more k16 steps of selection matrices)
                           instead of from shared memory in float32
                           (scripts/relpos_window_bias_mma.edits);
  relpos_window_one_stage  kernel F with one stage instead of two, so that
                           no item's loads overlap another's compute;
  relpos_fwd_grid          kernel E with one CTA a work item (a plain grid
                           of 512 CTAs at ViT-H) instead of a persistent CTA
                           an SM walking them;
  relpos_fwd_3wg           kernel E with three consumer warpgroups (192
                           query rows a work item) instead of two;
  factored_decode_two_waves, factored_decode_half_wave
                           kernel G's fused kernels with L split across twice
                           (half) as many CTAs a prompt as one wave of one
                           CTA an SM needs (csrc/factored_fused.cuh splits);
  factored_decode_upscale_4wg
                           kernel G's upscale with four consumer warpgroups
                           instead of three;
  twoway_fused_online      kernels H's and I's token-to-image attention in
                           one online sweep over L (a running maximum and
                           sum, p rounded before its normalisation) instead
                           of two (the row statistics, then p normalised
                           before it is rounded, where the TPU kernel
                           rounds it) (scripts/twoway_fused_online.edits).
An edit names a header as ``(header, text, replacement)``.  Each variant is
held against its plain version at its main shape (C and D:
B*H = 32, T = S = 767, D = 128, causal, bf16, chip_smoke.bwd_case's gate;
F: 400 and 3,200 pairs of 14 x 14 windows, D = 80, bf16,
chip_smoke.relpos_case's gate and a bitwise repeat; E: (16, 4096, 4096, 80)
and G = 40, the same gate; G: 64 prompts at L = 4096, chip_smoke.g_case's
gates, which hold each fused kernel against its record's emulation, and a
bitwise repeat; H: 8 prompts of 6 and 64 of 7 at L = 4096,
chip_smoke.twoway_case's gates, which hold each fused kernel against its
record's emulation, and a bitwise repeat) and timed on the device clock
(chip_smoke.device_ms; G and H replayed, with their fused records one at a
time), in turns with the kept kernel (kept, variant, variant, kept).  One JSON line a variant, with the spill and wgmma lines of
its ``-Xptxas -v`` report.  ``names``: a comma-separated subset (all by
default)."""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.chdir(ROOT)

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from llmseg_tpu_torch.ops import attention as A, kernels  # noqa: E402
from llmseg_tpu_torch import config as C  # noqa: E402
from llmseg_tpu_torch.ops import relpos_attention as R  # noqa: E402
from llmseg_tpu_torch.ops import twoway_kernel as TK  # noqa: E402

def read_edits(name):
    """The (text, replacement) pairs of scripts/<name>.edits: each text
    follows a line "@@ replace", its replacement a line "@@ with"."""
    with open(os.path.join(ROOT, "scripts", f"{name}.edits")) as f:
        blocks = f.read().removesuffix("\n").split("\n@@ ")[1:]
    texts = [b.split("\n", 1)[1] for b in blocks]
    assert [b.split("\n", 1)[0] for b in blocks] == ["replace", "with"] * (len(blocks) // 2)
    return list(zip(texts[0::2], texts[1::2]))


# (name, source, [(text in the source, its replacement)])
VARIANTS = [
    ("flash_bwd_dq_64rows", "flash_bwd_dq", [
        ("BQ = 128, BN = 64,", "BQ = 64, BN = 64,"),
        ("THREADS = 2 * 128 + 32;", "THREADS = 128 + 32;"),
        ("mbar_init(&bars.empty[i], 8);", "mbar_init(&bars.empty[i], 4);"),
        ("if (wg == 2) {\n    if (threadIdx.x == 256) {", "if (wg == 1) {\n    if (threadIdx.x == 128) {")]),
    ("flash_bwd_dkv_bq32", "flash_bwd_dkv", [
        ("BKV = 64, BQ = 64,", "BKV = 64, BQ = 32,")]),
    ("relpos_window_bias_mma", "relpos_window", read_edits("relpos_window_bias_mma")),
    ("relpos_window_one_stage", "relpos_window", [
        ("p.stages = 2 * p.stage + SLACK <= (uint32_t)SMEM_LIMIT ? 2 : 1;", "p.stages = 1;")]),
    ("relpos_fwd_grid", "relpos_fwd", [
        ("constexpr bool PERSISTENT = true;", "constexpr bool PERSISTENT = false;")]),
    ("relpos_fwd_3wg", "relpos_fwd", [
        ("constexpr int CWG = 2;", "constexpr int CWG = 3;")]),
    ("factored_decode_two_waves", "factored_decode", [
        ("factored_fused.cuh", "std::min<long long>(ntiles, sms / Z)",
         "std::min<long long>(ntiles, 2 * sms / Z)")]),
    ("factored_decode_half_wave", "factored_decode", [
        ("factored_fused.cuh", "std::min<long long>(ntiles, sms / Z)",
         "std::min<long long>(ntiles, sms / (2 * Z))")]),
    ("twoway_fused_online", "twoway_fused",
     [("twoway_sweeps.cuh",) + e for e in read_edits("twoway_fused_online")]),
    ("factored_decode_upscale_4wg", "factored_decode", [
        ("factored_fused.cuh", "UP_WGS = 3, UP_THREADS = 128 * UP_WGS + 32, UP_STAGES = 6;",
         "UP_WGS = 4, UP_THREADS = 128 * UP_WGS + 32, UP_STAGES = 4;")]),
]


def build_variant(name, source, edits):
    files = {}
    for edit in edits:
        fname, old, new = edit if len(edit) == 3 else (f"{source}.cu",) + tuple(edit)
        text = files.get(fname) or (kernels.CSRC / fname).read_text()
        if old not in text:
            raise SystemExit(f"{name}: {old!r} is not in csrc/{fname}")
        files[fname] = text.replace(old, new)
    # the variant's sources in a directory of their own, before csrc/ on the
    # include path: an edited header is found there first
    out = kernels.BUILD_DIR / "variants" / name
    out.mkdir(parents=True, exist_ok=True)
    files.setdefault(f"{source}.cu", (kernels.CSRC / f"{source}.cu").read_text())
    for fname, text in files.items():
        (out / fname).write_text(text)
    src = f"{source}.cu"
    so = out / f"lib{name}.so"
    cmd = [kernels._nvcc(), "-gencode", kernels.ARCH, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(out), "-I", str(kernels.CSRC),
           "-o", str(so), str(out / src)]
    rep = subprocess.run(cmd, capture_output=True, text=True)
    if rep.returncode:
        raise SystemExit(rep.stdout + rep.stderr)
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, source)
    fn.argtypes, fn.restype = kernels.SIGNATURES[source], ctypes.c_int
    err = getattr(lib, f"{source}_error_string")
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    notes, entry = [], ""
    for ln in (rep.stdout + rep.stderr).splitlines():   # each note with its function
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln
        elif "C75" in ln or ("spill stores" in ln and " 0 bytes spill stores" not in ln):
            notes.append(f"{entry[:80]}: {ln.split('ptxas info    : ')[-1].strip()[:90]}")
    return lib, notes


def bwd_turn(source, check):
    shape = dict(BH=32, T=767, S=767, D=128, causal=True, dtype=torch.bfloat16)
    if check:
        CS.bwd_case(A, repeat=True, **shape)   # raises if the variant is off
    return CS.bwd_device_times(A, **shape)[source]


def window_turn(source, check):
    if check:   # raises if the variant is off
        CS.relpos_case(R, source, BH=400, G=14, D=80, dtype=torch.bfloat16, repeat=True)
        CS.relpos_case(R, source, BH=3200, G=14, D=80, dtype=torch.bfloat16, padded=True)
    out = []
    for BH in (400, 3200):
        x = CS.relpos_inputs(R, BH, 14, 80, torch.bfloat16, 0)
        out.append(CS.device_ms(lambda: R.relpos_window(*x), 20))
    return out


def relpos_fwd_turn(source, check):
    if check:   # raises if the variant is off
        CS.relpos_case(R, source, BH=16, G=64, D=80, dtype=torch.bfloat16, repeat=True)
        CS.relpos_case(R, source, BH=16, G=40, D=80, dtype=torch.bfloat16, repeat=True)
    x = CS.relpos_inputs(R, 16, 64, 80, torch.bfloat16, 0)
    return CS.device_ms(lambda: R.relpos_fwd(*x), 20)


def g_turn(source, check):
    if check:   # raises if the variant is off
        CS.g_case(C, TK, torch.bfloat16, repeat=True)
    dec = CS.random_decoder(C, torch.bfloat16, 0)
    g = torch.Generator(device="cuda").manual_seed(1)
    base, pe = ((torch.randn(*sh, device="cuda", generator=g) * 0.5).bfloat16()
                for sh in ((1, 64, 64, 256), (64, 64, 256)))
    tok = (torch.randn(64, 7, 256, device="cuda", generator=g) * 0.5).bfloat16()
    cache = {}
    with torch.inference_mode():
        run = lambda: TK.factored_decode(dec.transformer, dec, base, pe, tok, 8, cache=cache)
        whole = CS.device_ms(run, 10)
        fused = CS.g_breakdown(TK, cache["factored_decode"][2])["fused_ms"]
    return {"device_ms": whole, "fused_ms": fused}


def tw_turn(source, check):
    """Kernel H replayed at the pixel decoder's shape and at 64 prompts."""
    out = {}
    for label, P, N in (("8x6", 8, 6), ("64x7", 64, 7)):
        if check:   # raises if the variant is off
            CS.twoway_case(C, TK, "twoway_decode", torch.bfloat16, P=P, N=N, check=True)
        dec = CS.random_decoder(C, torch.bfloat16, 0)
        g = torch.Generator(device="cuda").manual_seed(1)
        base = (torch.randn(P, 64, 64, 256, device="cuda", generator=g) * 0.5).bfloat16()
        pe = (torch.randn(64, 64, 256, device="cuda", generator=g) * 0.5).bfloat16()
        tok = (torch.randn(P, N, 256, device="cuda", generator=g) * 0.5).bfloat16()
        with torch.inference_mode():
            out[label] = CS.device_ms(lambda: TK.twoway_decode(dec.transformer, dec, base, pe,
                                                               tok, 8), 10)
            plan = TK._plan(TK.TWOWAY_DECODE, dec.transformer, dec, base, tok, 8)
            out[label + "_fused_ms"] = CS.tw_breakdown(TK, plan)["fused_ms"]
        del dec, plan
    return out


TURNS = {"relpos_window": window_turn, "relpos_fwd": relpos_fwd_turn, "factored_decode": g_turn,
         "twoway_fused": tw_turn}


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    want = set(sys.argv[1].split(",")) if len(sys.argv) > 1 else {v[0] for v in VARIANTS}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    for name, source, edits in VARIANTS:
        if name not in want:
            continue
        kept = kernels.library(source)
        lib, notes = build_variant(name, source, edits)
        rec = {"variant": name, "replaces": source, "ptxas": notes}
        turn_fn = TURNS.get(source, bwd_turn)
        for turn, which in enumerate(("kept", "variant", "variant", "kept")):
            kernels._LIBS[source] = kept if which == "kept" else lib
            rec.setdefault(f"{which}_device_ms", []).append(turn_fn(source, turn == 1))
        kernels._LIBS[source] = kept
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
