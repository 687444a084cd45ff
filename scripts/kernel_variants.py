"""Times design choices of kernels C, D and F against the ones the port
keeps.

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
                           no item's loads overlap another's compute.
Each variant is held against its plain version at its main shape (C and D:
B*H = 32, T = S = 767, D = 128, causal, bf16, chip_smoke.bwd_case's gate;
F: 400 and 3,200 pairs of 14 x 14 windows, D = 80, bf16,
chip_smoke.relpos_case's gate and a bitwise repeat) and timed on the device
clock (chip_smoke.device_ms), in turns with the kept kernel (kept, variant,
variant, kept).  One JSON line a variant, with the spill and wgmma lines of
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
from llmseg_tpu_torch.ops import relpos_attention as R  # noqa: E402

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
]


def build_variant(name, source, edits):
    src = (kernels.CSRC / f"{source}.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"{name}: {old!r} is not in csrc/{source}.cu")
        src = src.replace(old, new)
    out = kernels.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(src)
    so = out / f"lib{name}.so"
    cmd = [kernels._nvcc(), "-gencode", kernels.ARCH, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(kernels.CSRC), "-o", str(so),
           str(out / f"{name}.cu")]
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
        turn_fn = window_turn if source == "relpos_window" else bwd_turn
        for turn, which in enumerate(("kept", "variant", "variant", "kept")):
            kernels._LIBS[source] = kept if which == "kept" else lib
            rec.setdefault(f"{which}_device_ms", []).append(turn_fn(source, turn == 1))
        kernels._LIBS[source] = kept
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
