"""Times the tile choices of the backward kernels C and D against the ones
the port keeps.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/bwd_variants.py

It builds, beside the kept kernels, variants made from the same sources by
replacing their tile constants: kernel C with 64 query rows a CTA (one
consumer warpgroup and a producer warp) instead of 128, and kernel D with
32-row query tiles instead of 64.  Each variant is held against
flash_bwd_plain at the training shape (B*H = 32, T = S = 767, D = 128,
causal, bf16; chip_smoke.bwd_case's gate) and timed on the device clock
(chip_smoke.device_ms), in turns with the kept kernel.  One JSON line a
variant, with the spill and wgmma lines of its ``-Xptxas -v`` report."""
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

# (name, source, [(text in the source, its replacement)])
VARIANTS = [
    ("flash_bwd_dq_64rows", "flash_bwd_dq", [
        ("BQ = 128, BN = 64,", "BQ = 64, BN = 64,"),
        ("THREADS = 2 * 128 + 32;", "THREADS = 128 + 32;"),
        ("mbar_init(&bars.empty[i], 8);", "mbar_init(&bars.empty[i], 4);"),
        ("if (wg == 2) {\n    if (threadIdx.x == 256) {", "if (wg == 1) {\n    if (threadIdx.x == 128) {")]),
    ("flash_bwd_dkv_bq32", "flash_bwd_dkv", [
        ("BKV = 64, BQ = 64,", "BKV = 64, BQ = 32,")]),
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
    notes = [ln.split("ptxas info    : ")[-1][:90] for ln in (rep.stdout + rep.stderr).splitlines()
             if "C75" in ln or ("spill stores" in ln and " 0 bytes spill stores" not in ln)]
    return lib, notes


def main() -> int:
    if not torch.cuda.is_available():
        print("bwd_variants: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    shape = dict(BH=32, T=767, S=767, D=128, causal=True, dtype=torch.bfloat16)
    kept = {s: kernels.library(s) for s in ("flash_bwd_dq", "flash_bwd_dkv")}
    for name, source, edits in VARIANTS:
        lib, notes = build_variant(name, source, edits)
        rec = {"variant": name, "replaces": source, "ptxas": notes}
        for turn, which in enumerate(("kept", "variant", "variant", "kept")):
            kernels._LIBS[source] = kept[source] if which == "kept" else lib
            if turn == 1:
                CS.bwd_case(A, repeat=True, **shape)   # raises if the variant is off
            rec.setdefault(f"{which}_device_ms", []).append(
                CS.bwd_device_times(A, **shape)[source])
        kernels._LIBS[source] = kept[source]
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
