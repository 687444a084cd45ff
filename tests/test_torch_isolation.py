"""The port imports neither JAX nor the JAX package."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import llmseg_tpu_torch

ROOT = Path(__file__).resolve().parent.parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        llmseg_tpu_torch.__path__, prefix="llmseg_tpu_torch."))


def test_port_has_every_slice_module():
    mods = set(_modules())
    for name in ("config", "device", "models.layers", "models.vit", "models.llama",
                 "models.llava", "models.selection_head", "models.llmseg",
                 "models.sam.two_way_transformer", "ops.attention", "ops.kernels",
                 "data.synthetic", "import_weights.from_jax", "losses", "train.optim",
                 "train.train_step", "train.checkpoint", "train.trainer",
                 "utils.metrics"):
        assert f"llmseg_tpu_torch.{name}" in mods, name


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'jaxlib' or m.startswith('jaxlib.')\n"
        "       or m == 'llmseg_tpu' or m.startswith('llmseg_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_kernel_sources_are_in_the_package():
    from llmseg_tpu_torch.ops import kernels
    for name in kernels.SIGNATURES:
        assert (kernels.CSRC / f"{name}.cu").is_file()
