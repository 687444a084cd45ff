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
                 "utils.metrics", "models.sam.image_encoder", "models.sam.prompt_encoder",
                 "models.sam.mask_decoder", "models.sam.sam", "models.sam.amg",
                 "ops.relpos_attention", "ops.twoway_kernel", "ops.amg_utils", "ops.nms",
                 "ops.rle", "ops.device_rle", "models.generate", "models.pixel_decoder",
                 "ops.quant", "train.evaluate", "serving", "models.sam.export",
                 "import_weights.torch_import", "utils.profiling", "utils.logging",
                 "data.prompts", "data.conversation", "data.tokenizer", "data.collate",
                 "data.coco_api", "data.refer", "data.mask_reader", "data.data_processing",
                 "data.image_ops", "data.resample", "data.datasets", "train.loader"):
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


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py runs where JAX is absent: none of its imports, at any
    depth of the file, names JAX or the JAX package."""
    import ast
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert any(m.startswith("llmseg_tpu_torch") for m in names)
    bad = [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "llmseg_tpu")]
    assert not bad, bad


def test_kernel_sources_are_in_the_package():
    from llmseg_tpu_torch.ops import kernels
    for name in kernels.SIGNATURES:
        assert (kernels.CSRC / f"{name}.cu").is_file()


def test_port_loads_no_image_or_tokenizer_library():
    """The port, its data layer and loader included, imports neither JAX,
    the JAX package, PIL, cv2 nor transformers: the card's machine has none
    of the last three, and each is imported only by the function that
    needs it (the image decode and polygon fills, the sem-seg label read,
    HFTokenizer, the weight importers)."""
    mods = _modules()
    assert "llmseg_tpu_torch.train.loader" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "roots = ('jax', 'jaxlib', 'llmseg_tpu', 'PIL', 'cv2', 'transformers')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in roots]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
