"""The command's contract off the card: no card means no result; the
import guard; the references import nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from pbcore import guard

BENCH = Path(__file__).resolve().parents[1]


def test_no_card_exits_nonzero_without_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "llmseg_mistral7b.predict_b4", "--seed", "2147483999", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, cwd=BENCH.parent,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "llmseg_tpu_torch_fake", object())
    assert "llmseg_tpu" not in guard.banned_modules()
    monkeypatch.setitem(sys.modules, "llmseg_tpu.config", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert guard.banned_modules() == ["jaxlib", "llmseg_tpu"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".", 1)[0] for m in _imports(path)}
    assert not tops & {"llmseg_tpu_torch", "llmseg_tpu", "jax", "jaxlib", "flax", "pbcore"}


def test_harness_imports_no_jax():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".", 1)[0] for m in _imports(path)}
        assert not tops & {"llmseg_tpu", "jax", "jaxlib", "flax", "bench", "chip_smoke"}, path
