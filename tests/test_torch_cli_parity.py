"""The port's ``cli/parity.py`` beside the JAX package's, on the tiny HF
LLaVA directory of ``tests/tok_utils.add_tiny_llava_weights`` and a tiny
HF CLIP vision directory built from a config (no download), float32 on
the CPU: both report the same kind of line and pass, the port's LLaMA
logits and CLIP layer -2 features within 1e-4 of ``transformers``; a
weight changed on the port's side fails the run (exit 1); the parser's
options are JAX's plus ``--device``."""

import re

import pytest
import torch

from cli import parity as jparity
from llmseg_tpu_torch.cli import parity as tparity
from llmseg_tpu_torch.import_weights import torch_import as TTI

from tok_utils import add_tiny_llava_weights

DIFF = re.compile(r"(llama logits|clip select\(-2\) features) max\|diff\| = ([\d.e+-]+)")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    from transformers import CLIPVisionConfig, CLIPVisionModel

    root = tmp_path_factory.mktemp("parity")
    llava = root / "llava"
    llava.mkdir()
    add_tiny_llava_weights(str(llava), vocab_size=300)
    torch.manual_seed(0)
    clip = CLIPVisionModel(CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=3, num_attention_heads=2,
        image_size=28, patch_size=14))
    clip.save_pretrained(str(root / "clip"))
    return str(llava), str(root / "clip")


def test_parity_matches_jax(dirs, capsys):
    args = ["--llava_dir", dirs[0], "--clip_dir", dirs[1], "--seq", "24"]
    torch.manual_seed(1)
    jparity.main(args)
    jout = capsys.readouterr().out
    torch.manual_seed(1)
    worst = tparity.main(args + ["--device", "cpu"])
    tout = capsys.readouterr().out
    jd, td = DIFF.findall(jout), DIFF.findall(tout)
    assert [k for k, _ in jd] == [k for k, _ in td] == ["llama logits",
                                                       "clip select(-2) features"]
    assert all(float(v) <= 1e-4 for _, v in td), tout
    assert worst <= 1e-4
    assert tout.strip().endswith("parity OK") and jout.strip().endswith("parity OK")


def test_parity_fails_on_a_changed_weight(dirs, monkeypatch, capsys):
    real = TTI.import_llama

    def off(sd, cfg, prefix="model."):
        tree = real(sd, cfg, prefix)
        tree["norm"]["scale"] = tree["norm"]["scale"] * 1.5
        return tree

    monkeypatch.setattr(TTI, "import_llama", off)
    with pytest.raises(SystemExit) as e:
        tparity.main(["--llava_dir", dirs[0], "--device", "cpu"])
    assert e.value.code == 1
    assert "FAIL: worst diff" in capsys.readouterr().out


def test_parser_is_jax_plus_device(monkeypatch):
    """JAX's parser is built inside its ``main``: its options are read
    where it parses."""
    import argparse

    seen = {}

    def capture(self, argv=None, namespace=None):
        seen.update({a.dest: a.default for a in self._actions})
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(SystemExit):
        jparity.main([])
    t = {a.dest: a.default for a in tparity.build_parser()._actions}
    assert set(t) == set(seen) | {"device"} and {k: t[k] for k in seen} == seen
