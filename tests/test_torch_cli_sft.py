"""The port's ``cli/sft.py`` against the JAX package's ``cli/sft.py`` at
``--model_size tiny``, float32, on the corpus of
``tests/test_torch_llava_sft.py``: both regimes from the same weights (the
port's ``sft.init`` patched to load the JAX ``llava.init`` tree of the
run's seed; JAX's ``lora_init``, which draws from ``hash(name)``, patched to
a numpy draw that both sides share).  The printed ``ce`` and ``gnorm`` of
every step agree within 2e-4 (they are printed to 4 and 3 decimals), the
saved checkpoint holds every parameter, frozen ones as loaded and the
trainable ones moved; the parser's options are JAX's plus ``--device``."""

import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from cli import sft as jcli
from llmseg_tpu import config as JC
from llmseg_tpu.models import llama as jllama
from llmseg_tpu.models import llava as jllava
from llmseg_tpu_torch import config as TC
from llmseg_tpu_torch.cli import sft as tcli
from llmseg_tpu_torch.import_weights.from_jax import load_
from llmseg_tpu_torch.train import checkpoint as ckpt_lib
from llmseg_tpu_torch.train import sft as tsft

from test_torch_llava_sft import write_corpus

torch.set_num_threads(1)
REGIMES = {"lora": ["--lora_enable", "--lora_r", "2"],
           "projector": ["--tune_mm_mlp_adapter", "--conv_type", "plain"]}
LINE = re.compile(r"step (\d+): ce=([-\d.]+) gnorm=([-\d.]+)")


_LORA_INIT = jllama.lora_init


def _lora_np(key, cfg, lora_cfg, dtype=None):
    """LoRA of ``lora_init``'s shapes from a fixed numpy draw."""
    tree = _LORA_INIT(key, cfg, lora_cfg)
    rng = np.random.RandomState(3)
    return jax.tree.map(lambda x: (rng.randn(*np.shape(x)) / np.sqrt(np.shape(x)[0])
                                   ).astype(np.float32), tree)


def _plain_corpus(tmp_path):
    """The "plain" template takes (image, caption) pairs: every row one
    human <image> turn and one caption."""
    import json

    path, img_dir = write_corpus(tmp_path, n_image=4, n_text=0)
    items = json.loads(open(path).read())
    for it in items:
        it["conversations"] = [{"from": "human", "value": "<image>"},
                               {"from": "gpt", "value": f"caption {it['id']}"}]
    open(path, "w").write(json.dumps(items))
    return path, img_dir


@pytest.mark.parametrize("regime", list(REGIMES))
def test_main_matches_jax(tmp_path, monkeypatch, capsys, regime):
    if regime == "projector":
        path, img_dir = _plain_corpus(tmp_path)
    else:
        path, img_dir = write_corpus(tmp_path, n_image=4, n_text=2)
    common = ["--data_path", path, "--image_folder", img_dir, "--model_size", "tiny",
              "--precision", "fp32", "--model_max_length", "320", "--batch_size", "2",
              "--epochs", "2", "--max_steps", "4", "--print_freq", "1", "--lr", "1e-3",
              "--warmup_steps", "1", "--seed", "5"] + REGIMES[regime]

    monkeypatch.setattr(jllama, "lora_init", _lora_np)
    jcli.main(common + ["--output_dir", str(tmp_path / "jax")])
    jout = capsys.readouterr().out

    def init_from_jax(cfg, *, seed, device, dtype, lora_cfg):
        key = jax.random.PRNGKey(seed)
        tree = jllava.init(key, cfg_j(cfg))
        if lora_cfg is not None:
            tree["lora"] = _lora_np(key, cfg_j(cfg).llm, JC.LoraConfig(rank=2))
        model = tsft.LlavaSFT(cfg, lora_cfg, device=device, dtype=dtype)
        return load_(model, jax.tree.map(np.asarray, tree))

    def cfg_j(cfg):
        j = JC.llava_tiny()
        return dataclasses.replace(j, llm=dataclasses.replace(j.llm,
                                                              vocab_size=cfg.llm.vocab_size))

    monkeypatch.setattr(tsft, "init", init_from_jax)
    model = tcli.main(common + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    tout = capsys.readouterr().out

    jl, tl = LINE.findall(jout), LINE.findall(tout)
    assert len(jl) == len(tl) == 4
    for (js, jce, jgn), (ts, tce, tgn) in zip(jl, tl):
        assert js == ts
        assert abs(float(tce) - float(jce)) <= 2e-4 and abs(float(tgn) - float(jgn)) <= 2e-4
    assert re.search(r"trainable params: [\d.]+M \(\d+ tensors\)", tout)
    assert jout.splitlines()[0] == tout.splitlines()[0]      # the same trainable count
    assert "saved step 4 to" in tout

    params, _, step = ckpt_lib.restore(str(tmp_path / "port"))
    assert step == 4
    assert set(params) == {n for n, _ in model.named_parameters()}
    start = init_from_jax(model.cfg, seed=5, device="cpu", dtype=torch.float32,
                          lora_cfg=TC.LoraConfig(rank=2) if regime == "lora" else None)
    for name, p in start.named_parameters():
        trains = name.startswith("mm_projector.") or (regime == "lora"
                                                       and name.startswith("lora."))
        assert torch.equal(params[name], p.detach()) != trains, name


def test_parser_is_jax_plus_device():
    jopts = {a.dest: a.default for a in jcli.build_parser()._actions}
    topts = {a.dest: a.default for a in tcli.build_parser()._actions}
    assert set(topts) == set(jopts) | {"device"}
    assert {k: topts[k] for k in jopts} == jopts
    assert topts["device"] == "cuda"
