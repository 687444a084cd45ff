"""Activation parity of imported checkpoints, the counterpart of the JAX
package's ``cli/parity.py``: the port's LLaMA logits and CLIP layer -2
features against ``transformers``' own models (on the CPU, float32) from
the same HF directory, on shared random inputs; the largest absolute
difference of each, and a failure above 1e-2.

``transformers`` is imported inside the checks, so the package imports
without it.  The port's models run on ``--device`` (the card by default;
``--device cpu`` on request) in float32.

Usage:
  python -m llmseg_tpu_torch.cli.parity --llava_dir <dir> [--clip_dir <dir>] [--seq 64]
"""

from __future__ import annotations

import argparse
import sys

FAIL_ABOVE = 1e-2


def check_llama(llava_dir: str, seq: int, device="cuda") -> float:
    import torch
    from transformers import AutoConfig, LlamaForCausalLM

    from llmseg_tpu_torch import config as C
    from llmseg_tpu_torch.device import require
    from llmseg_tpu_torch.import_weights import torch_import as TI
    from llmseg_tpu_torch.import_weights.from_jax import load_
    from llmseg_tpu_torch.models import llama

    dev = require(device)
    hf_cfg = AutoConfig.from_pretrained(llava_dir)
    hf = LlamaForCausalLM.from_pretrained(llava_dir, torch_dtype=torch.float32,
                                          attn_implementation="eager").eval()
    cfg = C.LlamaConfig(
        vocab_size=hf_cfg.vocab_size, hidden_size=hf_cfg.hidden_size,
        intermediate_size=hf_cfg.intermediate_size, num_layers=hf_cfg.num_hidden_layers,
        num_heads=hf_cfg.num_attention_heads,
        num_kv_heads=getattr(hf_cfg, "num_key_value_heads", hf_cfg.num_attention_heads),
        head_dim=hf_cfg.hidden_size // hf_cfg.num_attention_heads, max_seq_len=max(seq, 64))
    model = llama.Llama(cfg, device=dev, dtype=torch.float32)
    load_(model, TI.import_llama(dict(hf.state_dict()), cfg, prefix="model."))
    ids = torch.randint(0, min(cfg.vocab_size, 32000), (1, seq))
    with torch.no_grad():
        ref = hf(ids).logits
        got = llama.logits(model, model(input_ids=ids.to(dev))).cpu()
    d = float((got - ref).abs().max())
    print(f"llama logits max|diff| = {d:.2e}")
    return d


def check_clip(clip_dir: str, device="cuda") -> float:
    import torch
    from transformers import CLIPVisionModel

    from llmseg_tpu_torch import config as C
    from llmseg_tpu_torch.device import require
    from llmseg_tpu_torch.import_weights import torch_import as TI
    from llmseg_tpu_torch.import_weights.from_jax import load_
    from llmseg_tpu_torch.models import vit

    dev = require(device)
    hf = CLIPVisionModel.from_pretrained(clip_dir, attn_implementation="eager").eval()
    c = hf.config
    cfg = C.ViTConfig(img_size=c.image_size, patch_size=c.patch_size,
                      hidden_size=c.hidden_size, depth=c.num_hidden_layers,
                      num_heads=c.num_attention_heads,
                      mlp_ratio=c.intermediate_size / c.hidden_size)
    tower = vit.ViT(cfg, device=dev, dtype=torch.float32)
    load_(tower, TI.import_clip_vision(dict(hf.state_dict()), cfg, prefix="vision_model."))
    x = torch.randn(1, 3, c.image_size, c.image_size)
    with torch.no_grad():
        ref = hf(x, output_hidden_states=True).hidden_states[-2][:, 1:]
        got = vit.clip_features(tower, x.permute(0, 2, 3, 1).to(dev)).cpu()
    d = float((got - ref).abs().max())
    print(f"clip select(-2) features max|diff| = {d:.2e}")
    return d


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("parity")
    p.add_argument("--llava_dir", default="")
    p.add_argument("--clip_dir", default="")
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--device", default="cuda",
                   help="the device the port's models run on: the card (cuda, the "
                        "default) or cpu")
    return p


def main(argv=None) -> float:
    args = build_parser().parse_args(argv)
    worst = 0.0
    if args.llava_dir:
        worst = max(worst, check_llama(args.llava_dir, args.seq, args.device))
    if args.clip_dir:
        worst = max(worst, check_clip(args.clip_dir, args.device))
    if worst > FAIL_ABOVE:
        print(f"FAIL: worst diff {worst:.2e} > {FAIL_ABOVE:.0e}")
        sys.exit(1)
    print("parity OK")
    return worst


if __name__ == "__main__":
    main()
