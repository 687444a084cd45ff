"""One process of ``tests/test_torch_cli_qmesh.py``'s runs on the CPU
(gloo): ``python tests/torch_cli_qmesh_worker.py <dir>`` with
``torchrun``'s environment.  It reads ``<dir>/inputs.pkl`` (the initial
weights as a JAX-layout numpy tree, and the argument lists), patches the
port's ``import_initial_params`` to load those weights, runs
``llmseg_tpu_torch.cli.train.main`` on each argument list (each with
``--multihost``) with the vocabulary rounded up to an even size
(:func:`even_vocab`), and writes what every ``train_epoch``, ``validate``,
``calibrate_quant_stats`` and scored batch returned to
``<dir>/rank<r>.pt``.  It imports the port and torch only."""

import dataclasses
import os
import pickle
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from llmseg_tpu_torch.cli import common  # noqa: E402
from llmseg_tpu_torch.cli import train  # noqa: E402
from llmseg_tpu_torch.import_weights.from_jax import load_  # noqa: E402
from llmseg_tpu_torch.models import llmseg  # noqa: E402
from llmseg_tpu_torch.parallel import ddp  # noqa: E402
from llmseg_tpu_torch.train import evaluate  # noqa: E402
from llmseg_tpu_torch.train.trainer import Trainer  # noqa: E402


def even_vocab(align):
    """``align_model_to_tokenizer`` with the vocabulary rounded up to an
    even size: the byte tokenizer's 263 ids do not split over tp = 2 (the
    JAX CLI's mesh refuses them as the port's does), so both sides of the
    test take 264."""
    def aligned(cfg, tokenizer):
        cfg = align(cfg, tokenizer)
        llm = cfg.model.llava.llm
        llm = dataclasses.replace(llm, vocab_size=-(-llm.vocab_size // 2) * 2)
        llava = dataclasses.replace(cfg.model.llava, llm=llm)
        return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, llava=llava))
    return aligned


def main(root: str) -> None:
    torch.set_num_threads(1)
    with open(os.path.join(root, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    log = []

    def weights(args, cfg, lora_cfg):
        return load_(llmseg.build(cfg.model, device=args.device, lora_cfg=lora_cfg),
                     inputs["tree"])

    def record(owner, attr, tag):
        fn = getattr(owner, attr)

        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            log.append((tag, out))
            return out
        setattr(owner, attr, wrapped)

    common.import_initial_params = weights
    common.align_model_to_tokenizer = even_vocab(common.align_model_to_tokenizer)
    record(Trainer, "train_epoch", "train")
    record(Trainer, "validate", "val")
    record(llmseg, "calibrate_quant_stats", "stats")
    run_validation = evaluate.run_validation

    def scored(step, model, batches, *a, **kw):
        def rec(m, b):
            out = step(m, b)
            log.append(("scores", {k: v.detach().float().numpy() for k, v in out.items()}))
            return out
        return run_validation(rec, model, batches, *a, **kw)

    evaluate.run_validation = scored
    for argv in inputs["runs"]:
        log.append(("run", argv))
        train.main(argv)
    torch.save(log, os.path.join(root, f"rank{ddp.rank()}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
