"""Optimizer: AdamW + WarmupDecayLR + grad clip over the trainable subset,
the counterpart of ``llmseg_tpu.train.optim``.

The trainable set is the JAX package's: the selection head (``select.*``),
LoRA (``lora.*``), and LLaMA's ``embed_tokens`` and ``lm_head``; the vision
towers, the projector and the LLaMA base stay frozen.  :func:`partition`
turns ``requires_grad`` off on the frozen parameters, so gradients and
optimizer state exist only for the trainable ones; :func:`quantize_skeleton`
then quantizes the frozen LLaMA projections in place (QLoRA).  The model is
one module tree, so ``combine`` has no counterpart.

:class:`TrainableOptimizer` is ``make_trainable_optimizer``'s chain:
``clip_by_global_norm`` with optax's formula, AdamW (beta 0.9/0.95, eps
1e-8), the warmup-decay schedule counted in optimizer updates, and, for
``grad_accum_steps > 1``, ``optax.MultiSteps``: the running mean of the
micro-step gradients, one update every ``grad_accum_steps`` micro-steps and
the parameters untouched in between.  On a mesh with fsdp or tp above 1
(``parallel/mesh.py``) the parameters are this rank's blocks: AdamW and
its state run on the blocks, and the clip's norm is that of the whole
gradient (``mesh.grad_norm``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Union

import torch
from torch import nn

from llmseg_tpu_torch.config import TrainConfig
from llmseg_tpu_torch.parallel import mesh as M

TRAINABLE_PREFIXES = ("select.", "lora.", "llava.llm.embed_tokens.", "llava.llm.lm_head.")


def is_trainable(name: str) -> bool:
    return name.startswith(TRAINABLE_PREFIXES)


def trainable_mask(model: nn.Module) -> Dict[str, bool]:
    """{parameter name: trainable}."""
    return {name: is_trainable(name) for name, _ in model.named_parameters()}


def partition(model: nn.Module, mask: Union[Mapping[str, bool], Callable[[str], bool],
                                             None] = None) -> "OrderedDict[str, nn.Parameter]":
    """Freeze every parameter outside the trainable set (requires_grad off)
    and return the trainable ones by name.  ``mask`` overrides
    ``TRAINABLE_PREFIXES``, as the JAX ``partition(params, mask)`` does: a
    map from every parameter name to whether it trains, or a predicate on
    names."""
    if mask is None:
        mask = is_trainable
    elif not callable(mask):
        mask = mask.__getitem__
    trainable = OrderedDict()
    for name, p in model.named_parameters():
        p.requires_grad_(bool(mask(name)))
        if p.requires_grad:
            trainable[name] = p
    return trainable


def quantize_skeleton(model: nn.Module, bits: int = 8) -> nn.Module:
    """QLoRA's frozen base, ``optim.quantize_skeleton``: the LLaMA
    projections quantized in place to weight-only int8 or packed int4
    (``quant.quantize_llama_inplace``, no smoothing), after
    :func:`partition`.  A module that holds a trainable parameter is never
    quantized: lm_head (and embed_tokens, which is no projection) stays in
    full precision, as the JAX skeleton's holes do; LoRA is outside the
    LLaMA."""
    from llmseg_tpu_torch.ops import quant

    llm = model.llava.llm
    quant.quantize_llama_inplace(llm, bits=bits, skip=holds_trainable(llm))
    return model


def holds_trainable(root: nn.Module):
    """A predicate on module paths (tuples of names) under ``root``: whether
    that module holds a trainable parameter (one that requires grad)."""
    def pred(path) -> bool:
        return any(p.requires_grad for p in root.get_submodule(".".join(path)).parameters())
    return pred


def warmup_decay_lr(cfg: TrainConfig, count: int) -> float:
    """DeepSpeed WarmupDecayLR as ``optim.warmup_decay_schedule``: linear
    0 -> lr over warmup_steps, then lr -> 0 over the remaining steps."""
    if count < cfg.warmup_steps:
        return cfg.lr * count / cfg.warmup_steps
    decay = max(cfg.epochs * cfg.steps_per_epoch - cfg.warmup_steps, 1)
    return cfg.lr * (1.0 - min(count - cfg.warmup_steps, decay) / decay)


def warmup_decay_schedule(opt: torch.optim.Optimizer,
                          cfg: TrainConfig) -> torch.optim.lr_scheduler.LambdaLR:
    """The schedule as a LambdaLR over ``opt`` (whose base lr is cfg.lr):
    stepped once per optimizer update, so the first update uses lr(0), as
    optax's schedule count does."""
    return torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: warmup_decay_lr(cfg, count) / cfg.lr if cfg.lr else 0.0)


@torch.no_grad()
def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, accumulated in float32."""
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32) for t in tensors]
    return torch.linalg.vector_norm(torch.stack(norms))


class TrainableOptimizer:
    """``make_trainable_optimizer``: clip, AdamW and MultiSteps over the
    trainable parameters.  :meth:`step` reads the micro-step gradients from
    ``.grad``, clears them, and returns True when it updated the
    parameters."""

    def __init__(self, cfg: TrainConfig, params: Dict[str, nn.Parameter],
                 mesh: Optional[M.Mesh] = None, specs: Optional[Dict[str, M.Spec]] = None):
        self.cfg = cfg
        self.params = params
        self.mesh, self.specs = mesh, specs
        self.adamw = torch.optim.AdamW(list(params.values()), lr=cfg.lr,
                                       betas=(cfg.beta1, cfg.beta2), eps=1e-8,
                                       weight_decay=cfg.weight_decay)
        self.schedule = warmup_decay_schedule(self.adamw, cfg)
        self.mini_step = 0
        self.acc: List[torch.Tensor] = []

    def _grads(self) -> List[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self.params.values()]

    def norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of ``grads`` ({parameter name: gradient}): of the
        whole gradient on a sharded mesh."""
        if self.mesh is None or not self.mesh.sharded:
            return global_norm(grads.values())
        return M.grad_norm(grads, self.specs, self.mesh)

    @torch.no_grad()
    def step(self, norm: Optional[torch.Tensor] = None) -> bool:
        """``norm``, the global norm of the micro-step gradients where the
        caller already has it, is the clip's norm unless accumulation
        replaces those gradients by their mean."""
        grads = self._grads()
        k = self.cfg.grad_accum_steps
        if k > 1:
            if self.mini_step == 0:
                self.acc = [torch.zeros_like(g) for g in grads]
            for a, g in zip(self.acc, grads):  # Welford mean, as MultiSteps
                a.add_((g - a) / (self.mini_step + 1))
            self.mini_step = (self.mini_step + 1) % k
            if self.mini_step:
                self.zero_grad()
                return False
            grads, self.acc, norm = self.acc, [], None
        if norm is None:
            norm = self.norm(dict(zip(self.params, grads)))
        if norm >=self.cfg.grad_clip:  # optax: t / |g| * c
            grads = [g / norm.to(g.dtype) * self.cfg.grad_clip for g in grads]
        for p, g in zip(self.params.values(), grads):
            p.grad = g
        self.adamw.step()
        self.schedule.step()
        self.zero_grad()
        return True

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "schedule": self.schedule.state_dict(),
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.schedule.load_state_dict(state["schedule"])
        self.mini_step = state["mini_step"]
        self.acc = list(state["acc"])


def make_trainable_optimizer(cfg: TrainConfig, params: Dict[str, nn.Parameter],
                             mesh: Optional[M.Mesh] = None,
                             specs: Optional[Dict[str, M.Spec]] = None) -> TrainableOptimizer:
    return TrainableOptimizer(cfg, params, mesh, specs)
