"""Training loop, the counterpart of ``llmseg_tpu.train.trainer.Trainer``:
init, the trainable partition, the quantized frozen base (QLoRA) and the
optimizer; epochs of micro-steps with grad accumulation, meters and
progress printing; validation (gIoU / cIoU), the best-checkpoint policy and
checkpoint resume.

It trains on one card (``device="cuda"``, the default) or, when the caller
asks, on the CPU.  A batch is a dict of tensors or of numpy arrays (what
``data.collate`` gives, alone or as the first item of a tuple); arrays are
copied to the device here, pinned tensors (``BatchLoader(...,
pin_memory=True)``) asynchronously.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from llmseg_tpu_torch.config import ExperimentConfig, LoraConfig
from llmseg_tpu_torch.device import require
from llmseg_tpu_torch.models import llmseg
from llmseg_tpu_torch.train import checkpoint as ckpt_lib
from llmseg_tpu_torch.train import evaluate as eval_lib
from llmseg_tpu_torch.train import optim
from llmseg_tpu_torch.train.train_step import eval_step, train_step
from llmseg_tpu_torch.utils.metrics import AverageMeter, ProgressMeter
from llmseg_tpu_torch.utils.profiling import trace

LOSS_KEYS = ("loss", "ce_loss", "align_loss", "regression_loss")


def _as_tensor(v) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v


class Trainer:
    def __init__(self, cfg: ExperimentConfig, *, lora_cfg: Optional[LoraConfig] = None,
                 model: Optional[llmseg.LLMSeg] = None, device="cuda",
                 pool: str = "adjoint", writer=None):
        self.cfg = cfg
        self.device = require(device)
        self.lora_cfg = lora_cfg if lora_cfg is not None else cfg.train.lora
        self.pool = pool
        dtype = torch.bfloat16 if cfg.train.precision == "bf16" else torch.float32
        if model is None:
            model = llmseg.init(cfg.model, seed=cfg.train.seed, device=self.device,
                                dtype=dtype, lora_cfg=self.lora_cfg)
        self.model = model
        self.trainable = optim.partition(model)
        if cfg.train.quantize_frozen:
            optim.quantize_skeleton(model, bits=cfg.train.quantize_bits)
        self.opt = optim.make_trainable_optimizer(cfg.train, self.trainable)
        self.remat = cfg.train.remat_policy
        self.global_step = 0
        self.writer = writer
        self.log_dir = cfg.train.log_dir
        os.makedirs(self.log_dir, exist_ok=True)
        self.best = ckpt_lib.BestKeeper(self.log_dir, cfg.train.save_best_metric)
        self._staged = None     # the last pinned batch and its copy's event

    def to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """A batch's values on the trainer's device.  A pinned tensor is
        copied without blocking; it is held (with an event after its copy)
        until the next call, which waits for that copy before letting it go,
        so its memory is neither freed nor reused while the copy reads it."""
        batch = {k: _as_tensor(v) for k, v in batch.items()}
        pinned = self.device.type == "cuda" and any(v.is_pinned() for v in batch.values())
        out = {k: v.to(self.device, non_blocking=v.is_pinned()) for k, v in batch.items()}
        if self._staged is not None:
            self._staged[1].synchronize()
            self._staged = None
        if pinned:
            done = torch.cuda.Event()
            done.record()
            self._staged = (batch, done)
        return out

    def step(self, batch) -> dict:
        return train_step(self.model, self.opt, batch, lora_cfg=self.lora_cfg,
                          remat=self.remat, pool=self.pool)

    def eval_step(self, model: llmseg.LLMSeg, batch) -> dict:
        return eval_step(model, self.to_device(batch), lora_cfg=self.lora_cfg, pool=self.pool)

    # -- checkpointing ------------------------------------------------------

    def maybe_resume(self, weights_only: bool = False) -> bool:
        """Restore the newest checkpoint's trainable parameters (and, unless
        ``weights_only``, the optimizer state and step).  The frozen weights
        are the model's own, already quantized under QLoRA."""
        step = ckpt_lib.latest_step(self.log_dir)
        if step is None:
            return False
        params, opt_state, step = ckpt_lib.restore(self.log_dir, step,
                                                   map_location=self.device)
        with torch.no_grad():
            for name, p in self.trainable.items():
                p.copy_(params[name])
        if not weights_only and opt_state is not None:
            self.opt.load_state_dict(opt_state)
            self.global_step = step
        print(f"resumed from step {step} (weights_only={weights_only})")
        return True

    # -- loops --------------------------------------------------------------

    def train_epoch(self, batches: Iterable, epoch: int, profile_steps: int = 0) -> dict:
        """One epoch over any iterable of batches (dicts of tensors or numpy
        arrays, or tuples whose first item is one); returns the meters'
        averages.  ``profile_steps`` > 0: a ``torch.profiler`` trace of that
        many leading micro-steps into <log_dir>/profile."""
        tcfg = self.cfg.train
        meters = {name: AverageMeter(name, ":.4f") for name in LOSS_KEYS}
        batch_time = AverageMeter("time", ":.3f")
        data_time = AverageMeter("data", ":.3f")
        progress = ProgressMeter(tcfg.steps_per_epoch,
                                 [batch_time, data_time] + list(meters.values()),
                                 prefix=f"Epoch: [{epoch}]")
        micro = 0
        end = time.time()
        profiler = None
        for batch in batches:
            if isinstance(batch, tuple):
                batch = batch[0]
            data_time.update(time.time() - end)
            if profile_steps and micro == 0:
                profiler = trace(os.path.join(self.log_dir, "profile"))
                profiler.__enter__()
            metrics = self.step(self.to_device(batch))
            if profiler is not None and micro + 1 == profile_steps:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                profiler.__exit__(None, None, None)
                profiler = None
            micro += 1
            if micro % tcfg.grad_accum_steps == 0:
                self.global_step += 1
                for name, m in meters.items():
                    m.update(float(metrics[name]))
                batch_time.update(time.time() - end)
                step_in_epoch = micro // tcfg.grad_accum_steps
                if step_in_epoch % tcfg.print_freq == 0:
                    progress.display(step_in_epoch)
                    if self.writer is not None:
                        for name, m in meters.items():
                            self.writer.add_scalar(f"train/{name}", m.val, self.global_step)
                        self.writer.add_scalar("metrics/total_secs_per_batch",
                                               batch_time.avg, self.global_step)
            end = time.time()
        if profiler is not None:     # epoch shorter than profile_steps
            profiler.__exit__(None, None, None)
        return {name: m.avg for name, m in meters.items()}

    def validate(self, batches: Iterable, strategy: str = "threshold",
                 threshold: float = 0.5, visualize_dir: Optional[str] = None
                 ) -> Dict[str, float]:
        """gIoU and cIoU over (batch, extras) pairs (``evaluate.run_validation``),
        written to the writer as val/giou and val/ciou."""
        results = eval_lib.run_validation(self.eval_step, self.model, batches,
                                          strategy=strategy, threshold=threshold,
                                          visualize_dir=visualize_dir)
        if self.writer is not None:
            self.writer.add_scalar("val/giou", results["giou"], self.global_step)
            self.writer.add_scalar("val/ciou", results["ciou"], self.global_step)
        return results

    def save_best(self, metrics: Dict[str, float]) -> bool:
        return self.best.update(self.global_step, metrics, self.trainable,
                                self.opt.state_dict())
