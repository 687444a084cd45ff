"""Entry ``predict``: LLM-Seg's ``llmseg.predict`` in a closed loop with one
caller.  Each call takes one batch of a pool of distinct batches made from
the seed on the device before the window (cycled), and ends when its
similarity and IoP scores are on the host.

Traffic parameters (``workloads/<cell>.json``): ``images_per_batch``,
``rows_per_image`` (questions an image), ``text_len`` (tokens a row, the
image placeholder at position 1 and ``[SEG]`` at ``text_len - 4``),
``pool_batches``, ``warmup_calls``, ``check_batches`` (batches of the window
the reference recomputes, drawn from the seed).

The batch is a frozen copy of ``llmseg_tpu_torch.data.synthetic.make_batch``'s
layout, drawn with a ``torch.Generator`` on the device; the proposals are
discs of random centre and radius (0/1), two of them marked invalid.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from pbcore import sub_seed, weights
from reference import llmseg_ref

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def program_config(doc: Dict):
    """The program's ``LLMSegConfig`` for the configuration document."""
    from llmseg_tpu_torch import config as C

    def vit(c):
        if c["hidden_act"] not in ("quick_gelu", "gelu_tanh"):
            raise ValueError(f"the port's ViT has no {c['hidden_act']}")
        return C.ViTConfig(img_size=c["image_size"], patch_size=c["patch_size"],
                           hidden_size=c["hidden_size"], depth=c["num_hidden_layers"],
                           num_heads=c["num_attention_heads"],
                           mlp_ratio=c["intermediate_size"] / c["hidden_size"],
                           layernorm_pre=c["pre_layernorm"], layerscale=c["layerscale"],
                           use_quick_gelu=c["hidden_act"] == "quick_gelu",
                           ln_eps=c["layer_norm_eps"])

    L, s = doc["llm"], doc["select"]
    if L["hidden_act"] != "silu" or s["layer_norm_eps"] != 1e-5:
        raise ValueError("the port's decoder is SwiGLU and its head's LayerNorm eps 1e-5")
    llm = C.LlamaConfig(vocab_size=llmseg_ref.vocab(doc), hidden_size=L["hidden_size"],
                        intermediate_size=L["intermediate_size"],
                        num_layers=L["num_hidden_layers"], num_heads=L["num_attention_heads"],
                        num_kv_heads=L["num_key_value_heads"], head_dim=L["head_dim"],
                        max_seq_len=doc["max_seq_len"], rope_theta=L["rope_theta"],
                        rms_norm_eps=L["rms_norm_eps"],
                        tie_embeddings=L["tie_word_embeddings"])
    vision = vit(doc["vision"])
    llava = C.LlavaConfig(vision=vision, llm=llm, mm_hidden_size=vision.hidden_size,
                          vision_select_layer=doc["vision"]["select_layer"],
                          num_image_tokens=vision.num_patches)
    dino = vit(doc["dino"])
    select = C.SelectionHeadConfig(dim=s["dim"], num_heads=s["num_heads"], mlp_dim=s["mlp_dim"],
                                   depth=s["depth"],
                                   attention_downsample_rate=s["attention_downsample_rate"],
                                   dino_dim=dino.hidden_size, llm_dim=llm.hidden_size,
                                   iou_head_hidden=s["iou_head_hidden"],
                                   embed_head_hidden=s["embed_head_hidden"])
    return C.LLMSegConfig(llava=llava, dino=dino, select=select,
                          max_proposals=doc["max_proposals"], seg_grid=doc["seg_grid"],
                          seg_token_id=doc["seg_token_id"], max_seq_len=doc["max_seq_len"],
                          dtype=doc["dtype"])


def make_batch(doc: Dict, traffic: Dict, seed: int, index: int, device) -> Dict:
    """Batch ``index`` of the run seeded ``seed``: the same on every call."""
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, "batch", index))
    dt = DTYPES[doc["dtype"]]
    B = traffic["images_per_batch"]
    R = B * traffic["rows_per_image"]
    T = traffic["text_len"]
    K, G = doc["max_proposals"], doc["seg_grid"]
    kw = dict(generator=g, device=device)
    ids = torch.randint(4, doc["llm"]["vocab_size"] - 4, (R, T), **kw, dtype=torch.int32)
    ids[:, T - 4] = doc["seg_token_id"]
    cy, cx = (torch.rand(B, K, 1, 1, **kw) * G for _ in range(2))
    r = G / 16 + torch.rand(B, K, 1, 1, **kw) * (G / 3 - G / 16)
    yy = torch.arange(G, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(G, device=device, dtype=torch.float32)[None, :]
    segs = ((yy - cy) ** 2 + (xx - cx) ** 2 < r * r).to(dt)
    dsz, csz = doc["dino"]["image_size"], doc["vision"]["image_size"]
    return {
        "images_dino": torch.randn(B, dsz, dsz, 3, **kw).to(dt),
        "images_clip": torch.randn(B, csz, csz, 3, **kw).to(dt),
        "input_ids": ids,
        "image_pos": torch.ones(R, dtype=torch.int32, device=device),
        "row_to_image": torch.arange(B, device=device).repeat_interleave(
            traffic["rows_per_image"]).to(torch.int32),
        "row_valid": torch.ones(R, dtype=torch.bool, device=device),
        "sam_segs": segs,
        "prop_valid": (torch.arange(K, device=device) < max(K - 2, 1)).expand(B, K).contiguous(),
    }


def compare(sim, iou, ref_sim, ref_iou, valid) -> Dict[str, float]:
    """The widest gaps of the two scores over the valid proposals."""
    v = valid.to(sim.device)
    return {"sim_gap": float((sim - ref_sim).abs()[v].max()),
            "iou_gap": float((iou - ref_iou).abs()[v].max())}


class Entry:
    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        self.cfg, self.traffic = cfg, traffic
        self.seed, self.device = seed, torch.device(device)
        self.dtype = DTYPES[cfg["dtype"]]
        self.outputs: Dict[int, tuple] = {}     # pool index -> (similarity, pred_iou) on the host
        self.calls = 0

    def setup(self) -> None:
        from llmseg_tpu_torch.models import llmseg
        self.llmseg = llmseg
        self.specs = llmseg_ref.param_specs(self.cfg)
        model = llmseg.build(program_config(self.cfg), device=self.device, dtype=self.dtype)
        weights.load_into(model, self.specs, sub_seed(self.seed, "weights"), self.device,
                          self.dtype)
        self.model = llmseg.fold_frozen_inplace(model)
        self.pool = [make_batch(self.cfg, self.traffic, self.seed, i, self.device)
                     for i in range(self.traffic["pool_batches"])]
        for i in range(self.traffic["warmup_calls"]):
            self._call(i % len(self.pool))
        self.calls = 0

    def _call(self, i: int) -> float:
        t0 = time.perf_counter()
        out = self.llmseg.predict(self.model, self.pool[i], device=self.device)
        sim, iou = out["pred_similarity"].float().cpu(), out["pred_iou"].float().cpu()
        dt = time.perf_counter() - t0
        self.outputs[i] = (sim, iou)
        return dt

    def window(self, seconds: float, max_steps: int = 0) -> Dict:
        lat: List[float] = []
        t0 = time.perf_counter()
        while (time.perf_counter() - t0 < seconds) if not max_steps else len(lat) < max_steps:
            lat.append(self._call(self.calls % len(self.pool)))
            self.calls += 1
        elapsed = time.perf_counter() - t0
        images = len(lat) * self.traffic["images_per_batch"]
        srt = sorted(lat)
        p95 = srt[max(0, -(-95 * len(srt) // 100) - 1)]
        return {"metrics": {"predict_img_per_s": images / elapsed, "predict_ms_p95": 1e3 * p95},
                "attempted": images, "failed": 0, "steps": len(lat),
                "host": {"step_s": elapsed / len(lat), "elapsed_s": elapsed}}

    def release(self) -> None:
        del self.model, self.pool
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def _sample(self) -> List[int]:
        done = sorted(self.outputs)
        g = torch.Generator().manual_seed(sub_seed(self.seed, "check"))
        pick = torch.randperm(len(done), generator=g)[:self.traffic["check_batches"]]
        return [done[int(i)] for i in pick]

    def _reference(self, precision: str, indices: List[int]):
        from reference.common import no_tf32
        no_tf32()
        tensors = weights.as_dict(self.specs, sub_seed(self.seed, "weights"), self.device,
                                  self.dtype)
        out = []
        for i in indices:
            batch = make_batch(self.cfg, self.traffic, self.seed, i, self.device)
            sim, iou = llmseg_ref.predict_scores(tensors, self.cfg, batch, precision)
            valid = batch["prop_valid"][batch["row_to_image"].long()]
            out.append((sim.cpu(), iou.cpu(), valid.cpu()))
        del tensors
        return out

    def check(self) -> Dict[str, float]:
        """The numbers of :func:`compare`, the worst over the sampled
        batches: the program's scores against the float32 reference's."""
        idx = self._sample()
        gaps = [compare(*self.outputs[i], *ref) for i, ref in zip(idx, self._reference("fp32", idx))]
        return {k: max(g[k] for g in gaps) for k in gaps[0]}

    def control(self, precision: str) -> Dict[str, float]:
        """The same numbers for the reference computed at ``precision`` in
        the program's place."""
        idx = self._sample()
        ref = self._reference("fp32", idx)
        low = self._reference(precision, idx)
        gaps = [compare(lo[0], lo[1], *r) for lo, r in zip(low, ref)]
        return {k: max(g[k] for g in gaps) for k in gaps[0]}
