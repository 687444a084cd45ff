"""Entry ``predict_mla_moe``: ``llmseg.predict`` with DeepSeek-V3's decoder
(the port's ``models/deepseek_v3.py``) in a closed loop with one caller, as
entry ``predict`` runs the LLaMA: the same batches (``predict.make_batch``),
the same window, the same gaps (``predict.compare``).  After each call it
keeps, for that batch, the experts every MoE layer chose: the device
tensors the program made, with no copy and no sync.

The check samples ``check_batches`` of the window's batches and recomputes
each with the float32 reference (``reference/llmseg_mla_moe_ref.py``),
whose MoE layers follow the program's choices; ``route_margin`` is how far
a choice of the program falls below the reference's own top k (0 where
they agree).  The control routes by the fp8 reference's own scores and is
held to the float32 reference that follows them.

The configuration document holds the decoder's published keys at its top
level (``configs/llmseg_kimivl_a3b.json``) and the towers' in their groups.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from entries import predict as P
from pbcore import sub_seed, weights
from reference import llmseg_mla_moe_ref as ref

# what the port's decoder computes, key by key: anything else is refused
FIXED = {"q_lora_rank": None, "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1,
         "norm_topk_prob": True, "scoring_func": "sigmoid", "moe_layer_freq": 1,
         "hidden_act": "silu", "rope_scaling": None, "attention_bias": False}


def program_config(doc: Dict):
    """The program's ``LLMSegConfig`` for the configuration document."""
    from llmseg_tpu_torch import config as C

    wrong = {k: doc[k] for k, v in FIXED.items() if doc[k] != v}
    if wrong or doc["num_key_value_heads"] != doc["num_attention_heads"]:
        raise ValueError(f"the port's DeepSeek-V3 decoder computes {FIXED}; got {wrong}")

    def vit(c):
        return C.ViTConfig(img_size=c["image_size"], patch_size=c["patch_size"],
                           hidden_size=c["hidden_size"], depth=c["num_hidden_layers"],
                           num_heads=c["num_attention_heads"],
                           mlp_ratio=c["intermediate_size"] / c["hidden_size"],
                           layernorm_pre=c["pre_layernorm"], layerscale=c["layerscale"],
                           use_quick_gelu=c["hidden_act"] == "quick_gelu",
                           ln_eps=c["layer_norm_eps"])

    llm = C.DeepseekV3Config(
        vocab_size=ref.vocab(doc), hidden_size=doc["hidden_size"],
        intermediate_size=doc["intermediate_size"],
        moe_intermediate_size=doc["moe_intermediate_size"],
        num_layers=doc["num_hidden_layers"], num_heads=doc["num_attention_heads"],
        kv_lora_rank=doc["kv_lora_rank"], qk_nope_head_dim=doc["qk_nope_head_dim"],
        qk_rope_head_dim=doc["qk_rope_head_dim"], v_head_dim=doc["v_head_dim"],
        n_routed_experts=doc["n_routed_experts"], num_experts_per_tok=doc["num_experts_per_tok"],
        n_shared_experts=doc["n_shared_experts"],
        first_k_dense_replace=doc["first_k_dense_replace"],
        routed_scaling_factor=doc["routed_scaling_factor"], max_seq_len=doc["max_seq_len"],
        rope_theta=float(doc["rope_theta"]), rms_norm_eps=doc["rms_norm_eps"],
        kv_norm_eps=ref.KV_NORM_EPS, tie_embeddings=doc["tie_word_embeddings"])
    vision, dino, s = vit(doc["vision"]), vit(doc["dino"]), doc["select"]
    llava = C.LlavaConfig(vision=vision, llm=llm, mm_hidden_size=vision.hidden_size,
                          vision_select_layer=doc["vision"]["select_layer"],
                          num_image_tokens=vision.num_patches)
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


def load_float32(model: torch.nn.Module, specs, seed: int, device) -> None:
    """Copy the seeded float32 weights (``ref.float32_specs``) into the
    model's buffers of those names, every one of its buffers specified."""
    buffers = dict(model.named_buffers())
    named = {name for name, _, _ in specs}
    if named != set(buffers):
        raise ValueError(f"float32 weights do not fit the program: unspecified "
                         f"{sorted(set(buffers) - named)[:5]}, "
                         f"unknown {sorted(named - set(buffers))[:5]}")
    weights.generate(specs, seed, device, torch.float32, lambda name, t: buffers[name].copy_(t))


class Entry(P.Entry):
    def setup(self) -> None:
        from llmseg_tpu_torch.models import llmseg
        self.llmseg = llmseg
        pcfg = program_config(self.cfg)
        self.specs = ref.param_specs(self.cfg)
        self.batch_doc = dict(self.cfg, llm={"vocab_size": self.cfg["vocab_size"]})
        model = llmseg.build(pcfg, device=self.device, dtype=self.dtype)
        weights.load_into(model, self.specs, sub_seed(self.seed, "weights"), self.device,
                          self.dtype)
        load_float32(model, ref.float32_specs(self.cfg), sub_seed(self.seed, "float32"),
                     self.device)
        self.model = llmseg.fold_frozen_inplace(model)
        self.moe = self.model.llava.llm.moe_layers()
        self.routes: Dict[int, List[torch.Tensor]] = {}
        self.pool = [P.make_batch(self.batch_doc, self.traffic, self.seed, i, self.device)
                     for i in range(self.traffic["pool_batches"])]
        for i in range(self.traffic["warmup_calls"]):
            self._call(i % len(self.pool))
        self.calls = 0

    def _call(self, i: int) -> float:
        dt = super()._call(i)
        self.routes[i] = [m.last_experts for m in self.moe]
        return dt

    def release(self) -> None:
        del self.moe
        super().release()

    def _reference(self, precision: str, indices: List[int], routes=None) -> List[Dict]:
        from reference.common import no_tf32
        no_tf32()
        tensors = weights.as_dict(self.specs, sub_seed(self.seed, "weights"), self.device,
                                  self.dtype)
        tensors.update(weights.as_dict(ref.float32_specs(self.cfg), sub_seed(self.seed, "float32"),
                                       self.device, torch.float32))
        out = []
        for n, i in enumerate(indices):
            batch = P.make_batch(self.batch_doc, self.traffic, self.seed, i, self.device)
            got = ref.predict_scores(tensors, self.cfg, batch, precision,
                                     None if routes is None else routes[n])
            got["valid"] = batch["prop_valid"][batch["row_to_image"].long()]
            out.append(got)
        del tensors
        return out

    @staticmethod
    def _gaps(pairs) -> Dict[str, float]:
        """The widest of :func:`predict.compare`'s gaps and of the route
        margins over (scores, reference) pairs."""
        gaps = [dict(P.compare(sim.cpu(), iou.cpu(), r["sim"].cpu(), r["iou"].cpu(),
                               r["valid"].cpu()), route_margin=r["route_margin"])
                for (sim, iou), r in pairs]
        return {k: max(g[k] for g in gaps) for k in gaps[0]}

    def check(self) -> Dict[str, float]:
        """The program's scores against the float32 reference that follows
        the program's routing, and the program's route margin."""
        idx = self._sample()
        refs = self._reference("fp32", idx, [self.routes[i] for i in idx])
        return self._gaps([(self.outputs[i], r) for i, r in zip(idx, refs)])

    def control(self, precision: str) -> Dict[str, float]:
        """The same numbers for the reference computed at ``precision`` in
        the program's place, with its own routing."""
        idx = self._sample()
        low = self._reference(precision, idx)
        refs = self._reference("fp32", idx, [lo["routes"] for lo in low])
        return self._gaps([((lo["sim"], lo["iou"]), r) for lo, r in zip(low, refs)])
