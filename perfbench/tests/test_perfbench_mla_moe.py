"""The cell ``llmseg_kimivl_a3b.predict_b4q3`` off the card: the entry
``predict_mla_moe`` at a tiny configuration on the CPU against its
reference, two planted routing faults, the fp8 control, the count functions
against the issue's figures, and the four new per-layer readers on
synthetic readings."""

import copy
import json
import time
from types import SimpleNamespace

import pytest
import torch

from pbcore import counts, manifest, runner, spans, trace
from pbcore import counts_mla_moe as M

CELL = "llmseg_kimivl_a3b.predict_b4q3"


def _tiny_doc():
    from conftest import LLMSEG_TINY
    doc = copy.deepcopy(LLMSEG_TINY)
    del doc["llm"]
    doc.update(manifest.load(CELL).entry().FIXED, vocab_size=200, hidden_size=64, intermediate_size=128,
               moe_intermediate_size=32, num_hidden_layers=3, num_attention_heads=4,
               num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
               v_head_dim=16, n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
               first_k_dense_replace=1, routed_scaling_factor=2.446, rope_theta=800000,
               rms_norm_eps=1e-5, tie_word_embeddings=False)
    return doc


@pytest.fixture
def cell():
    from conftest import PREDICT_TINY
    c = manifest.load(CELL)
    c.config = _tiny_doc()
    c.work = dict(c.work, traffic=dict(PREDICT_TINY, rows_per_image=3))
    return c


def _run(cell, seed=7, seconds=0.5, traced=False):
    lines = []
    res = runner.run_cell(cell.name, seed, seconds, traced, t_start=time.perf_counter(),
                          device="cpu", cell=cell, log=lines.append)
    return res, lines


def test_tiny_mla_moe_matches_reference(cell):
    res, lines = _run(cell, seed=2**31 + 11)
    assert res["correct"], res["checks"]
    c = res["checks"]
    assert c["sim_gap"]["value"] < 1e-4 and c["iou_gap"]["value"] < 1e-4, c
    assert c["route_margin"]["value"] == 0.0, c
    assert set(res["metrics"]) == {"predict_img_per_s", "predict_ms_p95", "setup_s"}
    assert lines[-1].startswith("check ")


def test_entry_keeps_each_batchs_expert_choices(cell):
    entry = cell.entry().Entry(cell.config, cell.traffic, 3, "cpu")
    entry.setup()
    entry.window(0.0, max_steps=3)
    R = cell.traffic["images_per_batch"] * cell.traffic["rows_per_image"]
    T = cell.traffic["text_len"] - 1 + 4
    assert sorted(entry.routes) == sorted(entry.outputs)
    for routes in entry.routes.values():
        assert [r.shape for r in routes] == [(R * T, 2)] * 2
    entry.release()
    assert not hasattr(entry, "moe") and not hasattr(entry, "model")


def test_entry_serves_the_correction_bias_in_float32(cell):
    """In a bf16 program the routers' correction biases are the float32
    draw of ``float32_specs``, finer than bf16 holds, and the reference
    gets the same values."""
    from pbcore import sub_seed, weights
    from reference import llmseg_mla_moe_ref as ref
    doc = dict(cell.config, dtype="bfloat16")
    entry = cell.entry().Entry(doc, dict(cell.traffic, warmup_calls=0), 4, "cpu")
    entry.setup()
    want = weights.as_dict(ref.float32_specs(doc), sub_seed(4, "float32"), "cpu", torch.float32)
    got = dict(entry.model.named_buffers())
    assert sorted(got) == sorted(want)
    for name, b in want.items():
        assert got[name].dtype == torch.float32 and torch.equal(got[name], b)
        assert not torch.equal(b.bfloat16().float(), b)
    assert entry.model.llava.llm.embed_tokens.weight.dtype == torch.bfloat16
    entry.release()


def _plant(monkeypatch, fault):
    from llmseg_tpu_torch.models import deepseek_v3 as DS
    if fault == "dropped_share":              # each token's first expert left out of the sum
        real = DS.Experts.forward

        def forward(self, x, idx, w):
            w = w.clone()
            w[:, 0] = 0.0
            return real(self, x, idx, w)

        monkeypatch.setattr(DS.Experts, "forward", forward)
    else:                                     # the choice made without the correction bias
        real = DS.Router.forward

        def forward(self, x):
            with torch.no_grad():
                saved = self.correction_bias.clone()
                self.correction_bias.zero_()
                idx, _ = real(self, x)
                self.correction_bias.copy_(saved)
            s = torch.sigmoid(torch.nn.functional.linear(x.float(), self.weight.float()))
            w = s.gather(1, idx)
            return idx, w / (w.sum(-1, keepdim=True) + 1e-20) * self.cfg.routed_scaling_factor

        monkeypatch.setattr(DS.Router, "forward", forward)


@pytest.mark.parametrize("fault, number", [("dropped_share", "sim_gap"),
                                           ("bias_ignored", "route_margin")])
def test_planted_routing_fault_fails(cell, monkeypatch, fault, number):
    _plant(monkeypatch, fault)
    res, _ = _run(cell)
    assert not res["correct"], res["checks"]
    c = res["checks"][number]
    assert c["value"] > c["limit"], res["checks"]


def test_control_reads_above_the_program(cell):
    entry = cell.entry().Entry(cell.config, cell.traffic, 5, "cpu")
    entry.setup()
    entry.window(0.0, max_steps=2)
    entry.release()
    prog = entry.check()
    ctrl = entry.control("fp8")
    assert ctrl["sim_gap"] > 100 * max(prog["sim_gap"], 1e-6), (ctrl, prog)
    assert prog["route_margin"] == 0.0 and ctrl["route_margin"] > 0.0, (ctrl, prog)


def test_parent_without_the_decoder_fails_at_once(cell, monkeypatch):
    """A program without ``DeepseekV3Config`` (the parent commit) stops in
    set-up, before any weight is drawn."""
    from llmseg_tpu_torch import config as C
    monkeypatch.delattr(C, "DeepseekV3Config")
    with pytest.raises((AttributeError, ImportError)):   # ImportError: the port's own import
        _run(cell)


def _full():
    root = manifest.ROOT
    cfg = json.loads((root / "perfbench/configs/llmseg_kimivl_a3b.json").read_text())
    work = json.loads((root / f"perfbench/workloads/{CELL}.json").read_text())
    return cfg, work["traffic"]


def test_counts_give_the_issues_figures():
    cfg, traffic = _full()
    rows, T = M.shape(cfg, traffic)
    assert (rows, T) == (12, 767)
    tf = {k: v / 1e12 for k, v in M.decoder_parts(cfg, rows, T).items()}
    want = {"routed_experts": 24.8, "shared_experts": 8.3, "mla_projections": 6.8,
            "dense": 1.3, "attention": 1.0}
    for k, v in want.items():
        assert tf[k] == pytest.approx(v, abs=0.05), (k, tf)
    assert sum(tf.values()) == pytest.approx(42.3, abs=0.1)
    t, which = M.mla_attention_bound(cfg, rows, T)
    assert which == "bytes" and t == pytest.approx(56.3e-6, rel=0.01)
    t, which = M.routed_experts_bound(cfg, rows, T)
    assert which == "operations" and t == pytest.approx(0.97e-3, rel=0.01)
    assert M.predict_flops(cfg, traffic) > sum(M.decoder_parts(cfg, rows, T).values())


def _reading(tmp_path, device):
    events = [{"ph": "X", "cat": "user_annotation", "name": "pb.window", "ts": 0,
               "dur": 10_000_000, "tid": 1}]
    events += [{"ph": "X", "cat": "kernel", "name": n, "ts": s, "dur": d} for n, s, d in device]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
    return trace.read_chrome_trace(str(p))


def _ctx(tmp_path, device, steps, **kw):
    cfg, traffic = _full()
    return SimpleNamespace(cfg=cfg, traffic=traffic, reading=_reading(tmp_path, device),
                           steps=steps, kernels=trace.kernel_specs(), counts=counts, **kw)


def test_attn_mla_roofline_reader(tmp_path):
    steps = 2
    dev = [("void flash_fwd_bf16<192, 128>(CUtensorMap)", 100 * i, 80) for i in range(54)]
    ctx = _ctx(tmp_path, dev, steps, launches={"flash_fwd": 54})
    got = manifest.load(CELL).metric_reader("attn_mla_roofline").read(ctx)
    cfg, traffic = _full()
    want = 100 * M.mla_attention_bound(cfg, *M.shape(cfg, traffic))[0] / 80e-6
    assert got == pytest.approx(want)
    ctx.launches = {"flash_fwd": 53}
    assert manifest.load(CELL).metric_reader("attn_mla_roofline").read(ctx) is None


@pytest.mark.parametrize("counted, kernels, want", [(104, 104, True), (104, 103, False),
                                                    (None, 104, False)])
def test_moe_expert_roofline_reader(tmp_path, monkeypatch, counted, kernels, want):
    """The grouped GEMMs' time against their bound; None unless the profile
    has as many as the program counted, or where it counted nothing."""
    name = ("void cutlass::device_kernel<at::cuda::detail::enable_3x_kernel_for_sm9x<"
            "cutlass::gemm::kernel::GemmUniversal<cutlass::gemm::GroupProblemShape<x>>>>(y)")
    dev = [(name, 2000 * i, 1500) for i in range(kernels)] + [("elementwise", 5, 1)]
    snap = {"spans": {}, "counters": {} if counted is None else {"moe.grouped_gemms": counted}}
    monkeypatch.setattr(spans, "snapshot", lambda: snap)
    got = manifest.load(CELL).metric_reader("moe_expert_roofline").read(
        _ctx(tmp_path, dev, 2))
    if not want:
        assert got is None
        return
    cfg, traffic = _full()
    per_layer = M.routed_experts_bound(cfg, *M.shape(cfg, traffic))[0]
    assert got == pytest.approx(100 * per_layer * 52 / (104 * 1500e-6))


def test_mfu_and_moe_host_ms_readers(tmp_path, monkeypatch):
    ctx = _ctx(tmp_path, [], 4, host={"step_s": 0.2})
    cfg, traffic = _full()
    reader = manifest.load(CELL).metric_reader
    assert reader("mfu.predict_moe").read(ctx) == pytest.approx(
        100 * M.predict_flops(cfg, traffic) / (0.2 * counts.PEAKS["bf16_flop_per_s"]))
    snap = {"spans": {"llm.moe": {"n": 104, "host_ms": 12.0, "self_ms": 10.0,
                                  "stream_ms": None}}, "counters": {}}
    monkeypatch.setattr(spans, "snapshot", lambda: snap)
    assert reader("moe.host_ms.predict").read(ctx) == pytest.approx(3.0)
    snap["spans"] = {}
    assert reader("moe.host_ms.predict").read(ctx) is None
