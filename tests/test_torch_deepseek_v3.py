"""DeepSeek-V3's decoder (``models/deepseek_v3.py``, Kimi-VL-A3B's language
model) at a tiny size on the CPU, against the plain float32 reference beside
these tests (``deepseek_v3_ref.py``): the decoder, the router's semantics,
the grouped products against a loop over experts, the RoPE pair layout,
``llmseg.predict`` through it, and the paths it refuses.  Seeded weights,
float32; tolerances 1e-5 (another summation order)."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import deepseek_v3_ref as ref  # noqa: E402

from llmseg_tpu_torch import config as C  # noqa: E402
from llmseg_tpu_torch.data.synthetic import make_batch  # noqa: E402
from llmseg_tpu_torch.models import deepseek_v3 as DS  # noqa: E402
from llmseg_tpu_torch.models import llmseg  # noqa: E402
from llmseg_tpu_torch.ops import moe as MO  # noqa: E402

CFG = C.deepseek_v3_tiny()


def _decoder(seed=0, cfg=CFG, bias_std=0.1):
    """The tiny decoder with seeded weights; correction biases N(0, bias_std)."""
    llm = DS.DeepseekV3(cfg, device="cpu", dtype=torch.float32)
    llmseg.random_init_(llm, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in llm.moe_layers():
            m.router.correction_bias.copy_(torch.randn(cfg.n_routed_experts, generator=g)
                                           * bias_std)
    return llm


def _x(B=2, T=40, seed=3, cfg=CFG):
    return torch.randn(B, T, cfg.hidden_size, generator=torch.Generator().manual_seed(seed))


def test_tiny_decoder_matches_the_reference():
    llm = _decoder()
    x = _x()
    routes = []
    with torch.no_grad():
        got = llm(inputs_embeds=x)
        want = ref.decoder(llm.state_dict(), CFG, x, routes)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert len(routes) == CFG.num_layers - CFG.first_k_dense_replace
    for m, r in zip(llm.moe_layers(), routes):
        assert torch.equal(m.last_experts, r)


def test_router_bias_moves_the_choice_and_not_the_weights():
    """The correction bias picks the experts; the weights are the sigmoid
    scores at the chosen ones, normalised over them and times
    routed_scaling_factor; the scores are float32 whatever the input."""
    cfg = C.replace(CFG, n_routed_experts=8, num_experts_per_tok=3)
    router = DS.Router(cfg)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        router.weight.copy_(torch.randn(8, cfg.hidden_size, generator=g) * 0.2)
        router.correction_bias.zero_()
    x = torch.randn(64, cfg.hidden_size, generator=g)
    s = torch.sigmoid(x @ router.weight.t())
    with torch.no_grad():
        idx0, w0 = router(x)
        router.correction_bias[0] = 10.0          # expert 0 always chosen
        router.correction_bias[1] = -10.0         # expert 1 never
        idx1, w1 = router(x)
    assert torch.equal(idx0, torch.topk(s, 3).indices)
    assert bool((idx1 == 0).any(-1).all()) and not bool((idx1 == 1).any())
    assert not torch.equal(idx0.sort(-1).values, idx1.sort(-1).values)
    for idx, w in ((idx0, w0), (idx1, w1)):
        sel = s.gather(1, idx)
        torch.testing.assert_close(w, sel / sel.sum(-1, keepdim=True) * 2.446)
        torch.testing.assert_close(w.sum(-1), torch.full((64,), 2.446))
    bf16 = DS.Router(cfg, dtype=torch.bfloat16)
    with torch.no_grad():
        bf16.weight.copy_(router.weight)
        idx2, w2 = bf16(x.to(torch.bfloat16))
    assert w2.dtype == torch.float32
    sb = torch.sigmoid(x.to(torch.bfloat16).float() @ bf16.weight.float().t())
    torch.testing.assert_close(w2, (lambda t: t / t.sum(-1, keepdim=True) * 2.446)(
        sb.gather(1, idx2)), atol=1e-6, rtol=1e-6)


def test_correction_bias_stays_float32_in_a_bf16_model():
    """The bias is a float32 buffer in a bf16 model (DeepSeek-V3's inference
    code keeps it so), through ``build``, ``init`` and a state dict: a gap
    in it finer than bf16's spacing near 1 still decides the choice."""
    cfg = C.replace(CFG, n_routed_experts=4, num_experts_per_tok=1)
    router = DS.Router(cfg, dtype=torch.bfloat16)
    assert router.correction_bias.dtype == torch.float32
    assert "correction_bias" not in dict(router.named_parameters())
    with torch.no_grad():
        router.weight.zero_()                          # every score sigmoid(0) = 1/2
        router.correction_bias.copy_(torch.tensor([1.0, 1.001, 1.002, 1.0]))
    assert float(torch.tensor(1.002).bfloat16()) == 1.0    # bf16 would lose the gap
    idx, w = router(torch.randn(5, cfg.hidden_size, dtype=torch.bfloat16))
    assert bool((idx == 2).all())
    torch.testing.assert_close(w, torch.full((5, 1), 2.446))
    model = llmseg.init(C.llmseg_mla_moe_tiny(), seed=1, device="cpu", dtype=torch.bfloat16)
    for m in model.llava.llm.moe_layers():
        assert m.router.correction_bias.dtype == torch.float32
        assert bool((m.router.correction_bias == 0).all())
    sd = model.llava.llm.state_dict()
    assert sd["layers.1.mlp.router.correction_bias"].dtype == torch.float32


@pytest.mark.parametrize("N", [1, 7, 200])
def test_grouped_products_match_a_loop_over_experts(N):
    """``Experts.forward`` (sort, group ends, two grouped products) and its
    combine (each token's rows read back through the inverse order, weighted
    and summed) against each expert on its own tokens, with experts that get
    no token at all."""
    llm = _decoder(seed=2)
    moe = llm.moe_layers()[0]
    g = torch.Generator().manual_seed(N)
    x = torch.randn(N, CFG.hidden_size, generator=g)
    idx = torch.stack([torch.randperm(4, generator=g)[:2] for _ in range(N)])  # experts 0-3 only
    w = torch.rand(N, 2, generator=g)
    with torch.no_grad():
        got = MO.combine(moe.experts(x, idx, w))
    W = {k: v for k, v in llm.state_dict().items()}
    want = ref.routed(W, "layers.1.mlp.", CFG, x, idx, w)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def _routed(N, k, d, E=10, seed=0, skip=None):
    """A ``Routed`` as ``Experts.forward`` leaves it: random expert choices
    (never ``skip``), the rows sorted stably by expert, seeded values."""
    g = torch.Generator().manual_seed(seed)
    experts = [e for e in range(E) if e != skip]
    idx = torch.tensor(experts)[torch.stack([torch.randperm(len(experts), generator=g)[:k]
                                             for _ in range(N)])]
    order = torch.sort(idx.reshape(-1), stable=True).indices
    y = torch.randn(N * k, d, generator=g)
    w = torch.rand(N, k, generator=g) * 2.446
    return MO.Routed(y, order, w), torch.randn(N, d, generator=g)


@pytest.mark.parametrize("N,k,d", [(1, 1, 8), (7, 6, 64), (200, 8, 24), (33, 2, 16)])
def test_plain_combine_matches_the_previous_formula(N, k, d):
    """The combine's plain version (the inverse order, an ordered float32
    sum, the shared row last, one rounding) against the steps it replaced:
    ``index_copy_`` back to pair order, the float32 products, ``.sum(1)``,
    the shared row added; within float32 rounding, and one bf16 rounding
    of the same sums in bf16 (an expert that gets no pair)."""
    routed, shared = _routed(N, k, d, seed=N + k, skip=3)
    y, order, w = routed
    inv = MO.inverse(order)
    assert torch.equal(order[inv], torch.arange(N * k)) and torch.equal(inv[order], order[inv])
    before = torch.empty_like(y).index_copy_(0, order, y).view(N, k, d)
    before = (before.float() * w[..., None]).sum(1)
    for sh in (None, shared):
        got = MO.combine(routed, sh)
        want = before if sh is None else before + sh
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    b16 = MO.Routed(y.bfloat16(), order, w)
    got = MO.combine(b16, shared.bfloat16())
    want = (torch.empty_like(b16.y).index_copy_(0, order, b16.y).view(N, k, d).float()
            * w[..., None]).sum(1) + shared.bfloat16().float()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.bfloat16().float(), atol=1e-2, rtol=2 ** -8)


def test_the_wrapper_names_what_the_kernel_does_not_take():
    """``moe_combine`` raises before any launch: d not a multiple of 8, k
    above 8, a weight that is not float32, tensors off the card."""
    routed, shared = _routed(4, 2, 12)
    inv = MO.inverse(routed.order)
    with pytest.raises(ValueError, match=r"d = 12.*not all on one card"):
        MO.moe_combine(routed.y, inv, routed.w, shared)
    routed, _ = _routed(2, 9, 16, E=12)
    with pytest.raises(ValueError, match=r"k = 9"):
        MO.moe_combine(routed.y, MO.inverse(routed.order), routed.w)
    routed, _ = _routed(2, 2, 16)
    with pytest.raises(ValueError, match=r"w is torch.float64"):
        MO.moe_combine(routed.y, MO.inverse(routed.order), routed.w.double())


def test_moe_counts_once_a_block_and_combines_plain_on_the_cpu():
    """Under the profiler each MoE block counts its two grouped products and
    its pairs once a forward; on the CPU the combine is the plain version,
    so ``moe.combine_kernels`` stays 0 and the kernel never launches."""
    from llmseg_tpu_torch.utils import profiling
    llm = _decoder()
    n_moe = len(llm.moe_layers())
    launches = MO.MOE_COMBINE.launches
    profiling.reset()
    try:
        with torch.no_grad(), torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            llm(inputs_embeds=_x())
            llm(inputs_embeds=_x(seed=4))
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.reset()
    assert n_moe == 2
    assert counters["moe.grouped_gemms"] == 2 * 2 * n_moe
    assert counters["moe.routed_pairs"] == 2 * n_moe * 2 * 40 * CFG.num_experts_per_tok
    assert counters.get("moe.combine_kernels", 0) == 0
    assert MO.MOE_COMBINE.launches == launches


def test_rope_pair_layout():
    """Pair (x_2j, x_2j+1) is turned by position * theta^(-2j/D) and lands
    at (j, j + D/2); position 0 only permutes."""
    from llmseg_tpu_torch.models import layers as L
    D, T = 8, 5
    x = torch.randn(1, T, 3, D, generator=torch.Generator().manual_seed(1))
    cos, sin = L.rope_frequencies(D, T, CFG.rope_theta)
    got = DS.apply_rope_pairs(x, cos, sin)
    torch.testing.assert_close(got, ref.rope_pairs(x, CFG.rope_theta), atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(got[0, 0], torch.cat([x[0, 0, :, 0::2], x[0, 0, :, 1::2]], -1))
    t, j = 3, 1
    a = CFG.rope_theta ** (-2 * j / D) * t
    want = x[0, t, :, 2 * j] * torch.cos(torch.tensor(a)) - x[0, t, :, 2 * j + 1] * torch.sin(
        torch.tensor(a))
    torch.testing.assert_close(got[0, t, :, j], want, atol=1e-6, rtol=1e-6)


class _RefLLM(torch.nn.Module):
    """The reference decoder behind ``Llama``'s contract, on the port's
    weights: ``embed`` is the table's rows."""

    def __init__(self, llm):
        super().__init__()
        self.weights, self.cfg = llm.state_dict(), llm.cfg
        self.table = llm.embed_tokens.weight

    def embed(self, ids):
        return self.table[ids]

    def forward(self, *, inputs_embeds, **_):
        return ref.decoder(self.weights, self.cfg, inputs_embeds).to(inputs_embeds.dtype)


def test_predict_through_the_tiny_mla_moe_llm_matches_the_reference():
    """``llmseg.predict`` at ``llmseg_mla_moe_tiny``: the Llava builds the
    DeepSeek-V3 decoder, and the scores equal those of the same model with
    the reference decoder in its place."""
    cfg = C.llmseg_mla_moe_tiny()
    model = llmseg.init(cfg, seed=4, device="cpu")
    assert isinstance(model.llava.llm, DS.DeepseekV3)
    with torch.no_grad():
        for m in model.llava.llm.moe_layers():
            m.router.correction_bias.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(9))
    batch = make_batch(cfg, num_images=2, rows_per_image=3, text_len=24, seed=6, device="cpu")
    got = llmseg.predict(model, batch, device="cpu")
    R, T = 6, 24 - 1 + cfg.llava.num_image_tokens
    assert [m.last_experts.shape for m in model.llava.llm.moe_layers()] == [(R * T, 2)] * 2
    model.llava.llm = _RefLLM(model.llava.llm)
    want = llmseg.predict(model, batch, device="cpu")
    for k in ("pred_similarity", "pred_iou"):
        torch.testing.assert_close(got[k], want[k], atol=1e-5, rtol=1e-5)
    assert float(got["pred_similarity"].std()) > 0


def test_refuses_lora_quant_stats_training_and_the_rest():
    """The decoder's config names every path not ported for it, and the one
    check raises for each with the words its callers are matched on;
    LLaMA's config names none."""
    words = {"lora": "LoRA", "quant_stats": "quant_stats", "training": "training",
             "cache": "cache", "quantization": "quantization", "mesh": "mesh"}
    assert C.DeepseekV3Config.unported == set(words) == set(C.UNPORTED)
    for path, word in words.items():
        with pytest.raises(NotImplementedError, match=word):
            C.require_ported(CFG, path)
        C.require_ported(C.llama_tiny(), path)
    assert not C.LlamaConfig.unported


def _refusal_sites():
    """Each place that refuses an unported path of the decoder: (the path,
    a call that reaches it)."""
    from llmseg_tpu_torch.models import generate
    from llmseg_tpu_torch.ops import quant
    from llmseg_tpu_torch.parallel import mesh

    def model():
        return llmseg.init(C.llmseg_mla_moe_tiny(), seed=1, device="cpu")

    def forward(**kw):
        def call():
            with torch.no_grad():
                return _decoder()(inputs_embeds=_x(1, 8), **kw)
        return call

    def training():
        return _decoder()(inputs_embeds=_x(1, 8))          # grad on

    return {
        "llmseg.LLMSeg(lora_cfg)": ("lora", lambda: llmseg.build(
            C.llmseg_mla_moe_tiny(), device="cpu", lora_cfg=C.LoraConfig())),
        "generate.prefill_cache": ("cache", lambda: generate.prefill_cache(
            _decoder(), _x(1, 8), 10)),
        "generate.greedy_generate": ("cache", lambda: generate.greedy_generate(
            _decoder(), _x(1, 8), 2)),
        "quant.quantize_llama": ("quantization", lambda: quant.quantize_llama(_decoder())),
        "quant.quantize_llama_inplace": ("quantization", lambda: quant.quantize_llama_inplace(
            _decoder(), w8a8=True)),
        "mesh.shard_params": ("mesh", lambda: mesh.shard_params(model(), mesh.Mesh(tp=2))),
        "DeepseekV3.forward(lora_cfg)": ("lora", forward(lora_cfg=C.LoraConfig())),
        "DeepseekV3.forward(quant_stats)": ("quant_stats", forward(quant_stats=[])),
        "DeepseekV3.forward(grad on)": ("training", training),
    }


@pytest.mark.parametrize("site", list(_refusal_sites()))
def test_each_refusal_site_raises_the_configs_message(site):
    path, call = _refusal_sites()[site]
    with pytest.raises(NotImplementedError) as want:
        C.require_ported(CFG, path)
    with pytest.raises(NotImplementedError) as got:
        call()
    assert str(got.value) == str(want.value)


def test_ops_and_parallel_import_no_decoder_module():
    """The decoder's refusals live in its config: no module under ops/ or
    parallel/ imports models.deepseek_v3 (read from the sources)."""
    import ast
    import pathlib

    import llmseg_tpu_torch
    root = pathlib.Path(llmseg_tpu_torch.__file__).parent
    files = sorted([*root.glob("ops/**/*.py"), *root.glob("parallel/**/*.py")])
    assert files
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module] + [f"{node.module}.{a.name}" for a in node.names]
            elif isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            else:
                continue
            assert "llmseg_tpu_torch.models.deepseek_v3" not in names, f


def test_plain_attention_takes_vs_own_head_dim():
    """Kernel A's plain version and its op on the CPU and on meta tensors at
    q/k head dim 192 and v 128 (the card's kernel is in test_torch_cuda.py):
    exp2-domain softmax of the pre-scaled logits times v."""
    from llmseg_tpu_torch.ops import attention as A
    g = torch.Generator().manual_seed(2)
    q, k = (torch.randn(3, 20, 192, generator=g) for _ in "qk")
    v = torch.randn(3, 20, 128, generator=g)
    q = q * (A.LOG2E / 192 ** 0.5)
    o, lse = A.flash_fwd_plain(q, k, v, causal=True, with_lse=True)
    s = (q @ k.transpose(1, 2)) / A.LOG2E
    s = s.masked_fill(torch.ones(20, 20, dtype=torch.bool).triu(1), float("-inf"))
    torch.testing.assert_close(o, torch.softmax(s, -1) @ v, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1) * A.LOG2E, atol=1e-5, rtol=1e-5)
    op_o, _ = A.flash_fwd(q, k, v, causal=True)
    torch.testing.assert_close(op_o, o)
    meta = A.flash_fwd(q.to("meta"), k.to("meta"), v.to("meta"), causal=True)[0]
    assert meta.shape == (3, 20, 128)
    q4, k4, v4 = (t.reshape(1, 3, 20, -1).transpose(1, 2) for t in (q, k, v))
    got = A.attention(q4, k4, v4, causal=True)
    torch.testing.assert_close(got, A.attention_plain(q4, k4, v4, causal=True))
    assert got.shape == (1, 20, 3, 128)
    with pytest.raises(ValueError, match="head dims"):
        A.flash_fwd(*(t.to("meta") for t in (q[..., :160], k[..., :160], v)), causal=True)
