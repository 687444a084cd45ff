"""``llmseg_tpu_torch.ops.quant`` and the quantized LLaMA against the JAX
package's ``ops.quant``, on the same numpy inputs from a seed, float32 on
the CPU (kernels Q1 and Q2 take their plain versions here).

Tolerances, by what can differ:
  * the weight quantizers: int values equal, scales to 1e-7 relative (the
    same float32 operations);
  * the activation quantizers: int8 values equal, the scale to 1e-6
    relative (the RMS form's mean of x^2 is summed in another order);
  * one quantized product: 1e-5 of max|ref| (another summation order);
  * SmoothQuant's vectors and folded weights: 1e-6 relative (pow in two
    libraries);
  * whole models (the LLaMA forward, predict): a rounding tie that one
    side's float32 sums put on the other side of .5 flips one int8 code,
    so the bound is a tenth of the mode's own quantization error, the
    largest |JAX quantized - JAX float32| of the same output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmseg_tpu import config as JC
from llmseg_tpu.data.synthetic import make_batch as jmake_batch
from llmseg_tpu.models import llama as jllama
from llmseg_tpu.models import llmseg as jllmseg
from llmseg_tpu.ops import quant as jquant
from llmseg_tpu_torch import config as TC
from llmseg_tpu_torch.data.synthetic import make_batch as tmake_batch
from llmseg_tpu_torch.import_weights import from_jax
from llmseg_tpu_torch.models import generate as tgenerate
from llmseg_tpu_torch.models import layers as TL
from llmseg_tpu_torch.models import llama as tllama
from llmseg_tpu_torch.models import llmseg as tllmseg
from llmseg_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)
MODES = {"int8": (8, False), "w8a8": (8, True), "int4": (4, False)}
QUANTIZERS = {"int8": (jquant.quantize_dense, tquant.quantize_dense),
              "w8a8": (jquant.quantize_dense_w8a8, tquant.quantize_dense_w8a8),
              "int4": (jquant.quantize_dense4, tquant.quantize_dense4)}
SCALE_RTOL = 1e-7
ACT_SC_RTOL = 1e-6
PRODUCT_TOL = 1e-5     # of max|ref|
PLAN_RTOL = 1e-6
TIE_FRACTION = 0.1     # of the mode's quantization error


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jitter(tree, seed):
    """Every leaf plus 0.05 N(0, 1), so that unit scales and zero biases
    carry signal."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: jnp.asarray(np.asarray(x) + 0.05 * rng.randn(*np.shape(x)), jnp.float32), tree)


def _holder(jleaf):
    """The port's module for a JAX quantized dense leaf, through from_jax
    (a placeholder ``nn.Linear`` that the load replaces)."""
    m = torch.nn.Module()
    m.lin = torch.nn.Linear(1, 1)
    return from_jax.load_(m, {"lin": _np(jleaf)}).lin


def _linear(w, b=None):
    lin = torch.nn.Linear(w.shape[0], w.shape[1], bias=b is not None)
    with torch.no_grad():
        lin.weight.copy_(torch.tensor(w.T))
        if b is not None:
            lin.bias.copy_(torch.tensor(b))
    return lin


def _assert_quantized_equal(jleaf, tmod, int_diff=0, scale_rtol=SCALE_RTOL):
    """The port's quantized module against a JAX quantized leaf: int values
    within ``int_diff`` codes (unpacked for int4), scales and bias to
    ``scale_rtol``."""
    flat = from_jax.flatten(_np(jleaf))
    bufs = dict(tmod.named_buffers())
    assert set(flat) == set(bufs), (set(flat), set(bufs))
    for name, arr in flat.items():
        got = bufs[name].numpy()
        if name == "w_q4":
            arr = tquant._unpack4(torch.tensor(arr)).numpy()
            got = tquant._unpack4(bufs[name]).numpy()
        if arr.dtype == np.int8:
            d = np.abs(arr.astype(np.int32) - got.astype(np.int32))
            assert d.max() <= int_diff, (name, d.max())
            assert (d > 0).mean() <= 1e-3, (name, (d > 0).mean())
        else:
            np.testing.assert_allclose(got, arr, rtol=scale_rtol, atol=0, err_msg=name)


def _within_quant_error(got, jq, jf):
    """max|got - JAX quantized| <= TIE_FRACTION * max|JAX quantized - JAX
    float32|, and that error is real."""
    got, jq, jf = (np.asarray(a, np.float32) for a in (got, jq, jf))
    qerr = np.abs(jq - jf).max()
    err = np.abs(got - jq).max()
    assert qerr > 1e-5, qerr
    assert err <= TIE_FRACTION * qerr, (err, qerr)


# ---------------------------------------------------------------------------
# Weight quantizers and products
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
def test_quantize_dense_matches_jax(mode):
    """int values equal, scales to 1e-7; int4 with an input width that is
    not a whole number of groups, its bytes equal to JAX's transposed."""
    rs = np.random.RandomState(0)
    in_dim = 300 if mode == "int4" else 64
    w = (rs.randn(in_dim, 32) * 0.1).astype(np.float32)
    b = (rs.randn(32) * 0.01).astype(np.float32)
    jfn, tfn = QUANTIZERS[mode]
    jq = jfn({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    tq = tfn(_linear(w, b))
    assert tquant.is_quantized(tq) and type(tq).__name__ == {
        "int8": "Int8Linear", "w8a8": "W8A8Linear", "int4": "Int4Linear"}[mode]
    _assert_quantized_equal(jq, tq)
    if mode == "int4":
        np.testing.assert_array_equal(tq.w_q4.numpy(), np.asarray(jq["w_q4"]).T)


def test_qdense4_roundtrip_exact_on_grid():
    """Weights on the int4 grid come back exactly, as in the JAX package."""
    w = (np.random.RandomState(0).randint(-7, 8, size=(256, 16)) * 0.5).astype(np.float32)
    got = tquant.qdense(tquant.quantize_dense4(_linear(w)), torch.eye(256))
    np.testing.assert_allclose(got.numpy(), w, rtol=1e-5, atol=1e-6)


def _outlier_xw(rs, in_dim=512, out_dim=64, rows=16, cols=(3, 77, 200), scale=80.0):
    """x and w with a few activation columns 80x the rest (the JAX tests'
    construction); every column maximum distinct, so that the top-k order
    is the same in both libraries."""
    w = rs.randn(in_dim, out_dim).astype(np.float32) * 0.1
    x = rs.randn(rows, in_dim).astype(np.float32)
    for c in cols:
        x[:, c] *= scale
        w[c, :] *= 0.02
    assert len(np.unique(np.abs(x).max(0))) == in_dim
    return x, w


def _tie_rows(rs, rows, cols):
    """Random rows, then one row of exact half-way values (max 127, so that
    the scale is 1): rounding must go half to even."""
    x = (rs.randn(rows, cols) * 2.0).astype(np.float32)
    tie = np.zeros(cols, np.float32)
    tie[:8] = [127.0, 2.5, 3.5, -2.5, -0.5, 0.5, 1.5, -126.5]
    return np.concatenate([x, tie[None]], 0)


@pytest.mark.parametrize("form", ["plain", "rms", "outliers"])
def test_quantize_activation_matches_jax(form):
    """xq equal, sc to 1e-6 relative; the top-k outlier columns, their
    values and the zeroed int8 operand equal."""
    rs = np.random.RandomState(7)
    if form == "outliers":
        x, _ = _outlier_xw(rs)
    else:
        x = _tie_rows(rs, 32, 64).reshape(3, 11, 64)
    gamma = (1.0 + 0.3 * rs.randn(64)).astype(np.float32)
    gamma[:8] = 1.0
    if form == "rms":
        j = jquant.rms_quantize_activation(jnp.asarray(x), jnp.asarray(gamma), 1e-6)
        t = tquant.rms_quantize_activation(torch.tensor(x), torch.tensor(gamma), 1e-6)
    else:
        k = 8 if form == "outliers" else 0
        j = jquant.quantize_activation(jnp.asarray(x), k=k)
        t = tquant.quantize_activation(torch.tensor(x), k=k)
    assert set(j) == set(t)
    np.testing.assert_array_equal(np.asarray(j["xq"]), t["xq"].numpy())
    np.testing.assert_allclose(t["sc"].numpy(), np.asarray(j["sc"]), rtol=ACT_SC_RTOL, atol=0)
    for key in ("idx", "x_out"):
        if key in j:
            np.testing.assert_array_equal(np.asarray(j[key]), t[key].numpy())
    if form != "outliers":   # the tie row: 2.5 -> 2, 3.5 -> 4, -0.5 -> 0, -126.5 -> -126
        assert t["xq"].reshape(-1, 64)[-1, :8].tolist() == [127, 2, 4, -2, 0, 0, 2, -126]


@pytest.mark.parametrize("mode", ["int8", "w8a8", "w8a8_outliers", "int4"])
def test_qdense_matches_jax(mode, monkeypatch):
    """One quantized product (bias included), through the module's forward,
    against ``quant.qdense``: 1e-5 of max|ref|."""
    rs = np.random.RandomState(1)
    if mode == "w8a8_outliers":
        x, w = _outlier_xw(rs)
        monkeypatch.setattr(jquant, "W8A8_OUTLIER_K", 8)
        monkeypatch.setattr(tquant, "W8A8_OUTLIER_K", 8)
        x = x.reshape(2, 8, -1)
    else:
        in_dim = 300 if mode == "int4" else 64
        w = (rs.randn(in_dim, 48) * 0.1).astype(np.float32)
        x = rs.randn(2, 7, in_dim).astype(np.float32)
    b = (rs.randn(w.shape[1]) * 0.01).astype(np.float32)
    jq = QUANTIZERS[mode.split("_")[0]][0]({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    ref = np.asarray(jquant.qdense(jq, jnp.asarray(x)))
    got = _holder(jq)(torch.tensor(x)).numpy()
    assert np.abs(got - ref).max() <= PRODUCT_TOL * np.abs(ref).max()


def test_shared_activation_quant_matches_per_product():
    """One shared quantize_activation for three products equals quantizing
    for each, exactly (it depends on x alone)."""
    rs = np.random.RandomState(3)
    x = torch.tensor(rs.randn(2, 7, 64).astype(np.float32))
    mods = [tquant.quantize_dense_w8a8(_linear(rs.randn(64, 48).astype(np.float32)))
            for _ in range(3)]
    qa = tquant.quantize_activation(x)
    for m in mods:
        torch.testing.assert_close(tquant.qdense_act(m, qa, x.dtype), m(x), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# SmoothQuant: statistics, plan and fold on a tiny LLaMA
# ---------------------------------------------------------------------------


def _gqa_cfgs():
    kw = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
              num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=512)
    return JC.LlamaConfig(**kw), TC.LlamaConfig(**kw)


def _llama(gqa=False, seed=0):
    """(JAX cfg, port cfg, jittered JAX params, the port's Llama loaded
    from them, token ids (2, 16))."""
    jcfg, tcfg = _gqa_cfgs() if gqa else (JC.llama_tiny(), TC.llama_tiny())
    params = _jitter(jllama.init(jax.random.PRNGKey(seed), jcfg), seed + 1)
    ids = np.random.RandomState(seed + 2).randint(4, 200, size=(2, 16)).astype(np.int32)
    return jcfg, tcfg, params, from_jax.load_(tllama.Llama(tcfg), _np(params)), ids


def _jstats(params, jcfg, ids, lora=None, lcfg=None):
    st: list = []
    jllama.apply(params, jcfg, input_ids=jnp.asarray(ids), quant_stats=st, lora=lora,
                 lora_cfg=lcfg)
    return _np(st)


@pytest.mark.parametrize("case", ["mha", "gqa", "gqa_head_dim"])
def test_smooth_plan_and_fold_match_jax(case):
    """The stats of the forward (1e-5), the plan's vectors and the folded
    weights (1e-6 relative) against JAX; the fold preserves the forward
    (the JAX test's 2e-4 / 2e-5), and without head_dim grouped-query
    attention skips the o site."""
    jcfg, tcfg, params, port, ids = _llama(gqa=case != "mha")
    head_dim = None if case == "gqa" else jcfg.head_dim
    stats = _jstats(params, jcfg, ids)
    tstats: list = []
    with torch.no_grad():
        h_ref = port(input_ids=torch.tensor(ids), quant_stats=tstats)
    for js, ts in zip(stats, tstats):
        assert set(js) == set(ts) == {"attn_in", "o_in", "mlp_in", "down_in"}
        for k in js:
            np.testing.assert_allclose(ts[k].numpy(), js[k], rtol=1e-5, atol=1e-6, err_msg=k)
    plan_j = jquant.llama_smooth_plan(params, stats, head_dim=head_dim)
    plan_t = tquant.llama_smooth_plan(port, from_jax.quant_stats(stats), head_dim=head_dim)
    for ej, et in zip(plan_j, plan_t):
        for k in ej:
            if ej[k] is None:
                assert et[k] is None and case == "gqa" and k.startswith("o")
            else:
                np.testing.assert_allclose(et[k].numpy(), np.asarray(ej[k]), rtol=PLAN_RTOL,
                                           err_msg=k)
    folded = jax.tree.map(lambda x: x, params)
    jquant.fold_smooth_llama_inplace(folded, stats, donate=False, head_dim=head_dim)
    tquant.fold_smooth_llama_inplace(port, stats, head_dim=head_dim)
    tparams = dict(port.named_parameters())
    for name, arr in from_jax.flatten(_np(folded)).items():
        np.testing.assert_allclose(tparams[name].detach().numpy(), arr, rtol=PLAN_RTOL,
                                   atol=1e-7, err_msg=name)
    with torch.no_grad():
        h_fold = port(input_ids=torch.tensor(ids))
    torch.testing.assert_close(h_fold, h_ref, rtol=2e-4, atol=2e-5)


def _lora(jcfg, rank, seed):
    """A LoRA overlay with nonzero B, drawn with numpy."""
    rs = np.random.RandomState(seed)
    outs = {"q": jcfg.num_heads * jcfg.head_dim, "v": jcfg.num_kv_heads * jcfg.head_dim}
    return {"layers": [{n: {"a": jnp.asarray(rs.randn(jcfg.hidden_size, rank) * 0.1, jnp.float32),
                            "b": jnp.asarray(rs.randn(rank, o) * 0.2, jnp.float32)}
                        for n, o in outs.items()} for _ in range(jcfg.num_layers)]}


@pytest.mark.parametrize("gqa", [False, True])
def test_fold_compensates_lora_like_jax(gqa):
    """The fold with a LoRA overlay: the folded overlay equals JAX's (1e-6
    relative), and the folded base with it keeps the forward of the
    original base with the original overlay."""
    jcfg, tcfg, params, port, ids = _llama(gqa=gqa, seed=4)
    lcfg_j, lcfg_t = JC.LoraConfig(rank=4), TC.LoraConfig(rank=4)
    lora = _lora(jcfg, 4, seed=9)
    tlora = from_jax.load_(tllama.LlamaLora(tcfg, lcfg_t), _np(lora))
    stats = _jstats(params, jcfg, ids, lora, lcfg_j)
    with torch.no_grad():
        h_ref = port(input_ids=torch.tensor(ids), lora=tlora, lora_cfg=lcfg_t)
    jlora = jax.tree.map(lambda x: x, lora)
    jquant.fold_smooth_llama_inplace(jax.tree.map(lambda x: x, params), stats, donate=False,
                                     lora=jlora, head_dim=jcfg.head_dim)
    tquant.fold_smooth_llama_inplace(port, stats, lora=tlora, head_dim=jcfg.head_dim)
    tparams = dict(tlora.named_parameters())
    for name, arr in from_jax.flatten(_np(jlora)).items():
        np.testing.assert_allclose(tparams[name].detach().numpy(), arr, rtol=PLAN_RTOL,
                                   atol=1e-7, err_msg=name)
    with torch.no_grad():
        h_comp = port(input_ids=torch.tensor(ids), lora=tlora, lora_cfg=lcfg_t)
    torch.testing.assert_close(h_comp, h_ref, rtol=2e-4, atol=2e-5)


def test_degenerate_stats_opt_out():
    """All-zero or non-finite stats give s = ones, as in JAX, and a fold
    with all-zero stats leaves every weight bit-identical."""
    w_max = np.abs(np.random.RandomState(0).randn(32)) + 0.1
    bad = np.ones(32)
    bad[3] = np.nan
    for a in (np.zeros(32), bad):
        np.testing.assert_array_equal(tquant._smooth_scales(a, w_max, 0.5).numpy(),
                                      np.asarray(jquant._smooth_scales(a, w_max, 0.5)))
        assert (tquant._smooth_scales(a, w_max, 0.5) == 1).all()
    jcfg, _, params, port, ids = _llama()
    zero = [{k: np.zeros_like(v) for k, v in st.items()} for st in _jstats(params, jcfg, ids)]
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    tquant.fold_smooth_llama_inplace(port, zero, head_dim=jcfg.head_dim)
    for n, p in port.named_parameters():
        assert torch.equal(p, before[n]), n


# ---------------------------------------------------------------------------
# Quantizing the LLaMA, its forward routes, from_jax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
def test_from_jax_carries_quantized_llama(mode):
    """A JAX-quantized tiny LLaMA (calibrated fold for W8A8 and int4)
    carried across holds the same int values and scales, in the matching
    modules; quantizing the carried float32 tree in the port, with the
    carried stats, gives the same (a code may move at a rounding tie that
    the fold's float32 puts on the other side of .5: at most one code, in
    at most 1e-3 of the values)."""
    bits, w8a8 = MODES[mode]
    jcfg, tcfg, params, port, ids = _llama(seed=5)
    stats = None if mode == "int8" else _jstats(params, jcfg, ids)
    jq = jquant.quantize_llama(params, bits=bits, w8a8=w8a8, smooth_stats=stats,
                               head_dim=jcfg.head_dim)
    carried = from_jax.load_(tllama.Llama(tcfg), _np(jq))
    tq = tquant.quantize_llama(port, bits=bits, w8a8=w8a8, smooth_stats=None if stats is None
                               else from_jax.quant_stats(stats), head_dim=jcfg.head_dim)
    for path in ("layers.0.attn.q", "layers.1.attn.o", "layers.1.mlp.up", "layers.0.mlp.down",
                 "lm_head"):
        leaf = jq
        for key in path.split("."):
            leaf = leaf[int(key)] if key.isdigit() else leaf[key]
        _assert_quantized_equal(leaf, carried.get_submodule(path), scale_rtol=0)
        _assert_quantized_equal(leaf, tq.get_submodule(path), int_diff=1, scale_rtol=PLAN_RTOL)
    np.testing.assert_allclose(tq.layers[1].post_norm.weight.detach().numpy(),
                               np.asarray(jq["layers"][1]["post_norm"]["scale"]), rtol=PLAN_RTOL)
    assert isinstance(port.layers[0].attn.q, torch.nn.Linear)   # the input is not changed


def test_quantize_llama_inplace_matches_functional():
    """The in-place variant gives the functional one's modules, bit for bit,
    and replaces every projection and lm_head, nothing else."""
    jcfg, tcfg, params, port, ids = _llama(seed=6)
    stats = from_jax.quant_stats(_jstats(params, jcfg, ids))
    ref = tquant.quantize_llama(port, bits=8, w8a8=True, smooth_stats=stats,
                                head_dim=jcfg.head_dim)
    out = tquant.quantize_llama_inplace(port, bits=8, w8a8=True, smooth_stats=stats,
                                        head_dim=jcfg.head_dim)
    assert out is port
    kinds = {n: type(m).__name__ for n, m in out.named_modules()
             if isinstance(m, (torch.nn.Linear, TL.W8A8Linear))}
    assert set(kinds.values()) == {"W8A8Linear"} and len(kinds) == 7 * jcfg.num_layers + 1
    ref_state, out_state = ref.state_dict(), out.state_dict()
    assert set(ref_state) == set(out_state)
    for k in ref_state:
        assert torch.equal(ref_state[k], out_state[k]), k


@pytest.mark.parametrize("route", ["fused", "shared"])
def test_llama_w8a8_forward_matches_jax(route, monkeypatch):
    """The W8A8 LLaMA (SmoothQuant folded in JAX, carried across): the fused
    RMS route of q/k/v and gate/up, and the shared route (the fused one
    switched off on both sides), against JAX's within a tenth of the
    quantization error; the port's two routes within the JAX test's
    bound (2e-2)."""
    jcfg, tcfg, params, _, ids = _llama(seed=7)
    stats = _jstats(params, jcfg, ids)
    jq = jquant.quantize_llama(params, bits=8, w8a8=True, smooth_stats=stats,
                               head_dim=jcfg.head_dim)
    port = from_jax.load_(tllama.Llama(tcfg), _np(jq))
    with torch.no_grad():
        fused = port(input_ids=torch.tensor(ids))
    if route == "shared":
        monkeypatch.setattr(jllama, "_rms_qdense", lambda *a: None)
        monkeypatch.setattr(tllama, "_rms_qdense", lambda *a: None)
    h_f = jllama.apply(params, jcfg, input_ids=jnp.asarray(ids))
    h_q = jllama.apply(jq, jcfg, input_ids=jnp.asarray(ids))
    with torch.no_grad():
        got = port(input_ids=torch.tensor(ids))
    _within_quant_error(got.numpy(), h_q, h_f)
    torch.testing.assert_close(got, fused, rtol=2e-2, atol=2e-2)


def test_rms_qdense_gates(monkeypatch):
    """The fused route opts out for a LoRA overlay, calibration stats, the
    outlier decomposition and a module that is not W8A8."""
    x = torch.ones(1, 4, 32)
    norm = TL.RMSNorm(32)
    lin = torch.nn.Linear(32, 16, bias=False)
    torch.nn.init.ones_(lin.weight)
    pq, pw = [tquant.quantize_dense_w8a8(lin)], [lin]
    assert tllama._rms_qdense(pq, x, norm, None, None) is not None
    assert tllama._rms_qdense(pw, x, norm, None, None) is None
    assert tllama._rms_qdense(pq, x, norm, torch.nn.ModuleDict(), None) is None
    assert tllama._rms_qdense(pq, x, norm, None, {}) is None
    monkeypatch.setattr(tquant, "W8A8_OUTLIER_K", 4)
    assert tllama._rms_qdense(pq, x, norm, None, None) is None


def test_quant_stats_exclude_remat():
    _, tcfg, _, port, ids = _llama()
    with pytest.raises(ValueError, match="remat"):
        port(input_ids=torch.tensor(ids), remat="full", quant_stats=[])


def test_generate_runs_on_a_w8a8_llama():
    """Greedy generation through the quantized routes (one-row steps, a
    quantized lm_head): the first token is the argmax of the quantized
    lm_head at the last prompt position, and the first step's hidden state
    is the full forward's over the prompt and that token (1e-4: the step
    attends in another order, which may move a rounding tie)."""
    jcfg, tcfg, params, port, ids = _llama(seed=8)
    q = tquant.quantize_llama(port, bits=8, w8a8=True)
    emb = q.embed_tokens(torch.tensor(ids))
    with torch.no_grad():
        tokens, hidden = tgenerate.greedy_generate(q, emb, 3)
        first = tllama.logits(q, q(inputs_embeds=emb)[:, -1:])[:, 0].argmax(-1)
        full = q(inputs_embeds=torch.cat([emb, q.embed_tokens(tokens[:, :1])], 1))
    assert tokens.shape == (2, 3) and torch.isfinite(hidden).all()
    assert torch.equal(tokens[:, 0], first)
    torch.testing.assert_close(hidden[:, 0], full[:, -1], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The slice as a whole: calibration and predict at llmseg_tiny
# ---------------------------------------------------------------------------


def _jpredict(params, batch):
    cfg = JC.llmseg_tiny()
    return _np(jax.jit(lambda p, b: jllmseg.predict(p, cfg, b))(params, batch))


def _model_and_batches(seed):
    params = _jitter(jllmseg.init(jax.random.PRNGKey(0), JC.llmseg_tiny()), seed)
    kw = dict(num_images=1, rows_per_image=2, text_len=32)
    jb = [jmake_batch(JC.llmseg_tiny(), seed=s, **kw) for s in (1, 7)]
    tb = [tmake_batch(TC.llmseg_tiny(), device="cpu", seed=s, **kw) for s in (1, 7)]
    return params, jb, tb


def test_calibrate_quant_stats_matches_jax():
    """One batch and an iterable of two (merged by elementwise max) against
    JAX (1e-4 relative, 1e-5 absolute: the whole float32 model before the
    statistic); the merge is the max of the single runs exactly; an empty
    iterable gives None."""
    params, jb, tb = _model_and_batches(seed=11)
    model = from_jax.load_(tllmseg.build(TC.llmseg_tiny(), device="cpu"), _np(params))
    cfg = JC.llmseg_tiny()
    singles = [tllmseg.calibrate_quant_stats(model, b) for b in tb]
    for jstats, tstats in ((jllmseg.calibrate_quant_stats(params, cfg, jb[0]), singles[0]),
                           (jllmseg.calibrate_quant_stats(params, cfg, iter(jb)),
                            tllmseg.calibrate_quant_stats(model, iter(tb)))):
        assert len(jstats) == len(tstats) == cfg.llava.llm.num_layers
        for js, ts in zip(jstats, tstats):
            for k in js:
                np.testing.assert_allclose(ts[k].numpy(), js[k], rtol=1e-4, atol=1e-5)
    for m, a, b in zip(tstats, *singles):
        for k in m:
            assert torch.equal(m[k], torch.maximum(a[k], b[k]))
    assert tllmseg.calibrate_quant_stats(model, iter([])) is None


@pytest.mark.parametrize("mode", list(MODES))
def test_predict_quantized_matches_jax(mode):
    """predict with the LLaMA in W8A8 (SmoothQuant), int8 or int4 (the
    AWQ-style fold): the JAX-quantized model carried through from_jax, and
    the float32 model quantized by the port after its own calibration,
    each against JAX's quantized predict within a tenth of the mode's
    quantization error."""
    bits, w8a8 = MODES[mode]
    params, jb, tb = _model_and_batches(seed=12)
    cfg = JC.llmseg_tiny()
    ref = _jpredict(params, jb[0])
    model = from_jax.load_(tllmseg.build(TC.llmseg_tiny(), device="cpu"), _np(params))
    jstats = None if mode == "int8" else jllmseg.calibrate_quant_stats(params, cfg, jb[0])
    tstats = None if mode == "int8" else tllmseg.calibrate_quant_stats(model, tb[0])
    jquant.quantize_llama_inplace(params["llava"]["llm"], bits=bits, w8a8=w8a8,
                                  smooth_stats=jstats, head_dim=cfg.llava.llm.head_dim)
    got_j = _jpredict(params, jb[0])
    carried = from_jax.load_(tllmseg.build(TC.llmseg_tiny(), device="cpu"), _np(params))
    tquant.quantize_llama_inplace(model.llava.llm, bits=bits, w8a8=w8a8, smooth_stats=tstats,
                                  head_dim=cfg.llava.llm.head_dim)
    for m in (carried, model):
        got = tllmseg.predict(m, tb[0], device="cpu")
        for k in ("pred_similarity", "pred_iou"):
            _within_quant_error(got[k].numpy(), got_j[k], ref[k])
        np.testing.assert_array_equal(got["prop_valid"].numpy(), got_j["prop_valid"])
