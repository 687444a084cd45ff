"""``llmseg_tpu_torch.serving``, ``models.sam.export``, the kernels' custom
ops and ``utils.profiling`` / ``utils.logging``, on the CPU.

The exported programs are held to the bit against the port's eager
functions on the same weights, and against the JAX package's exported
programs (``llmseg_tpu.serving``, ``llmseg_tpu.models.sam.export``) within
2e-5 absolute, the tolerance of ``tests/test_export.py``: the same float32
model in two frameworks, outputs of O(1).  W8A8 is held to JAX's W8A8
artifact as ``tests/test_torch_quant.py`` holds W8A8 ``predict``: within a
tenth of the quantization error, since a rounding tie that one side's
float32 sums put on the other side of .5 flips an int8 code.  A CPU torch
cannot run the card's route, but it can trace it: ``predict`` at
``llmseg_7b`` width is exported on fake CUDA tensors and its graph holds
the kernels' op nodes."""

import collections
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.overrides import TorchFunctionMode

from llmseg_tpu import config as JC
from llmseg_tpu import serving as jserving
from llmseg_tpu.data.synthetic import make_batch as jmake_batch
from llmseg_tpu.models import llmseg as jllmseg
from llmseg_tpu.models.sam import export as jexport
from llmseg_tpu.models.sam import sam as jsam
from llmseg_tpu.ops import quant as jquant
from llmseg_tpu_torch import config as TC
from llmseg_tpu_torch import serving
from llmseg_tpu_torch.data.synthetic import make_batch as tmake_batch
from llmseg_tpu_torch.import_weights.from_jax import load_
from llmseg_tpu_torch.models import llmseg as tllmseg
from llmseg_tpu_torch.models.sam import export as texport
from llmseg_tpu_torch.models.sam import sam as tsam
from llmseg_tpu_torch.ops import attention as TA
from llmseg_tpu_torch.ops import quant as TQ
from llmseg_tpu_torch.utils.logging import MetricLogger
from llmseg_tpu_torch.utils.profiling import StepTimer, trace

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=0)
TIE_FRACTION = 0.1     # of the W8A8 quantization error, as test_torch_quant.py
SHAPE = dict(num_images=1, rows=1, text_len=32)


def _jitter(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.randn(*np.shape(x))).astype(np.float32), tree)


def _predict_setup():
    params = _jitter(jllmseg.init(jax.random.PRNGKey(0), JC.llmseg_tiny()), 1)
    kw = dict(num_images=1, rows_per_image=1, text_len=32, seed=2)
    return params, jmake_batch(JC.llmseg_tiny(), **kw), tmake_batch(TC.llmseg_tiny(),
                                                                     device="cpu", **kw)


def _roundtrip(model, tb, path):
    serving.save_predict(path, model, dtype=torch.float32, **SHAPE)
    shapes = serving.predict_arg_shapes(TC.llmseg_tiny(), dtype=torch.float32, **SHAPE)
    return serving.load_predict(path)({k: tb[k] for k in shapes})


def _jax_artifact(params, jb, path):
    jserving.save_predict(path, jax.tree.map(jnp.asarray, params), JC.llmseg_tiny(),
                          dtype=jnp.float32, **SHAPE)
    shapes = jserving.predict_arg_shapes(JC.llmseg_tiny(), dtype=jnp.float32, **SHAPE)
    return jserving.load_predict(path)({k: jb[k] for k in shapes})


def _assert_same(got, ref):
    assert set(got) == set(serving.OUTPUTS)
    for k in serving.OUTPUTS:
        assert torch.equal(got[k], ref[k]), k


def test_predict_arg_shapes_match_jax():
    t = serving.predict_arg_shapes(TC.llmseg_tiny(), num_images=2, rows=3, text_len=40)
    j = jserving.predict_arg_shapes(JC.llmseg_tiny(), num_images=2, rows=3, text_len=40)
    assert set(t) == set(j)
    for k in t:
        assert t[k].device.type == "meta"
        assert tuple(t[k].shape) == j[k].shape, k
        assert str(t[k].dtype).rsplit(".", 1)[1] == str(j[k].dtype), k


def test_predict_roundtrip_matches_eager_and_jax(tmp_path):
    """float32 ``llmseg_tiny``: save -> load -> call equals eager predict to
    the bit and JAX's saved program within 2e-5."""
    params, jb, tb = _predict_setup()
    model = load_(tllmseg.build(TC.llmseg_tiny(), device="cpu"), params)
    got = _roundtrip(model, tb, str(tmp_path / "predict.pt2"))
    _assert_same(got, tllmseg.predict(model, tb, device="cpu"))
    ref = _jax_artifact(params, jb, str(tmp_path / "predict.stablehlo"))
    for k in ("pred_similarity", "pred_iou"):
        np.testing.assert_allclose(np.asarray(ref[k]), got[k].numpy(), **TOL)
    for k in ("prop_valid", "row_valid"):
        np.testing.assert_array_equal(np.asarray(ref[k]), got[k].numpy())


def test_predict_roundtrip_w8a8(tmp_path):
    """The LLaMA quantized W8A8 in place (JAX's quantized tree carried
    through ``from_jax``): the program holds Q1 and Q2 as op nodes (4 and 7
    a layer), equals eager predict to the bit, and JAX's W8A8 artifact
    within a tenth of the quantization error."""
    params, jb, tb = _predict_setup()
    jf = _jax_artifact(params, jb, str(tmp_path / "f32.stablehlo"))
    jquant.quantize_llama_inplace(params["llava"]["llm"], bits=8, w8a8=True)
    jq = _jax_artifact(params, jb, str(tmp_path / "w8a8.stablehlo"))
    model = load_(tllmseg.build(TC.llmseg_tiny(), device="cpu"),
                  jax.tree.map(np.asarray, params))
    ep = serving.export_predict(model, dtype=torch.float32, **SHAPE)
    nodes = collections.Counter(str(n.target) for n in ep.graph.nodes)
    layers = TC.llmseg_tiny().llava.llm.num_layers
    assert nodes["llmseg.quantize_rows.default"] == 4 * layers
    assert nodes["llmseg.w8a8_linear.default"] == 7 * layers
    got = _roundtrip(model, tb, str(tmp_path / "w8a8.pt2"))
    _assert_same(got, tllmseg.predict(model, tb, device="cpu"))
    for k in ("pred_similarity", "pred_iou"):
        g, q, f = (np.asarray(a[k], np.float32) for a in (got, jq, jf))
        qerr = np.abs(q - f).max()
        assert qerr > 1e-5, qerr
        assert np.abs(g - q).max() <= TIE_FRACTION * qerr, k


# ---------------------------------------------------------------------------
# SAM's decoder program
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_sam():
    params = _jitter(jsam.init(jax.random.PRNGKey(0), JC.sam_tiny()), 3)
    return params, load_(tsam.build(TC.sam_tiny(), device="cpu"), params)


def _decoder_inputs(cfg, batch=2, n_points=1, seed=1, mask_seed=None):
    rng = np.random.RandomState(seed)
    S, D = cfg.prompt.image_embedding_size, cfg.prompt.embed_dim
    emb = rng.randn(1, S, S, D).astype(np.float32)
    pts = (rng.rand(batch, n_points, 2) * cfg.encoder.img_size).astype(np.float32)
    lbl = np.ones((batch, n_points), np.int32)
    mask_in = (np.zeros((batch, 4 * S, 4 * S, 1), np.float32) if mask_seed is None else
               np.random.RandomState(mask_seed).randn(batch, 4 * S, 4 * S, 1).astype(np.float32))
    return emb, pts, lbl, mask_in


@pytest.mark.parametrize("options", [
    {}, {"return_single_mask": True, "use_stability_score": True},
    {"return_single_mask": True, "return_extra_metrics": True, "orig_hw": (48, 64)}],
    ids=["plain", "single_stability", "single_metrics"])
def test_decoder_roundtrip_matches_jax(tiny_sam, tmp_path, options):
    """save -> load -> call against the port's eager program (to the bit)
    and JAX's exported decoder (2e-5), without and with a mask input."""
    params, model = tiny_sam
    path = str(tmp_path / "decoder.pt2")
    texport.save_decoder(path, model, batch=2, n_points=2, **options)
    dec = texport.load_decoder(path)
    jpath = str(tmp_path / "decoder.stablehlo")
    jexport.save_decoder(jpath, params, JC.sam_tiny(), batch=2, n_points=2, **options)
    jdec = jexport.load_decoder(jpath)
    prog = texport.DecoderProgram(model, **options)
    for has_mask, mask_seed in ((0.0, None), (1.0, 3)):
        args = _decoder_inputs(TC.sam_tiny(), n_points=2, mask_seed=mask_seed)
        targs = [torch.tensor(a) for a in args] + [torch.tensor(has_mask)]
        got = dec(*targs)
        with torch.no_grad():
            eager = prog(*targs)
        assert all(torch.equal(g, e) for g, e in zip(got, eager))
        ref = jdec(*args, np.float32(has_mask))
        assert len(ref) == len(got)
        for r, g in zip(ref, got):
            assert tuple(np.shape(r)) == tuple(g.shape)
            np.testing.assert_allclose(np.asarray(r, np.float32), g.float().numpy(), **TOL)


def test_decoder_matches_decode_masks(tiny_sam):
    """The program's low-res masks and scores are ``decode_masks``' (every
    mask token; the multimask slice is tokens 1:), as tests/test_export.py
    holds JAX's."""
    _, model = tiny_sam
    emb, pts, lbl, mask_in = (torch.tensor(a) for a in _decoder_inputs(TC.sam_tiny()))
    with torch.no_grad():
        up, scores, low = texport.DecoderProgram(model)(emb, pts, lbl, mask_in,
                                                        torch.tensor(0.0))
        masks, iou = tsam.decode_masks(model, emb, points=pts, labels=lbl)
    torch.testing.assert_close(low[:, 1:], masks, atol=1e-5, rtol=0)
    torch.testing.assert_close(scores[:, 1:], iou, atol=1e-5, rtol=0)
    assert up.shape == (2, low.shape[1], 64, 64)


def test_decoder_mask_input_blend(tiny_sam):
    """has_mask_input switches the dense prompt from no_mask_embed to the
    downscaled mask: the outputs differ, as in JAX's test."""
    _, model = tiny_sam
    emb, pts, lbl, mask_in = (torch.tensor(a) for a in
                              _decoder_inputs(TC.sam_tiny(), mask_seed=3))
    prog = texport.DecoderProgram(model)
    with torch.no_grad():
        out0 = prog(emb, pts, lbl, mask_in, torch.tensor(0.0))[0]
        out1 = prog(emb, pts, lbl, mask_in, torch.tensor(1.0))[0]
    assert float((out0 - out1).abs().max()) > 1e-6


# ---------------------------------------------------------------------------
# The kernels' custom ops
# ---------------------------------------------------------------------------


def _rand(*shape, seed=0, dtype=torch.float32):
    return torch.tensor(np.random.RandomState(seed).randn(*shape), dtype=dtype)


OPCHECK_CASES = {
    "flash_fwd": lambda: (torch.ops.llmseg.flash_fwd.default,
                          (_rand(2, 65, 64, seed=0), _rand(2, 70, 64, seed=1),
                           _rand(2, 70, 64, seed=2), _rand(1, 65, 70, seed=3), False, True)),
    "flash_fwd_causal": lambda: (torch.ops.llmseg.flash_fwd.default,
                                 (_rand(2, 65, 128, seed=0), _rand(2, 65, 128, seed=1),
                                  _rand(2, 65, 128, seed=2), None, True, False)),
    "flash_fwd_1pass": lambda: (torch.ops.llmseg.flash_fwd_1pass.default,
                                (_rand(2, 65, 64, seed=0), _rand(2, 70, 64, seed=1),
                                 _rand(2, 70, 64, seed=2))),
    "flash_fwd_1pass_t": lambda: (torch.ops.llmseg.flash_fwd_1pass_t.default,
                                  (_rand(2, 65, 64, seed=0), _rand(2, 70, 64, seed=1),
                                   _rand(2, 70, 64, seed=2))),
    "quantize_rows": lambda: (torch.ops.llmseg.quantize_rows.default,
                              (_rand(5, 48, seed=4), None, 1e-6)),
    "quantize_rows_rms": lambda: (torch.ops.llmseg.quantize_rows.default,
                                  (_rand(5, 48, seed=4, dtype=torch.bfloat16),
                                   _rand(48, seed=5), 1e-6)),
    "w8a8_linear": lambda: (torch.ops.llmseg.w8a8_linear.default,
                            (torch.randint(-127, 128, (5, 32), dtype=torch.int8,
                                           generator=torch.Generator().manual_seed(0)),
                             _rand(5, 1, seed=6).abs(),
                             torch.randint(-127, 128, (24, 32), dtype=torch.int8,
                                           generator=torch.Generator().manual_seed(1)),
                             _rand(24, seed=7).abs(), _rand(24, seed=8, dtype=torch.bfloat16),
                             torch.bfloat16, _rand(5, 24, seed=9))),
}


@pytest.mark.parametrize("case", list(OPCHECK_CASES))
def test_opcheck(case):
    """``torch.library.opcheck`` on CPU tensors: the schema, the fake
    implementation against the CPU one (shapes, dtypes, strides), the
    autograd registration and tracing under AOT dispatch."""
    op, args = OPCHECK_CASES[case]()
    torch.library.opcheck(op, args)


def test_ops_on_the_cpu_are_the_plain_versions():
    """Each wrapper is a call of its op, whose CPU implementation is the
    plain version: equal to the bit, and no launch."""
    q, k, v = _rand(2, 65, 64, seed=0), _rand(2, 70, 64, seed=1), _rand(2, 70, 64, seed=2)
    bias = _rand(1, 65, 70, seed=3)
    before = [kern.launches for kern in TA.KERNELS + TQ.KERNELS]
    o, lse = TA.flash_fwd(q, k, v, causal=False, bias=bias, with_lse=True)
    ro, rl = TA.flash_fwd_plain(q, k, v, causal=False, bias=bias, with_lse=True)
    assert torch.equal(o, ro) and torch.equal(lse, rl)
    assert TA.flash_fwd(q, k, v, causal=True)[1] is None
    kmax = TA.key_norm_max(k)
    assert torch.equal(TA.flash_fwd_1pass(q, k, v), TA.flash_fwd_1pass_plain(q, k, v, kmax))
    assert torch.equal(TA.flash_fwd_1pass_t(q, k, v), TA.flash_fwd_1pass_t_plain(q, k, v, kmax))
    x, gamma = _rand(5, 48, seed=4), _rand(48, seed=5)
    for got, ref in zip(TQ.quantize_rows(x, gamma), TQ.quantize_rows_plain(x, gamma)):
        assert torch.equal(got, ref)
    assert [kern.launches for kern in TA.KERNELS + TQ.KERNELS] == before


def test_flash_attention_bias_matches_jax_reference():
    """``flash_attention_bias`` (A with an additive bias, scaled into the
    exp2 domain) against the JAX function's plain equivalent,
    ``attention_xla`` with the same bias, and against the port's
    ``attention_plain``; a bias broadcast over the heads and one per head."""
    from llmseg_tpu.ops import attention as JA
    rng = np.random.RandomState(7)
    B, T, S, H, D = 2, 40, 56, 2, 32
    q, k, v = (rng.randn(B, L, H, D).astype(np.float32) for L in (T, S, S))
    for bias in (rng.randn(1, T, S).astype(np.float32),
                 rng.randn(B * H, T, S).astype(np.float32)):
        got = TA.flash_attention_bias(*map(torch.tensor, (q, k, v)), torch.tensor(bias))
        b4 = bias.reshape(-1, H, T, S) if bias.shape[0] > 1 else bias[None]
        ref = JA.attention_xla(*map(jnp.asarray, (q, k, v)), bias=jnp.asarray(b4))
        np.testing.assert_allclose(np.asarray(ref), got.numpy(), atol=1e-5, rtol=1e-5)
        plain = TA.attention_plain(*map(torch.tensor, (q, k, v)), bias=torch.tensor(b4))
        torch.testing.assert_close(got, plain, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# The card's route, traced on fake CUDA tensors
# ---------------------------------------------------------------------------


def _getitem(x, idx):
    """``x[idx]`` through aten ops: basic indexing as views, then one
    ``aten.index`` for the tensor indices, as ``Tensor.__getitem__`` does.
    A CPU build of torch has no CUDA device guard, which ``__getitem__``
    takes even for a fake CUDA tensor; the aten ops take none."""
    aten = torch.ops.aten
    idx = idx if isinstance(idx, tuple) else (idx,)
    if Ellipsis in idx:
        k = idx.index(Ellipsis)
        real = sum(i is not None and i is not Ellipsis for i in idx)
        idx = idx[:k] + (slice(None),) * (x.dim() - real) + idx[k + 1:]
    dim, tensors = 0, []
    for i in idx:
        if i is None:
            x = aten.unsqueeze.default(x, dim)
        elif isinstance(i, int):
            x = aten.select.int(x, dim, i)
            continue
        elif isinstance(i, slice):
            if i != slice(None):
                x = aten.slice.Tensor(x, dim, i.start, i.stop, i.step or 1)
        else:
            tensors.append((dim, i))
        dim += 1
    if tensors:
        index = [None] * (tensors[-1][0] + 1)
        for d, t in tensors:
            index[d] = t
        x = aten.index.Tensor(x, index)
    return x


class _AtenIndexing(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.__getitem__:
            return _getitem(*args)
        return func(*args, **(kwargs or {}))


def test_getitem_emulation_matches_indexing():
    x = torch.arange(2 * 5 * 4 * 3, dtype=torch.float32).reshape(2, 5, 4, 3)
    i = torch.tensor([1, 0])
    for idx in ((slice(None), slice(1, 4)), (Ellipsis, slice(None, 2)), (Ellipsis, 0),
                (i, torch.tensor([3, 4])), (slice(None), None, 2), (i,), (0, slice(None, None, 2))):
        assert torch.equal(_getitem(x, idx), x[idx]), idx


def test_fake_cuda_export_holds_the_kernel_ops():
    """``predict`` at ``llmseg_7b`` width with 2 LLaMA layers and 2 DINOv2
    blocks, exported on fake CUDA tensors in bf16: one ``llmseg::flash_fwd``
    node a LLaMA layer, one ``llmseg::flash_fwd_1pass`` a DINOv2 block, and
    no softmax inside either tower (CLIP's 257 tokens and the selection
    head keep the plain path)."""
    base = TC.llmseg_7b()
    cfg = TC.replace(base, llava=TC.replace(base.llava, llm=TC.replace(base.llava.llm,
                                                                        num_layers=2)),
                     dino=TC.replace(base.dino, depth=2))
    model = tllmseg.LLMSeg(cfg, device="meta", dtype=torch.bfloat16).requires_grad_(False)
    with FakeTensorMode(allow_non_fake_inputs=True), _AtenIndexing():
        model = model.to_empty(device="cuda")
        ep = serving.export_predict(model, num_images=2, rows=2, text_len=512)
    nodes = [n for n in ep.graph.nodes if n.op == "call_function"]
    count = collections.Counter(str(n.target) for n in nodes)
    assert count["llmseg.flash_fwd.default"] == 2
    assert count["llmseg.flash_fwd_1pass.default"] == 2
    assert count["llmseg.flash_fwd_1pass_t.default"] == 0
    for n in nodes:
        if "llmseg" in str(n.target):
            assert n.args[0].meta["val"].device.type == "cuda"
        if "softmax" in str(n.target):
            where = list(n.meta["nn_module_stack"].values())[-1][0]
            assert not where.startswith(("model.llava.llm", "model.dino")), where


# ---------------------------------------------------------------------------
# utils.profiling and utils.logging, as tests/test_profiling.py
# ---------------------------------------------------------------------------


def test_step_timer():
    t = StepTimer()
    time.sleep(0.01)
    t.mark("data")
    time.sleep(0.02)
    t.mark("step")
    time.sleep(0.01)
    t.mark("data")
    avg = t.averages()
    assert avg["data"] > 0 and avg["step"] > 0
    assert abs(avg["data"] - 0.01) < 0.01
    t.reset()
    assert t.averages() == {}


def test_trace_disabled_noop(tmp_path):
    with trace(str(tmp_path / "prof"), enabled=False):
        pass
    assert not os.path.exists(tmp_path / "prof")


def test_trace_enabled(tmp_path):
    with trace(str(tmp_path / "prof"), enabled=True):
        torch.ones(8, 8) @ torch.ones(8, 8)
    path = tmp_path / "prof" / "trace.json"
    assert path.is_file() and "traceEvents" in path.read_text()


def test_metric_logger_writes_tensorboard(tmp_path):
    log = MetricLogger(str(tmp_path), use_tensorboard=True)
    log.add_scalar("val/giou", 0.5, 1)
    log.log_dict({"ciou": 0.25, "loss": torch.tensor(1.5)}, 2, prefix="val/")
    log.close()
    assert any(n.startswith("events.out.tfevents") for n in os.listdir(tmp_path))


def test_metric_logger_off_rank_and_without_sinks(tmp_path):
    for log in (MetricLogger(str(tmp_path / "r1"), rank=1),
                MetricLogger(str(tmp_path / "none"), use_tensorboard=False)):
        assert log.tb is None and log.wandb is None
        log.log_dict({"x": 1.0}, 0)
        log.close()
    assert not os.path.exists(tmp_path / "r1")
