"""Kernels H's and I's recorded launch sequence (``twoway_kernel.tw_program``)
interpreted with torch (``Program.run_torch``), and the plan that keeps it.

The sequence is what the card runs in one C call: in float32 the unfused
records (the projections over the image tokens on the strided GEMM, the
scalar attention and mask kernels), in bf16 the fused records that sweep
over L with every keys-side projection folded into the token side.  Held
against the plain versions ``fused_decode_plain`` / ``fused_twoway_plain``
(float32 within 1e-4 of max|ref|: the same operations summed in another
order; bf16 within 5e-2 of max|ref|, normwise, as the card holds kernels H
and I: the folded products round at other places) at sam_tiny's decoder
widths and at a decoder of 8 heads (M = 8 N = 128 rows at 16 tokens), with
a base per prompt and a shared one; the float32 sequence also against the
JAX package's interpret-mode ``_decode_kernel`` and ``_kernel`` (1e-5, as
the JAX package's own tests); and each fused record against the unfused
records it replaces.  The plan's cache is tested with its launch replaced
by the torch interpretation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmseg_tpu.config import SamDecoderConfig as JDC
from llmseg_tpu.models.sam import mask_decoder as jmd
from llmseg_tpu.ops import twoway_kernel as jtk
from llmseg_tpu_torch.config import SamDecoderConfig as TDC, sam_tiny
from llmseg_tpu_torch.import_weights.from_jax import load_
from llmseg_tpu_torch.models.sam import sam as S_
from llmseg_tpu_torch.models.sam.mask_decoder import MaskDecoder
from llmseg_tpu_torch.ops import twoway_kernel as tk

torch.set_num_threads(1)
H8 = dict(transformer_dim=64, transformer_depth=2, transformer_num_heads=8,
          transformer_mlp_dim=128, iou_head_hidden_dim=32)
TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
S = 8     # the image grid: L = 64, one fused tile


def _decoder(cfg, dtype, seed):
    """A decoder from a seed, with noise on every 1-D parameter so that no
    bias or norm is trivial."""
    dec = MaskDecoder(cfg)
    S_.random_init_(dec, torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed + 1)
    with torch.no_grad():
        for p in dec.parameters():
            if p.ndim == 1:
                p.add_(torch.tensor(0.1 * rng.randn(*p.shape), dtype=p.dtype))
    return dec.to(dtype)


def _inputs(P, Bi, N, d, dtype, seed):
    rng = np.random.RandomState(seed)
    base, pe, tokens = (torch.tensor(rng.randn(*sh) * 0.5, dtype=dtype)
                        for sh in ((Bi, S, S, d), (S, S, d), (P, N, d)))
    return base, pe, tokens


def _run(kind, dec, base, pe, tokens, nh, fused=None):
    """The sequence recorded and interpreted: H's (masks, iou) or I's
    (queries, keys)."""
    prog, (a, b) = tk.tw_program(dec.transformer, dec if kind == "h" else None, base,
                                 pe.reshape(-1, base.shape[-1]), tokens, nh, fused=fused)
    prog.run_torch()
    if kind == "h" and a.dim() == 3:   # mask columns of the fused upscale
        a = tk.unpermute_masks(a, tokens.shape[0], S, S, b.shape[-1])
    return (a, b), prog


def _normwise(got, ref, tol):
    for x, r in zip(got, ref):
        assert x.shape == r.shape and x.dtype == r.dtype
        err = (x.float() - r.float()).abs().max().item()
        assert err <= tol * r.float().abs().max().item(), (err, r.float().abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths", ["sam_tiny", "heads8"])
@pytest.mark.parametrize("kind,P,N,shared", [("h", 3, 6, False), ("h", 4, 6, True),
                                             ("h", 2, 16, False), ("i", 3, 1, False),
                                             ("i", 3, 6, False), ("i", 2, 16, False)])
def test_recorded_sequence_matches_plain(dtype, widths, kind, P, N, shared):
    """The route of each dtype (float32: the unfused records; bf16: the
    fused ones) against the plain version in the same dtype."""
    cfg = sam_tiny().decoder if widths == "sam_tiny" else TDC(**H8)
    nh = cfg.transformer_num_heads
    dec = _decoder(cfg, dtype, seed=N + P)
    base, pe, tokens = _inputs(P, 1 if shared else P, N, cfg.transformer_dim, dtype, seed=P * N)
    with torch.no_grad():
        got, prog = _run(kind, dec, base, pe, tokens, nh)
        if kind == "h":
            ref = tk.fused_decode_plain(dec.transformer, dec, base, pe, tokens, nh)
        else:
            ref = tk.fused_twoway_plain(dec.transformer, base, pe, tokens, nh)
    fused_ops = {"tw_t2i", "tw_i2t_norm4"} | ({"tw_upscale"} if kind == "h" else set())
    ops = {tk.OP_NAMES[r[0]] for r in prog.records}
    assert fused_ops <= ops if dtype == torch.bfloat16 else not ops & fused_ops
    _normwise(got, ref, TOL[dtype])


@pytest.fixture(scope="module")
def jax_decoders():
    rng = np.random.RandomState(1)
    p = jax.tree.map(lambda x: (np.asarray(x) + 0.1 * rng.randn(*np.shape(x))).astype(np.float32),
                     jmd.init(jax.random.PRNGKey(0), JDC(**H8)))
    return p, load_(MaskDecoder(TDC(**H8)), p)


@pytest.mark.parametrize("kind,P,Bi", [("h", 4, 4), ("h", 5, 1), ("i", 3, 3)])
def test_float32_sequence_matches_jax_interpret(jax_decoders, kind, P, Bi):
    """The float32 sequence against the JAX package's ``_decode_kernel``
    (a base per prompt, and a shared one with ``factored=False``) and
    ``_kernel``, both in Pallas interpret mode."""
    p, m = jax_decoders
    base, pe, tokens = _inputs(P, Bi, 7, 64, torch.float32, seed=11 + P)
    jargs = (jnp.asarray(base.numpy()), jnp.asarray(pe.numpy()), jnp.asarray(tokens.numpy()))
    if kind == "h":
        ref = jtk.fused_decode_apply(p["transformer"], p, *jargs, 8, factored=False)
    else:
        ref = jtk.fused_twoway_apply(p["transformer"], *jargs, 8)
    with torch.no_grad():
        got, _ = _run(kind, m, base, pe, tokens, 8)
    for r, x in zip(ref, got):
        np.testing.assert_allclose(np.asarray(r), x.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("part", tk.TW_PARTS)
def test_fused_record_matches_the_records_it_replaces(part, shared):
    """Each fused record's torch interpretation (token-to-image attention,
    image-to-token attention with norm4, the upscale) against the unfused
    records it replaces, float32: kernel H's sequence with that part fused
    against the one without."""
    dec = _decoder(TDC(**H8), torch.float32, seed=5)
    base, pe, tokens = _inputs(3, 1 if shared else 3, 7, 64, torch.float32, seed=9)
    out = {}
    with torch.no_grad():
        for fused in ((), (part,)):
            got, prog = _run("h", dec, base, pe, tokens, 8, fused=fused)
            out[fused] = (got, {tk.OP_NAMES[r[0]] for r in prog.records})
    assert {"i2t": "tw_i2t_norm4"}.get(part, "tw_" + part) in out[(part,)][1] - out[()][1]
    for a, b in zip(out[(part,)][0], out[()][0]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@pytest.fixture
def torch_launch(monkeypatch):
    """Plans whose launch is the torch interpretation of their records."""
    monkeypatch.setattr(tk._TwPlan, "launch", lambda self: self.prog.run_torch())


def test_plan_is_kept_for_its_weights_and_shapes(torch_launch):
    """The same weights and shapes reuse the plan; an in-place weight
    change, or another P, N or base batch, records a new one; each call's
    result is its own plain version's."""
    dec = _decoder(sam_tiny().decoder, torch.float32, seed=2)
    kern, twt = tk.TWOWAY_DECODE, dec.transformer
    plans = []
    with torch.no_grad():
        for step, (P, Bi, N) in enumerate([(3, 3, 6), (3, 3, 6), (3, 3, 6), (4, 4, 6),
                                           (4, 1, 6), (4, 1, 7)]):
            if step == 2:
                dec.transformer.layers[1].norm4.weight.add_(0.25)
            base, pe, tokens = _inputs(P, Bi, N, 16, torch.float32, seed=step)
            plan = tk._plan(kern, twt, dec, base, tokens, 2)
            got = plan.run(base, pe, tokens)
            _normwise(got, tk.fused_decode_plain(twt, dec, base, pe, tokens, 2), 1e-4)
            plans.append(plan)
    assert plans[1] is plans[0]
    assert len({id(p) for p in plans}) == 5


def test_plan_replays_on_a_new_base_and_tokens(torch_launch):
    """A second call of a kept plan with a new base, positional encoding
    and tokens equals a fresh plan's result, and leaves the first call's
    outputs as they were (kernel I, and kernel H in bf16 with the fused
    records)."""
    for kind, dtype in (("i", torch.float32), ("h", torch.bfloat16)):
        dec = _decoder(sam_tiny().decoder, dtype, seed=4)
        kern = tk.TWOWAY_DECODE if kind == "h" else tk.TWOWAY_TRANSFORMER
        decoder = dec if kind == "h" else None
        ins = [_inputs(3, 3, 6, 16, dtype, seed=s) for s in (20, 21)]
        with torch.no_grad():
            plan = tk._plan(kern, dec.transformer, decoder, ins[0][0], ins[0][2], 2)
            first = plan.run(*ins[0])
            kept = [t.clone() for t in first]
            again = tk._plan(kern, dec.transformer, decoder, ins[1][0], ins[1][2], 2)
            assert again is plan
            second = again.run(*ins[1])
            fresh = tk._TwPlan(kern, dec.transformer, decoder, ins[1][0], ins[1][2], 2).run(
                *ins[1])
        for a, b in zip(second, fresh):
            assert torch.equal(a, b)
        for a, b in zip(first, kept):
            assert torch.equal(a, b)


def _bytes_over_l(prog, rows):
    """Bytes of the distinct buffers of ``rows`` elements or more that the
    records of the parts over L (all but the token side and the head's
    MLPs) read or write."""
    seen = {}
    for rec, region in zip(prog.records, prog.regions):
        for t, _ in filter(None, rec[2]):
            if region not in ("token", "head") and t is not None and t.numel() >= rows:
                s = t.untyped_storage()
                seen[s.data_ptr()] = s.nbytes()
    return sum(seen.values())


@pytest.mark.parametrize("kind", ["h", "i"])
def test_float32_sequence_holds_one_layers_intermediates(kind):
    """The float32 route's buffers over the image tokens (the unfused
    projections, attentions and upscale) are shared by the layers: a
    deeper transformer records no more of them."""
    import dataclasses
    sizes = []
    for depth in (2, 4):
        cfg = dataclasses.replace(sam_tiny().decoder, transformer_depth=depth)
        dec = _decoder(cfg, torch.float32, seed=3)
        base, pe, tokens = _inputs(3, 3, 6, cfg.transformer_dim, torch.float32, seed=3)
        prog, _ = tk.tw_program(dec.transformer, dec if kind == "h" else None, base,
                                pe.reshape(-1, base.shape[-1]), tokens,
                                cfg.transformer_num_heads)
        sizes.append(_bytes_over_l(prog, 3 * S * S))
    assert sizes[0] == sizes[1] > 0
