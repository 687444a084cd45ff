"""The port's two-way transformer, mask decoder and factored decode (kernel
G's plain version and its launch sequence) against the JAX package's.

JAX initialises the decoder at a test size (dim 64, 8 heads, depth 2);
every leaf is jittered with seeded numpy noise, converted with
``import_weights.from_jax`` and run through both.  JAX's
``fused_decode_apply`` runs ``_decode_kernel_factored`` in Pallas interpret
mode.  float32, JAX at highest matmul precision.  Tolerances, as the JAX
package's own tests: the factored decode vs JAX's 1e-5; vs the
reference-structured plain decoder 2e-4 on the masks and 2e-5 on the IoU
(the factored form sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from llmseg_tpu.config import SamDecoderConfig as JDC
from llmseg_tpu.models.sam import mask_decoder as jmd
from llmseg_tpu.models.sam import two_way_transformer as jtwt
from llmseg_tpu.ops import twoway_kernel as jtk
from llmseg_tpu_torch.config import SamDecoderConfig as TDC
from llmseg_tpu_torch.import_weights.from_jax import load_
from llmseg_tpu_torch.models.sam.mask_decoder import MaskDecoder
from llmseg_tpu_torch.models.sam.two_way_transformer import TwoWayTransformer
from llmseg_tpu_torch.ops import kernels as K
from llmseg_tpu_torch.ops import twoway_kernel as tk

torch.set_num_threads(1)
DIMS = dict(transformer_dim=64, transformer_depth=2, transformer_num_heads=8,
            transformer_mlp_dim=128, iou_head_hidden_dim=32)
NH = 8


def _jitter(params, seed, amp=0.1):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + amp * rng.randn(*np.shape(x))).astype(np.float32), params)


@pytest.fixture(scope="module")
def decoders():
    p = _jitter(jmd.init(jax.random.PRNGKey(0), JDC(**DIMS)), 1)
    return p, load_(MaskDecoder(TDC(**DIMS)), p)


def _chunk(B=5, S=8, d=64, seed=4):
    rng = np.random.RandomState(seed)
    emb = (rng.randn(1, S, S, d) * 0.5).astype(np.float32)
    pe = (rng.randn(S, S, d) * 0.5).astype(np.float32)
    sparse = (rng.randn(B, 2, d) * 0.5).astype(np.float32)
    dense = (rng.randn(1, S, S, d) * 0.1).astype(np.float32)
    return emb, pe, sparse, dense


def _tokens(p, sparse):
    B, _, d = sparse.shape
    out_tok = np.concatenate([p["iou_token"], p["mask_tokens"]], 0)
    return np.concatenate([np.broadcast_to(out_tok[None], (B,) + out_tok.shape), sparse], 1)


def _close(ref, got, atol):
    np.testing.assert_allclose(np.asarray(ref), got.detach().numpy(), atol=atol, rtol=0)


def test_two_way_transformer_matches_jax():
    p = _jitter(jtwt.init(jax.random.PRNGKey(2), 2, 32, 4, 64), 3)
    m = load_(TwoWayTransformer(2, 32, 4, 64), p)
    rng = np.random.RandomState(5)
    emb, pe, pts = (rng.randn(*s).astype(np.float32) * 0.5
                    for s in ((3, 8, 8, 32), (8, 8, 32), (3, 6, 32)))
    qj, kj = jtwt.apply(p, jnp.asarray(emb), jnp.asarray(pe), jnp.asarray(pts), 4, impl="xla")
    qt, kt = m(torch.tensor(emb), torch.tensor(pe), torch.tensor(pts))
    _close(qj, qt, 1e-5)
    _close(kj, kt, 1e-5)


def test_plain_tail_matches_jax(decoders):
    p, m = decoders
    emb, pe, sparse, dense = _chunk()
    B = sparse.shape[0]
    dense_b = np.broadcast_to(dense, (B,) + dense.shape[1:])
    mj, ij = jmd.predict_masks(p, JDC(**DIMS), jnp.asarray(emb), jnp.asarray(pe),
                               jnp.asarray(sparse), jnp.asarray(dense_b), impl="xla")
    with torch.no_grad():
        mt, it = m.predict_masks(torch.tensor(emb), torch.tensor(pe), torch.tensor(sparse),
                                 torch.tensor(dense_b), impl="xla")
    _close(mj, mt, 1e-5)
    _close(ij, it, 1e-5)


def test_factored_decode_plain_matches_jax(decoders):
    """Against JAX's factored_decode_ref and its interpret-mode
    ``_decode_kernel_factored`` (1e-5), and against the plain decoder (2e-4
    masks, 2e-5 IoU)."""
    p, m = decoders
    emb, pe, sparse, dense = _chunk()
    B, S = sparse.shape[0], emb.shape[1]
    tokens = _tokens(p, sparse)
    base = emb + dense
    jargs = (jnp.asarray(base), jnp.asarray(pe), jnp.asarray(tokens), NH)
    mr, ir = jtk.factored_decode_ref(p["transformer"], p, *jargs)
    mk, ik = jtk.fused_decode_apply(p["transformer"], p, *jargs)
    with torch.no_grad():
        mt, it = tk.factored_decode_plain(m.transformer, m, torch.tensor(base), torch.tensor(pe),
                                          torch.tensor(tokens), NH)
        m0, i0 = m.predict_masks(torch.tensor(emb), torch.tensor(pe), torch.tensor(sparse),
                                 torch.tensor(dense).expand(B, S, S, 64), impl="xla")
    for ref_m, ref_i in ((mr, ir), (mk, ik)):
        _close(ref_m, mt, 1e-5)
        _close(ref_i, it, 1e-5)
    _close(m0.numpy(), mt, 2e-4)
    _close(i0.numpy(), it, 2e-5)


def test_kernel_g_sequence_matches_plain(decoders):
    """Kernel G's launch sequence, interpreted with torch, against
    factored_decode_plain: the same operations in another order."""
    p, m = decoders
    emb, pe, sparse, dense = _chunk(B=3, seed=6)
    args = (m.transformer, m, torch.tensor(emb + dense), torch.tensor(pe),
            torch.tensor(_tokens(p, sparse)), NH)
    with torch.no_grad():
        prog, cols, iou = tk.g_program(*args)
        prog.run_torch()
        mt, it = tk.factored_decode_plain(*args)
    torch.testing.assert_close(tk.unpermute_masks(cols, 3, 8, 8, 4), mt, atol=1e-5, rtol=0)
    torch.testing.assert_close(iou[:, 0], it, atol=1e-5, rtol=0)
    assert prog.flops > 0 and len(prog.records) > 100


def test_kernel_g_sequence_replays_on_new_tokens(decoders):
    """A recorded sequence run again on other tokens (as AMG replays it for
    every chunk of an image) gives their decode: no state of the first run
    (norm4 scales rho in place) leaks into the second."""
    p, m = decoders
    emb, pe, sparse, dense = _chunk(B=3, seed=6)
    _, _, sparse2, _ = _chunk(B=3, seed=9)
    tokens = torch.tensor(_tokens(p, sparse))
    args = (m.transformer, m, torch.tensor(emb + dense), torch.tensor(pe))
    with torch.no_grad():
        prog, cols, iou = tk.g_program(*args, tokens, NH)
        prog.run_torch()
        tokens.copy_(torch.tensor(_tokens(p, sparse2)))
        prog.run_torch()
        mt, it = tk.factored_decode_plain(*args, tokens, NH)
    torch.testing.assert_close(tk.unpermute_masks(cols, 3, 8, 8, 4), mt, atol=1e-5, rtol=0)
    torch.testing.assert_close(iou[:, 0], it, atol=1e-5, rtol=0)


@pytest.mark.parametrize("part", tk.FUSED_PARTS)
def test_fused_record_matches_the_records_it_replaces(decoders, part):
    """Each fused record's torch interpretation (the bf16 route's records:
    token-to-image attention, image-to-token scores, norm4 with its
    products, the upscale tail) against the unfused records it replaces,
    float32: the sequence with that part fused against the one without."""
    p, m = decoders
    emb, pe, sparse, dense = _chunk(B=3, seed=6)
    args = (m.transformer, m, torch.tensor(emb + dense), torch.tensor(pe),
            torch.tensor(_tokens(p, sparse)), NH)
    out = {}
    with torch.no_grad():
        for fused in ((), (part,)):
            prog, cols, iou = tk.g_program(*args, fused=fused)
            prog.run_torch()
            out[fused] = (cols, iou, {tk.OP_NAMES[r[0]] for r in prog.records})
    assert {"t2i": "t2i", "i2t": "i2t", "norm4": "norm4_fused", "upscale": "upscale"}[part] \
        in out[(part,)][2] - out[()][2]
    torch.testing.assert_close(out[(part,)][0], out[()][0], atol=1e-5, rtol=0)
    torch.testing.assert_close(out[(part,)][1], out[()][1], atol=1e-5, rtol=0)


def _tiny_bf16_decoder(seed):
    from llmseg_tpu_torch.config import sam_tiny
    from llmseg_tpu_torch.models.sam import sam as S_
    dec = MaskDecoder(sam_tiny().decoder).to(torch.bfloat16)
    S_.random_init_(dec, torch.Generator().manual_seed(seed))
    return dec


@pytest.mark.parametrize("replay", [False, True])
def test_kernel_g_bf16_sequence_with_fused_records_matches_plain(replay):
    """The bf16 route of kernel G's sequence (the fused records) at
    sam_tiny's decoder widths, interpreted with torch, against
    factored_decode_plain in bf16, on a fresh recording and on a replay with
    new tokens; held normwise as the card holds kernel G: max|err| <= 5e-2
    max|ref|."""
    dec = _tiny_bf16_decoder(3)
    rng = np.random.RandomState(8)
    S, d = 8, dec.cfg.transformer_dim
    base, pe = (torch.tensor(rng.randn(*sh) * 0.5, dtype=torch.bfloat16)
                for sh in ((1, S, S, d), (S, S, d)))
    toks = [torch.tensor(rng.randn(5, 7, d) * 0.5, dtype=torch.bfloat16) for _ in range(2)]
    tokens = toks[0].clone()
    args = (dec.transformer, dec, base, pe)
    with torch.no_grad():
        prog, cols, iou = tk.g_program(*args, tokens, 2)
        prog.run_torch()
        if replay:
            tokens.copy_(toks[1])
            prog.run_torch()
        mt, it = tk.factored_decode_plain(*args, toks[int(replay)], 2)
    assert {"t2i", "i2t", "norm4_fused", "upscale"} <= {tk.OP_NAMES[r[0]] for r in prog.records}
    for got, ref in ((tk.unpermute_masks(cols, 5, S, S, 4), mt), (iou[:, 0], it)):
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= 5e-2 * ref.float().abs().max().item()


def test_convt_as_matmul_matches_conv_transpose(decoders):
    """The bridge's upscale weights applied as JAX applies them (spatially
    flipped conv_transpose)."""
    p, m = decoders
    x = np.random.RandomState(7).randn(2, 5, 5, 64).astype(np.float32)
    ref = jmd._convt(p["upscale_conv1"], jnp.asarray(x), 2)
    with torch.no_grad():
        got = m.upscale_conv1(torch.tensor(x))
    _close(ref, got, 1e-5)
    w, b = tk.convt_as_matmul(m.upscale_conv1)
    jw = jtk._convt_as_matmul(p["upscale_conv1"])
    _close(jw["w"], w, 0)
    _close(jw["b"], b, 0)


def test_fused_route_and_grad_route(decoders):
    """impl="fused" with a shared base runs kernel G's wrapper (the plain
    version on the CPU) and equals JAX's fused route; under autograd the
    decoder takes the plain tail, as JAX's custom_vjp does."""
    p, m = decoders
    emb, pe, sparse, _ = _chunk(B=9, seed=8)
    dense = np.zeros((9, 8, 8, 64), np.float32)
    mj, ij = jmd.predict_masks(p, JDC(**DIMS), jnp.asarray(emb), jnp.asarray(pe),
                               jnp.asarray(sparse), jnp.asarray(dense), dense_shared=True,
                               impl="fused")
    targs = (torch.tensor(emb), torch.tensor(pe), torch.tensor(sparse), torch.tensor(dense))
    with torch.no_grad():
        mt, it = m.predict_masks(*targs, dense_shared=True, impl="fused")
        mx, ix = m.predict_masks(*targs, impl="xla")
    _close(mj, mt, 1e-5)
    _close(ij, it, 1e-5)
    mg, ig = m.predict_masks(*targs, dense_shared=True, impl="fused")   # grad enabled
    assert mg.grad_fn is not None
    torch.testing.assert_close(mg, mx)
    torch.testing.assert_close(ig, ix)
    (mg.square().mean() + ig.mean()).backward()
    assert m.transformer.layers[0].norm4.weight.grad is not None
    m.zero_grad(set_to_none=True)


def test_cached_recomputes_when_an_input_changes():
    """``cached`` keeps a value only while its inputs are the same tensors,
    unchanged: another tensor of equal content, an in-place change, new
    weights loaded, another view of the same storage or another ``extra``
    computes it anew."""
    cache, calls = {}, []

    def get(*xs, extra=()):
        return K.cached(cache, "v", list(xs), lambda *a: calls.append(a) or len(calls),
                        extra=extra)

    x, y, lin = torch.zeros(4), torch.zeros(4), nn.Linear(4, 4)
    assert get(x, lin.weight) == get(x, lin.weight) == 1
    assert get(y, lin.weight) == get(y, lin.weight) == 2
    y.add_(1)
    assert get(y, lin.weight) == 3
    lin.load_state_dict(nn.Linear(4, 4).state_dict())
    assert get(y, lin.weight) == 4
    assert get(y, lin.weight, extra=(1,)) == 5
    assert get(y[:2], lin.weight) == 6
    assert cache["v"][1][0].data_ptr() == y.data_ptr()    # the entry holds its inputs
    assert K.cached(None, "v", [y], lambda a: "uncached") == "uncached"


def test_one_cache_for_two_images_gives_each_its_own_masks(decoders):
    """A cache given the fused route for one image and then another (or new
    weights) decodes each against its own base, never the first one's."""
    p, m = decoders
    _, pe, sparse, _ = _chunk(B=9, seed=8)
    dense = torch.zeros(9, 8, 8, 64)
    targs = (torch.tensor(pe), torch.tensor(sparse), dense)
    cache, bias = {}, m.iou_head.layers[0].bias
    saved = bias.detach().clone()
    with torch.no_grad():
        for seed in (8, 10, 12):
            emb = torch.tensor(_chunk(B=9, seed=seed)[0])
            if seed == 12:
                bias.add_(0.5)
            got = m.predict_masks(emb, *targs, dense_shared=True, impl="fused", cache=cache)
            want = m.predict_masks(emb, *targs, dense_shared=True, impl="fused")
            torch.testing.assert_close(got, want, atol=0, rtol=0)
            assert cache["base"][1][0] is emb
        bias.copy_(saved)


def test_should_fuse_is_keyed_on_the_device():
    pe3, pe_b = torch.zeros(8, 8, 16), torch.zeros(4, 8, 8, 16)
    assert not tk.should_fuse(64, 4096, pe3, "cpu")
    assert tk.should_fuse(64, 4096, pe3, "cuda")
    assert not tk.should_fuse(64, 4096, pe_b, "cuda")
    assert not tk.should_fuse(4, 4096, pe3, "cuda")
    assert not tk.should_fuse(64, 256, pe3, "cuda")


def test_per_prompt_base_is_not_fused(decoders, monkeypatch):
    """A base per prompt is not the factored decode: ``fused_decode_apply``
    sends it to kernel H (``_decode_kernel``'s port; on the CPU its plain
    version), never to G."""
    p, m = decoders
    emb, pe, sparse, _ = _chunk(B=3)
    args = (m.transformer, m, torch.tensor(emb).expand(3, 8, 8, 64), torch.tensor(pe),
            torch.tensor(_tokens(p, sparse)), NH)

    def not_g(*a, **k):
        raise AssertionError("a base per prompt reached the factored decode")

    monkeypatch.setattr(tk, "factored_decode", not_g)
    with torch.no_grad():
        got = tk.fused_decode_apply(*args)
        want = tk.fused_decode_plain(*args)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
