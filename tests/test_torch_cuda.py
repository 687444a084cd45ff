"""The port's CUDA kernels against their plain versions, on the card.

Run on a machine with a CUDA card (tests/conftest.py needs JAX, which the card's
machine may lack): ``python -m pytest --noconftest tests/test_torch_cuda.py -q``.
Elsewhere every test skips.  Inputs from a seed; the plain version computes
in float32 on the same (rounded) inputs.  Tolerances: bf16 outputs of the
forward kernels (A, B, E, F, J) within 1e-2 + 1e-2 * |ref| (bf16 keeps 8
significant bits; the kernels also round the probabilities to bf16 before
the second product, as the TPU kernels do); float32 within 1e-4 (another
summation order); the backward kernels and kernels G, H and I normwise, as
their tests state; the quant kernels Q1 and Q2 (and the standalone
rescale that Q2 replaced) as their tests state."""

import math

import pytest
import torch

from llmseg_tpu_torch import config as C
from llmseg_tpu_torch.ops import attention as A
from llmseg_tpu_torch.ops import quant as Q
from llmseg_tpu_torch.ops import relpos_attention as R
from llmseg_tpu_torch.ops import twoway_kernel as TK

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # the float32 references stay float32
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


def _inputs(BH, T, S, D, dtype, seed=0, adversarial=False):
    """adversarial: True (every row of kernels B and J is rescued) or
    "mixed" (every third row is a small one that needs no rescue)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(device="cuda", dtype=torch.float32, generator=g)
    if adversarial:
        q = torch.zeros(BH, T, D, device="cuda")
        k = torch.zeros(BH, S, D, device="cuda")
        q[..., :D // 2] = torch.randn(BH, T, D // 2, **kw) * 30
        k[..., D // 2:] = torch.randn(BH, S, D // 2, **kw) * 30
        q[..., D // 2] = torch.randn(BH, T, **kw) * 0.3
        if adversarial == "mixed":
            q[:, ::3] = torch.randn(BH, len(range(0, T, 3)), D, **kw) * 0.01
    else:
        q, k = torch.randn(BH, T, D, **kw), torch.randn(BH, S, D, **kw)
    v = torch.randn(BH, S, D, **kw)
    q = q.to(dtype) * torch.tensor(A.LOG2E / math.sqrt(D), dtype=dtype, device="cuda")
    return q.contiguous(), k.to(dtype).contiguous(), v.to(dtype).contiguous()


def _assert_close(got, ref, dtype):
    tol = dict(atol=1e-2, rtol=1e-2) if dtype == torch.bfloat16 else dict(atol=1e-4, rtol=0)
    torch.testing.assert_close(got.float(), ref.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal,BH,T,S,D,bias", [
    (True, 8, 767, 767, 128, "head"), (False, 8, 300, 200, 64, "head"),
    (True, 8, 130, 130, 64, "head"),
    # lengths off the 128-row tiles, one head, a broadcast bias, no bias
    (False, 3, 65, 129, 64, "head"), (True, 2, 129, 65, 128, "broadcast"),
    (True, 1, 1, 1, 128, None), (True, 1, 767, 767, 128, None),
    (False, 4, 300, 200, 128, "broadcast"), (True, 8, 300, 300, 64, None)])
def test_kernel_a_matches_plain(dtype, causal, BH, T, S, D, bias):
    """Kernel A with its lse, a bias per head, one broadcast over the heads
    (stride 0) or none."""
    q, k, v = _inputs(BH, T, S, D, dtype)
    g = torch.Generator(device="cuda").manual_seed(2)
    if bias is not None:
        bias = torch.randn(BH if bias == "head" else 1, T, S, device="cuda",
                           generator=g) * A.LOG2E
    o, lse = A.flash_fwd(q, k, v, causal=causal, bias=bias, with_lse=True)
    ro, rl = A.flash_fwd_plain(q.float(), k.float(), v.float(), causal=causal, bias=bias,
                               with_lse=True)
    _assert_close(o, ro, dtype)
    torch.testing.assert_close(lse, rl, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("adversarial", [False, True, "mixed"])
@pytest.mark.parametrize("BH,T,S,D", [(4, 4097, 4097, 64), (4, 200, 300, 128),
                                      # lengths off the 128-row tiles, S != T both
                                      # ways, one head
                                      (1, 65, 129, 64), (3, 129, 65, 128), (1, 1, 1, 64),
                                      (2, 129, 129, 128), (2, 65, 65, 64), (1, 4097, 4097, 64)])
def test_kernel_b_matches_plain(dtype, adversarial, BH, T, S, D):
    """Kernel B (the rescue per row) against its plain version, at lengths
    off its 128-row tiles too, with one head, and with rescued rows beside
    rows that are not ("mixed")."""
    q, k, v = _inputs(BH, T, S, D, dtype, seed=1, adversarial=adversarial)
    o = A.flash_fwd_1pass(q, k, v)
    ro = A.flash_fwd_1pass_plain(q.float(), k.float(), v.float(), A.key_norm_max(k))
    _assert_close(o, ro, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("adversarial", [False, "mixed"])
@pytest.mark.parametrize("BH,T,S,D", [(4, 4097, 4097, 64), (3, 129, 65, 128), (1, 65, 129, 64)])
def test_kernels_b_and_j_agree_to_the_bit(dtype, adversarial, BH, T, S, D):
    """B and J run one kernel body and differ in the epilogue only, so o
    and o^T hold the same bits; a second run of B repeats them."""
    q, k, v = _inputs(BH, T, S, D, dtype, seed=4, adversarial=adversarial)
    o = A.flash_fwd_1pass(q, k, v)
    assert torch.equal(o, A.flash_fwd_1pass_t(q, k, v).transpose(1, 2))
    assert torch.equal(o, A.flash_fwd_1pass(q, k, v))


def test_kernel_b_computes_its_key_norms_in_its_c_call(monkeypatch):
    """On the card kernel B's wrapper never calls key_norm_max: the C call
    reduces max|k|^2 itself."""
    def refuse(k):
        raise AssertionError("key_norm_max called on the CUDA path")

    q, k, v = _inputs(2, 300, 200, 64, torch.bfloat16)
    ref = A.flash_fwd_1pass_plain(q.float(), k.float(), v.float(), A.key_norm_max(k))
    monkeypatch.setattr(A, "key_norm_max", refuse)
    before = A.FLASH_FWD_1PASS.launches
    o = A.flash_fwd_1pass(q, k, v)
    assert A.FLASH_FWD_1PASS.launches == before + 1
    _assert_close(o, ref, torch.bfloat16)


def _bwd_inputs(BH, T, S, D, dtype, causal, seed=3):
    q, k, v = _inputs(BH, T, S, D, dtype, seed=seed)
    o, lse = A.flash_fwd(q, k, v, causal=causal, with_lse=True)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    do = torch.randn(BH, T, D, device="cuda", generator=g).to(dtype)
    return q, k, v, o, do, lse


def _bwd_scales(q, k, v, do, ref):
    """The scale of each of (dq, dk, dv) for the normwise gate: max|ref|.
    With one key (S = 1) every row's softmax has a single entry, so ds =
    p * (dp - delta) is zero in exact arithmetic and dq, dk are the rounding
    of that difference in either version; they are held against the size of
    the terms that cancel, max|do v^T| times max|k| (dq) or max|q| (dk)."""
    scales = [r.abs().max().item() for r in ref]
    if k.shape[1] == 1:
        dp = (do.float() * v.float()).sum(-1).abs().max().item()
        scales[0] = dp * k.float().abs().max().item()
        scales[1] = dp * q.float().abs().max().item()
    return scales


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal,BH,T,S,D", [
    (True, 8, 767, 767, 128), (False, 8, 300, 200, 64), (True, 8, 130, 130, 64),
    (False, 8, 100, 257, 128),
    # lengths off C's 128-row blocks and D's 64-row tiles, S != T both ways,
    # D = 64 at the training length, one head
    (True, 8, 1, 1, 128), (False, 8, 1, 1, 64), (True, 8, 65, 65, 64), (False, 8, 65, 65, 128),
    (True, 8, 129, 129, 128), (False, 8, 129, 129, 64), (False, 8, 65, 129, 64),
    (False, 8, 129, 65, 128), (True, 8, 65, 129, 128), (True, 8, 129, 65, 64),
    (True, 8, 767, 767, 64), (True, 1, 767, 767, 128)])
def test_kernels_c_d_match_plain(dtype, causal, BH, T, S, D):
    """Kernels C and D against flash_bwd_plain in float32 on the same inputs.
    bf16 is held normwise, max|err| <= 2e-2 * max|ref| per output: p and ds
    are rounded to bf16 and summed over up to S (or T) terms, so the error
    of a small entry scales with the whole row, not with the entry."""
    q, k, v, o, do, lse = _bwd_inputs(BH, T, S, D, dtype, causal)
    dq, delta = A.flash_bwd_dq(q, k, v, o, do, lse, causal=causal)
    dk, dv = A.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal)
    ref = A.flash_bwd_plain(*(x.float() for x in (q, k, v, o, do)), lse, causal=causal)
    torch.testing.assert_close(delta, A.bwd_delta(o, do), atol=1e-3, rtol=1e-4)
    rel = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for got, r, scale in zip((dq, dk, dv), ref, _bwd_scales(q, k, v, do, ref)):
        assert (got.float() - r).abs().max().item() <= rel * scale


@pytest.mark.parametrize("causal,T,S,D", [(True, 767, 767, 128), (False, 129, 65, 64)])
def test_kernels_c_d_are_deterministic(causal, T, S, D):
    """Two runs of C and D on the same inputs give the same bits: every
    output row belongs to one CTA, and nothing is summed by atomics."""
    q, k, v, o, do, lse = _bwd_inputs(8, T, S, D, torch.bfloat16, causal)
    runs = []
    for _ in range(2):
        dq, delta = A.flash_bwd_dq(q, k, v, o, do, lse, causal=causal)
        runs.append((dq, delta) + A.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_flash_attention_grad_launches_c_and_d():
    """Under autograd the CUDA path runs kernel A with lse, then C and D."""
    x = torch.randn(1, 300, 2, 128, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    before = {kern.name: kern.launches for kern in A.KERNELS}
    A.flash_attention(x, x, x, causal=True).float().square().sum().backward()
    after = {kern.name: kern.launches for kern in A.KERNELS}
    assert {n: after[n] - before[n] for n in after} == {
        "flash_fwd": 1, "flash_fwd_1pass": 0, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
        "flash_fwd_1pass_t": 0}
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


def test_kernel_rejects_unsupported_inputs():
    q, k, v = _inputs(2, 64, 64, 64, torch.bfloat16)
    with pytest.raises(ValueError):
        A.flash_fwd(q.half(), k.half(), v.half(), causal=True)
    with pytest.raises(ValueError):
        A.flash_fwd_1pass(q[:, :, :48].contiguous(), k[:, :, :48].contiguous(),
                          v[:, :, :48].contiguous())


def test_attention_dispatch_launches_the_kernels():
    """Eligible CUDA shapes reach the kernels; short or biased ones do not."""
    before = {kern.name: kern.launches for kern in A.KERNELS}
    x = torch.randn(1, 300, 2, 128, device="cuda", dtype=torch.bfloat16)
    A.attention(x, x, x, causal=True)
    y = torch.randn(1, 2048, 2, 64, device="cuda", dtype=torch.bfloat16)
    A.attention(y, y, y)
    A.attention(x[:, :255], x[:, :255], x[:, :255], causal=True)
    A.attention(y, y, y, bias=torch.zeros(1, 1, 1, 2048, device="cuda"))
    after = {kern.name: kern.launches for kern in A.KERNELS}
    assert after["flash_fwd"] - before["flash_fwd"] == 1
    assert after["flash_fwd_1pass"] - before["flash_fwd_1pass"] == 1


def _relpos_inputs(BH, G, D, dtype, seed=5):
    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(device="cuda", dtype=torch.float32, generator=g)
    T = G * G
    q = torch.randn(BH, T, D, **kw).to(dtype) * torch.tensor(A.LOG2E / math.sqrt(D), dtype=dtype,
                                                             device="cuda")
    k, v = (torch.randn(BH, T, D, **kw).to(dtype) for _ in range(2))
    rh, rw = ((torch.randn(BH, T, G, **kw) * A.LOG2E).to(dtype) for _ in range(2))
    return q.contiguous(), k, v, rh, rw


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("BH,G,D", [(4, 64, 80), (4, 32, 80), (4, 23, 64),
                                    # one head and an AMG layer's 16 (the persistent
                                    # CTAs walk several items), G = 64 on the
                                    # register-held rw path, 23 and 40 (ragged last
                                    # key tile, query rows past T) on the general one
                                    (1, 64, 80), (16, 64, 80), (1, 64, 64), (16, 64, 64),
                                    (1, 23, 80), (16, 23, 80), (16, 23, 64),
                                    (1, 40, 64), (16, 40, 64), (1, 40, 80), (16, 40, 80)])
def test_kernel_e_matches_plain(dtype, BH, G, D):
    """Kernel E with random nonzero rel-pos tables (SAM's are zero at init)."""
    x = _relpos_inputs(BH, G, D, dtype)
    got = R.relpos_fwd(*x)
    for i in range(0, BH, 4):   # the float32 reference of 4 heads at a time
        xi = [t[i:i + 4] for t in x]
        _assert_close(got[i:i + 4], R.relpos_fwd_plain(*(t.float() if j < 3 else t
                                                         for j, t in enumerate(xi))), dtype)


@pytest.mark.parametrize("BH,G,D", [(16, 64, 80), (16, 40, 64), (3, 23, 80)])
def test_kernel_e_is_deterministic(BH, G, D):
    """Two runs of E on the same inputs give the same bits."""
    x = _relpos_inputs(BH, G, D, torch.bfloat16)
    assert torch.equal(R.relpos_fwd(*x), R.relpos_fwd(*x))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("BH,G,D", [(16, 14, 80), (16, 5, 32), (16, 22, 64),
                                    # one pair, an AMG layer's 400 pairs, an evaluate's
                                    # 3,200 (the persistent CTAs walk many), G = 2
                                    # and 16, D = 16, 64, 128 at G = 14
                                    (1, 14, 80), (400, 14, 80), (3200, 14, 80), (8, 2, 16),
                                    (8, 16, 128), (8, 14, 64), (8, 14, 128), (8, 14, 16)])
def test_kernel_f_matches_plain(dtype, BH, G, D):
    x = _relpos_inputs(BH, G, D, dtype)
    _assert_close(R.relpos_window(*x), R.relpos_window_plain(*(t.float() if i < 3 else t
                                                               for i, t in enumerate(x))), dtype)


def _padded_windows(dtype, B=2, H=4, D=80, G=14, seed=7):
    """SAM's windowed layer on a 64-wide token grid: q, k, v zero-padded to
    70 x 70 and cut into 14 x 14 windows by window_partition, the tables from
    random rel-pos weights (relpos_tables); kernel layout (B*25*H, 196, D)."""
    from llmseg_tpu_torch.models.sam.image_encoder import window_partition
    g = torch.Generator(device="cuda").manual_seed(seed)
    grid = [torch.randn(B, 64, 64, H * D, device="cuda", generator=g).to(dtype)
            for _ in range(3)]
    q, k, v = (window_partition(x, G)[0].reshape(-1, G * G, H, D) for x in grid)
    rel_h, rel_w = ((torch.randn(2 * G - 1, D, device="cuda", generator=g) * 0.3).to(dtype)
                    for _ in range(2))
    rh, rw = R.relpos_tables(q, rel_h, rel_w, G)
    qs = q * torch.tensor(A.LOG2E / math.sqrt(D), dtype=dtype, device="cuda")

    def prep(x):
        return x.permute(0, 2, 1, 3).reshape(-1, G * G, D).contiguous()

    return prep(qs), prep(k), prep(v), rh, rw


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_f_on_zero_padded_windows(dtype):
    """The windows at the grid's right and bottom edges hold zero tokens,
    which are real keys (and queries) for kernel F as for the TPU kernel."""
    x = _padded_windows(dtype)
    assert bool((x[1].reshape(2, 25, 4, 14, 14, 80)[:, 24, :, 8:] == 0).all())
    _assert_close(R.relpos_window(*x), R.relpos_window_plain(*(t.float() if i < 3 else t
                                                               for i, t in enumerate(x))), dtype)


@pytest.mark.parametrize("BH,G,D", [(400, 14, 80), (16, 22, 64)])
def test_kernel_f_is_deterministic(BH, G, D):
    """Two runs of F on the same inputs give the same bits."""
    x = _relpos_inputs(BH, G, D, torch.bfloat16)
    assert torch.equal(R.relpos_window(*x), R.relpos_window(*x))


def test_relpos_dispatch_launches_f_then_e():
    """T <= 512 takes kernel F, larger grids kernel E, one launch each."""
    before = (R.RELPOS_FWD.launches, R.RELPOS_WINDOW.launches)
    rel = torch.zeros(2 * 64 - 1, 80, device="cuda", dtype=torch.bfloat16)
    for G in (14, 64):
        x = torch.randn(1, G * G, 2, 80, device="cuda", dtype=torch.bfloat16)
        R.relpos_flash_attention(x, x, x, rel[:2 * G - 1], rel[:2 * G - 1], G)
    assert (R.RELPOS_FWD.launches - before[0], R.RELPOS_WINDOW.launches - before[1]) == (1, 1)
    with pytest.raises(ValueError):
        R.relpos_window(*_relpos_inputs(1, 24, 64, torch.bfloat16))   # T = 576 > 512


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 5e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("S", [64, 16])
def test_kernel_g_matches_plain(dtype, tol, S):
    """Kernel G against factored_decode_plain at sam_vit_h's decoder widths,
    64 prompts, held normwise: max|err| <= tol * max|ref| (bf16 rounds at
    other places in another summation order)."""
    from llmseg_tpu_torch.models.sam import sam as S_
    from llmseg_tpu_torch.models.sam.mask_decoder import MaskDecoder
    dec = MaskDecoder(C.sam_vit_h().decoder, device="cuda", dtype=dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    S_.random_init_(dec, g)
    base = (torch.randn(1, S, S, 256, device="cuda", generator=g) * 0.5).to(dtype)
    pe = (torch.randn(S, S, 256, device="cuda", generator=g) * 0.5).to(dtype)
    tok = (torch.randn(64, 7, 256, device="cuda", generator=g) * 0.5).to(dtype)
    with torch.inference_mode():
        before = TK.FACTORED_DECODE.launches
        m, i = TK.factored_decode(dec.transformer, dec, base, pe, tok, 8)
        assert TK.FACTORED_DECODE.launches == before + 1
        rm, ri = TK.factored_decode_plain(dec.transformer, dec, base, pe, tok, 8)
    for got, ref in ((m, rm), (i, ri)):
        assert (got.float() - ref.float()).abs().max().item() <= tol * ref.float().abs().max().item()


def test_kernel_g_replays_its_sequence_for_each_chunk():
    """With a cache (one image, several chunks of prompts) G records its
    sequence once and replays it on new tokens: each chunk's result equals
    an uncached call's, and earlier results are not overwritten."""
    from llmseg_tpu_torch.models.sam import sam as S_
    from llmseg_tpu_torch.models.sam.mask_decoder import MaskDecoder
    dec = MaskDecoder(C.sam_vit_h().decoder, device="cuda", dtype=torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(1)
    S_.random_init_(dec, g)
    base = (torch.randn(1, 16, 16, 256, device="cuda", generator=g) * 0.5).bfloat16()
    pe = (torch.randn(16, 16, 256, device="cuda", generator=g) * 0.5).bfloat16()
    toks = [(torch.randn(8, 7, 256, device="cuda", generator=g) * 0.5).bfloat16()
            for _ in range(3)]
    cache = {}
    with torch.inference_mode():
        before = TK.FACTORED_DECODE.launches
        cached = [TK.factored_decode(dec.transformer, dec, base, pe, t, 8, cache=cache)
                  for t in toks]
        plan = cache["factored_decode"][-1]
        assert TK.FACTORED_DECODE.launches == before + 3
        fresh = [TK.factored_decode(dec.transformer, dec, base, pe, t, 8) for t in toks]
        assert cache["factored_decode"][-1] is plan
    for (m, i), (rm, ri) in zip(cached, fresh):
        assert torch.equal(m, rm) and torch.equal(i, ri)


@pytest.mark.parametrize("P", [1, 3, 64])
def test_kernel_g_fused_records_match_their_emulation(P):
    """Each fused kernel of G's bf16 route (token-to-image attention,
    image-to-token scores, norm4, the upscale) at sam_vit_h's decoder widths
    and L = 64*64 against its record's torch interpretation on the same
    operands, normwise per written operand: max|err| <= 5e-2 max|ref|."""
    from llmseg_tpu_torch.models.sam import sam as S_
    from llmseg_tpu_torch.models.sam.mask_decoder import MaskDecoder
    dec = MaskDecoder(C.sam_vit_h().decoder, device="cuda", dtype=torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(3)
    S_.random_init_(dec, g)
    base = (torch.randn(1, 64, 64, 256, device="cuda", generator=g) * 0.5).bfloat16()
    pe = (torch.randn(64, 64, 256, device="cuda", generator=g) * 0.5).bfloat16()
    tok = (torch.randn(P, 7, 256, device="cuda", generator=g) * 0.5).bfloat16()
    with torch.inference_mode():
        prog, _, _ = TK.g_program(dec.transformer, dec, base, pe, tok, 8)
        res = TK.fused_record_errors(prog)
    assert sorted({r["op"] for r in res}) == ["i2t", "norm4_fused", "t2i", "upscale"]
    for r in res:
        for err, ref in zip(r["max_abs_err"], r["max_abs_ref"]):
            assert err <= 5e-2 * ref, r


def test_kernel_g_cache_follows_the_base_and_the_weights():
    """One cache given a second image's base, then new weights, records G's
    sequence anew each time: every result equals an uncached call's, never
    a replay against the first base or the old weights."""
    from llmseg_tpu_torch.models.sam import sam as S_
    from llmseg_tpu_torch.models.sam.mask_decoder import MaskDecoder
    dec = MaskDecoder(C.sam_vit_h().decoder, device="cuda", dtype=torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(2)
    S_.random_init_(dec, g)
    bases = [(torch.randn(1, 16, 16, 256, device="cuda", generator=g) * 0.5).bfloat16()
             for _ in range(2)]
    pe = (torch.randn(16, 16, 256, device="cuda", generator=g) * 0.5).bfloat16()
    tok = (torch.randn(8, 7, 256, device="cuda", generator=g) * 0.5).bfloat16()
    cache, plans = {}, []
    with torch.no_grad():
        for step, base in enumerate(bases + bases[1:]):
            if step == 2:
                dec.iou_head.layers[0].bias.add_(0.5)
            m, i = TK.factored_decode(dec.transformer, dec, base, pe, tok, 8, cache=cache)
            rm, ri = TK.factored_decode(dec.transformer, dec, base, pe, tok, 8)
            assert torch.equal(m, rm) and torch.equal(i, ri)
            plans.append(cache["factored_decode"][-1])
    assert len({id(p) for p in plans}) == 3


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("adversarial", [False, True, "mixed"])
@pytest.mark.parametrize("BH,T,S,D", [(4, 4097, 4097, 64), (4, 200, 300, 128), (4, 130, 100, 64),
                                      (1, 65, 129, 64), (3, 129, 65, 128), (1, 1, 1, 64)])
def test_kernel_j_matches_plain(dtype, adversarial, BH, T, S, D):
    """Kernel J (o^T, the rescue per column) against its plain version, at
    lengths off its 128-row tiles too, with one head, and with rescued rows
    beside rows that are not ("mixed")."""
    q, k, v = _inputs(BH, T, S, D, dtype, seed=6, adversarial=adversarial)
    ot = A.flash_fwd_1pass_t(q, k, v)
    assert ot.shape == (BH, D, T)
    ref = A.flash_fwd_1pass_t_plain(q.float(), k.float(), v.float(), A.key_norm_max(k))
    _assert_close(ot, ref, dtype)


def test_onepass_flags_pick_the_non_causal_kernel(monkeypatch):
    """Non-causal inference attention: B by default, J with ONEPASS_T, A
    with ONEPASS off; one launch each."""
    y = torch.randn(1, 2048, 2, 64, device="cuda", dtype=torch.bfloat16)
    for onepass, onepass_t, name in ((True, False, "flash_fwd_1pass"),
                                     (True, True, "flash_fwd_1pass_t"),
                                     (False, True, "flash_fwd")):
        monkeypatch.setattr(A, "ONEPASS", onepass)
        monkeypatch.setattr(A, "ONEPASS_T", onepass_t)
        before = {kern.name: kern.launches for kern in A.KERNELS}
        A.attention(y, y, y)
        after = {kern.name: kern.launches for kern in A.KERNELS}
        assert {n for n in after if after[n] != before[n]} == {name}


def _decoder(dtype, seed):
    """sam_vit_h's mask decoder from a seed, with noise on every 1-D
    parameter so that no bias or norm is trivial."""
    from llmseg_tpu_torch.models.sam import sam as S_
    from llmseg_tpu_torch.models.sam.mask_decoder import MaskDecoder
    dec = MaskDecoder(C.sam_vit_h().decoder, device="cuda", dtype=dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    S_.random_init_(dec, g)
    with torch.no_grad():
        for p in dec.parameters():
            if p.ndim == 1:
                p.add_(0.1 * torch.randn(p.shape, device="cuda", generator=g).to(dtype))
    return dec, g


def _normwise(got, ref, tol):
    for x, r in zip(got, ref):
        assert x.shape == r.shape and x.dtype == r.dtype
        err = (x.float() - r.float()).abs().max().item()
        assert err <= tol * r.float().abs().max().item(), (err, r.float().abs().max().item())


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 5e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("P,N,shared", [(8, 6, False), (9, 7, False), (64, 7, False),
                                        (8, 6, True), (64, 7, True), (1, 6, False),
                                        (9, 16, False), (64, 16, True), (9, 7, True)])
def test_kernel_h_matches_plain(dtype, tol, P, N, shared):
    """Kernel H against fused_decode_plain at sam_vit_h's decoder widths,
    a base per prompt or one shared (``factored=False``), held normwise:
    max|err| <= tol * max|ref| (bf16 rounds in another summation order)."""
    dec, g = _decoder(dtype, P + N)
    base = (torch.randn(1 if shared else P, 64, 64, 256, device="cuda", generator=g) * 0.5
            ).to(dtype)
    pe = (torch.randn(64, 64, 256, device="cuda", generator=g) * 0.5).to(dtype)
    tok = (torch.randn(P, N, 256, device="cuda", generator=g) * 0.5).to(dtype)
    args = (dec.transformer, dec, base, pe, tok, 8)
    with torch.inference_mode():
        before = (TK.TWOWAY_DECODE.launches, TK.FACTORED_DECODE.launches)
        got = TK.fused_decode_apply(*args, factored=False)
        assert (TK.TWOWAY_DECODE.launches, TK.FACTORED_DECODE.launches) == (before[0] + 1,
                                                                          before[1])
        ref = TK.fused_decode_plain(*args)
    assert got[0].shape == (P, 4, 256, 256) and got[1].shape == (P, 4)
    _normwise(got, ref, tol)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 5e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("P,N", [(64, 7), (8, 6), (1, 1), (9, 16), (64, 16), (9, 6)])
def test_kernel_i_matches_plain(dtype, tol, P, N):
    """Kernel I against fused_twoway_plain, normwise as kernel H; the
    transformer's routing on the card reaches it once (from 8 prompts on;
    fewer are called directly)."""
    dec, g = _decoder(dtype, 3)
    emb = (torch.randn(P, 64, 64, 256, device="cuda", generator=g) * 0.5).to(dtype)
    pe = (torch.randn(1, 64, 64, 256, device="cuda", generator=g) * 0.5).to(dtype)
    tok = (torch.randn(P, N, 256, device="cuda", generator=g) * 0.5).to(dtype)
    with torch.inference_mode():
        before = TK.TWOWAY_TRANSFORMER.launches
        got = (dec.transformer(emb, pe, tok) if P >= 8
               else TK.fused_twoway_apply(dec.transformer, emb, pe, tok, 8))
        assert TK.TWOWAY_TRANSFORMER.launches == before + 1
        ref = TK.fused_twoway_plain(dec.transformer, emb, pe, tok, 8)
    _normwise(got, ref, tol)


@pytest.mark.parametrize("kind,P,N,shared", [("h", 1, 6, False), ("h", 9, 16, False),
                                             ("h", 64, 7, True), ("i", 9, 7, False),
                                             ("i", 64, 16, False)])
def test_kernels_h_i_fused_records_match_their_emulation(kind, P, N, shared):
    """Each fused kernel of H's and I's bf16 route (token-to-image
    attention, image-to-token attention with norm4, the upscale) at
    sam_vit_h's decoder widths and L = 64*64 against its record's torch
    interpretation on the same operands, normwise per written operand:
    max|err| <= 5e-2 max|ref|."""
    dec, g = _decoder(torch.bfloat16, P + N)
    base = (torch.randn(1 if shared else P, 64, 64, 256, device="cuda", generator=g) * 0.5
            ).bfloat16()
    pe = (torch.randn(4096, 256, device="cuda", generator=g) * 0.5).bfloat16()
    tok = (torch.randn(P, N, 256, device="cuda", generator=g) * 0.5).bfloat16()
    kern = TK.TWOWAY_DECODE if kind == "h" else TK.TWOWAY_TRANSFORMER
    with torch.inference_mode():
        prog, _ = TK.tw_program(dec.transformer, dec if kind == "h" else None, base, pe, tok, 8)
        res = TK.fused_record_errors(prog, kern)
    want = ["tw_i2t_norm4", "tw_t2i"] + (["tw_upscale"] if kind == "h" else [])
    assert sorted({r["op"] for r in res}) == want
    for r in res:
        for err, ref in zip(r["max_abs_err"], r["max_abs_ref"]):
            assert err <= 5e-2 * ref, r


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["h", "i"])
def test_kernels_h_i_replay_their_plan(dtype, kind):
    """H and I keep one plan for a set of weights and shapes and replay it,
    one launch a call: a call on a new base and new tokens equals a fresh
    plan's result, a repeat of it equals it to the bit, and the earlier
    result is left as it was; an in-place weight change records anew."""
    dec, g = _decoder(dtype, 11)
    P, N = 9, 7
    pe = (torch.randn(64, 64, 256, device="cuda", generator=g) * 0.5).to(dtype)
    ins = [((torch.randn(P, 64, 64, 256, device="cuda", generator=g) * 0.5).to(dtype),
            (torch.randn(P, N, 256, device="cuda", generator=g) * 0.5).to(dtype))
           for _ in range(2)]
    kern = TK.TWOWAY_DECODE if kind == "h" else TK.TWOWAY_TRANSFORMER
    if kind == "h":
        call = lambda b, t: TK.twoway_decode(dec.transformer, dec, b, pe, t, 8)
    else:
        call = lambda b, t: TK.fused_twoway_apply(dec.transformer, b, pe, t, 8)
    with torch.inference_mode():
        before = kern.launches
        first = call(*ins[0])
        kept = [t.clone() for t in first]
        plan = TK._plan(kern, dec.transformer, dec if kind == "h" else None, *ins[0], 8)
        second, repeat = call(*ins[1]), call(*ins[1])
        assert kern.launches == before + 3
        assert TK._plan(kern, dec.transformer, dec if kind == "h" else None, *ins[0], 8) is plan
        TK._PLANS.pop(dec.transformer)
        fresh = call(*ins[1])
        assert all(torch.equal(a, b) for a, b in zip(second, fresh))
        assert all(torch.equal(a, b) for a, b in zip(second, repeat))
        assert all(torch.equal(a, b) for a, b in zip(first, kept))
    with torch.no_grad():
        dec.transformer.layers[1].norm4.weight.add_(0.25)
        changed = call(*ins[1])
        assert TK._plan(kern, dec.transformer, dec if kind == "h" else None, *ins[0], 8) \
            is not plan
    ref = (TK.fused_decode_plain(dec.transformer, dec, ins[1][0], pe, ins[1][1], 8) if kind == "h"
           else TK.fused_twoway_plain(dec.transformer, ins[1][0], pe, ins[1][1], 8))
    _normwise(changed, ref, 5e-2 if dtype == torch.bfloat16 else 1e-4)


def test_pixel_shaped_decode_routes_to_h():
    """8 prompts, each with its own image embedding (the pixel decoder's
    decode): predict_masks reaches H once, G never, and under autograd the
    plain tail."""
    dec, g = _decoder(torch.bfloat16, 5)
    emb = (torch.randn(8, 64, 64, 256, device="cuda", generator=g) * 0.5).bfloat16()
    pe = (torch.randn(1, 64, 64, 256, device="cuda", generator=g) * 0.5).bfloat16()
    sparse = (torch.randn(8, 1, 256, device="cuda", generator=g) * 0.5).bfloat16()
    dense = (torch.randn(1, 1, 1, 256, device="cuda", generator=g) * 0.5).bfloat16().expand(
        8, 64, 64, 256)
    with torch.inference_mode():
        before = {k.name: k.launches for k in TK.KERNELS}
        m, i = dec.predict_masks(emb, pe, sparse, dense, dense_shared=True)
        after = {k.name: k.launches for k in TK.KERNELS}
    assert {n: after[n] - before[n] for n in after} == {
        "factored_decode": 0, "twoway_decode": 1, "twoway_transformer": 0}
    assert m.dtype == torch.bfloat16 and bool(torch.isfinite(m.float()).all())
    mg, _ = dec.predict_masks(emb, pe, sparse, dense, dense_shared=True)
    assert mg.grad_fn is not None and mg.dtype == torch.float32


def test_kernels_h_i_reject_unsupported_inputs():
    dec, g = _decoder(torch.bfloat16, 7)
    emb = torch.randn(8, 64, 64, 256, device="cuda", generator=g).bfloat16()
    pe = torch.randn(64, 64, 256, device="cuda", generator=g).bfloat16()
    tok = torch.randn(8, 6, 256, device="cuda", generator=g).bfloat16()
    with pytest.raises(ValueError):     # a per-batch positional encoding
        TK.twoway_decode(dec.transformer, dec, emb, pe.expand(8, 64, 64, 256), tok, 8)
    with pytest.raises(ValueError):     # float16
        TK.twoway_decode(dec.transformer, dec, emb.half(), pe.half(), tok.half(), 8)
    with pytest.raises(ValueError):     # more tokens than the kernels take
        TK.fused_twoway_apply(dec.transformer, emb, pe, tok.repeat(1, 3, 1), 8)
    with pytest.raises(ValueError):     # 3 image embeddings for 8 prompts
        TK.twoway_decode(dec.transformer, dec, emb[:3], pe, tok, 8)
    with pytest.raises(ValueError):     # bf16 takes L a multiple of 64 (the fused tiles)
        TK.twoway_decode(dec.transformer, dec, emb[:, :60, :60], pe[:60, :60], tok, 8)


# ---------------------------------------------------------------------------
# Kernels Q1 (csrc/quant.cu) and Q2 (csrc/w8a8_gemm.cu), the W8A8 path
# ---------------------------------------------------------------------------


def _ulps(got, ref):
    """|got - ref| in units in the last place of their type, as integers
    (the bit patterns of two finite values of one sign)."""
    view = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    return (got.view(view).long() - ref.view(view).long()).abs()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("R,C", [(1, 4096), (17, 4096), (3068, 4096), (3068, 11008),
                                 (6136, 4096), (6136, 11008), (129, 11008), (5, 100)])
def test_q1_matches_plain(dtype, rms, R, C):
    """int8 values equal (the same IEEE operations, rounding half to even),
    including a row of exact ties; the scale equal in the plain form and
    within 2e-6 relative in the RMS form (its mean of x^2 is summed in
    another order, and torch.rsqrt may differ from 1 / sqrt by an ulp).
    C = 100 takes the scalar path (not a whole number of 16-byte vectors)."""
    g = torch.Generator(device="cuda").manual_seed(R + C)
    x = torch.randn(R, C, device="cuda", generator=g) * 3
    x[0, :4] = torch.tensor([127.0, 2.5, -3.5, 0.5])
    x = x.to(dtype)
    gamma = None
    if rms:
        gamma = (1 + 0.3 * torch.randn(C, device="cuda", generator=g)).to(dtype)
        gamma[:4] = 1.0
    xq, sc = Q.quantize_rows(x, gamma, 1e-6)
    rq, rsc = Q.quantize_rows_plain(x, gamma, 1e-6)
    assert torch.equal(xq, rq)
    if rms:
        torch.testing.assert_close(sc, rsc, rtol=2e-6, atol=0)
    else:
        assert torch.equal(sc, rsc)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("extra", [None, "bias", "side"])
@pytest.mark.parametrize("R,N", [(1, 4096), (17, 11008), (3068, 4096), (129, 4096), (7, 100)])
def test_q2_matches_plain(out_dtype, extra, R, N):
    """The standalone rescale (the yardstick's, after torch._int_mm) within
    one ulp of the output type of the plain version (the same operations in
    the same order); N = 100 takes the scalar path."""
    g = torch.Generator(device="cuda").manual_seed(R * N)
    acc = torch.randint(-2 ** 22, 2 ** 22, (R, N), device="cuda", generator=g,
                        dtype=torch.int32)
    sc = torch.rand(R, 1, device="cuda", generator=g) * 1e-3
    ws = torch.rand(N, device="cuda", generator=g) * 1e-2
    bias = (torch.randn(N, device="cuda", generator=g).to(out_dtype)
            if extra == "bias" else None)
    side = torch.randn(R, N, device="cuda", generator=g) if extra == "side" else None
    got = Q.w8a8_epilogue(acc, sc, ws, bias, out_dtype, side)
    ref = Q.w8a8_epilogue_plain(acc, sc, ws, bias, out_dtype, side)
    assert got.dtype == out_dtype and _ulps(got, ref).max().item() <= 1


def _same_bits(got, ref):
    view = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    return got.dtype == ref.dtype and torch.equal(got.view(view), ref.view(view))


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("extra", [None, "bias", "side"])
@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 11008), (11008, 4096), (64, 128)])
@pytest.mark.parametrize("R", [1, 16, 17, 129, 3068, 6136])
def test_q2_w8a8_linear_matches_plain_bitwise(R, K, N, extra, out_dtype):
    """Kernel Q2 (the int8 product on wgmma with the rescale in registers)
    against its plain version (torch._int_mm, then the plain rescale), equal
    to the bit: the int32 sums are exact and the rescale is the same IEEE
    operations in the same order.  Operands span the int8 range, so a wrong
    swizzle, descriptor or k step shows in every sum."""
    g = torch.Generator(device="cuda").manual_seed(R + K + N)
    xq = torch.randint(-127, 128, (R, K), device="cuda", generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (N, K), device="cuda", generator=g, dtype=torch.int8)
    sc = torch.rand(R, 1, device="cuda", generator=g) * 1e-3
    ws = torch.rand(N, device="cuda", generator=g) * 1e-2
    bias = (torch.randn(N, device="cuda", generator=g).to(out_dtype)
            if extra == "bias" else None)
    side = torch.randn(R, N, device="cuda", generator=g) if extra == "side" else None
    got = Q.w8a8_linear(xq, sc, w, ws, bias, out_dtype, side)
    ref = Q.w8a8_linear_plain(xq, sc, w, ws, bias, out_dtype, side)
    assert got.shape == (R, N) and _same_bits(got, ref)


@pytest.mark.parametrize("R", [1, 16, 17, 3068])
def test_int8_product_pads_small_row_counts(R):
    """The s8 x s8 -> s32 product is exact at every row count, those of 16
    and fewer padded for torch._int_mm."""
    g = torch.Generator(device="cuda").manual_seed(R)
    xq = torch.randint(-127, 128, (R, 4096), device="cuda", generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (1024, 4096), device="cuda", generator=g, dtype=torch.int8)
    got = Q._int_mm(xq, w)
    assert got.shape == (R, 1024) and got.dtype == torch.int32
    assert torch.equal(got.double(), xq.double() @ w.double().t())


def test_w8a8_predict_runs_through_q1_and_q2(monkeypatch):
    """llmseg_tiny predict with the LLaMA in W8A8 (SmoothQuant) on the card
    against the same model on the CPU, float32 (no TF32 convolutions):
    within a tenth of the quantization error (a rounding tie may fall the
    other way); Q1 launches four times a layer, Q2 (w8a8_linear) seven, and
    neither torch._int_mm nor the standalone rescale runs."""
    from llmseg_tpu_torch.data.synthetic import make_batch
    from llmseg_tpu_torch.models import llmseg

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)

    cfg = C.llmseg_tiny()
    m_cpu = llmseg.init(cfg, seed=0, device="cpu")
    b_cpu = make_batch(cfg, num_images=2, rows_per_image=2, text_len=32, seed=1, device="cpu")
    ref = llmseg.predict(m_cpu, b_cpu, device="cpu")["pred_similarity"]
    Q.quantize_llama_inplace(m_cpu.llava.llm, bits=8, w8a8=True,
                             smooth_stats=llmseg.calibrate_quant_stats(m_cpu, b_cpu),
                             head_dim=cfg.llava.llm.head_dim)
    m_gpu = llmseg.build(cfg, device="cuda")
    Q.quantize_llama_inplace(m_gpu.llava.llm, bits=8, w8a8=True)
    m_gpu.load_state_dict(m_cpu.state_dict())
    counted = Q.KERNELS + (Q.W8A8_EPILOGUE,)
    int_mm, kept_int_mm = [], torch._int_mm
    monkeypatch.setattr(torch, "_int_mm", lambda *a: int_mm.append(a))
    before = {k.name: k.launches for k in counted}
    got = llmseg.predict(m_gpu, {k: v.cuda() for k, v in b_cpu.items()})["pred_similarity"]
    launches = {k.name: k.launches - before[k.name] for k in counted}
    monkeypatch.setattr(torch, "_int_mm", kept_int_mm)
    want = llmseg.predict(m_cpu, b_cpu, device="cpu")["pred_similarity"]
    L = cfg.llava.llm.num_layers
    assert launches == {"quantize_rows": 4 * L, "w8a8_linear": 7 * L, "w8a8_epilogue": 0}
    assert not int_mm
    qerr = (want - ref).abs().max().item()
    assert qerr > 0 and (got.cpu() - want).abs().max().item() <= 0.1 * qerr


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2), (torch.float32, 1e-5)])
@pytest.mark.parametrize("R,K,N", [(767, 4096, 11008), (17, 11008, 4096), (3, 64, 48)])
def test_int8_product_backward_matches_the_dequantized_product(dtype, tol, R, K, N):
    """The weight-only int8 product under autograd (QLoRA's frozen base):
    dx through ``quant._Int8MM`` against autograd of the float32 product
    with the dequantized weight, within ``tol`` of max|ref| (bf16: dy * scale
    and dx are rounded to bf16); the int8 buffers get no gradient."""
    g = torch.Generator(device="cuda").manual_seed(R)
    lin = torch.nn.Linear(K, N, bias=False, device="cuda")
    with torch.no_grad():
        lin.weight.copy_(torch.randn(N, K, device="cuda", generator=g) * 0.02)
    q = Q.quantize_dense(lin)
    x = torch.randn(R, K, device="cuda", generator=g).to(dtype).requires_grad_()
    dy = torch.randn(R, N, device="cuda", generator=g).to(dtype)
    y = q(x)
    y.backward(dy)
    assert y.dtype == dtype and x.grad.dtype == dtype
    xr = x.detach().float().requires_grad_()
    (xr @ (q.w_q.float() * q.w_scale[:, None]).t()).backward(dy.float())
    err = (x.grad.float() - xr.grad).abs().max().item()
    assert err <= tol * xr.grad.abs().max().item(), err
    assert all(b.grad is None and not b.requires_grad for b in q.buffers())


def test_device_compose_equals_the_numpy_path():
    """evaluate.compose_counts on the card: the same counts as the numpy
    compose, resize and histogram, for every strategy, with and without a
    resize to the ground truth and with ignored pixels."""
    import numpy as np
    from llmseg_tpu_torch.train import evaluate as E

    rng = np.random.RandomState(0)
    for shape, gt_shape in (((480, 640), (480, 640)), ((300, 410), (480, 640)),
                            ((1024, 1024), (97, 131))):
        segs = (rng.rand(*shape, 50) < 0.3).astype(np.uint8)
        gt = (rng.rand(*gt_shape) < 0.3).astype(np.float32)
        gt[rng.rand(*gt_shape) < 0.05] = 255.0
        sim, iou, valid = rng.rand(50), rng.rand(50), rng.rand(50) < 0.9
        for strategy in E.SELECTORS:
            keep = E.select(strategy, sim, iou, valid, 0.5)
            pred = E.compose_mask(segs, keep)
            if pred.shape != gt.shape:
                pred = E._nearest_resize_2d(pred, gt.shape)
            ref = E.SegEvalAccumulator()
            ref.add(pred, gt)
            c = E.compose_counts(torch.from_numpy(segs).cuda(),
                                 torch.as_tensor(np.asarray(keep, np.int64)).cuda(),
                                 torch.from_numpy(gt).cuda()).cpu().numpy()
            got = E.SegEvalAccumulator()
            got.add_counts(c[0], c[1])
            np.testing.assert_array_equal(got.intersection.sum, ref.intersection.sum)
            np.testing.assert_array_equal(got.union.sum, ref.union.sum)


@pytest.mark.parametrize("bits", [8, 4])
def test_qlora_trainer_two_steps(tmp_path, bits):
    """A two-step QLoRA Trainer at llmseg_tiny in float32 on the card: the
    first step's loss equals the CPU's within 1e-4 relative, the losses stay
    finite, the quantized buffers bit-identical, the trainables move, and
    validate / save_best run on the card."""
    import copy

    import numpy as np
    from llmseg_tpu_torch.data.synthetic import make_batch
    from llmseg_tpu_torch.models import llmseg
    from llmseg_tpu_torch.train.trainer import Trainer

    lora = C.LoraConfig(rank=2)
    cfg = C.ExperimentConfig(model=C.llmseg_tiny(), train=C.TrainConfig(
        grad_accum_steps=1, epochs=1, steps_per_epoch=2, warmup_steps=0, lr=1e-3,
        precision="fp32", log_dir=str(tmp_path), lora=lora,
        quantize_frozen=True, quantize_bits=bits))
    batches = [make_batch(C.llmseg_tiny(), device="cpu", num_images=1, rows_per_image=2,
                          text_len=32, seed=40 + i) for i in range(2)]
    # one set of weights (the CPU's and the card's generators draw apart)
    model = llmseg.init(C.llmseg_tiny(), seed=0, device="cpu", lora_cfg=lora)
    gpu = Trainer(cfg, model=copy.deepcopy(model).cuda())
    cpu = Trainer(cfg, model=model, device="cpu")
    buffers = {n: b.clone() for n, b in gpu.model.named_buffers()}
    start = {n: p.detach().clone() for n, p in gpu.trainable.items()}
    m_cpu = cpu.step(batches[0])
    m_gpu = [gpu.step({k: v.cuda() for k, v in b.items()}) for b in batches]
    assert m_gpu[0]["loss"].item() == pytest.approx(m_cpu["loss"].item(), rel=1e-4)
    assert all(np.isfinite(m["loss"].item()) for m in m_gpu)
    assert all(torch.equal(b, buffers[n]) for n, b in gpu.model.named_buffers())
    assert any(not torch.equal(p, start[n]) for n, p in gpu.trainable.items())
    rng = np.random.RandomState(0)
    K = C.llmseg_tiny().max_proposals
    extras = {"segs_origin": [(rng.rand(24, 32, K) < 0.4).astype(np.uint8)],
              "masks_list": [[(rng.rand(24, 32) < 0.4).astype(np.float32)]],
              "image_paths": [None], "conversations": [[""]]}
    val = [(make_batch(C.llmseg_tiny(), device="cpu", num_images=1, text_len=32, seed=50),
            extras)]
    res = gpu.validate(val)
    assert res == gpu.validate(val) and all(np.isfinite(v) for v in res.values())
    assert gpu.save_best(res)


# ---------------------------------------------------------------------------
# The kernels as custom ops, exported programs, flash_attention_bias
# ---------------------------------------------------------------------------


def _op_cases():
    g = torch.Generator(device="cuda").manual_seed(30)
    q, k, v = _inputs(4, 300, 300, 64, torch.bfloat16, seed=5)
    x = torch.randn(17, 4096, device="cuda", generator=g).to(torch.bfloat16)
    gamma = torch.randn(4096, device="cuda", generator=g).to(torch.bfloat16)
    xq, sc = Q.quantize_rows_plain(x)
    w = torch.randint(-127, 128, (256, 4096), dtype=torch.int8, device="cuda", generator=g)
    ws = torch.rand(256, device="cuda", generator=g) * 1e-2
    return {
        "flash_fwd": (A.FLASH_FWD, lambda: torch.ops.llmseg.flash_fwd(q, k, v, None, True, True),
                      lambda: A.flash_fwd_plain(q, k, v, causal=True, with_lse=True)),
        "flash_fwd_1pass": (A.FLASH_FWD_1PASS, lambda: torch.ops.llmseg.flash_fwd_1pass(q, k, v),
                            lambda: A.flash_fwd_1pass_plain(q, k, v, A.key_norm_max(k))),
        "flash_fwd_1pass_t": (A.FLASH_FWD_1PASS_T,
                              lambda: torch.ops.llmseg.flash_fwd_1pass_t(q, k, v),
                              lambda: A.flash_fwd_1pass_t_plain(q, k, v, A.key_norm_max(k))),
        "quantize_rows": (Q.QUANTIZE_ROWS, lambda: torch.ops.llmseg.quantize_rows(x, gamma, 1e-6),
                          lambda: Q.quantize_rows_plain(x, gamma, 1e-6)),
        "w8a8_linear": (Q.W8A8_LINEAR,
                        lambda: torch.ops.llmseg.w8a8_linear(xq, sc, w, ws, None, torch.bfloat16,
                                                             None),
                        lambda: Q.w8a8_linear_plain(xq, sc, w, ws, None, torch.bfloat16)),
    }


@pytest.mark.parametrize("name", ["flash_fwd", "flash_fwd_1pass", "flash_fwd_1pass_t",
                                  "quantize_rows", "w8a8_linear"])
def test_custom_op_on_the_card_launches_its_kernel(name):
    """``torch.ops.llmseg.<name>`` on CUDA tensors runs the CUDA
    implementation: its kernel's count moves by one, and the result is the
    kernel's (against the plain version, as the kernel's own test)."""
    kern, op, plain = _op_cases()[name]
    before = kern.launches
    got = op()
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    got = got if isinstance(got, tuple) else (got,)
    ref = plain()
    ref = ref if isinstance(ref, tuple) else (ref,)
    if name in ("quantize_rows", "w8a8_linear"):
        assert torch.equal(got[0], ref[0])
    else:
        _assert_close(got[0], ref[0].float(), torch.bfloat16)


def _serving_cfg():
    """llmseg_tiny with a 315-token sequence (kernel A from 256) and a
    644-px DINOv2 (2117 tokens: kernel B from 2048), D = 16 padded to 64."""
    cfg = C.llmseg_tiny()
    return C.replace(cfg, dino=C.replace(cfg.dino, img_size=644))


@pytest.mark.parametrize("mode", ["float32", "w8a8"])
def test_exported_predict_runs_the_kernels(tmp_path, mode):
    """save_predict -> load_predict on the card: equal to eager predict to
    the bit, and each call launches A per LLaMA layer, B per DINOv2 block
    and, in W8A8, Q1 four and Q2 seven times a layer, once per op node."""
    from llmseg_tpu_torch import serving
    from llmseg_tpu_torch.data.synthetic import make_batch
    from llmseg_tpu_torch.models import llmseg

    cfg = _serving_cfg()
    model = llmseg.init(cfg, seed=0)
    if mode == "w8a8":
        Q.quantize_llama_inplace(model.llava.llm, bits=8, w8a8=True)
    batch = make_batch(cfg, num_images=2, rows_per_image=1, text_len=300, seed=1)
    shape = dict(num_images=2, rows=2, text_len=300, dtype=torch.float32)
    path = str(tmp_path / "predict.pt2")
    serving.save_predict(path, model, **shape)
    fn = serving.load_predict(path)
    served = {k: batch[k] for k in serving.predict_arg_shapes(cfg, **shape)}
    eager = llmseg.predict(model, batch)
    kern = A.KERNELS + Q.KERNELS
    before = [k.launches for k in kern]
    got = fn(served)
    torch.cuda.synchronize()
    launches = {k.name: k.launches - b for k, b in zip(kern, before)}
    L, D = cfg.llava.llm.num_layers, cfg.dino.depth
    want = {"flash_fwd": L, "flash_fwd_1pass": D, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "flash_fwd_1pass_t": 0, "quantize_rows": 0, "w8a8_linear": 0}
    if mode == "w8a8":
        want.update(quantize_rows=4 * L, w8a8_linear=7 * L)
    assert launches == want
    for k in serving.OUTPUTS:
        assert torch.equal(got[k], eager[k]), k


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("heads_bias", [False, True])
def test_flash_attention_bias_matches_plain(dtype, heads_bias):
    """``flash_attention_bias`` (kernel A, non-causal, the bias times log2(e)
    in float32) against ``attention_plain`` with the same bias: one launch
    of A."""
    g = torch.Generator(device="cuda").manual_seed(31)
    B, T, S, H, D = 2, 300, 200, 4, 64
    q, k, v = (torch.randn(B, L, H, D, device="cuda", generator=g).to(dtype) for L in (T, S, S))
    bias = torch.randn(B * H if heads_bias else 1, T, S, device="cuda", generator=g)
    before = A.FLASH_FWD.launches
    got = A.flash_attention_bias(q, k, v, bias)
    torch.cuda.synchronize()
    assert A.FLASH_FWD.launches == before + 1
    b4 = bias.reshape(B, H, T, S) if heads_bias else bias[None]
    ref = A.attention_plain(q.float(), k.float(), v.float(), bias=b4)
    _assert_close(got, ref, dtype)


def test_pinned_loader_batches_reach_the_card_intact(tmp_path, monkeypatch):
    """The data layer's batches, pinned in the loader's producer thread and
    copied to the card without blocking by ``Trainer.to_device``: each,
    copied back, equals the numpy batch collate gave for it (a pinned
    buffer freed or reused before its copy ends would differ).  A small
    LLM-Seg40K-layout corpus from ``chip_smoke.py``'s writer, its image
    decode stood in for as the smoke does."""
    import numpy as np

    import chip_smoke as CS
    from llmseg_tpu_torch.data import collate as collate_lib
    from llmseg_tpu_torch.data import datasets as D
    from llmseg_tpu_torch.data.mask_reader import SamMaskReader
    from llmseg_tpu_torch.data.tokenizer import ByteTokenizer
    from llmseg_tpu_torch.train.loader import BatchLoader
    from llmseg_tpu_torch.train.trainer import Trainer

    corpus = CS.write_llmseg_corpus(str(tmp_path), 0, shapes=((60, 80), (80, 60)), proposals=6)
    p = corpus["paths"]
    monkeypatch.setattr(D, "_imread_rgb", CS.standin_imread(corpus["shapes"], 0))
    cfg = C.llmseg_tiny()
    ds = D.LLMSegDataset(p["train"], p["coco"], p["ego_objects"],
                         SamMaskReader(p["llmseg40k_train"], verbose=False),
                         SamMaskReader(p["egoobjects"], verbose=False),
                         image_size=cfg.dino.img_size, clip_size=cfg.llava.vision.img_size,
                         seg_grid=cfg.seg_grid)
    tok, kept = ByteTokenizer(model_max_length=480), []

    def collate(samples):
        item = collate_lib.collate(samples, tok, num_image_tokens=cfg.llava.num_image_tokens,
                                   rows_per_sample=1, max_proposals=cfg.max_proposals)
        kept.append({k: v.copy() for k, v in item[0].items()})
        return item

    trainer = Trainer(C.ExperimentConfig(model=cfg, train=C.TrainConfig(
        precision="fp32", log_dir=str(tmp_path / "runs"))))
    got = []
    for batch, _ in BatchLoader(ds, collate, 2, 6, pin_memory=True).epoch(0):
        assert all(v.is_pinned() for v in batch.values())
        got.append({k: v.cpu().numpy() for k, v in trainer.to_device(batch).items()})
    assert len(got) == len(kept) == 6
    for g, h in zip(got, kept):
        assert set(g) == set(h)
        for k in h:
            assert g[k].dtype == h[k].dtype and np.array_equal(g[k], h[k]), k



def test_cli_prepare_runs_the_sam_kernels(tmp_path, monkeypatch):
    """``cli.prepare.main`` at ``sam_vit_b`` on one image of 683 x 1024 with
    the crop cascade (``--crop_n_layers 1``: the image and 4 crops, each
    resized to the 1024 input): kernels E, F and G launch 4, 8 and 16 times
    a frame, and the annotations keep the reference's schema.  The file's
    decode is stood in for (the card's machine has no cv2)."""
    import json

    import numpy as np

    from llmseg_tpu_torch.cli import prepare as CP
    from llmseg_tpu_torch.models.sam import amg as AMG

    img = np.random.RandomState(0).randint(0, 255, (683, 1024, 3), np.uint8)
    (tmp_path / "imgs").mkdir()
    (tmp_path / "imgs" / "a.jpg").write_bytes(b"")
    monkeypatch.setattr(CP, "_imread_rgb", lambda path: img)
    kernels = R.KERNELS + TK.KERNELS
    seen = []
    submit = AMG.AutomaticMaskGenerator.submit

    def counted(self, image):
        for k in kernels:
            k.launches = 0
        handle = submit(self, image)
        seen.append({k.name: k.launches for k in kernels})
        return handle

    monkeypatch.setattr(AMG.AutomaticMaskGenerator, "submit", counted)
    out = tmp_path / "masks.json"
    CP.main(["--image_dir", str(tmp_path / "imgs"), "--output", str(out), "--sam_model", "vit_b",
             "--crop_n_layers", "1", "--pred_iou_thresh=-1e9", "--stability_score_thresh=-1"])
    assert seen == [{"relpos_fwd": 20, "relpos_window": 40, "factored_decode": 80,
                     "twoway_decode": 0, "twoway_transformer": 0}]
    doc = json.loads(out.read_text())
    assert [d["target_size"] for d in doc] == [[683, 1024]] and doc[0]["masks"]
    for a in doc[0]["masks"]:
        x, y, w, h = a["crop_box"]
        assert a["area"] > 0 and 0 <= x and 0 <= y and x + w <= 1024 and y + h <= 683


def test_sft_step_launches_a_c_and_d():
    """One LLaVA SFT step (LoRA, full remat) at LLaMA-7B's head shape over a
    512-token spliced sequence, 2 layers: A forward and again in the
    recompute, C and D backward, every layer; CLIP's 257 tokens take the
    plain path."""
    from llmseg_tpu_torch.train import optim, sft

    full = C.LlavaConfig()
    cfg = C.replace(full, llm=C.replace(full.llm, num_layers=2, vocab_size=512),
                    vision=C.replace(full.vision, depth=1))
    lora = C.LoraConfig(rank=8)
    model = sft.init(cfg, seed=0, device="cuda", dtype=torch.bfloat16, lora_cfg=lora)
    trainable = optim.partition(model, sft.sft_trainable_mask(model, lora_enable=True))
    step, _ = sft.make_sft_train_step(C.TrainConfig(warmup_steps=0, grad_accum_steps=1),
                                      trainable, lora_cfg=lora)
    g = torch.Generator(device="cuda").manual_seed(0)
    T = 512 - (cfg.num_image_tokens - 1)
    ids = torch.randint(4, 500, (2, T), device="cuda", generator=g, dtype=torch.int32)
    batch = {"images_clip": torch.randn(2, 224, 224, 3, device="cuda", generator=g),
             "input_ids": ids, "labels": ids.long(),
             "image_pos": torch.tensor([3, T - 1], device="cuda", dtype=torch.int32),
             "has_image": torch.tensor([True, False], device="cuda")}
    before = {kern.name: kern.launches for kern in A.KERNELS}
    out = step(model, batch)
    torch.cuda.synchronize()
    after = {kern.name: kern.launches for kern in A.KERNELS}
    assert {n: after[n] - before[n] for n in after} == {
        "flash_fwd": 4, "flash_fwd_1pass": 0, "flash_bwd_dq": 2, "flash_bwd_dkv": 2,
        "flash_fwd_1pass_t": 0}
    assert math.isfinite(out["ce_loss"].item()) and math.isfinite(out["grad_norm"].item())


def test_native_rle_builds_and_loads():
    """The card's machine builds the native codec from the checkout and it
    gives the numpy path's answers."""
    import numpy as np

    from llmseg_tpu_torch.native import rle as native
    from llmseg_tpu_torch.ops import rle

    native.build(force=True)
    assert native.library() is not None
    m = (np.random.default_rng(0).random((57, 31)) > 0.5).astype(np.uint8)
    assert native.mask_to_counts(m) == rle._runs(m).tolist()
    packed = np.packbits(m, axis=-1)
    assert rle.encode_packed(packed, 57, 31) == rle.encode_stats(m)
