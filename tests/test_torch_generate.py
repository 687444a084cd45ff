"""The port's greedy generation with a KV cache (``models.generate``)
against the JAX package's, on the same weights: ``llama_tiny`` initialised
by JAX, every leaf jittered with seeded numpy noise, LoRA drawn from numpy
(JAX's ``lora_init`` seeds from ``hash(name)``), converted with
``import_weights.from_jax``.  float32 on the CPU, JAX at highest matmul
precision.  Tokens must be equal; hidden states within 1e-4 (the prefill
and the decode steps in float32, summed in other orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmseg_tpu import config as JC
from llmseg_tpu.models import generate as jgen
from llmseg_tpu.models import llama as jllama
from llmseg_tpu_torch import config as TC
from llmseg_tpu_torch.import_weights.from_jax import load_
from llmseg_tpu_torch.models import generate as tgen
from llmseg_tpu_torch.models import llama as tllama

torch.set_num_threads(1)
HIDDEN_TOL = 1e-4


def _model(vocab_size=256, with_lora=False, seed=0):
    jcfg, tcfg = JC.llama_tiny(vocab_size), TC.llama_tiny(vocab_size)
    rng = np.random.RandomState(seed + 1)
    p = jax.tree.map(lambda x: (np.asarray(x) + 0.1 * rng.randn(*np.shape(x))).astype(np.float32),
                     jllama.init(jax.random.PRNGKey(seed), jcfg))
    m = load_(tllama.Llama(tcfg), p)
    p = jax.tree.map(jnp.asarray, p)
    if not with_lora:
        return p, m, None, None
    r, d = TC.LoraConfig().rank, jcfg.hidden_size
    lora = {"layers": [{n: {"a": (rng.randn(d, r) * 0.2).astype(np.float32),
                            "b": (rng.randn(r, d) * 0.2).astype(np.float32)}
                        for n in ("q", "v")} for _ in range(jcfg.num_layers)]}
    return p, m, jax.tree.map(jnp.asarray, lora), load_(tllama.LlamaLora(tcfg, TC.LoraConfig()),
                                                        lora)


def _embeds(p, B, T, seed):
    ids = np.random.RandomState(seed).randint(4, 200, (B, T))
    return np.asarray(p["embed_tokens"])[ids]


@pytest.mark.parametrize("with_lora", [False, True])
def test_greedy_generate_matches_jax(with_lora):
    p, m, lj, lt = _model(with_lora=with_lora)
    x = _embeds(p, 2, 8, seed=2)
    jl, tl = (JC.LoraConfig(), TC.LoraConfig()) if with_lora else (None, None)
    tj, hj = jgen.greedy_generate(p, JC.llama_tiny(), jnp.asarray(x), 6, eos_token_id=2,
                                  lora=lj, lora_cfg=jl)
    tt, ht = tgen.greedy_generate(m, torch.tensor(x), 6, eos_token_id=2, lora=lt, lora_cfg=tl)
    assert tt.shape == (2, 6) and ht.shape == (2, 6, 64)
    np.testing.assert_array_equal(np.asarray(tj), tt.numpy())
    np.testing.assert_allclose(np.asarray(hj), ht.numpy(), atol=HIDDEN_TOL, rtol=0)


def test_prefill_matches_the_full_forward():
    """The prefill's hidden states are the model's forward, and its cache
    holds the prompt's K and V, zero after it."""
    p, m, _, _ = _model(seed=3)
    x = torch.tensor(_embeds(p, 2, 8, seed=4))
    with torch.no_grad():
        hidden, cache = tgen.prefill_cache(m, x, 11)
        ref = m(inputs_embeds=x)
    torch.testing.assert_close(hidden, ref, atol=1e-6, rtol=0)
    assert len(cache) == 2 and cache[0][0].shape == (2, 11, 4, 16)
    assert not cache[1][1][:, :8].eq(0).all() and cache[1][1][:, 8:].eq(0).all()


def test_eos_latching_matches_jax():
    """The first emitted token declared EOS: the row latches at once."""
    p, m, _, _ = _model(seed=5)
    x = _embeds(p, 1, 4, seed=6)
    first = int(tgen.greedy_generate(m, torch.tensor(x), 1)[0][0, 0])
    tj, _ = jgen.greedy_generate(p, JC.llama_tiny(), jnp.asarray(x), 6, eos_token_id=first)
    tt, _ = tgen.greedy_generate(m, torch.tensor(x), 6, eos_token_id=first)
    np.testing.assert_array_equal(np.asarray(tj), tt.numpy())
    assert (tt == first).all()


def test_stop_token_ids_match_jax():
    """stop_token_ids latch like EOS; the rest of the row repeats EOS."""
    p, m, _, _ = _model(vocab_size=64, seed=7)
    x = np.random.RandomState(8).randn(1, 4, 64).astype(np.float32)
    plain, _ = tgen.greedy_generate(m, torch.tensor(x), 8, eos_token_id=63)
    first = int(plain[0, 0])
    tj, _ = jgen.greedy_generate(p, JC.llama_tiny(64), jnp.asarray(x), 8, eos_token_id=63,
                                 stop_token_ids=(first,))
    tt, _ = tgen.greedy_generate(m, torch.tensor(x), 8, eos_token_id=63, stop_token_ids=(first,))
    np.testing.assert_array_equal(np.asarray(tj), tt.numpy())
    assert tt[0, 0] == first and (tt[0, 1:] == 63).all()


def test_generation_past_max_seq_len_raises():
    _, m, _, _ = _model()
    with pytest.raises(ValueError, match="max_seq_len"):
        tgen.greedy_generate(m, torch.zeros(1, 500, 64), 13)
