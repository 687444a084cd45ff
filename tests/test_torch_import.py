"""``llmseg_tpu_torch.import_weights.torch_import`` against the JAX
package's importers, on the CPU.

Reference-named state dicts come from tiny HF models (LLaMA, CLIP, and
DINOv2 renamed to the torch.hub names, as ``tests/test_import.py`` builds
them) and, for SAM at ``sam_tiny`` and an LLM-Seg DeepSpeed checkpoint with
peft names and LoRA, from a port model filled with seeded numpy values and
written by ``chip_smoke.py``'s reference-layout writers (which this file
also holds to the round trip).  Per component, the module the port's
importer fills must equal, to the bit, the module that ``from_jax.load_``
fills from the JAX importer's tree, in float32 and in bf16 (the JAX
importer reads every tensor as float32 numpy, ``load_`` rounds it to the
module's dtype once; the port keeps bf16 tensors as they are).  The one
exception is a DINOv2 position table resized to another grid: the port's
bicubic weights are float64 and ``jax.image.resize``'s float32, so it is
held within 1e-6.  ``predict`` on an imported checkpoint set is held to
JAX's ``predict`` on JAX's import within 1e-4 (float32, the tolerance of
``tests/test_torch_llmseg.py``)."""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
from llmseg_tpu import config as JC
from llmseg_tpu.data.synthetic import make_batch as jmake_batch
from llmseg_tpu.import_weights import torch_import as JI
from llmseg_tpu.models import llmseg as jllmseg
from llmseg_tpu_torch import config as TC
from llmseg_tpu_torch.data.synthetic import make_batch as tmake_batch
from llmseg_tpu_torch.import_weights import torch_import as TI
from llmseg_tpu_torch.import_weights.from_jax import load_
from llmseg_tpu_torch.models import llama as tllama
from llmseg_tpu_torch.models import llava as tllava
from llmseg_tpu_torch.models import llmseg as tllmseg
from llmseg_tpu_torch.models import vit as tvit
from llmseg_tpu_torch.models.sam import sam as tsam

torch.set_num_threads(1)
DTYPES = [torch.float32, torch.bfloat16]
POS_TOL = 1e-6
PREDICT_TOL = dict(atol=1e-4, rtol=0)


def _jax_state(sd):
    """What the JAX importer reads from a torch file: float32 numpy."""
    return {k: JI._np(v) for k, v in sd.items()}


def _filled(module, seed, scale=0.1):
    """Every parameter of ``module`` from seeded numpy (module order)."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.tensor(rng.randn(*p.shape) * scale))
    return module


def _assert_modules_equal(got, ref, skip=()):
    gp, rp = dict(got.named_parameters()), dict(ref.named_parameters())
    assert set(gp) == set(rp)
    for name in gp:
        if name not in skip:
            assert gp[name].dtype == rp[name].dtype, name
            assert torch.equal(gp[name], rp[name]), name


def _both(build, port_tree, jax_tree, strict=True):
    """The same fresh module twice: one filled from the port's tree, one
    from the JAX importer's tree through ``from_jax.load_``."""
    base = build()
    a, b = copy.deepcopy(base), copy.deepcopy(base)
    return load_(a, port_tree, strict=strict), load_(b, jax_tree, strict=strict)


# ---------------------------------------------------------------------------
# HF and hub models
# ---------------------------------------------------------------------------


def _hf_llama(vocab=64, seed=0):
    from transformers import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig(vocab_size=vocab, hidden_size=32, intermediate_size=64,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
                      max_position_embeddings=64, rms_norm_eps=1e-6)
    torch.manual_seed(seed)
    return LlamaForCausalLM(cfg).eval()


def _llama_cfgs(vocab=70):
    kw = dict(vocab_size=vocab, hidden_size=32, intermediate_size=64, num_layers=2,
              num_heads=4, num_kv_heads=4, head_dim=8, max_seq_len=64)
    return JC.LlamaConfig(**kw), TC.LlamaConfig(**kw)


def _sd(module, dtype):
    return {k: v.detach().to(dtype) for k, v in module.state_dict().items()}


@pytest.mark.parametrize("dtype", DTYPES)
def test_llama_matches_jax(dtype):
    """HF LLaMA (vocab 64 padded to 70 with the mean row) into ``Llama``."""
    sd = _sd(_hf_llama(), dtype)
    jcfg, tcfg = _llama_cfgs()
    got, ref = _both(lambda: tllama.Llama(tcfg, device="cpu", dtype=dtype),
                     TI.import_llama(sd, tcfg), JI.import_llama(_jax_state(sd), jcfg))
    _assert_modules_equal(got, ref)
    assert torch.equal(got.embed_tokens.weight[:64], sd["model.embed_tokens.weight"])


def _hf_clip():
    from transformers import CLIPVisionConfig, CLIPVisionModel
    cfg = CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                           num_attention_heads=4, image_size=28, patch_size=14)
    torch.manual_seed(0)
    return CLIPVisionModel(cfg).eval()


def _clip_cfgs():
    kw = dict(img_size=28, patch_size=14, hidden_size=32, depth=3, num_heads=4, mlp_ratio=2.0)
    return JC.ViTConfig(**kw), TC.ViTConfig(**kw)


@pytest.mark.parametrize("dtype", DTYPES)
def test_clip_matches_jax(dtype, tmp_path):
    """HF CLIPVisionModel into ``ViT``, from a state dict and from a dir."""
    hf = _hf_clip()
    sd = _sd(hf, dtype)
    jcfg, tcfg = _clip_cfgs()
    got, ref = _both(lambda: tvit.ViT(tcfg, device="cpu", dtype=dtype),
                     TI.import_clip_vision(sd, tcfg), JI.import_clip_vision(_jax_state(sd), jcfg))
    _assert_modules_equal(got, ref)
    hf.to(dtype).save_pretrained(tmp_path / "clip")
    from_dir = load_(tvit.ViT(tcfg, device="cpu", dtype=dtype),
                     TI.import_clip_dir(str(tmp_path / "clip"), tcfg))
    _assert_modules_equal(from_dir, got)


def _hub_dinov2(dtype):
    """An HF Dinov2Model renamed to torch.hub dinov2 names (what the
    importers eat), as tests/test_import.py does."""
    from transformers import Dinov2Config, Dinov2Model
    cfg = Dinov2Config(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                       mlp_ratio=2, image_size=28, patch_size=14, layerscale_value=0.5)
    torch.manual_seed(0)
    hf = _sd(Dinov2Model(cfg).eval(), dtype)
    sd = {"cls_token": hf["embeddings.cls_token"],
          "pos_embed": hf["embeddings.position_embeddings"],
          "patch_embed.proj.weight": hf["embeddings.patch_embeddings.projection.weight"],
          "patch_embed.proj.bias": hf["embeddings.patch_embeddings.projection.bias"],
          "norm.weight": hf["layernorm.weight"], "norm.bias": hf["layernorm.bias"]}
    for i in range(2):
        b, o = f"encoder.layer.{i}", f"blocks.{i}"
        att = f"{b}.attention.attention"
        sd[f"{o}.attn.qkv.weight"] = torch.cat([hf[f"{att}.{n}.weight"]
                                                for n in ("query", "key", "value")])
        sd[f"{o}.attn.qkv.bias"] = torch.cat([hf[f"{att}.{n}.bias"]
                                              for n in ("query", "key", "value")])
        for src, dst in (("attention.output.dense", "attn.proj"), ("norm1", "norm1"),
                         ("norm2", "norm2"), ("mlp.fc1", "mlp.fc1"), ("mlp.fc2", "mlp.fc2")):
            sd[f"{o}.{dst}.weight"] = hf[f"{b}.{src}.weight"]
            sd[f"{o}.{dst}.bias"] = hf[f"{b}.{src}.bias"]
        sd[f"{o}.ls1.gamma"] = hf[f"{b}.layer_scale1.lambda1"]
        sd[f"{o}.ls2.gamma"] = hf[f"{b}.layer_scale2.lambda1"]
    return sd


def _dino_cfgs(img_size=28):
    kw = dict(img_size=img_size, patch_size=14, hidden_size=32, depth=2, num_heads=4,
              mlp_ratio=2.0, layernorm_pre=False, layerscale=True, use_quick_gelu=False,
              ln_eps=1e-6)
    return JC.ViTConfig(**kw), TC.ViTConfig(**kw)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("img_size", [28, 56], ids=["same_grid", "grid_2_to_4"])
def test_dinov2_matches_jax(dtype, img_size, tmp_path):
    """A hub DINOv2 ``.pth`` into ``ViT``: every leaf to the bit; the
    position table resized 2 -> 4 within 1e-6 of ``jax.image.resize``."""
    sd = _hub_dinov2(dtype)
    path = str(tmp_path / "dinov2.pth")
    torch.save(sd, path)
    jcfg, tcfg = _dino_cfgs(img_size)
    resized = img_size != 28
    got, ref = _both(lambda: tvit.ViT(tcfg, device="cpu", dtype=dtype),
                     TI.import_dinov2_pth(path, tcfg), JI.import_dinov2_pth(path, jcfg))
    _assert_modules_equal(got, ref, skip=("pos_embed",) if resized else ())
    if resized:
        tpos = TI.interpolate_pos_embed(sd["pos_embed"].float(), 2, 4)
        jpos = JI.interpolate_pos_embed(JI._np(sd["pos_embed"]), 2, 4)
        np.testing.assert_allclose(tpos.numpy(), jpos, atol=POS_TOL, rtol=0)
    else:
        assert torch.equal(got.pos_embed, ref.pos_embed)


@pytest.mark.parametrize("src,dst", [(37, 64), (16, 64), (5, 5), (37, 16)])
def test_interpolate_pos_embed_matches_jax_resize(src, dst):
    """Keys' cubic (a = -0.5) as ``jax.image.resize(method="bicubic")``:
    DINOv2's hub grid 37 to the port's 64, 16 to 64, an equal grid
    (returned as it is), and 37 down to 16 (the kernel widened)."""
    pos = np.random.RandomState(src).randn(1, 1 + src * src, 24).astype(np.float32)
    got = TI.interpolate_pos_embed(torch.tensor(pos), src, dst)
    ref = JI.interpolate_pos_embed(pos, src, dst)
    assert got.shape == (1, 1 + dst * dst, 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=POS_TOL, rtol=0)
    if src == dst:
        assert torch.equal(got, torch.tensor(pos))


# ---------------------------------------------------------------------------
# LLaVA directories: shards, safetensors, deltas
# ---------------------------------------------------------------------------


def _llava_cfgs(vocab=64):
    jl, tl = _llama_cfgs(vocab)
    jv, tv = _clip_cfgs()
    return (JC.LlavaConfig(vision=jv, llm=jl, mm_hidden_size=32, num_image_tokens=4),
            TC.LlavaConfig(vision=tv, llm=tl, mm_hidden_size=32, num_image_tokens=4))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["bin_shards", "safetensors"])
def test_llava_dir_matches_jax(dtype, layout, tmp_path):
    """An HF LLaMA directory in several ``.bin`` shards with their index, or
    in safetensors, into ``Llava`` (the LLaMA; no projector or tower in the
    directory, so those keep their values)."""
    hf = _hf_llama().to(dtype)
    d = tmp_path / "llava"
    if layout == "bin_shards":
        hf.save_pretrained(d, safe_serialization=False, max_shard_size="40KB")
        assert (d / "pytorch_model.bin.index.json").is_file()
        assert len([n for n in os.listdir(d) if n.endswith(".bin")]) > 1
    else:
        hf.save_pretrained(d, safe_serialization=True)
    jcfg, tcfg = _llava_cfgs()
    got, ref = _both(lambda: _filled(tllava.Llava(tcfg, device="cpu", dtype=dtype), 1),
                     TI.import_llava_dir(str(d), tcfg), JI.import_llava_dir(str(d), jcfg),
                     strict=False)
    _assert_modules_equal(got, ref)
    assert torch.equal(got.llm.norm.weight, hf.state_dict()["model.norm.weight"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_llava_delta_dirs_match_jax(dtype, tmp_path):
    """A base LLaMA dir and a LLaVA delta dir (vocab 64 -> 68, a projector)
    merged by ``apply_delta`` and imported into ``Llava``."""
    from safetensors.torch import save_file
    _hf_llama(64, seed=0).to(dtype).save_pretrained(tmp_path / "base")
    _hf_llama(68, seed=1).to(dtype).save_pretrained(tmp_path / "delta")
    delta = TI.load_hf_dir(str(tmp_path / "delta"))
    rng = np.random.RandomState(2)
    delta["model.mm_projector.weight"] = torch.tensor(rng.randn(32, 32), dtype=dtype)
    delta["model.mm_projector.bias"] = torch.tensor(rng.randn(32), dtype=dtype)
    save_file({k: v.contiguous() for k, v in delta.items()},
              str(tmp_path / "delta" / "model.safetensors"))
    jcfg, tcfg = _llava_cfgs(vocab=68)
    got, ref = _both(lambda: _filled(tllava.Llava(tcfg, device="cpu", dtype=dtype), 3),
                     TI.import_llava_delta_dirs(str(tmp_path / "base"), str(tmp_path / "delta"),
                                                tcfg),
                     JI.import_llava_delta_dirs(str(tmp_path / "base"), str(tmp_path / "delta"),
                                                jcfg), strict=False)
    _assert_modules_equal(got, ref)
    assert torch.equal(got.mm_projector.weight, delta["model.mm_projector.weight"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_delta_matches_jax(dtype):
    """Same-shape keys summed, the larger vocab's leading block summed, the
    projector kept; an unknown key raises KeyError, a shape mismatch
    ValueError (the reference asserts both)."""
    rng = np.random.RandomState(0)
    D = 8

    def t(*shape):
        return torch.tensor(rng.randn(*shape), dtype=dtype)

    base = {"model.embed_tokens.weight": t(16, D), "lm_head.weight": t(16, D),
            "model.layers.0.self_attn.q_proj.weight": t(D, D)}
    delta = {"model.embed_tokens.weight": t(20, D), "lm_head.weight": t(20, D),
             "model.layers.0.self_attn.q_proj.weight": t(D, D),
             "model.mm_projector.weight": t(D, 4), "model.mm_projector.bias": t(D)}
    got = TI.apply_delta(base, delta)
    ref = JI.apply_delta(_jax_state(base), _jax_state(delta))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == dtype, k
        assert torch.equal(got[k], torch.tensor(ref[k]).to(dtype)), k
    assert torch.equal(delta["model.embed_tokens.weight"][16:], got["model.embed_tokens.weight"][16:])
    with pytest.raises(KeyError):
        TI.apply_delta(base, {"model.unknown.weight": delta["lm_head.weight"]})
    with pytest.raises(ValueError):
        TI.apply_delta(base, {"model.layers.0.self_attn.q_proj.weight": t(D, D + 1)})


@pytest.mark.parametrize("dtype", DTYPES)
def test_pad_vocab_matches_jax(dtype):
    w = torch.tensor(np.random.RandomState(1).randn(5, 3), dtype=dtype)
    for n in (5, 3, 8):
        got = TI._pad_vocab(w, n)
        ref = torch.tensor(JI._pad_vocab(JI._np(w), n)).to(dtype)
        assert got.shape == (n, 3) and got.dtype == dtype
        assert torch.equal(got, ref)


def test_strip_peft_matches_jax():
    v = torch.zeros(1)
    sd = {"base_model.model.model.layers.0.self_attn.q_proj.base_layer.weight": v,
          "base_model.model.model.layers.0.self_attn.q_proj.lora_A.default.weight": v,
          "base_model.model.model.layers.0.self_attn.q_proj.lora_B.default.weight": v,
          "base_model.model.model.norm.weight": v, "model.lisa_dino_conv.bias": v}
    base, lora = TI.strip_peft(sd)
    jbase, jlora = JI.strip_peft(sd)
    assert list(base) == list(jbase) and list(lora) == list(jlora)
    assert sorted(base) == ["model.layers.0.self_attn.q_proj.weight",
                            "model.lisa_dino_conv.bias", "model.norm.weight"]
    assert sorted(lora) == ["model.layers.0.self_attn.q_proj.lora_A.default.weight",
                            "model.layers.0.self_attn.q_proj.lora_B.default.weight"]


def test_resolve_deepspeed_dir(tmp_path):
    """The .pt file itself, a global_stepN dir, the ckpt_model dir through
    ``latest``, and a missing checkpoint (FileNotFoundError), as JAX."""
    step = tmp_path / "ckpt_model" / "global_step7"
    step.mkdir(parents=True)
    pt = step / "mp_rank_00_model_states.pt"
    torch.save({"module": {}}, pt)
    (tmp_path / "ckpt_model" / "latest").write_text("global_step7\n")
    for path in (pt, step, tmp_path / "ckpt_model"):
        assert TI.resolve_deepspeed_dir(str(path)) == str(pt)
        assert JI.resolve_deepspeed_dir(str(path)) == str(pt)
    for fn in (TI.resolve_deepspeed_dir, JI.resolve_deepspeed_dir):
        with pytest.raises(FileNotFoundError):
            fn(str(tmp_path))


# ---------------------------------------------------------------------------
# SAM and the LLM-Seg checkpoint, written by chip_smoke.py's writers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_sam_matches_jax(dtype, tmp_path):
    """``sam_tiny`` written as build_sam's ``.pth`` (the transposed-conv taps
    in torch's layout) and imported: equal to JAX's import and to the
    source, leaf for leaf."""
    src = _filled(tsam.build(TC.sam_tiny(), device="cpu", dtype=dtype), 4)
    path = str(tmp_path / "sam.pth")
    torch.save(CS.host_copy(CS.ref_sam(src)), path)
    got, ref = _both(lambda: tsam.build(TC.sam_tiny(), device="cpu", dtype=dtype),
                     TI.import_sam_pth(path, TC.sam_tiny()),
                     JI.import_sam_pth(path, JC.sam_tiny()))
    _assert_modules_equal(got, ref)
    _assert_modules_equal(got, src)
    loaded = TI.load_sam_into(tsam.build(TC.sam_tiny(), device="cpu", dtype=dtype), path,
                              device="cpu")
    _assert_modules_equal(loaded, src)


def _seg_cfgs():
    kw = dict(layerscale=True, use_quick_gelu=False, ln_eps=1e-6, layernorm_pre=False)
    return (JC.replace(JC.llmseg_tiny(), dino=JC.replace(JC.llmseg_tiny().dino, **kw)),
            TC.replace(TC.llmseg_tiny(), dino=TC.replace(TC.llmseg_tiny().dino, **kw)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_llmseg_checkpoint_matches_jax(dtype, tmp_path):
    """An LLM-Seg DeepSpeed checkpoint (``ckpt_model/latest`` ->
    ``global_step10``, the state under ``module``, peft names, LoRA on q/v,
    the lisa head) into ``LLMSeg`` with LoRA: equal to JAX's import and to
    the source for everything the checkpoint holds."""
    jcfg, tcfg = _seg_cfgs()
    lora = TC.LoraConfig()
    src = _filled(tllmseg.build(tcfg, device="cpu", dtype=dtype, lora_cfg=lora), 5)
    paths = CS.write_checkpoints(str(tmp_path), src, tsam.build(TC.sam_tiny(), device="cpu"),
                                 src.dino.pos_embed.new_zeros((1, 5, 32)))
    with open(os.path.join(paths["llmseg"], "latest")) as f:
        assert f.read() == "global_step10"
    jtree = JI.import_llmseg_checkpoint(paths["llmseg"], jcfg, lora_cfg=JC.LoraConfig())
    got, ref = _both(lambda: _filled(tllmseg.build(tcfg, device="cpu", dtype=dtype,
                                                   lora_cfg=lora), 6),
                     TI.import_llmseg_checkpoint(paths["llmseg"], tcfg, lora_cfg=lora),
                     jtree, strict=False)
    _assert_modules_equal(got, ref)
    held = [n for n, _ in got.named_parameters() if not n.startswith(("dino.",
                                                                      "llava.vision_tower."))]
    sp, gp = dict(src.named_parameters()), dict(got.named_parameters())
    assert all(torch.equal(gp[n], sp[n]) for n in held)
    assert len(held) > 0 and any(n.startswith("lora.") for n in held)


def test_checkpoint_set_predict_matches_jax(tmp_path):
    """A whole checkpoint set at ``llmseg_tiny`` (hub DINOv2 with a 2 x 2
    grid, CLIP dir, LLaVA dir in two shards, DeepSpeed checkpoint with
    LoRA, SAM), float32: every port parameter equals its source (the
    resized position table aside), and ``predict`` on the port's import
    equals JAX's ``predict`` on JAX's import within 1e-4."""
    jcfg, tcfg = _seg_cfgs()
    lora = TC.LoraConfig()
    src = _filled(tllmseg.build(tcfg, device="cpu", lora_cfg=lora), 7, scale=0.05)
    pos_hub = torch.tensor(np.random.RandomState(8).randn(1, 5, 32) * 0.05, dtype=torch.float32)
    paths = CS.write_checkpoints(str(tmp_path), src, tsam.build(TC.sam_tiny(), device="cpu"),
                                 pos_hub)
    with open(os.path.join(paths["llava"], "pytorch_model.bin.index.json")) as f:
        assert len(set(json.load(f)["weight_map"].values())) == 2
    model = tllmseg.build(tcfg, device="cpu", lora_cfg=lora)
    TI.load_dinov2_into(model, paths["dinov2"], device="cpu")
    TI.load_clip_into(model, paths["clip"], device="cpu")
    TI.load_llava_into(model, paths["llava"], device="cpu")
    TI.load_llmseg_into(model, paths["llmseg"], lora_cfg=lora, device="cpu")
    sp = dict(src.named_parameters())
    for n, p in model.named_parameters():
        if n != "dino.pos_embed":
            assert torch.equal(p, sp[n]), n
    assert torch.equal(model.dino.pos_embed, TI.interpolate_pos_embed(pos_hub, 2, 4))

    jlora = JC.LoraConfig()
    jp = JI.import_llmseg_checkpoint(paths["llmseg"], jcfg, lora_cfg=jlora)
    llava = JI.import_llava_dir(paths["llava"], jcfg.llava)
    jp["llava"]["vision_tower"] = JI.import_clip_dir(paths["clip"], jcfg.llava.vision)
    jp["llava"]["mm_projector"] = llava["mm_projector"]
    jp["dino"] = JI.import_dinov2_pth(paths["dinov2"], jcfg.dino)
    jp = jax.tree.map(jnp.asarray, jp)
    kw = dict(num_images=2, rows_per_image=2, text_len=32, seed=9)
    ref = jllmseg.predict(jp, jcfg, jmake_batch(jcfg, **kw), lora_cfg=jlora)
    got = tllmseg.predict(model, tmake_batch(tcfg, device="cpu", **kw), device="cpu",
                          lora_cfg=lora)
    for k in ("pred_similarity", "pred_iou"):
        np.testing.assert_allclose(np.asarray(ref[k]), got[k].numpy(), **PREDICT_TOL)
    for k in ("prop_valid", "row_valid"):
        np.testing.assert_array_equal(np.asarray(ref[k]), got[k].numpy())


def test_load_into_asks_for_the_card_by_default(tmp_path):
    """Without ``device=`` a ``load_*_into`` puts the weights on the card,
    and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src = _filled(tsam.build(TC.sam_tiny(), device="cpu"), 4)
    path = str(tmp_path / "sam.pth")
    torch.save(CS.host_copy(CS.ref_sam(src)), path)
    with pytest.raises(RuntimeError, match="CUDA"):
        TI.load_sam_into(tsam.build(TC.sam_tiny(), device="cpu"), path)


def test_smoke_import_phase_runs_small_on_the_cpu(capsys):
    """``chip_smoke.py``'s import phase, as the card runs it but at
    ``llmseg_tiny`` + ``sam_tiny`` on the CPU (a 2 x 2 hub table resized to
    4 x 4): its gates hold and it reports every import."""
    _, tcfg = _seg_cfgs()
    out = CS.import_phase(TC, tllmseg, tsam, TI, tmake_batch, base=tcfg,
                          sam_cfg=TC.sam_tiny(), hub_grid=2, text_len=32, device="cpu")
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["phase"] == "import" and rec["ok"], rec
    assert set(rec["seconds"]) == {"dinov2", "clip", "llava", "llmseg", "sam"}
    assert rec["pos_max_abs_err"] <= CS.POS_LIMIT
    assert out["model"].lora is not None
