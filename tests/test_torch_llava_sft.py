"""The port's LLaVA SFT (``data/llava_sft.py``, ``train/sft.py``) against
the JAX package's at ``llava_tiny``, float32 on the CPU, from the same
weights (``from_jax``) and the same corpus (a json list and one PNG image
written from a numpy seed).

Tolerances: the data side exactly (token ids, labels, the CLIP image, the
collated arrays); ``sft_loss`` within 1e-5 relative; every trainable
gradient within 5e-5 of JAX's, relative in the Frobenius norm (the same
gradient in float64 puts each float32 side up to 2.4e-5 from it: the
projector's, through the whole LLaMA, rounds most);
after three train steps (accumulation 1) or four micro-steps
(accumulation 2) each trainable tensor within 1e-5 relative in the
Frobenius norm (AdamW normalises each entry, so an entry whose gradient is
near its rounding noise steps differently; ``tests/test_torch_train.py``
explains the norm); frozen parameters bit-identical."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmseg_tpu import config as JC
from llmseg_tpu.data import llava_sft as JS
from llmseg_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from llmseg_tpu.models import llava as jllava
from llmseg_tpu.train import optim as joptim
from llmseg_tpu.train import sft as jsft
from llmseg_tpu_torch import config as TC
from llmseg_tpu_torch.data import llava_sft as TS
from llmseg_tpu_torch.data.prompts import DEFAULT_IMAGE_TOKEN
from llmseg_tpu_torch.data.tokenizer import ByteTokenizer as TByteTokenizer
from llmseg_tpu_torch.import_weights.from_jax import flatten, flatten_paths, load_
from llmseg_tpu_torch.train import optim
from llmseg_tpu_torch.train import sft as tsft

torch.set_num_threads(1)
MML = 320            # the byte-tokenized vicuna system prompt is ~150 tokens
RANK = 2
FLAGS = [dict(), dict(tune_mm_mlp_adapter=True), dict(lora_enable=True),
         dict(tune_mm_mlp_adapter=True, lora_enable=True)]


def _toks():
    return JByteTokenizer(model_max_length=MML), TByteTokenizer(model_max_length=MML)


SOURCES = [
    [{"from": "human", "value": f"what is this {DEFAULT_IMAGE_TOKEN}?"},
     {"from": "gpt", "value": "a cat"}],
    [{"from": "human", "value": f"{DEFAULT_IMAGE_TOKEN}\nwhat?"},
     {"from": "gpt", "value": "ANSWER_ONE"},
     {"from": "human", "value": "more?"},
     {"from": "gpt", "value": "ANSWER_TWO"}],
    [{"from": "gpt", "value": "stray"},
     {"from": "human", "value": "q"},
     {"from": "gpt", "value": "a"}],
    [{"from": "human", "value": "text only?"}, {"from": "gpt", "value": "yes"}],
]


def _same(a, b):
    for (ji, jl), (ti, tl) in zip(a, b):
        assert ji == ti
        np.testing.assert_array_equal(jl, tl)


@pytest.mark.parametrize("start_end", [False, True])
def test_preprocess_multimodal_matches_jax(start_end):
    got = TS.preprocess_multimodal(SOURCES, mm_use_im_start_end=start_end)
    assert got == JS.preprocess_multimodal(SOURCES, mm_use_im_start_end=start_end)
    assert DEFAULT_IMAGE_TOKEN in SOURCES[0][0]["value"].split("?")[0]   # not changed


@pytest.mark.parametrize("conv_type", ["vicuna_v1", "llava_v1", "plain"])
def test_preprocess_matches_jax(conv_type):
    jtok, ttok = _toks()
    if conv_type == "plain":
        srcs = [[{"from": "human", "value": DEFAULT_IMAGE_TOKEN},
                 {"from": "gpt", "value": "a photo of a dog"}]]
        _same(JS.preprocess_plain(srcs, jtok), TS.preprocess_plain(srcs, ttok))
    else:
        srcs = TS.preprocess_multimodal(SOURCES)
        for s in srcs:
            assert (TS.build_conversation(s, conv_type)
                    == JS.build_conversation(s, conv_type))
        _same(JS.preprocess_v1(srcs, jtok, conv_type=conv_type),
              TS.preprocess_v1(srcs, ttok, conv_type=conv_type))
    _same(JS.preprocess(srcs, jtok, conv_type=conv_type),
          TS.preprocess(srcs, ttok, conv_type=conv_type))


@pytest.mark.parametrize("shape", [(10, 4), (4, 10), (5, 5), (7, 12)])
def test_expand2square_matches_jax(shape):
    img = np.random.default_rng(0).integers(0, 255, shape + (3,), np.uint8)
    got = TS.expand2square(img, TS._CLIP_MEAN_U8)
    np.testing.assert_array_equal(got, JS.expand2square(img, JS._CLIP_MEAN_U8))
    assert TS._CLIP_MEAN_U8 == JS._CLIP_MEAN_U8


def write_corpus(root, n_image=2, n_text=1, seed=0):
    """A json list of ``n_image`` rows with an image (PNG files of several
    shapes) and ``n_text`` text-only rows, from a numpy seed."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    img_dir = root / "imgs"
    img_dir.mkdir(exist_ok=True)
    items = []
    for i in range(n_image):
        h, w = [(30, 44), (40, 28), (32, 32)][i % 3]
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(img_dir / f"{i}.png")
        conv = [{"from": "human", "value": f"{DEFAULT_IMAGE_TOKEN}\nwhat is {i}?"},
                {"from": "gpt", "value": f"thing {i}"}]
        if i % 2:
            conv += [{"from": "human", "value": "and?"}, {"from": "gpt", "value": "more"}]
        items.append({"id": str(i), "image": f"{i}.png", "conversations": conv})
    for i in range(n_text):
        items.append({"id": f"t{i}", "conversations": [
            {"from": "human", "value": f"text only {i}?"}, {"from": "gpt", "value": "yes"}]})
    path = root / "sft.json"
    path.write_text(json.dumps(items))
    return str(path), str(img_dir)


@pytest.mark.parametrize("aspect", ["pad", "none"])
def test_dataset_and_collate_match_jax(tmp_path, aspect):
    jtok, ttok = _toks()
    path, img_dir = write_corpus(tmp_path)
    kw = dict(image_folder=img_dir, image_aspect_ratio=aspect, clip_size=28)
    jds, tds = JS.SFTDataset(path, jtok, **kw), TS.SFTDataset(path, ttok, **kw)
    assert len(jds) == len(tds) == 3
    for i in range(3):
        j, t = jds[i], tds[i]
        assert j["input_ids"] == t["input_ids"] and j["has_image"] == t["has_image"]
        np.testing.assert_array_equal(j["labels"], t["labels"])
        np.testing.assert_array_equal(j["image"], t["image"])
    jb = JS.sft_collate([jds[i] for i in range(3)], jtok, num_image_tokens=4,
                        model_max_length=MML)
    tb = TS.sft_collate([tds[i] for i in range(3)], ttok, num_image_tokens=4,
                        model_max_length=MML)
    assert set(jb) == set(tb)
    for k in jb:
        assert jb[k].dtype == tb[k].dtype, k
        np.testing.assert_array_equal(jb[k], tb[k], err_msg=k)
    assert tb["has_image"].tolist() == [True, True, False]


# ---------------------------------------------------------------------------
# the model side
# ---------------------------------------------------------------------------


def cfgs(vocab):
    jcfg, tcfg = JC.llava_tiny(), TC.llava_tiny()
    grow = lambda c: dataclasses.replace(c, llm=dataclasses.replace(c.llm, vocab_size=vocab))
    return grow(jcfg), grow(tcfg)


def jittered(cfg, lora: bool, seed=1):
    """JAX ``llava.init`` (+ LoRA redrawn from numpy: ``lora_init`` draws
    from ``hash(name)``), every leaf jittered so that zero biases, unit
    scales and LoRA's zero B carry signal."""
    from llmseg_tpu.models import llama as jllama

    p = jllava.init(jax.random.PRNGKey(0), cfg)
    rng = np.random.RandomState(seed)
    if lora:
        p["lora"] = jax.tree.map(
            lambda x: rng.randn(*np.shape(x)) / np.sqrt(np.shape(x)[0]),
            jllama.lora_init(jax.random.PRNGKey(1), cfg.llm, JC.LoraConfig(rank=RANK)))
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.randn(*np.shape(x))).astype(np.float32), p)


def port_model(tcfg, params):
    lora_cfg = TC.LoraConfig(rank=RANK) if "lora" in params else None
    model = tsft.LlavaSFT(tcfg, lora_cfg, device="cpu")
    return load_(model, params)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("sft")
    jtok, ttok = _toks()
    path, img_dir = write_corpus(root, n_image=4, n_text=2)
    jds = JS.SFTDataset(path, jtok, image_folder=img_dir, clip_size=28)
    tds = TS.SFTDataset(path, ttok, image_folder=img_dir, clip_size=28)
    return dict(jtok=jtok, ttok=ttok, jds=jds, tds=tds)


def batches(corpus, order, bsz=2):
    """Collated batches of ``order`` in groups of ``bsz``: (JAX, port)."""
    out = []
    for i in range(0, len(order), bsz):
        idx = order[i:i + bsz]
        jb = JS.sft_collate([corpus["jds"][j] for j in idx], corpus["jtok"],
                            num_image_tokens=4, model_max_length=MML)
        tb = TS.sft_collate([corpus["tds"][j] for j in idx], corpus["ttok"],
                            num_image_tokens=4, model_max_length=MML)
        out.append(({k: jnp.asarray(v) for k, v in jb.items()},
                    {k: torch.from_numpy(v) for k, v in tb.items()}))
    return out


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "+".join(f) or "full")
def test_trainable_mask_matches_jax(corpus, flags):
    jcfg, tcfg = cfgs(corpus["ttok"].vocab_size)
    params = jittered(jcfg, lora=True)
    jmask = jsft.sft_trainable_mask(params, **flags)
    # each mask leaf as an array of its parameter's shape, so that it
    # flattens to the parameter's name
    jflat = {n: bool(v.reshape(-1)[0]) for n, v in flatten(jax.tree.map(
        lambda m, p: np.full(np.shape(p), bool(m)), jmask, params)).items()}
    model = port_model(tcfg, params)
    tmask = tsft.sft_trainable_mask(model, **flags)
    assert tmask == jflat
    trainable = optim.partition(model, tmask)
    jtrain, _ = joptim.partition(params, jmask)
    assert set(trainable) == set(flatten_paths(jtrain))
    assert not any(n.startswith("vision_tower.") for n in trainable)
    # a predicate gives the same partition as the map
    assert list(optim.partition(model, tmask.__getitem__)) == list(trainable)


@pytest.mark.parametrize("rows", ["image", "text_only", "mixed"])
@pytest.mark.parametrize("lora", [False, True])
def test_sft_loss_and_gradients_match_jax(corpus, rows, lora):
    jcfg, tcfg = cfgs(corpus["ttok"].vocab_size)
    params = jittered(jcfg, lora=lora)
    order = {"image": [0, 1], "text_only": [4, 5], "mixed": [2, 5]}[rows]
    ((jb, tb),) = batches(corpus, order)
    flags = dict(lora_enable=lora)
    jmask = jsft.sft_trainable_mask(params, **flags)
    jtrain, skeleton = joptim.partition(params, jmask)
    jlora = JC.LoraConfig(rank=RANK) if lora else None
    jloss, jgrads = jax.value_and_grad(lambda tr: jsft.sft_loss(
        joptim.combine(skeleton, tr), jcfg, jb, lora_cfg=jlora))(jtrain)

    model = port_model(tcfg, params)
    trainable = optim.partition(model, tsft.sft_trainable_mask(model, **flags))
    loss = tsft.sft_loss(model, tb, lora_cfg=TC.LoraConfig(rank=RANK) if lora else None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    jg = flatten_paths(jax.tree.map(np.asarray, jgrads))
    assert set(jg) == set(trainable)
    for name, p in trainable.items():
        err = np.linalg.norm(p.grad.numpy() - jg[name]) / max(np.linalg.norm(jg[name]), 1e-30)
        assert err <= 5e-5, (name, err)


def run_steps(corpus, accum, flags):
    n = 3 * accum
    jcfg, tcfg = cfgs(corpus["ttok"].vocab_size)
    lora = flags.get("lora_enable", False)
    params = jittered(jcfg, lora=lora)
    pairs = batches(corpus, [0, 4, 1, 5, 2, 3] + [1, 2] * (n - 3), bsz=2)[:n]
    kw = dict(lr=1e-3, epochs=1, steps_per_epoch=3, warmup_steps=1, grad_accum_steps=accum)
    jlora = JC.LoraConfig(rank=RANK) if lora else None
    tlora = TC.LoraConfig(rank=RANK) if lora else None

    trainable, skeleton = joptim.partition(params, jsft.sft_trainable_mask(params, **flags))
    tx = joptim.make_trainable_optimizer(JC.TrainConfig(**kw))
    opt_state = tx.init(trainable)
    step = jax.jit(jsft.make_sft_train_step(jcfg, tx, lora_cfg=jlora, remat=True))
    jm = []
    for jb, _ in pairs:
        trainable, opt_state, m = step(trainable, skeleton, opt_state, jb)
        jm.append({k: float(v) for k, v in m.items()})

    model = port_model(tcfg, params)
    ttrain = optim.partition(model, tsft.sft_trainable_mask(model, **flags))
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if n not in ttrain}
    step_fn, _ = tsft.make_sft_train_step(TC.TrainConfig(**kw), ttrain, lora_cfg=tlora)
    tm = [{k: float(v) for k, v in step_fn(model, tb).items()} for _, tb in pairs]
    return dict(jm=jm, tm=tm, model=model, frozen=frozen, trainable=ttrain,
                jparams=flatten_paths(jax.tree.map(np.asarray, trainable)))


@pytest.mark.parametrize("flags", [dict(lora_enable=True), dict(tune_mm_mlp_adapter=True)],
                         ids=["lora", "projector"])
@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_jax(corpus, accum, flags):
    r = run_steps(corpus, accum, flags)
    for j, t in zip(r["jm"], r["tm"]):
        np.testing.assert_allclose(t["ce_loss"], j["ce_loss"], rtol=1e-5)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=1e-4)
    for name, p in r["model"].named_parameters():
        if name in r["frozen"]:
            assert torch.equal(p, r["frozen"][name]), name
            continue
        ref = r["jparams"][name]
        rel = np.linalg.norm(p.detach().numpy() - ref) / max(np.linalg.norm(ref), 1e-30)
        assert rel <= 1e-5, (name, rel)
    moved = r["trainable"]
    assert moved and all(n.startswith(("lora.", "mm_projector.")) for n in moved)


def test_text_only_rows_are_isolated_from_the_image(corpus):
    """With both rows text-only the loss does not depend on the pixels, and
    equals JAX's."""
    jcfg, tcfg = cfgs(corpus["ttok"].vocab_size)
    params = jittered(jcfg, lora=False)
    ((jb, tb),) = batches(corpus, [0, 1])
    T = tb["input_ids"].shape[1]
    tb = dict(tb, has_image=torch.zeros_like(tb["has_image"]),
              image_pos=torch.full_like(tb["image_pos"], T - 1))
    jb = dict(jb, has_image=jnp.zeros_like(jb["has_image"]),
              image_pos=jnp.full_like(jb["image_pos"], T - 1))
    model = port_model(tcfg, params)
    with torch.no_grad():
        l0 = tsft.sft_loss(model, tb).item()
        l1 = tsft.sft_loss(model, dict(tb, images_clip=tb["images_clip"] + 1.0)).item()
    assert l0 == l1
    np.testing.assert_allclose(l0, float(jsft.sft_loss(params, jcfg, jb)), rtol=1e-5)
