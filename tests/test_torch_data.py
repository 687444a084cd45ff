"""The port's data modules against ``llmseg_tpu.data`` on the same inputs:
prompts, conversation templates, both tokenizers and
``tokenizer_image_token``, ``mask_targets`` and ``collate`` (batch and
extras), ``COCO`` / ``ann_to_mask`` (RLE and polygon), ``REFER`` and
``G_REFER`` on a written refs pickle, ``SamMaskReader``,
``get_mask_from_json`` and the image preprocesses.  Every comparison is
exact (``assert_array_equal``, ``==``): the port copies these functions.

The resamplers of ``data/resample.py`` are held against the libraries the
JAX package calls, over sizes drawn by ``hypothesis`` (shrinking, growing,
odd sizes, 1-pixel sides) and the real cases (480 x 640 to DINOv2's 896
and CLIP's 224): ``pil_resize`` equal to ``PIL.Image.resize`` to the bit,
``cv2_resize`` within 1e-6 absolute of ``cv2.resize`` on values in [0, 1]
(the port sums in float64, cv2 in float32)."""

import json
import os
import pickle
import sys

import cv2
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from llmseg_tpu.data import coco_api as jcoco
from llmseg_tpu.data import collate as jcollate
from llmseg_tpu.data import conversation as jconv
from llmseg_tpu.data import data_processing as jdp
from llmseg_tpu.data import image_ops as jimg
from llmseg_tpu.data import mask_reader as jmr
from llmseg_tpu.data import prompts as jprompts
from llmseg_tpu.data import refer as jrefer
from llmseg_tpu.data import tokenizer as jtok
from llmseg_tpu.ops import rle as jrle
from llmseg_tpu_torch.data import coco_api as tcoco
from llmseg_tpu_torch.data import collate as tcollate
from llmseg_tpu_torch.data import conversation as tconv
from llmseg_tpu_torch.data import data_processing as tdp
from llmseg_tpu_torch.data import image_ops as timg
from llmseg_tpu_torch.data import mask_reader as tmr
from llmseg_tpu_torch.data import prompts as tprompts
from llmseg_tpu_torch.data import refer as trefer
from llmseg_tpu_torch.data import resample
from llmseg_tpu_torch.data import tokenizer as ttok

sys.path.insert(0, os.path.dirname(__file__))

CV2_TOL = 1e-6      # cv2_resize vs cv2.resize, absolute, values in [0, 1]
SETTINGS = settings(max_examples=60, deadline=None, derandomize=True,
                    suppress_health_check=[HealthCheck.too_slow])


def assert_tree_equal(a, b, path="x"):
    """Equal structure, types and values; numpy arrays equal in dtype,
    shape and every element."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


# ---------------------------------------------------------------------------
# prompts, conversation templates, tokenizers
# ---------------------------------------------------------------------------


def test_prompts_match_jax():
    names = [n for n in dir(jprompts) if n.isupper()]
    assert names == [n for n in dir(tprompts) if n.isupper()]
    for n in names:
        assert getattr(tprompts, n) == getattr(jprompts, n), n


@pytest.mark.parametrize("name", sorted(jconv.conv_templates))
def test_conversation_templates_match_jax(name):
    assert [s.name for s in tconv.SeparatorStyle] == [s.name for s in jconv.SeparatorStyle]
    prompts = []
    for lib in (jconv, tconv):
        conv = lib.get_default_conv_template(name)
        assert conv.messages == []
        conv.append_message(conv.roles[0], "<image>\nWhat is the red thing?")
        conv.append_message(conv.roles[1], "It is [SEG].")
        conv.append_message(conv.roles[0], "And the next?")
        conv.append_message(conv.roles[1], None)
        prompts.append((conv.get_prompt(), conv.copy().get_prompt(), conv.version,
                        conv.roles, conv.sep, conv.sep2, conv.system))
    assert prompts[0] == prompts[1]
    assert tconv.default_conversation.get_prompt() == jconv.default_conversation.get_prompt()


TEXTS = ["", "plain ascii", "<image>\nWhat is [SEG]?", "ünïcödé <im_start><image><im_end> x",
         "A chat. USER: <image>\nhi ASSISTANT: It is [SEG].</s>USER: more ASSISTANT: ok</s>",
         "<image>", "a<image>b<image>c"]


@pytest.mark.parametrize("text", TEXTS)
def test_byte_tokenizer_matches_jax(text):
    j, t = jtok.ByteTokenizer(model_max_length=77), ttok.ByteTokenizer(model_max_length=77)
    assert (t.vocab_size, t.added, t.model_max_length) == (j.vocab_size, j.added, j.model_max_length)
    for add_bos in (True, False):
        assert t.encode(text, add_bos=add_bos) == j.encode(text, add_bos=add_bos)
    assert t(text).input_ids == j(text).input_ids
    ids = j.encode(text)
    assert t.decode(ids) == j.decode(ids)
    assert ttok.tokenizer_image_token(text, t) == jtok.tokenizer_image_token(text, j)
    assert ttok.tokenizer_image_token(text, t, image_token_index=-7) == \
        jtok.tokenizer_image_token(text, j, image_token_index=-7)
    assert ttok.seg_token_id(t) == jtok.seg_token_id(j)
    assert t.add_special_token("<x>") == j.add_special_token("<x>")


def test_hf_tokenizer_matches_jax(tmp_path):
    pytest.importorskip("tokenizers")
    pytest.importorskip("transformers")
    from tok_utils import build_tiny_fast_tokenizer
    d = build_tiny_fast_tokenizer(str(tmp_path), TEXTS)
    for mm in (True, False):
        j = jtok.HFTokenizer(d, model_max_length=64, use_mm_start_end=mm)
        t = ttok.HFTokenizer(d, model_max_length=64, use_mm_start_end=mm)
        assert (t.vocab_size, t.pad_token_id, t.bos_token_id, t.eos_token_id) == \
            (j.vocab_size, j.pad_token_id, j.bos_token_id, j.eos_token_id)
        assert ttok.seg_token_id(t) == jtok.seg_token_id(j)
        for text in TEXTS:
            assert t.encode(text, add_bos=False) == j.encode(text, add_bos=False)
            assert ttok.tokenizer_image_token(text, t) == jtok.tokenizer_image_token(text, j)
            conv = TEXTS[4]
            np.testing.assert_array_equal(
                tcollate.mask_targets(conv, ttok.tokenizer_image_token(conv, t), t),
                jcollate.mask_targets(conv, jtok.tokenizer_image_token(conv, j), j))


# ---------------------------------------------------------------------------
# mask_targets and collate
# ---------------------------------------------------------------------------


def _conversation(lib, question, answer, conv_type="llava_v1"):
    conv = lib.get_default_conv_template(conv_type)
    conv.append_message(conv.roles[0], question)
    conv.append_message(conv.roles[1], answer)
    return conv.get_prompt()


@pytest.mark.parametrize("conv_type", ["llava_v1", "llava_llama_2"])
def test_mask_targets_match_jax(conv_type):
    j, t = jtok.ByteTokenizer(), ttok.ByteTokenizer()
    for q, a in (("<image>\nWhat is the cat?", "It is [SEG]."), ("no image here", "Sure."),
                 ("<image>\n" + "long " * 40, "[SEG].")):
        conv = _conversation(jconv, q, a, conv_type)
        assert conv == _conversation(tconv, q, a, conv_type)
        got = tcollate.mask_targets(conv, ttok.tokenizer_image_token(conv, t), t, conv_type)
        ref = jcollate.mask_targets(conv, jtok.tokenizer_image_token(conv, j), j, conv_type)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def _samples(seed, n=3, K=(5, 12, 3), G=16, rows=(2, 1, 3), inference=False):
    """Dataset-shaped sample dicts: ragged proposals and rows, some rows
    without labels, extras of every kind."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        k, r = K[i % len(K)], rows[i % len(rows)]
        convs = [_conversation(jconv, "<image>\nWhat is thing %d?" % j,
                               "Sure, [SEG]." if j % 2 else "It is [SEG].") for j in range(r)]
        out.append({
            "image_path": f"/data/img{i}.jpg",
            "images_dino": rng.randn(56, 56, 3).astype(np.float32),
            "images_clip": rng.randn(28, 28, 3).astype(np.float32),
            "conversations": convs,
            "segs": rng.rand(k, G, G).astype(np.float32),
            "ious": rng.rand(r, k).astype(np.float32) if i != 1 else None,
            "iops": rng.rand(r, k).astype(np.float32) if i != 1 else None,
            "masks": (rng.rand(r, 30, 40) < 0.5).astype(np.float32),
            "resize": (42, 56),
            "segs_origin": (rng.rand(30, 40, k) < 0.3).astype(np.float64) if inference else None,
            "bbox": [[1.0, 2.0, 3.0, 4.0]] * k if inference else None,
            "inference": inference,
        })
    return out


@pytest.mark.parametrize("rows_per_sample,max_proposals,mml,mm", [
    (2, 8, 120, True), (3, 16, 400, False), (1, 4, 90, True)])
def test_collate_matches_jax(rows_per_sample, max_proposals, mml, mm):
    """Padding of rows and proposals, truncation of long rows (mml 90 cuts
    them), the image placeholder, and every extra."""
    samples = _samples(seed=rows_per_sample, inference=mm)
    kw = dict(num_image_tokens=9, rows_per_sample=rows_per_sample,
              max_proposals=max_proposals, use_mm_start_end=mm, model_max_length=mml)
    ref = jcollate.collate(samples, jtok.ByteTokenizer(), **kw)
    got = tcollate.collate(samples, ttok.ByteTokenizer(), **kw)
    assert_tree_equal(got, ref)


# ---------------------------------------------------------------------------
# COCO, REFER, G_REFER, SamMaskReader, get_mask_from_json
# ---------------------------------------------------------------------------


def _instances(rng, h=40, w=48):
    m = np.zeros((h, w), np.uint8)
    m[3:20, 5:30] = 1
    crle = jrle.encode(m)
    urle = {"size": [h, w], "counts": jrle.mask_to_counts(m[::-1].copy())}
    return {
        "images": [{"id": 1, "height": h, "width": w, "file_name": "a.jpg"},
                   {"id": 2, "height": h, "width": w, "file_name": "b.jpg"}],
        "annotations": [
            {"id": 10, "image_id": 1, "category_id": 5, "bbox": [4, 4, 10, 10],
             "segmentation": [[4.2, 4, 14, 4.6, 14, 14, 4, 14], [30, 30, 40, 32, 35, 38]]},
            {"id": 11, "image_id": 1, "category_id": 6, "bbox": [5, 3, 25, 17],
             "segmentation": crle},
            {"id": 12, "image_id": 2, "category_id": 5, "bbox": [0, 0, 1, 1],
             "segmentation": urle},
        ],
        "categories": [{"id": 5, "name": "bench"}, {"id": 6, "name": "dog:ear"}],
    }


def test_coco_api_matches_jax(tmp_path):
    doc = _instances(np.random.RandomState(0))
    path = tmp_path / "inst.json"
    path.write_text(json.dumps(doc))
    j, t = jcoco.COCO(str(path)), tcoco.COCO(str(path))
    assert t.getCatIds() == j.getCatIds() and t.getImgIds() == j.getImgIds()
    for q in (dict(), dict(imgIds=1), dict(imgIds=[2]), dict(catIds=5), dict(imgIds=1, catIds=[6])):
        assert t.getAnnIds(**q) == j.getAnnIds(**q)
    assert t.loadCats([5, 6]) == j.loadCats([5, 6]) and t.loadImgs(2) == j.loadImgs(2)
    for ann in doc["annotations"]:
        assert t.loadAnns(ann["id"]) == j.loadAnns(ann["id"])
        got, ref = t.annToMask(ann), j.annToMask(ann)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
        assert tcoco.ann_to_rle(ann, 40, 48) == jcoco.ann_to_rle(ann, 40, 48)
        np.testing.assert_array_equal(tcoco.ann_to_mask(ann, 40, 48), jcoco.ann_to_mask(ann, 40, 48))
    assert tcoco._as_list(np.arange(3)) == jcoco._as_list(np.arange(3))


def _refer_tree(root, grefer=False):
    rng = np.random.RandomState(1)
    name = "grefcoco" if grefer else "refcoco"
    d = root / name
    d.mkdir(parents=True)
    (d / "instances.json").write_text(json.dumps(_instances(rng)))
    splits = ["train", "val", "testA", "testB", "train"]
    refs = []
    for i in range(5):
        ann = ([10, 11] if i == 0 else [-1] if i == 1 else [12]) if grefer else [10, 11, 12][i % 3]
        refs.append({"ref_id": i, "ann_id": ann, "image_id": 1 if i < 3 else 2,
                     "category_id": 5 if i % 2 else 6, "split": splits[i],
                     "sentences": [{"sent_id": 2 * i, "sent": f"the thing {i}",
                                    "tokens": ["the", "thing", str(i)]},
                                   {"sent_id": 2 * i + 1, "sent": f"object {i}",
                                    "tokens": ["object", str(i)]}]})
    with open(d / ("grefs(unc).p" if grefer else "refs(unc).p"), "wb") as f:
        pickle.dump(refs, f)
    return name


@pytest.mark.parametrize("grefer", [False, True])
def test_refer_apis_match_jax(tmp_path, grefer):
    name = _refer_tree(tmp_path, grefer)
    J, T = (jrefer.G_REFER, trefer.G_REFER) if grefer else (jrefer.REFER, trefer.REFER)
    j, t = J(str(tmp_path), name, "unc"), T(str(tmp_path), name, "unc")
    for attr in ("Refs", "Anns", "Imgs", "Cats", "Sents", "imgToRefs", "imgToAnns",
                 "refToAnn", "annToRef", "catToRefs", "sentToRef", "sentToTokens"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.IMAGE_DIR == j.IMAGE_DIR
    for split in ("", "train", "val", "test", "testA", "testB"):
        assert t.getRefIds(split=split) == j.getRefIds(split=split)
    assert t.getRefIds(image_ids=[1], cat_ids=5) == j.getRefIds(image_ids=[1], cat_ids=5)
    assert t.getAnnIds(image_ids=1, cat_ids=6) == j.getAnnIds(image_ids=1, cat_ids=6)
    if grefer:      # a gRefCOCO ref's ann_id is a list: both raise alike
        for api in (j, t):
            with pytest.raises(TypeError):
                api.getAnnIds(ref_ids=[0, 1])
    else:
        assert sorted(t.getAnnIds(image_ids=1, ref_ids=[0, 1])) == \
            sorted(j.getAnnIds(image_ids=1, ref_ids=[0, 1]))
    assert sorted(t.getImgIds([0, 3])) == sorted(j.getImgIds([0, 3]))
    assert t.getCatIds() == j.getCatIds() and t.loadCats([5]) == j.loadCats([5])
    for ref in j.data["refs"]:
        got, want = t.getMask(ref), j.getMask(ref)
        assert got["area"] == want["area"]
        np.testing.assert_array_equal(got["mask"], want["mask"])
    with pytest.raises(ValueError):
        t.getRefIds(split="nope")


def _masks_doc(rng, names, h, w, k):
    doc = []
    for name in names:
        masks = []
        for _ in range(k):
            m = np.zeros((h, w), np.uint8)
            y, x = rng.randint(0, h - 8), rng.randint(0, w - 8)
            hh, ww = rng.randint(2, 8, 2)
            m[y:y + hh, x:x + ww] = 1
            masks.append({"segmentation": jrle.encode(m), "area": int(m.sum()),
                          "bbox": [float(x), float(y), float(ww), float(hh)]})
        doc.append({"image": name, "target_size": [h, w], "masks": masks})
    return doc


@pytest.mark.parametrize("h,w,top_k,size", [(40, 48, 50, 16), (61, 37, 3, 16), (20, 20, 4, 32)])
def test_sam_mask_reader_matches_jax(tmp_path, h, w, top_k, size):
    path = tmp_path / "masks.json"
    path.write_text(json.dumps(_masks_doc(np.random.RandomState(h), ["a.jpg", "b.jpg"], h, w, 6)))
    j = jmr.SamMaskReader(str(path), top_k=top_k, verbose=False)
    t = tmr.SamMaskReader(str(path), top_k=top_k, verbose=False)
    assert ("a.jpg" in t) and ("c.jpg" not in t) and t.index == j.index
    for name in ("a.jpg", "b.jpg"):
        got, ref = t.extract_sam_segs(name), j.extract_sam_segs(name)
        assert_tree_equal(got, ref)
        segs = tmr.resize_segs_bilinear(got["segs_square"], size)
        want = jmr.resize_segs_bilinear(ref["segs_square"], size)
        assert segs.dtype == want.dtype == np.float32 and segs.shape == want.shape
        np.testing.assert_allclose(segs, want, rtol=0, atol=CV2_TOL)
    with pytest.raises(ValueError):
        t.extract_sam_segs("c.jpg")


def test_get_mask_from_json_matches_jax(tmp_path):
    anno = {"shapes": [{"label": "target", "points": [[5, 5], [50, 5], [50, 40], [5, 40]]},
                       {"label": "ignore this", "points": [[10, 10], [20, 10], [20, 20]]},
                       {"label": "Flag", "points": [[0, 0], [59, 0], [59, 59]]},
                       {"label": "small", "points": [[30, 30], [34, 30], [34, 35], [30, 36]]}],
            "text": ["a red thing", "the other"], "is_sentence": True}
    path = tmp_path / "a.json"
    path.write_text(json.dumps(anno))
    img = np.zeros((60, 80, 3), np.uint8)
    got, ref = tdp.get_mask_from_json(str(path), img), jdp.get_mask_from_json(str(path), img)
    assert got[1:] == ref[1:]
    assert got[0].dtype == ref[0].dtype
    np.testing.assert_array_equal(got[0], ref[0])
    assert set(np.unique(got[0])) == {0, 1, 255}


# ---------------------------------------------------------------------------
# image preprocesses and the resamplers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w", [(60, 80), (80, 60), (57, 57), (1, 5), (480, 640)])
def test_image_ops_match_jax(h, w):
    img = np.random.RandomState(h * w).randint(0, 256, (h, w, 3)).astype(np.uint8)
    for size in (56, 896, 15):
        assert timg.get_preprocess_shape(h, w, size) == jimg.get_preprocess_shape(h, w, size)
        assert_tree_equal(timg.resize_longest_side(img, size), jimg.resize_longest_side(img, size))
    for size in (56, 896):
        assert_tree_equal(timg.preprocess_dino(img, size), jimg.preprocess_dino(img, size))
    if min(h, w) > 1:        # JAX's crop of a 1-pixel side is empty
        for size in (28, 224):
            assert_tree_equal(timg.preprocess_clip(img, size), jimg.preprocess_clip(img, size))
    pts = np.random.RandomState(0).rand(5, 2) * [w, h]
    assert_tree_equal(timg.apply_coords(pts, (h, w), 56), jimg.apply_coords(pts, (h, w), 56))
    boxes = np.random.RandomState(1).rand(3, 4) * [w, h, w, h]
    assert_tree_equal(timg.apply_boxes(boxes, (h, w), 56), jimg.apply_boxes(boxes, (h, w), 56))
    for name in ("SAM_PIXEL_MEAN", "SAM_PIXEL_STD", "CLIP_MEAN", "CLIP_STD"):
        assert_tree_equal(getattr(timg, name), getattr(jimg, name))


def _pil(img, size, name):
    f = {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC}[name]
    return np.asarray(Image.fromarray(img).resize((size[1], size[0]), f))


sides = st.one_of(st.integers(1, 4), st.integers(5, 300))


@SETTINGS
@given(h=sides, w=sides, oh=sides, ow=sides, channels=st.sampled_from([0, 1, 3]),
       name=st.sampled_from(["bilinear", "bicubic"]), seed=st.integers(0, 2 ** 31 - 1))
def test_pil_resize_equals_pil(h, w, oh, ow, channels, name, seed):
    rng = np.random.RandomState(seed)
    shape = (h, w) if channels == 0 else (h, w, channels)
    img = rng.randint(0, 256, shape).astype(np.uint8)
    if channels == 1:
        ref = _pil(img[..., 0], (oh, ow), name)[..., None]
    else:
        ref = _pil(img, (oh, ow), name)
    got = resample.pil_resize(img, (oh, ow), name)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape,size,name", [
    ((480, 640, 3), (672, 896), "bilinear"), ((640, 480, 3), (896, 672), "bilinear"),
    ((427, 640, 3), (598, 896), "bilinear"), ((480, 640, 3), (224, 298), "bicubic"),
    ((640, 480, 3), (298, 224), "bicubic"), ((427, 640, 3), (224, 335), "bicubic")])
def test_pil_resize_real_cases(shape, size, name):
    """DINOv2's 896 longest side and CLIP's 224 shortest side of the corpora's
    480 x 640, 640 x 480 and 427 x 640 images, on noise and on a smooth
    image (ramps hit the rounding boundaries that noise averages away)."""
    rng = np.random.RandomState(7)
    noise = rng.randint(0, 256, shape).astype(np.uint8)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    ramp = np.stack([(xx * 255) // shape[1], (yy * 255) // shape[0], (xx + yy) % 256],
                    -1).astype(np.uint8)
    for img in (noise, ramp):
        np.testing.assert_array_equal(resample.pil_resize(img, size, name), _pil(img, size, name))


def _cv2(x, size):
    interp = cv2.INTER_AREA if size[0] < x.shape[0] else cv2.INTER_LINEAR
    return cv2.resize(x.astype(np.float32), (size[1], size[0]), interpolation=interp)


@SETTINGS
@given(s=sides, d=sides, k=st.integers(1, 4), binary=st.booleans(),
       seed=st.integers(0, 2 ** 31 - 1))
def test_cv2_resize_matches_cv2(s, d, k, binary, seed):
    """Square (S, S, K) stacks, as the segment resize gets them, shrunk by
    INTER_AREA and grown by INTER_LINEAR; masks and values in [0, 1]."""
    rng = np.random.RandomState(seed)
    x = rng.rand(s, s, k)
    if binary:
        x = (x < 0.3).astype(np.float64)
    got = resample.cv2_resize(x, (d, d))
    ref = np.stack([_cv2(x[..., i], (d, d)) for i in range(k)], -1)
    assert got.dtype == np.float32 and got.shape == (d, d, k)
    np.testing.assert_allclose(got, ref, rtol=0, atol=CV2_TOL)


@pytest.mark.parametrize("s,d", [(640, 256), (480, 256), (512, 256), (256, 256), (100, 256),
                                 (80, 16), (1, 16), (640, 1)])
def test_cv2_resize_real_cases(s, d):
    """The segment resize's real shapes: 640 and 480 (non-integer ratios),
    512 (the block mean), equal, growing, 1-pixel sides."""
    rng = np.random.RandomState(s + d)
    x = (rng.rand(s, s, 3) < 0.3).astype(np.float64)
    x[..., 2] = rng.rand(s, s)
    got = resample.cv2_resize(x, (d, d))
    ref = np.stack([_cv2(x[..., i], (d, d)) for i in range(3)], -1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=CV2_TOL)


def test_resamplers_refuse_what_they_do_not_do():
    with pytest.raises(TypeError):
        resample.pil_resize(np.zeros((4, 4), np.float32), (2, 2))
    with pytest.raises(ValueError):
        resample.cv2_resize(np.zeros((4, 8)), (2, 16))
