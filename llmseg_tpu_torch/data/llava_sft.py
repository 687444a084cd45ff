"""LLaVA supervised-finetuning data, the counterpart of
``llmseg_tpu.data.llava_sft`` (the reference's model/llava/train/train.py):

  * :func:`preprocess_multimodal` (train.py:314-343): the <image>
    placeholder moved to the front of its turn, optionally wrapped in
    <im_start>/<im_end>;
  * :func:`preprocess_plain` (train.py:592-620): feature-alignment
    pretraining, every token up to the placeholder ignored;
  * :func:`preprocess_v1` (train.py:430-515): Vicuna-round instruction
    masking through ``data.collate.mask_targets``;
  * :class:`SFTDataset` (train.py:681-762): a json list of {image?,
    conversations}, the "pad" aspect ratio (:func:`expand2square` on the
    CLIP mean), a zero image for a text-only sample;
  * :func:`sft_collate` (train.py:763-795) with a static shape: text padded
    to ``model_max_length - (num_image_tokens - 1)``, so that the spliced
    sequence is ``model_max_length`` long.

A text-only row points ``image_pos`` at its first padding slot and clears
``has_image``; ``train.sft.sft_loss`` zeroes that row's image embeddings, so
the splice puts zero vectors in the padded tail, where causal attention
cannot reach a real token.

Images are read by :func:`_imread_rgb` (PIL, imported there), one
module-level function that a caller without PIL can stand in for.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from llmseg_tpu_torch.data import conversation as conv_lib
from llmseg_tpu_torch.data import image_ops
from llmseg_tpu_torch.data.collate import mask_targets
from llmseg_tpu_torch.data.prompts import (DEFAULT_IM_END_TOKEN, DEFAULT_IM_START_TOKEN,
                                           DEFAULT_IMAGE_TOKEN, IGNORE_INDEX,
                                           IMAGE_TOKEN_INDEX)
from llmseg_tpu_torch.data.tokenizer import tokenizer_image_token

Source = List[Dict[str, str]]  # [{"from": "human"|"gpt", "value": str}, ...]


def preprocess_multimodal(sources: Sequence[Source], *,
                          mm_use_im_start_end: bool = False) -> List[Source]:
    """Strip <image> wherever it appears in a turn and put it back as
    ``<image>\\n`` at the front of that turn; optionally wrap it with
    <im_start>/<im_end>.  The sources are copied, not changed."""
    out = copy.deepcopy(list(sources))
    for source in out:
        for sentence in source:
            if DEFAULT_IMAGE_TOKEN in sentence["value"]:
                v = sentence["value"].replace(DEFAULT_IMAGE_TOKEN, "").strip()
                sentence["value"] = (DEFAULT_IMAGE_TOKEN + "\n" + v).strip()
            if mm_use_im_start_end:
                sentence["value"] = sentence["value"].replace(
                    DEFAULT_IMAGE_TOKEN,
                    DEFAULT_IM_START_TOKEN + DEFAULT_IMAGE_TOKEN + DEFAULT_IM_END_TOKEN)
    return out


def preprocess_plain(sources: Sequence[Source], tokenizer
                     ) -> List[Tuple[List[int], np.ndarray]]:
    """"<image>" + caption + sep: every token up to and including the
    placeholder is IGNORE, the caption supervises."""
    conv = conv_lib.conv_templates["plain"]
    results = []
    for source in sources:
        assert len(source) == 2, "plain preprocessing expects (image, caption)"
        assert DEFAULT_IMAGE_TOKEN in source[0]["value"]
        ids = tokenizer_image_token(DEFAULT_IMAGE_TOKEN + source[1]["value"] + conv.sep,
                                    tokenizer)
        labels = np.asarray(ids, np.int64).copy()
        labels[:len(tokenizer_image_token(DEFAULT_IMAGE_TOKEN, tokenizer))] = IGNORE_INDEX
        results.append((ids, labels))
    return results


def build_conversation(source: Source, conv_type: str = "vicuna_v1") -> str:
    """One source through the conversation template: a leading non-human
    turn is dropped, then the roles alternate."""
    conv = conv_lib.get_default_conv_template(conv_type)
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    if roles.get(source[0]["from"]) != conv.roles[0]:
        source = source[1:]
    for j, sentence in enumerate(source):
        role = roles[sentence["from"]]
        assert role == conv.roles[j % 2], f"role order broken at turn {j}"
        conv.append_message(role, sentence["value"])
    return conv.get_prompt()


def preprocess_v1(sources: Sequence[Source], tokenizer, *, conv_type: str = "vicuna_v1"
                  ) -> List[Tuple[List[int], np.ndarray]]:
    """Vicuna-style instruction masking: the questions ignored, the answers
    supervised (``mask_targets``' round arithmetic)."""
    results = []
    for source in sources:
        conversation = build_conversation(source, conv_type)
        ids = tokenizer_image_token(conversation, tokenizer)
        results.append((ids, mask_targets(conversation, ids, tokenizer, conv_type)))
    return results


def preprocess(sources: Sequence[Source], tokenizer, *, conv_type: str = "vicuna_v1"
               ) -> List[Tuple[List[int], np.ndarray]]:
    """:func:`preprocess_plain` for the plain template, else
    :func:`preprocess_v1`."""
    if conv_lib.conv_templates[conv_type].sep_style == conv_lib.SeparatorStyle.PLAIN:
        return preprocess_plain(sources, tokenizer)
    return preprocess_v1(sources, tokenizer, conv_type=conv_type)


def expand2square(image: np.ndarray, background: Tuple[int, int, int]) -> np.ndarray:
    """An (H, W, 3) image padded to a square of ``background``, the short
    axis centred."""
    h, w = image.shape[:2]
    if h == w:
        return image
    side = max(h, w)
    out = np.empty((side, side, 3), image.dtype)
    out[:] = np.asarray(background, image.dtype)
    if w > h:
        top = (side - h) // 2
        out[top:top + h, :] = image
    else:
        left = (side - w) // 2
        out[:, left:left + w] = image
    return out


_CLIP_MEAN_U8 = tuple(int(x * 255) for x in np.asarray(image_ops.CLIP_MEAN).reshape(-1))


def _imread_rgb(path: str) -> np.ndarray:
    """One file's (H, W, 3) uint8 RGB image, read by PIL."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


class SFTDataset:
    """A json list of {"id", "image"?, "conversations"}.  A sample with an
    image is normalised by :func:`preprocess_multimodal`; a text-only one
    carries a zero CLIP image and ``has_image`` False."""

    def __init__(self, data_path: str, tokenizer, *, image_folder: Optional[str] = None,
                 conv_type: str = "vicuna_v1", image_aspect_ratio: str = "pad",
                 clip_size: int = 224, mm_use_im_start_end: bool = False,
                 is_multimodal: bool = True):
        with open(data_path) as f:
            self.items = json.load(f)
        self.tokenizer = tokenizer
        self.image_folder = image_folder
        self.conv_type = conv_type
        self.image_aspect_ratio = image_aspect_ratio
        self.clip_size = clip_size
        self.mm_use_im_start_end = mm_use_im_start_end
        self.is_multimodal = is_multimodal

    def __len__(self) -> int:
        return len(self.items)

    def _load_image(self, fname: str) -> np.ndarray:
        img = _imread_rgb(os.path.join(self.image_folder or "", fname))
        if self.image_aspect_ratio == "pad":
            img = expand2square(img, _CLIP_MEAN_U8)
        return image_ops.preprocess_clip(img, self.clip_size)

    def __getitem__(self, i: int) -> Dict:
        item = self.items[i]
        has_image = "image" in item
        source = item["conversations"]
        if has_image:
            (source,) = preprocess_multimodal([source],
                                              mm_use_im_start_end=self.mm_use_im_start_end)
            image = self._load_image(item["image"])
        else:
            image = np.zeros((self.clip_size, self.clip_size, 3), np.float32)
        ((ids, labels),) = preprocess([source], self.tokenizer, conv_type=self.conv_type)
        return {"input_ids": ids, "labels": labels, "image": image,
                "has_image": has_image and self.is_multimodal}


def sft_collate(instances: Sequence[Dict], tokenizer, *, num_image_tokens: int,
                model_max_length: Optional[int] = None) -> Dict:
    """A static-shape batch for ``train.sft.sft_loss``: images_clip (B, H,
    W, 3), input_ids (B, T) with the placeholder consumed, labels (B, T),
    image_pos (B,), has_image (B,); T makes the spliced sequence
    ``model_max_length`` long.  numpy arrays."""
    mml = model_max_length or tokenizer.model_max_length
    T = mml - (num_image_tokens - 1)
    B = len(instances)
    pad_id = tokenizer.pad_token_id

    input_ids = np.full((B, T), pad_id, np.int32)
    labels = np.full((B, T), IGNORE_INDEX, np.int64)
    image_pos = np.zeros((B,), np.int32)
    has_image = np.zeros((B,), bool)
    images = np.stack([inst["image"] for inst in instances])

    for b, inst in enumerate(instances):
        ids = np.asarray(inst["input_ids"], np.int64)[:T]
        tgt = np.asarray(inst["labels"], np.int64)[:T].copy()
        img_where = np.nonzero(ids == IMAGE_TOKEN_INDEX)[0]
        if len(img_where) and inst["has_image"]:
            pos = int(img_where[0])
            has_image[b] = True
        else:
            # text-only: the splice goes to the padded tail, where causal
            # attention reaches no real token; a row that fills the window
            # is cut to T - 1 so that a pad slot exists
            ids, tgt = ids[:T - 1], tgt[:T - 1]
            pos = len(ids)
        ids = ids.copy()
        ids[ids == IMAGE_TOKEN_INDEX] = pad_id
        tgt[tgt == IMAGE_TOKEN_INDEX] = IGNORE_INDEX
        input_ids[b, :len(ids)] = ids
        labels[b, :len(ids)] = tgt
        image_pos[b] = pos

    return {"images_clip": images, "input_ids": input_ids, "labels": labels,
            "image_pos": image_pos, "has_image": has_image}
