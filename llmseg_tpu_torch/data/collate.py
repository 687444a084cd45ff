"""Static-shape batch collation, a copy of ``llmseg_tpu.data.collate``: the
same numpy batch and extras.

Replaces reference collate_fn_new (utils/dataset.py:33-170).  Differences by
design (static shapes):
  * every output array has a fixed shape: text padded to
    `model_max_length - (num_image_tokens - 1)` tokens (so the spliced
    sequence is exactly model_max_length), conversation rows padded to
    R = batch * num_classes_per_sample, proposals padded to K — one set of
    shapes serves every batch;
  * the ragged python lists (offset, sam_segs_list, ...) become dense arrays
    with `row_to_image` indices and validity masks;
  * the <image> placeholder (-200) is consumed on the host: its position is
    recorded in `image_pos` and the id replaced by pad (the device splice
    overwrites that slot).

The Vicuna-style target masking reproduces the reference arithmetic exactly
(utils/dataset.py:92-126): mask system+question tokens per round, keep
answer + sep2 tokens.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from llmseg_tpu_torch.data import conversation as conv_lib
from llmseg_tpu_torch.data.prompts import (DEFAULT_IM_END_TOKEN,
                                           DEFAULT_IM_START_TOKEN,
                                           DEFAULT_IMAGE_TOKEN, IGNORE_INDEX,
                                           IMAGE_TOKEN_INDEX)
from llmseg_tpu_torch.data.tokenizer import tokenizer_image_token


def mask_targets(conversation: str, ids: List[int], tokenizer,
                 conv_type: str = "llava_v1") -> np.ndarray:
    """Vicuna round masking over one conversation's token ids."""
    conv = conv_lib.conv_templates[conv_type]
    target = np.asarray(ids, np.int64).copy()
    if conv.sep_style == conv_lib.SeparatorStyle.TWO:
        sep = conv.sep + conv.roles[1] + ": "
    else:
        sep = "[/INST] "
    off = tokenizer.instruction_mask_offset
    rounds = conversation.split(conv.sep2)
    cur_len = 1
    target[:cur_len] = IGNORE_INDEX
    for rou in rounds:
        if rou == "":
            break
        parts = rou.split(sep)
        assert len(parts) == 2, (len(parts), rou)
        parts[0] += sep
        if DEFAULT_IMAGE_TOKEN in conversation:
            round_len = len(tokenizer_image_token(rou, tokenizer))
            instruction_len = len(tokenizer_image_token(parts[0], tokenizer)) - off
        else:
            round_len = len(tokenizer.encode(rou))
            instruction_len = len(tokenizer.encode(parts[0])) - off
        target[cur_len:cur_len + instruction_len] = IGNORE_INDEX
        cur_len += round_len
    target[cur_len:] = IGNORE_INDEX
    return target


def collate(samples: List[Dict], tokenizer, *, num_image_tokens: int,
            rows_per_sample: int, max_proposals: int,
            conv_type: str = "llava_v1", use_mm_start_end: bool = True,
            model_max_length: Optional[int] = None) -> Dict:
    """samples: dataset dicts (numpy).  Returns the model batch contract
    (see models/llmseg.forward) as numpy arrays + host-side eval extras."""
    mml = model_max_length or tokenizer.model_max_length
    T = mml - (num_image_tokens - 1)
    B = len(samples)
    R = B * rows_per_sample
    K = max_proposals

    input_ids = np.zeros((R, T), np.int32)
    labels = np.full((R, T), IGNORE_INDEX, np.int64)
    image_pos = np.zeros((R,), np.int32)
    row_to_image = np.zeros((R,), np.int32)
    row_valid = np.zeros((R,), bool)
    gt_ious = np.zeros((R, K), np.float32)
    gt_iops = np.zeros((R, K), np.float32)

    G = samples[0]["segs"].shape[-1]
    sam_segs = np.zeros((B, K, G, G), np.float32)
    prop_valid = np.zeros((B, K), bool)

    pad_id = tokenizer.pad_token_id
    row = 0
    for i, s in enumerate(samples):
        k_i = min(s["segs"].shape[0], K)
        sam_segs[i, :k_i] = s["segs"][:k_i]
        prop_valid[i, :k_i] = True
        for r, conversation in enumerate(s["conversations"]):
            if row >= R:
                break
            if use_mm_start_end:
                conversation = conversation.replace(
                    DEFAULT_IMAGE_TOKEN,
                    DEFAULT_IM_START_TOKEN + DEFAULT_IMAGE_TOKEN
                    + DEFAULT_IM_END_TOKEN)
            ids = tokenizer_image_token(conversation, tokenizer)
            tgt = mask_targets(conversation, ids, tokenizer, conv_type)
            ids = np.asarray(ids, np.int64)
            ids, tgt = ids[:T], tgt[:T]

            img_where = np.nonzero(ids == IMAGE_TOKEN_INDEX)[0]
            pos = int(img_where[0]) if len(img_where) else 0
            ids = ids.copy()
            ids[ids == IMAGE_TOKEN_INDEX] = pad_id
            tgt[tgt == IMAGE_TOKEN_INDEX] = IGNORE_INDEX

            n = len(ids)
            input_ids[row, :n] = ids
            input_ids[row, n:] = pad_id
            labels[row, :n] = tgt
            image_pos[row] = pos
            row_to_image[row] = i
            row_valid[row] = True
            if s.get("ious") is not None and r < len(s["ious"]):
                kk = min(len(s["ious"][r]), K)
                gt_ious[row, :kk] = s["ious"][r][:kk]
                gt_iops[row, :kk] = s["iops"][r][:kk]
            row += 1

    batch = {
        "images_dino": np.stack([s["images_dino"] for s in samples]),
        "images_clip": np.stack([s["images_clip"] for s in samples]),
        "input_ids": input_ids,
        "labels": labels,
        "image_pos": image_pos,
        "row_to_image": row_to_image,
        "row_valid": row_valid,
        "sam_segs": sam_segs,
        "prop_valid": prop_valid,
        "gt_ious": gt_ious,
        "gt_iops": gt_iops,
    }
    extras = {
        "image_paths": [s.get("image_path") for s in samples],
        "masks_list": [s.get("masks") for s in samples],
        "segs_origin": [s.get("segs_origin") for s in samples],
        "bbox": [s.get("bbox") for s in samples],
        "resize": [s.get("resize") for s in samples],
        "conversations": [s.get("conversations") for s in samples],
        "inference": bool(samples[0].get("inference", False)),
    }
    return batch, extras
