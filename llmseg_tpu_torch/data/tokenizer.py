"""Tokenizer layer, a copy of ``llmseg_tpu.data.tokenizer``: HF LLaMA
tokenizer wrapper + hermetic byte fallback.

Mirrors the reference glue (model/llava/mm_utils.py:19-44
tokenizer_image_token, training.py:121-137 [SEG] registration) behind one
interface.  The byte-level fallback keeps the whole pipeline testable with no
external tokenizer assets (sentencepiece is not in this image).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from llmseg_tpu_torch.data.prompts import (DEFAULT_IM_END_TOKEN,
                                           DEFAULT_IM_START_TOKEN,
                                           DEFAULT_IMAGE_TOKEN, IMAGE_TOKEN_INDEX,
                                           SEG_TOKEN)


class ByteTokenizer:
    """Byte-level tokenizer with LLaMA-compatible special-token semantics.

    ids: 0 pad, 1 bos, 2 eos (</s>), 3 unk, 4..259 bytes, then specials.
    Always emits BOS first (like LLaMA).  `instruction_mask_offset` feeds the
    collator's Vicuna masking arithmetic (2 for sentencepiece, see
    reference utils/dataset.py:117; 1 here because byte tokenization has no
    leading-space merge).
    """

    instruction_mask_offset = 1

    def __init__(self, model_max_length: int = 512):
        self.model_max_length = model_max_length
        self.pad_token_id = 0
        self.bos_token_id = 1
        self.eos_token_id = 2
        self.unk_token_id = 3
        self._byte_off = 4
        self._specials = {"</s>": 2}
        self._next_id = 260
        self.added = {}
        for tok in (SEG_TOKEN, DEFAULT_IM_START_TOKEN, DEFAULT_IM_END_TOKEN):
            self.add_special_token(tok)

    def add_special_token(self, tok: str) -> int:
        if tok in self._specials:
            return self._specials[tok]
        tid = self._next_id
        self._next_id += 1
        self._specials[tok] = tid
        self.added[tok] = tid
        return tid

    @property
    def vocab_size(self) -> int:
        return self._next_id

    def convert_tokens_to_ids(self, tok: str) -> int:
        return self._specials[tok]

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = [self.bos_token_id] if add_bos else []
        i = 0
        specials = sorted(self._specials, key=len, reverse=True)
        while i < len(text):
            for sp in specials:
                if text.startswith(sp, i):
                    ids.append(self._specials[sp])
                    i += len(sp)
                    break
            else:
                ids.extend(self._byte_off + b
                           for b in text[i].encode("utf-8"))
                i += 1
        return ids

    def __call__(self, text: str):
        class _Out:
            pass
        out = _Out()
        out.input_ids = self.encode(text)
        return out

    def decode(self, ids) -> str:
        rev = {v: k for k, v in self._specials.items()}
        parts = []
        buf = bytearray()
        for t in ids:
            t = int(t)
            if self._byte_off <= t < self._byte_off + 256:
                buf.append(t - self._byte_off)
            else:
                if buf:
                    parts.append(buf.decode("utf-8", "replace"))
                    buf = bytearray()
                if t in rev:
                    parts.append(rev[t])
        if buf:
            parts.append(buf.decode("utf-8", "replace"))
        return "".join(parts)


class HFTokenizer:
    """Wrapper over a transformers LLaMA tokenizer directory
    (reference training.py:121-137: padding_side right, [SEG] +
    <im_start>/<im_end> added, pad = unk)."""

    instruction_mask_offset = 2

    def __init__(self, path: str, model_max_length: int = 512,
                 use_mm_start_end: bool = True):
        from transformers import AutoTokenizer
        self.tok = AutoTokenizer.from_pretrained(
            path, model_max_length=model_max_length, padding_side="right",
            use_fast=True)
        self.tok.pad_token = self.tok.unk_token
        self.tok.add_tokens(SEG_TOKEN)
        if use_mm_start_end:
            self.tok.add_tokens([DEFAULT_IM_START_TOKEN, DEFAULT_IM_END_TOKEN],
                                special_tokens=True)
        self.model_max_length = model_max_length
        self.pad_token_id = self.tok.pad_token_id
        self.bos_token_id = self.tok.bos_token_id
        self.eos_token_id = self.tok.eos_token_id

    @property
    def vocab_size(self) -> int:
        return len(self.tok)

    def convert_tokens_to_ids(self, t: str) -> int:
        return self.tok.convert_tokens_to_ids(t)

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = self.tok(text).input_ids
        if not add_bos and ids and ids[0] == self.bos_token_id:
            ids = ids[1:]
        return ids

    def __call__(self, text: str):
        return self.tok(text)

    def decode(self, ids) -> str:
        return self.tok.decode(ids)


def tokenizer_image_token(prompt: str, tokenizer,
                          image_token_index: int = IMAGE_TOKEN_INDEX
                          ) -> List[int]:
    """Split on <image>, insert the placeholder id between chunks
    (reference mm_utils.py:19-44): each chunk after the first drops its BOS."""
    chunks = [tokenizer.encode(c) for c in prompt.split(DEFAULT_IMAGE_TOKEN)]
    ids: List[int] = []
    offset = 0
    if chunks and chunks[0] and chunks[0][0] == tokenizer.bos_token_id:
        offset = 1
        ids.append(chunks[0][0])
    sep = [image_token_index] * (offset + 1)
    merged: List[List[int]] = []
    for i, c in enumerate(chunks):
        merged.append(c)
        if i < len(chunks) - 1:
            merged.append(sep)
    for x in merged:
        ids.extend(x[offset:])
    return ids


def seg_token_id(tokenizer) -> int:
    return tokenizer.convert_tokens_to_ids(SEG_TOKEN)
