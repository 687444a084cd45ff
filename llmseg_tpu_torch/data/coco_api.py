"""Minimal COCO-format annotation index (pycocotools-free), a copy of
``llmseg_tpu.data.coco_api``.

Covers what the datasets need from pycocotools.coco.COCO: imgs/anns/cats
indices, getAnnIds/getCatIds/getImgIds, loadAnns/loadCats/loadImgs, and
annToMask (polygon + RLE decoding via the port's ops/rle.py; polygons
are filled by cv2, imported when one is filled).
Used by paco_lvis / pascal_part semantic-seg branches and the REFER API.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional, Union

import numpy as np

from llmseg_tpu_torch.ops import rle as rle_lib


def ann_to_rle(ann: Dict, h: int, w: int) -> Dict:
    """segmentation (polygon list | uncompressed RLE | compressed RLE) -> RLE."""
    segm = ann["segmentation"]
    if isinstance(segm, list):  # polygons
        import cv2

        m = np.zeros((h, w), np.uint8)
        for poly in segm:
            pts = np.asarray(poly, np.float64).reshape(-1, 2)
            cv2.fillPoly(m, [np.round(pts).astype(np.int32)], 1)
        return rle_lib.encode(m)
    if isinstance(segm.get("counts"), list):
        return {"size": segm["size"], "counts": segm["counts"]}
    return segm


def ann_to_mask(ann: Dict, h: int, w: int) -> np.ndarray:
    return rle_lib.decode(ann_to_rle(ann, h, w))


class COCO:
    def __init__(self, annotation_file: Optional[str] = None,
                 dataset: Optional[Dict] = None):
        if annotation_file is not None:
            with open(annotation_file) as f:
                dataset = json.load(f)
        self.dataset = dataset or {}
        self.anns: Dict = {}
        self.imgs: Dict = {}
        self.cats: Dict = {}
        self.img_to_anns = defaultdict(list)
        self.cat_to_imgs = defaultdict(list)
        self.create_index()

    def create_index(self):
        for ann in self.dataset.get("annotations", []):
            self.anns[ann["id"]] = ann
            self.img_to_anns[ann["image_id"]].append(ann)
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat
        for ann in self.dataset.get("annotations", []):
            if "category_id" in ann:
                self.cat_to_imgs[ann["category_id"]].append(ann["image_id"])

    def getAnnIds(self, imgIds=None, catIds=None) -> List:
        imgIds = _as_list(imgIds)
        catIds = _as_list(catIds)
        if imgIds:
            anns = [a for i in imgIds for a in self.img_to_anns[i]]
        else:
            anns = list(self.anns.values())
        if catIds:
            cset = set(catIds)
            anns = [a for a in anns if a.get("category_id") in cset]
        return [a["id"] for a in anns]

    def getCatIds(self) -> List:
        return sorted(self.cats)

    def getImgIds(self) -> List:
        return sorted(self.imgs)

    def loadAnns(self, ids) -> List[Dict]:
        return [self.anns[i] for i in _as_list(ids)]

    def loadCats(self, ids) -> List[Dict]:
        return [self.cats[i] for i in _as_list(ids)]

    def loadImgs(self, ids) -> List[Dict]:
        return [self.imgs[i] for i in _as_list(ids)]

    def annToMask(self, ann: Dict) -> np.ndarray:
        img = self.imgs[ann["image_id"]]
        return ann_to_mask(ann, img["height"], img["width"])


def _as_list(x) -> List:
    if x is None:
        return []
    if isinstance(x, (list, tuple, np.ndarray)):
        return list(x)
    return [x]
