"""REFER / G_REFER referring-expression APIs, a copy of
``llmseg_tpu.data.refer`` (capability parity with
reference utils/refer.py:43-391 and utils/grefer.py:36-352, pycocotools-free).

Data layout (as published by the refer project):
  <data_root>/<dataset>/refs(<splitBy>).p   — pickled list of ref dicts
  <data_root>/<dataset>/instances.json      — COCO-format annotations
where dataset in {refclef, refcoco, refcoco+, refcocog, grefcoco}.
"""

from __future__ import annotations

import itertools
import os
import pickle
import time
from typing import Dict, List

import numpy as np

from llmseg_tpu_torch.data.coco_api import COCO, ann_to_mask, _as_list


class REFER:
    def __init__(self, data_root: str, dataset: str = "refcoco",
                 splitBy: str = "unc"):
        self.ROOT_DIR = data_root
        self.DATA_DIR = os.path.join(data_root, dataset)
        if dataset in ("refcoco", "refcoco+", "refcocog"):
            self.IMAGE_DIR = os.path.join(data_root,
                                          "images/mscoco/images/train2014")
        elif dataset == "refclef":
            self.IMAGE_DIR = os.path.join(data_root, "images/saiapr_tc-12")
        else:
            raise ValueError(f"No refer dataset {dataset}")
        tic = time.time()
        ref_file = os.path.join(self.DATA_DIR, f"refs({splitBy}).p")
        with open(ref_file, "rb") as f:
            self.data = {"dataset": dataset, "refs": pickle.load(f)}
        self.coco = COCO(os.path.join(self.DATA_DIR, "instances.json"))
        self.data["images"] = self.coco.dataset["images"]
        self.data["annotations"] = self.coco.dataset["annotations"]
        self.data["categories"] = self.coco.dataset["categories"]
        self.createIndex()
        print(f"REFER {dataset}({splitBy}) index created in "
              f"{time.time() - tic:.2f}s")

    def createIndex(self):
        self.Refs, self.Anns, self.Imgs, self.Cats = {}, {}, {}, {}
        self.Sents, self.imgToRefs, self.imgToAnns = {}, {}, {}
        self.refToAnn, self.annToRef, self.catToRefs = {}, {}, {}
        self.sentToRef, self.sentToTokens = {}, {}
        for ann in self.data["annotations"]:
            self.Anns[ann["id"]] = ann
            self.imgToAnns.setdefault(ann["image_id"], []).append(ann)
        for img in self.data["images"]:
            self.Imgs[img["id"]] = img
        for cat in self.data["categories"]:
            self.Cats[cat["id"]] = cat["name"]
        for ref in self.data["refs"]:
            ref_id, ann_id = ref["ref_id"], ref["ann_id"]
            category_id, image_id = ref["category_id"], ref["image_id"]
            self.Refs[ref_id] = ref
            self.imgToRefs.setdefault(image_id, []).append(ref)
            self.catToRefs.setdefault(category_id, []).append(ref)
            self.refToAnn[ref_id] = self.Anns[ann_id]
            self.annToRef[ann_id] = ref
            for sent in ref["sentences"]:
                self.Sents[sent["sent_id"]] = sent
                self.sentToRef[sent["sent_id"]] = ref
                self.sentToTokens[sent["sent_id"]] = sent["tokens"]

    def getRefIds(self, image_ids=None, cat_ids=None, ref_ids=None,
                  split: str = "") -> List:
        image_ids = _as_list(image_ids)
        cat_ids = _as_list(cat_ids)
        ref_ids = _as_list(ref_ids)
        refs = self.data["refs"]
        if image_ids:
            iset = set(image_ids)
            refs = [r for r in refs if r["image_id"] in iset]
        if cat_ids:
            cset = set(cat_ids)
            refs = [r for r in refs if r["category_id"] in cset]
        if ref_ids:
            rset = set(ref_ids)
            refs = [r for r in refs if r["ref_id"] in rset]
        if split:
            if split in ("testA", "testB", "testC"):
                refs = [r for r in refs if split[-1] in r["split"]]
            elif split in ("testAB", "testBC", "testAC"):
                refs = [r for r in refs if r["split"] == split]
            elif split == "test":
                refs = [r for r in refs if "test" in r["split"]]
            elif split in ("train", "val"):
                refs = [r for r in refs if r["split"] == split]
            else:
                raise ValueError(f"No such split {split}")
        return [r["ref_id"] for r in refs]

    def getAnnIds(self, image_ids=None, cat_ids=None, ref_ids=None) -> List:
        image_ids = _as_list(image_ids)
        cat_ids = _as_list(cat_ids)
        ref_ids = _as_list(ref_ids)
        if image_ids:
            lists = [self.imgToAnns[i] for i in image_ids
                     if i in self.imgToAnns]
            anns = list(itertools.chain.from_iterable(lists))
        else:
            anns = self.data["annotations"]
        if cat_ids:
            cset = set(cat_ids)
            anns = [a for a in anns if a["category_id"] in cset]
        ids = [a["id"] for a in anns]
        if ref_ids:
            rset = set(ref_ids)
            ids = set(ids).intersection(
                [self.Refs[r]["ann_id"] for r in ref_ids])
            ids = list(ids)
        return ids

    def getImgIds(self, ref_ids=None) -> List:
        ref_ids = _as_list(ref_ids)
        if ref_ids:
            return list(set(self.Refs[r]["image_id"] for r in ref_ids))
        return list(self.Imgs)

    def getCatIds(self) -> List:
        return list(self.Cats)

    def loadRefs(self, ref_ids) -> List[Dict]:
        return [self.Refs[r] for r in _as_list(ref_ids)]

    def loadAnns(self, ann_ids) -> List[Dict]:
        return [self.Anns[a] for a in _as_list(ann_ids)]

    def loadImgs(self, image_ids) -> List[Dict]:
        return [self.Imgs[i] for i in _as_list(image_ids)]

    def loadCats(self, cat_ids) -> List:
        return [self.Cats[c] for c in _as_list(cat_ids)]

    def getRefBox(self, ref_id) -> List:
        return self.refToAnn[ref_id]["bbox"]

    def getMask(self, ref) -> Dict:
        ann = self.refToAnn[ref["ref_id"]]
        image = self.Imgs[ref["image_id"]]
        m = ann_to_mask(ann, image["height"], image["width"])
        return {"mask": m, "area": int(m.sum())}


class G_REFER(REFER):
    """gRefCOCO: refs may aggregate multiple ann_ids (-1 = no target)
    (reference utils/grefer.py)."""

    def __init__(self, data_root: str, dataset: str = "grefcoco",
                 splitBy: str = "unc"):
        self.ROOT_DIR = data_root
        self.DATA_DIR = os.path.join(data_root, dataset)
        self.IMAGE_DIR = os.path.join(data_root,
                                      "images/mscoco/images/train2014")
        tic = time.time()
        refs = None
        for ext in ("p", "json"):
            path = os.path.join(self.DATA_DIR, f"grefs({splitBy}).{ext}")
            if os.path.exists(path):
                if ext == "p":
                    with open(path, "rb") as f:
                        refs = pickle.load(f)
                else:
                    import json
                    with open(path) as f:
                        refs = json.load(f)
                break
        if refs is None:
            raise FileNotFoundError(f"grefs({splitBy}) under {self.DATA_DIR}")
        self.data = {"dataset": dataset, "refs": refs}
        self.coco = COCO(os.path.join(self.DATA_DIR, "instances.json"))
        self.data["images"] = self.coco.dataset["images"]
        self.data["annotations"] = self.coco.dataset["annotations"]
        self.data["categories"] = self.coco.dataset["categories"]
        self.createIndex()
        print(f"G_REFER {dataset}({splitBy}) index created in "
              f"{time.time() - tic:.2f}s")

    def createIndex(self):
        super_refs = self.data["refs"]
        self.Refs, self.Anns, self.Imgs, self.Cats = {}, {}, {}, {}
        self.Sents, self.imgToRefs, self.imgToAnns = {}, {}, {}
        self.refToAnn, self.annToRef, self.catToRefs = {}, {}, {}
        self.sentToRef, self.sentToTokens = {}, {}
        for ann in self.data["annotations"]:
            if ann is None:
                continue
            self.Anns[ann["id"]] = ann
            self.imgToAnns.setdefault(ann["image_id"], []).append(ann)
        for img in self.data["images"]:
            self.Imgs[img["id"]] = img
        for cat in self.data["categories"]:
            self.Cats[cat["id"]] = cat["name"]
        for ref in super_refs:
            ref_id = ref["ref_id"]
            self.Refs[ref_id] = ref
            self.imgToRefs.setdefault(ref["image_id"], []).append(ref)
            self.catToRefs.setdefault(ref["category_id"], []).append(ref)
            ann_ids = ref["ann_id"]
            if not isinstance(ann_ids, list):
                ann_ids = [ann_ids]
            self.refToAnn[ref_id] = [self.Anns[a] for a in ann_ids
                                     if a != -1]
            for sent in ref["sentences"]:
                self.Sents[sent["sent_id"]] = sent
                self.sentToRef[sent["sent_id"]] = ref
                self.sentToTokens[sent["sent_id"]] = sent.get("tokens", [])

    def getMask(self, ref) -> Dict:
        image = self.Imgs[ref["image_id"]]
        anns = self.refToAnn[ref["ref_id"]]
        m = np.zeros((image["height"], image["width"]), np.uint8)
        for ann in anns:
            m |= ann_to_mask(ann, image["height"], image["width"])
        return {"mask": m, "area": int(m.sum())}
