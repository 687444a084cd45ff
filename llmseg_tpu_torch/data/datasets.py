"""Datasets, a copy of ``llmseg_tpu.data.datasets`` (capability parity with
reference utils/*_dataset.py): every class and function, on the port's
modules.  The image decode (``_imread_rgb``) and polygon fills stay on cv2,
and the sem-seg label read on PIL, each imported where it is called; the
resizes are ``data.resample``'s.

All datasets emit the same numpy sample dict consumed by data.collate:
  image_path, images_dino (896,896,3) f32, images_clip (224,224,3) f32,
  conversations [str], segs (K,256,256) f32, ious (R,K) f32, iops (R,K) f32,
  masks (R,H,W) GT binary, resize (h,w), inference bool,
  segs_origin / bbox (eval only).

Differences by design:
  * explicit np.random.Generator per dataset (the reference uses the global
    `random`, which breaks determinism across workers),
  * sub-dataset dispatch by dict (the reference eval()s init_<name>),
  * IoU/IoP label computation is vectorized (the port's utils/metrics.py,
    the JAX module's numpy path) instead of the per-proposal python loop
    (reference utils/utils.py:234-272).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Sequence

import numpy as np

from llmseg_tpu_torch.data import conversation as conversation_lib
from llmseg_tpu_torch.data import image_ops
from llmseg_tpu_torch.data.coco_api import COCO
from llmseg_tpu_torch.data.data_processing import get_mask_from_json
from llmseg_tpu_torch.data.mask_reader import SamMaskReader, resize_segs_bilinear
from llmseg_tpu_torch.data.prompts import (ANSWER_LIST, DEFAULT_IMAGE_TOKEN,
                                           LONG_QUESTION_LIST, SHORT_QUESTION_LIST)
from llmseg_tpu_torch.data.refer import G_REFER, REFER
from llmseg_tpu_torch.ops import rle as rle_lib
from llmseg_tpu_torch.utils.metrics import compute_all_iou_iop


def _imread_rgb(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class BaseDataset:
    """Shared preprocessing + templating."""

    ignore_label = 255

    def __init__(self, samples_per_epoch: int = 500 * 8 * 2 * 10,
                 num_classes_per_sample: int = 3, image_size: int = 896,
                 clip_size: int = 224, seg_grid: int = 256, seed: int = 0,
                 conv_type: str = "llava_v1"):
        self.samples_per_epoch = samples_per_epoch
        self.num_classes_per_sample = num_classes_per_sample
        self.image_size = image_size
        self.clip_size = clip_size
        self.seg_grid = seg_grid
        self.rng = np.random.default_rng(seed)
        self.conv_type = conv_type

    def __len__(self):
        return self.samples_per_epoch

    def _prep_images(self, image: np.ndarray):
        dino, resize = image_ops.preprocess_dino(image, self.image_size)
        clip = image_ops.preprocess_clip(image, self.clip_size)
        return dino, clip, resize

    def _prep_segs(self, segs_square: np.ndarray) -> np.ndarray:
        return resize_segs_bilinear(segs_square, self.seg_grid)

    def _labels(self, segs_origin: np.ndarray, masks: Sequence[np.ndarray]):
        ious, iops = [], []
        for m in masks:
            iou, iop = compute_all_iou_iop(segs_origin, m.astype(np.uint8))
            ious.append(iou)
            iops.append(iop)
        return np.stack(ious), np.stack(iops)

    def _conversations(self, questions: Sequence[str],
                       answers: Sequence[str]) -> List[str]:
        out = []
        for q, a in zip(questions, answers):
            conv = conversation_lib.get_default_conv_template(self.conv_type)
            conv.append_message(conv.roles[0], q)
            conv.append_message(conv.roles[1], a)
            out.append(conv.get_prompt())
        return out

    def _choice(self, seq):
        return seq[int(self.rng.integers(len(seq)))]

    def _pack(self, image_path, image, segs_dict, questions, answers, masks,
              inference: bool = False, keep_origin: bool = False) -> Dict:
        dino, clip, resize = self._prep_images(image)
        segs = self._prep_segs(segs_dict["segs_square"])
        ious, iops = self._labels(segs_dict["segs_origin"], masks)
        return {
            "image_path": image_path,
            "images_dino": dino,
            "images_clip": clip,
            "conversations": self._conversations(questions, answers),
            "segs": segs,
            "ious": ious,
            "iops": iops,
            "masks": np.stack(masks).astype(np.float32) if masks else None,
            "resize": resize,
            "segs_origin": segs_dict["segs_origin"] if keep_origin else None,
            "bbox": segs_dict.get("bbox") if keep_origin else None,
            "inference": inference,
        }


# ---------------------------------------------------------------------------
# ReasonSeg (reference utils/reason_seg_dataset.py:25-282)
# ---------------------------------------------------------------------------


class ReasonSegDataset(BaseDataset):
    def __init__(self, base_image_dir: str, mask_readers: Dict[str, SamMaskReader],
                 reason_seg_data: str = "ReasonSeg|train",
                 explanatory: float = 0.1, **kw):
        super().__init__(**kw)
        self.base_image_dir = base_image_dir
        self.explanatory = explanatory
        self.mask_readers = mask_readers     # {"train": reader, "val": reader}

        name, splits = reason_seg_data.split("|")
        images = []
        for split in splits.split("_"):
            images += glob.glob(os.path.join(
                base_image_dir, "reason_seg", name, split, "*.jpg"))
        self.images = images
        self.jsons = [p.replace(".jpg", ".json") for p in images]

        self.img_to_explanation = {}
        if explanatory != -1:
            path = os.path.join(base_image_dir, "reason_seg", name,
                                "explanatory", "train.json")
            if os.path.exists(path):
                with open(path) as f:
                    for item in json.load(f):
                        self.img_to_explanation[item["image"]] = {
                            "query": item["query"],
                            "outputs": item["outputs"]}

    def __getitem__(self, _):
        idx = int(self.rng.integers(len(self.images)))
        image_path = self.images[idx]
        image = _imread_rgb(image_path)
        mask, sents, is_sentence = get_mask_from_json(self.jsons[idx], image)

        n = min(self.num_classes_per_sample, len(sents))
        inds = self.rng.choice(len(sents), size=n, replace=False)
        sampled_sents = [sents[int(i)] for i in inds]
        sampled_masks = [(mask == 1).astype(np.float32) for _ in inds]

        split = os.path.basename(os.path.dirname(image_path))
        segs_dict = self.mask_readers[split].extract_sam_segs(
            os.path.basename(image_path))

        questions, answers = [], []
        for text in sampled_sents:
            if is_sentence:
                questions.append(self._choice(LONG_QUESTION_LIST)
                                 .format(sent=text))
            else:
                questions.append(self._choice(SHORT_QUESTION_LIST)
                                 .format(class_name=text.lower()))
            # choice==0 always: segmentation-only answers
            # (reference reason_seg_dataset.py:218 "simplify the problem")
            answers.append(self._choice(ANSWER_LIST))

        return self._pack(image_path, image, segs_dict, questions, answers,
                          sampled_masks)


# ---------------------------------------------------------------------------
# Referring segmentation (reference utils/refer_seg_dataset.py:18-334)
# ---------------------------------------------------------------------------


class ReferSegDataset(BaseDataset):
    def __init__(self, base_image_dir: str,
                 coco2014_reader: SamMaskReader,
                 saiapr_reader: SamMaskReader,
                 refer_seg_data: str = "refclef||refcoco||refcoco+||refcocog",
                 **kw):
        super().__init__(**kw)
        data_dir = os.path.join(base_image_dir, "refer_seg")
        self.data_dir = data_dir
        self.coco2014_reader = coco2014_reader
        self.saiapr_reader = saiapr_reader
        self.ds_list = refer_seg_data.split("||")
        self.data = {}
        for ds in self.ds_list:
            split_by = "umd" if ds == "refcocog" else "unc"
            api = (G_REFER if ds == "grefcoco" else REFER)(data_dir, ds,
                                                           split_by)
            ref_ids = api.getRefIds(split="train")
            img_ids = api.getImgIds(ref_ids=ref_ids)
            refs = api.loadRefs(ref_ids=ref_ids)
            images = []
            for item in api.loadImgs(img_ids):
                item = dict(item)
                sub = ("images/saiapr_tc-12" if ds == "refclef"
                       else "images/mscoco/images/train2014")
                item["file_name"] = os.path.join(data_dir, sub,
                                                 item["file_name"])
                images.append(item)
            img2refs = {}
            for ref in refs:
                img2refs.setdefault(ref["image_id"], []).append(ref)
            self.data[ds] = {"api": api, "images": images,
                             "img2refs": img2refs}

    def __getitem__(self, _):
        ds = self._choice(self.ds_list)
        d = self.data[ds]
        image_info = d["images"][int(self.rng.integers(len(d["images"])))]
        refs = d["img2refs"].get(image_info["id"], [])
        if not refs:
            return self.__getitem__(0)

        sents, ref_for_sent = [], []
        for ref in refs:
            for sent in ref["sentences"]:
                sents.append(sent["sent"])
                ref_for_sent.append(ref)
        n = min(self.num_classes_per_sample, len(sents))
        inds = self.rng.choice(len(sents), size=n, replace=False)
        sampled_sents = [sents[int(i)] for i in inds]
        sampled_refs = [ref_for_sent[int(i)] for i in inds]

        image = _imread_rgb(image_info["file_name"])
        if ds == "refclef":
            name = os.path.join(*image_info["file_name"].split("/")[-3:])
            segs_dict = self.saiapr_reader.extract_sam_segs(name)
        else:
            segs_dict = self.coco2014_reader.extract_sam_segs(
                os.path.basename(image_info["file_name"]))

        questions, answers = [], []
        for text in sampled_sents:
            questions.append(self._choice(SHORT_QUESTION_LIST)
                             .format(class_name=text.strip().lower()))
            answers.append(self._choice(ANSWER_LIST))

        masks = [d["api"].getMask(ref)["mask"].astype(np.float32)
                 for ref in sampled_refs]
        return self._pack(image_info["file_name"], image, segs_dict,
                          questions, answers, masks)


# ---------------------------------------------------------------------------
# Semantic segmentation (reference utils/sem_seg_dataset.py:21-422)
# ---------------------------------------------------------------------------


def init_mapillary(base_image_dir):
    root = os.path.join(base_image_dir, "mapillary")
    with open(os.path.join(root, "config_v2.0.json")) as f:
        classes = np.array([x["readable"].lower()
                            for x in json.load(f)["labels"]])
    labels = sorted(glob.glob(os.path.join(root, "training", "v2.0",
                                           "labels", "*.png")))
    images = [x.replace(".png", ".jpg").replace("v2.0/labels", "images")
              for x in labels]
    return classes, images, labels


def init_ade20k(base_image_dir):
    with open(os.path.join(base_image_dir, "ade20k",
                           "ade20k_classes.json")) as f:
        classes = np.array(json.load(f))
    img_dir = os.path.join(base_image_dir, "ade20k/images", "training")
    ids = [x[:-4] for x in sorted(os.listdir(img_dir)) if x.endswith(".jpg")]
    images = [os.path.join(img_dir, f"{i}.jpg") for i in ids]
    labels = [x.replace(".jpg", ".png").replace("images", "annotations")
              for x in images]
    return classes, images, labels


def init_cocostuff(base_image_dir):
    classes = []
    with open(os.path.join(base_image_dir, "cocostuff",
                           "cocostuff_classes.txt")) as f:
        for line in f.readlines()[1:]:
            classes.append(line.strip().split(": ")[-1])
    classes = np.array(classes)
    labels = glob.glob(os.path.join(base_image_dir, "cocostuff", "train2017",
                                    "*.png"))
    images = [x.replace(".png", ".jpg").replace("cocostuff", "coco")
              for x in labels]
    return classes, images, labels


def init_paco_lvis(base_image_dir):
    api = COCO(os.path.join(base_image_dir, "vlpart", "paco", "annotations",
                            "paco_lvis_v1_train.json"))
    class_map = {}
    for cat in api.loadCats(api.getCatIds()):
        cat_split = cat["name"].strip().split(":")
        if len(cat_split) == 1:
            name = cat_split[0].split("_(")[0]
        else:
            obj, part = cat_split
            name = (obj.split("_(")[0], part.split("_(")[0])
        class_map[cat["id"]] = name
    return class_map, api.getImgIds(), api


def init_pascal_part(base_image_dir):
    api = COCO(os.path.join(base_image_dir, "vlpart", "pascal_part",
                            "train.json"))
    class_map = {}
    for cat in api.loadCats(api.getCatIds()):
        main, part = cat["name"].strip().split(":")
        class_map[cat["id"]] = (main, part)
    return class_map, api.getImgIds(), api


SEM_SEG_INITS = {
    "mapillary": init_mapillary,
    "ade20k": init_ade20k,
    "cocostuff": init_cocostuff,
    "paco_lvis": init_paco_lvis,
    "pascal_part": init_pascal_part,
}


class SemSegDataset(BaseDataset):
    def __init__(self, base_image_dir: str, readers: Dict[str, SamMaskReader],
                 sem_seg_data: str = "ade20k||cocostuff||pascal_part||"
                                     "paco_lvis||mapillary", **kw):
        """readers keys: ade20k, mapillary, coco2017, voc2010."""
        super().__init__(**kw)
        self.base_image_dir = base_image_dir
        self.readers = readers
        self.sem_seg_datas = sem_seg_data.split("||")
        self.data2list = {}
        self.data2classes = {}
        for ds in self.sem_seg_datas:
            out = SEM_SEG_INITS[ds](base_image_dir)
            self.data2classes[ds], a, b = out
            self.data2list[ds] = (a, b)
        if "cocostuff" in self.sem_seg_datas:
            self.cocostuff_class2index = {
                c: i for i, c in enumerate(self.data2classes["cocostuff"])}

    _READER_KEY = {"ade20k": "ade20k", "mapillary": "mapillary",
                   "cocostuff": "coco2017", "paco_lvis": "coco2017",
                   "pascal_part": "voc2010"}

    def _reader_for(self, ds: str) -> SamMaskReader:
        return self.readers[self._READER_KEY[ds]]

    def __getitem__(self, _):
        from PIL import Image as PILImage

        ds = self._choice(self.sem_seg_datas)
        if ds in ("paco_lvis", "pascal_part"):
            class_map, (img_ids, api) = self.data2classes[ds], self.data2list[ds]
            img_id = img_ids[int(self.rng.integers(len(img_ids)))]
            info = api.loadImgs([img_id])[0]
            if ds == "pascal_part":
                image_path = os.path.join(self.base_image_dir, "vlpart", ds,
                                          "VOCdevkit", "VOC2010", "JPEGImages",
                                          info["file_name"])
            else:
                image_path = os.path.join(self.base_image_dir, "coco",
                                          info["file_name"])
            image = _imread_rgb(image_path)
            anns = api.loadAnns(api.getAnnIds(imgIds=info["id"]))
            if not anns:
                return self.__getitem__(0)
            n = min(self.num_classes_per_sample, len(anns))
            idxs = self.rng.choice(len(anns), size=n, replace=False)
            sampled_anns = [anns[int(i)] for i in idxs]
            sampled_classes = []
            for ann in sampled_anns:
                cls = class_map[ann["category_id"]]
                if isinstance(cls, tuple):
                    obj, part = cls
                    name = (f"{obj} {part}" if self.rng.random() < 0.5
                            else f"the {part} of the {obj}")
                else:
                    name = cls
                sampled_classes.append(name)
            masks = [api.annToMask(ann).astype(np.float32)
                     for ann in sampled_anns]
        else:
            images, labels = self.data2list[ds]
            idx = int(self.rng.integers(len(images)))
            image_path, label_path = images[idx], labels[idx]
            label = np.array(PILImage.open(label_path))
            if ds == "ade20k":
                label = label.astype(np.int32)
                label[label == 0] = 255
                label -= 1
                label[label == 254] = 255
            elif ds == "cocostuff":
                for c, i in self.cocostuff_class2index.items():
                    if "-" in c:
                        label[label == i] = 255
            image = _imread_rgb(image_path)
            unique = [u for u in np.unique(label).tolist() if u != 255]
            if not unique:
                return self.__getitem__(0)
            classes = [self.data2classes[ds][u] for u in unique]
            n = min(self.num_classes_per_sample, len(classes))
            pick = self.rng.choice(len(classes), size=n, replace=False)
            sampled_classes = [classes[int(i)] for i in pick]
            class_ids = [unique[int(i)] for i in pick]
            masks = [(label == cid).astype(np.float32) for cid in class_ids]

        segs_dict = self._reader_for(ds).extract_sam_segs(
            os.path.basename(image_path))

        questions = [self._choice(SHORT_QUESTION_LIST)
                     .format(class_name=str(c).lower())
                     for c in sampled_classes]
        answers = [self._choice(ANSWER_LIST) for _ in questions]
        return self._pack(image_path, image, segs_dict, questions, answers,
                          masks)


# ---------------------------------------------------------------------------
# VQA (reference utils/vqa_dataset.py:32-176)
# ---------------------------------------------------------------------------


class VQADataset(BaseDataset):
    def __init__(self, base_image_dir: str, coco2017_reader: SamMaskReader,
                 vqa_data: str = "llava_instruct_150k", **kw):
        super().__init__(**kw)
        self.image_root = os.path.join(base_image_dir, "coco/train2017")
        with open(os.path.join(base_image_dir, "llava_dataset",
                               f"{vqa_data}.json")) as f:
            self.vqa_data = json.load(f)
        self.reader = coco2017_reader

    def __getitem__(self, _):
        item = self.vqa_data[int(self.rng.integers(len(self.vqa_data)))]
        image_path = os.path.join(self.image_root, item["image"])
        image = _imread_rgb(image_path)
        segs_dict = self.reader.extract_sam_segs(item["image"])

        conv = conversation_lib.get_default_conv_template(self.conv_type)
        roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
        source = item["conversations"]
        if roles[source[0]["from"]] != conv.roles[0]:
            source = source[1:]
        conv.messages = []
        for j, sentence in enumerate(source):
            role = roles[sentence["from"]]
            assert role == conv.roles[j % 2], f"{j}"
            conv.append_message(role, sentence["value"])
        conversations = [conv.get_prompt()]

        dino, clip, resize = self._prep_images(image)
        segs = self._prep_segs(segs_dict["segs_square"])
        k = segs.shape[0]
        # no segmentation supervision: zero iou/iop, the [SEG]-less rows are
        # masked by the model (reference passes empty torch.rand(0,...) lists)
        return {
            "image_path": image_path,
            "images_dino": dino, "images_clip": clip,
            "conversations": conversations,
            "segs": segs,
            "ious": np.zeros((1, k), np.float32),
            "iops": np.zeros((1, k), np.float32),
            "masks": None, "resize": resize, "segs_origin": None,
            "bbox": None, "inference": False,
        }


# ---------------------------------------------------------------------------
# LLM-Seg40K (reference utils/llm_seg_dataset.py:25-257)
# ---------------------------------------------------------------------------


class LLMSegDataset(BaseDataset):
    def __init__(self, json_path: str, coco_image_dir: str,
                 ego_objects_image_dir: str,
                 coco_reader: SamMaskReader,
                 egoobjects_reader: SamMaskReader, **kw):
        super().__init__(**kw)
        with open(json_path) as f:
            self.json_data = json.load(f)
        self.coco_image_dir = coco_image_dir
        self.ego_objects_image_dir = ego_objects_image_dir
        self.readers = {"coco": coco_reader, "ego_objects": egoobjects_reader}
        self.samples = self._load_all_samples()

    def _load_all_samples(self) -> List[Dict]:
        samples = []
        for image, sample in self.json_data.items():
            root = (self.ego_objects_image_dir
                    if sample["from_dataset"] == "ego_objects"
                    else self.coco_image_dir)
            for qa in sample["qa_pairs"]:
                samples.append({
                    "image_path": os.path.join(root, image),
                    "image_name": image,
                    "question": qa["question"],
                    "answer": qa["answer"],
                    "from_dataset": sample["from_dataset"],
                    "rle_seg": qa["rle_seg"],
                })
        return samples

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        s = self.samples[idx % len(self.samples)]
        image = _imread_rgb(s["image_path"])
        gt = (rle_lib.decode(s["rle_seg"]) > 0).astype(np.float32)
        segs_dict = self.readers[s["from_dataset"]].extract_sam_segs(
            s["image_name"])
        question = DEFAULT_IMAGE_TOKEN + "\n" + s["question"]
        answer = self._choice(ANSWER_LIST)
        return self._pack(s["image_path"], image, segs_dict, [question],
                          [answer], [gt])


# ---------------------------------------------------------------------------
# Mixture (reference utils/dataset.py:317-506 HybridDataset)
# ---------------------------------------------------------------------------


class HybridDataset(BaseDataset):
    def __init__(self, datasets: Sequence, sample_rates: Sequence[float],
                 samples_per_epoch: int = 500 * 8 * 2 * 10, seed: int = 0):
        super().__init__(samples_per_epoch=samples_per_epoch, seed=seed)
        assert len(datasets) == len(sample_rates)
        self.datasets = list(datasets)
        rates = np.asarray(sample_rates, np.float64)
        self.probs = rates / rates.sum()

    def __getitem__(self, idx):
        i = int(self.rng.choice(len(self.datasets), p=self.probs))
        return self.datasets[i][idx]


# ---------------------------------------------------------------------------
# Validation datasets (reference utils/dataset.py:509-836)
# ---------------------------------------------------------------------------


class ValReasonSegDataset(BaseDataset):
    """ReasonSeg val: first sentence only, keeps full-res origin segs
    (reference ValDataSet_ReasonSeg, utils/dataset.py:509-656)."""

    def __init__(self, base_image_dir: str, mask_reader: SamMaskReader,
                 val_dataset: str = "ReasonSeg|val", **kw):
        super().__init__(**kw)
        name, split = val_dataset.split("|")
        self.images = sorted(glob.glob(os.path.join(
            base_image_dir, "reason_seg", name, split, "*.jpg")))
        self.reader = mask_reader

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        image_path = self.images[idx]
        image = _imread_rgb(image_path)
        mask_json, sents, is_sentence = get_mask_from_json(
            image_path.replace(".jpg", ".json"), image)
        sent = sents[0]
        if is_sentence:
            question = (DEFAULT_IMAGE_TOKEN + "\n {} Please output "
                        "segmentation mask.".format(sent))
        else:
            question = (DEFAULT_IMAGE_TOKEN + "\n What is {} in this image? "
                        "Please output segmentation mask.".format(sent))
        answer = "[SEG]."
        gt = (mask_json == 1).astype(np.float32)
        segs_dict = self.reader.extract_sam_segs(os.path.basename(image_path))
        sample = self._pack(image_path, image, segs_dict, [question],
                            [answer], [gt], inference=True, keep_origin=True)
        return sample


class ValLLMSegDataset(BaseDataset):
    """LLM-Seg40K validation (reference ValDataSet_LLMSeg,
    utils/dataset.py:659-836): seed-42 shuffle, first 100 samples."""

    def __init__(self, json_path: str, coco_image_dir: str,
                 ego_objects_image_dir: str, coco_reader: SamMaskReader,
                 egoobjects_reader: SamMaskReader, limit: int = 100, **kw):
        super().__init__(**kw)
        self.inner = LLMSegDataset(json_path, coco_image_dir,
                                   ego_objects_image_dir, coco_reader,
                                   egoobjects_reader, **kw)
        order = np.random.RandomState(42).permutation(len(self.inner.samples))
        self.order = order[:limit]

    def __len__(self):
        return len(self.order)

    def __getitem__(self, idx):
        s = self.inner.samples[int(self.order[idx])]
        image = _imread_rgb(s["image_path"])
        gt = (rle_lib.decode(s["rle_seg"]) > 0).astype(np.float32)
        segs_dict = self.inner.readers[s["from_dataset"]].extract_sam_segs(
            s["image_name"])
        question = DEFAULT_IMAGE_TOKEN + "\n" + s["question"]
        return self._pack(s["image_path"], image, segs_dict, [question],
                          ["[SEG]."], [gt], inference=True, keep_origin=True)
