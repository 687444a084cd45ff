"""ReasonSeg LabelMe-style polygon annotations -> GT mask, a copy of
``llmseg_tpu.data.data_processing`` with cv2 imported when a mask is made
(capability parity with reference utils/data_processing.py:9-60):
area-sorted z-order polygon fill, 'ignore' labels painted 255, 'flag'
annotations dropped.
"""

from __future__ import annotations

import json
from typing import List, Tuple

import numpy as np


def get_mask_from_json(json_path: str, img: np.ndarray
                       ) -> Tuple[np.ndarray, List[str], bool]:
    import cv2

    try:
        with open(json_path, "r") as r:
            anno = json.loads(r.read())
    except UnicodeDecodeError:
        with open(json_path, "r", encoding="cp1252") as r:
            anno = json.loads(r.read())

    inform = anno["shapes"]
    comments = anno["text"]
    is_sentence = anno["is_sentence"]
    height, width = img.shape[:2]

    # sort polygons by area, large first, so small ones stay on top
    area_list, valid = [], []
    for shape in inform:
        if "flag" == shape["label"].lower():
            continue
        tmp = np.zeros((height, width), np.uint8)
        pts = np.array([shape["points"]], np.int32)
        cv2.polylines(tmp, pts, True, 1, 1)
        cv2.fillPoly(tmp, pts, 1)
        area_list.append(int(tmp.sum()))
        valid.append(shape)

    order = np.argsort(area_list)[::-1]
    mask = np.zeros((height, width), np.uint8)
    for idx in order:
        shape = valid[int(idx)]
        value = 255 if "ignore" in shape["label"].lower() else 1
        pts = np.array([shape["points"]], np.int32)
        cv2.polylines(mask, pts, True, value, 1)
        cv2.fillPoly(mask, pts, value)
    return mask, comments, is_sentence
