"""Everything-mode automatic mask generation (AMG), the counterpart of
``llmseg_tpu.models.sam.amg``.

``amg_select`` decodes every grid point against one image embedding in
chunks of ``points_per_batch`` (kernel G on the card), casts the low-res
logits to bf16, filters by predicted IoU and stability, takes inclusive
boxes, runs NMS and keeps the top ``max_masks`` by predicted IoU, all on the
device; on the card, a whole image's work up to the NMS is one CUDA graph
and the NMS a kernel, and none of it waits for the host.
``AutomaticMaskGenerator`` drives it: ``submit`` (encode + select),
``prefetch`` (survivor metadata, then the upscale of the survivors: run
boundaries computed on the device, or bit-packed bitmaps when small regions
are cleaned, and their copy to the host), ``finish`` (RLE and the annotation
schema on the host, which overlaps the next image's device work).  The
crop cascade (``crop_n_layers > 0``) runs the full frame and every crop
(resized to the SAM input with ``data.image_ops.resize_longest_side``)
through the same ``amg_select``, drops candidates on a crop's inner edge,
upscales each crop's survivors to the crop's extent on the device and
dedups across crops on the host, smaller crops first.
"""

from __future__ import annotations

import functools
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from llmseg_tpu_torch.config import AMGConfig, SamConfig
from llmseg_tpu_torch.data import image_ops
from llmseg_tpu_torch.device import require
from llmseg_tpu_torch.models.sam import sam as sam_lib
from llmseg_tpu_torch.ops import amg_utils, device_rle, nms, rle
from llmseg_tpu_torch.ops.kernels import StaticGraph, replay_or_capture
from llmseg_tpu_torch.utils import profiling

# per-column run-start budget of the device RLE; blobby SAM masks have 1-2
MAX_RUNS_PER_COL = 8


def _candidate_filters(low_masks, iou_pred, amg: AMGConfig, cfg: SamConfig, valid_hw):
    """IoU and stability filters on low-res logits (N, S, S) outside the
    padded area; ``valid_hw`` the extent on that grid, two ints or a (2,)
    integer tensor on the logits' device.  Returns (keep, stability, masked
    logits)."""
    S = low_masks.shape[-1]
    row = torch.arange(S, device=low_masks.device)
    region = ((row < valid_hw[0])[:, None] & (row < valid_hw[1])[None, :])[None]
    # a Python scalar, rounded to the logits' dtype where it is written
    neg = cfg.mask_threshold - 2.0 * amg.stability_score_offset - 1.0
    masked = torch.where(region, low_masks, neg)
    keep = iou_pred > amg.pred_iou_thresh
    stability = amg_utils.calculate_stability_score(masked, cfg.mask_threshold,
                                                    amg.stability_score_offset)
    keep &= stability >= amg.stability_score_thresh
    return keep, stability, masked


def _lowres_hw(valid_hw, S4: int, img: int):
    """The image's extent (h, w) on the low-res grid, at least 1: ints from
    ints, a (2,) int64 tensor on the device from a tensor there, by the same
    integer arithmetic."""
    if isinstance(valid_hw, torch.Tensor):
        return (valid_hw.long() * S4 // img).clamp_min(1)
    return tuple(max(v * S4 // img, 1) for v in valid_hw)


def _chunks(points: torch.Tensor, B: int) -> torch.Tensor:
    """(P, 2) -> (ceil(P / B), B, 1, 2), zero-padded."""
    n_chunks = -(-points.shape[0] // B)
    pts = torch.nn.functional.pad(points, (0, 0, 0, n_chunks * B - points.shape[0]))
    return pts.reshape(n_chunks, B, 1, 2)


def _decode(model, image_embedding: torch.Tensor, pts: torch.Tensor, cache: Dict):
    """Every chunk of prompts against the image embedding: (bf16 logits (M,
    S4, S4), iou (M,)), M = 3 a prompt.  ``cache`` (new for each image)
    keeps what the chunks share, kernel G's recorded sequence among it."""
    S4 = model.cfg.prompt.image_embedding_size * 4
    labels = torch.ones(pts.shape[1], 1, dtype=torch.int32, device=pts.device)
    masks, ious = [], []
    for c in range(pts.shape[0]):
        m, i = sam_lib.decode_masks(model, image_embedding, points=pts[c], labels=labels,
                                    multimask_output=True, cache=cache)
        masks.append(m.to(torch.bfloat16))   # the filters see bf16 logits
        ious.append(i)
    return torch.stack(masks).reshape(-1, S4, S4), torch.stack(ious).reshape(-1)


def _candidates(model, amg: AMGConfig, masks, iou_pred, pts, P: int, valid_hw,
                crop_box=None, orig_box=None, box_scale=None) -> Dict:
    """The filters, the inclusive boxes and the crop-edge test on every
    candidate: the NMS's input (``keep``, its validity) beside the
    candidates' logits, IoU, stability, boxes and points."""
    cfg = model.cfg
    S4, M = masks.shape[-1], masks.shape[0]
    point_per_mask = pts.reshape(-1, 2).repeat_interleave(3, 0)
    real = torch.arange(M, device=masks.device) // 3 < P
    img = cfg.encoder.img_size
    keep, stability, masked = _candidate_filters(masks, iou_pred, amg, cfg,
                                                 _lowres_hw(valid_hw, S4, img))
    keep &= real
    binary = masked > cfg.mask_threshold
    boxes = amg_utils.batched_mask_to_box(binary) * (img / S4)
    keep &= binary.any(-1).any(-1)
    if crop_box is not None:
        sc = torch.as_tensor(box_scale, dtype=torch.float32, device=boxes.device).repeat(2)
        keep &= ~amg_utils.is_box_near_crop_edge(boxes * sc, crop_box, orig_box)
    return {"masks_low": masks, "iou": iou_pred, "stability": stability, "boxes": boxes,
            "points": point_per_mask, "keep": keep}


def _nms_top(cand: Dict, amg: AMGConfig) -> Dict:
    """NMS over the candidates, then the top ``max_masks`` by predicted IoU:
    rows gathered into tensors of their own."""
    with profiling.span("nms"):
        keep_nms = nms.nms(cand["boxes"], cand["iou"], amg.box_nms_thresh, valid=cand["keep"])
    score = torch.where(keep_nms, cand["iou"], -torch.inf)
    top = torch.argsort(-score, stable=True)[:amg.max_masks]
    out = {k: cand[k][top] for k in ("masks_low", "iou", "stability", "boxes", "points")}
    out["valid"] = keep_nms[top]
    return out


def _select(model, amg: AMGConfig, cache: Dict, image_embedding, points, valid_hw) -> Dict:
    """The selection's work from the image embedding to the NMS's input
    (the chunks' prompt encoding and kernel G, the stack of the logits, the
    filters, the boxes and ``keep``), as its graph captures it; ``cache``
    keeps G's plan, whose buffers the captured kernels read."""
    pts = _chunks(points, amg.points_per_batch)
    masks, iou = _decode(model, image_embedding, pts, cache)
    return _candidates(model, amg, masks, iou, pts, points.shape[0], valid_hw)


# model -> {key: StaticGraph}; dropped with the model
_SELECT_GRAPHS = weakref.WeakKeyDictionary()


def _select_graph(model, amg: AMGConfig, image_embedding, points, valid_hw) -> Dict:
    """The candidates of one image from its selection graph: a replay, or
    the capture's warm-up result on the first call at a key.  One graph an
    embedding shape, dtype and device, grid size and filter settings.  Its
    static inputs are the embedding, the points and the image's extent (h,
    w), which the captured work reads on the card, so one graph serves
    every image size.  G's sequence is recorded in the capture, once, and
    kept with the graph; each replay adds the launches the capture took
    back (G: one a chunk).  The weights' storage and versions are stamped:
    a weight moved or changed captures anew.  The outputs are the graph's
    own: ``_nms_top`` gathers the kept rows before the next replay."""
    key = (tuple(image_embedding.shape), image_embedding.dtype, image_embedding.device,
           points.shape[0], amg.points_per_batch, amg.pred_iou_thresh,
           amg.stability_score_thresh, amg.stability_score_offset,
           id(model.prompt_encoder), id(model.mask_decoder))
    hw = torch.as_tensor(valid_hw, device=image_embedding.device)
    return replay_or_capture(_SELECT_GRAPHS, model, key, lambda *inputs: StaticGraph(
        functools.partial(_select, model, amg), *inputs, versions=True,
        tensors=[*model.prompt_encoder.parameters(), *model.mask_decoder.parameters()],
        counter="amg.select_graph"), image_embedding, points, hw)


def amg_select(model, amg: AMGConfig, image_embedding: torch.Tensor, points: torch.Tensor,
               valid_hw, crop_box=None, orig_box=None, box_scale=None) -> Dict:
    """Grid prompts -> filtered, NMS'd top-K candidates.  image_embedding
    (1, G, G, C); points (P, 2) input-frame pixels; valid_hw the image's
    extent (h, w), two ints or a (2,) tensor on the embedding's device.  In
    the crop cascade, ``crop_box`` and ``orig_box`` are xyxy in the full
    image's pixels and ``box_scale`` (sx, sy) maps this frame's boxes to the
    crop's pixels: a candidate whose box touches the crop's edge but not the
    image's is dropped before the NMS.  Returns K = max_masks rows:
    masks_low (K, S, S) bf16, iou, stability, boxes (K, 4) input-frame
    xyxy, points (K, 2), valid (K,).

    On the card with grad off, a frame of the whole image replays its
    selection graph (:func:`_select_graph`) and then launches the NMS
    kernel and the top K: nothing waits for the host.  On the CPU, with
    grad on, or for a crop, the work runs eagerly."""
    if image_embedding.is_cuda and not torch.is_grad_enabled() and crop_box is None:
        with profiling.span("amg.decode"):
            cand = _select_graph(model, amg, image_embedding, points, valid_hw)
        with profiling.span("amg.select"):  # NMS, top K
            return _nms_top(cand, amg)
    with torch.no_grad():
        pts = _chunks(points, amg.points_per_batch)
        with profiling.span("amg.decode"):
            masks, iou = _decode(model, image_embedding, pts, {})
        with profiling.span("amg.select"):  # filters, boxes, NMS, top K
            cand = _candidates(model, amg, masks, iou, pts, points.shape[0], valid_hw,
                               crop_box, orig_box, box_scale)
            return _nms_top(cand, amg)


def _to_host(tensors) -> Tuple[List[torch.Tensor], Optional[torch.cuda.Event]]:
    """Host copies of a frame's upscaled survivors: from the card, into
    pinned memory, enqueued on the current stream with an event after them,
    so that ``finish`` waits for these copies alone and not for the work
    enqueued after them (the next image's); CPU tensors as they are."""
    if not tensors[0].is_cuda:
        return list(tensors), None
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for dst, src in zip(host, tensors):
        dst.copy_(src, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(tensors[0].device))
    return host, ready


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(K, H, W) 0/1 -> (K, H, ceil(W / 8)) uint8, MSB first, the last byte
    zero-padded."""
    K, H, W = bits.shape
    bits = torch.nn.functional.pad(bits.int(), (0, (-W) % 8)).reshape(K, H, -1, 8)
    weights = 2 ** torch.arange(7, -1, -1, device=bits.device, dtype=torch.int32)
    return (bits * weights).sum(-1).to(torch.uint8)


@torch.no_grad()
def upscale_binary(masks_low: torch.Tensor, out_hw: Tuple[int, int], threshold: float = 0.0,
                   bucket: Optional[int] = None) -> torch.Tensor:
    """(K, S, S) logits -> (K, H, W // 8) bit-packed (MSB first) masks at
    the input-frame resolution."""
    if bucket is not None:
        masks_low = masks_low[:bucket]
    return _pack_bits(amg_utils.resize_bilinear(masks_low, out_hw) > threshold)


@torch.no_grad()
def upscale_crop_binary(masks_low: torch.Tensor, rhw: Tuple[int, int], chw: Tuple[int, int],
                        s_in: int, threshold: float = 0.0,
                        bucket: Optional[int] = None) -> torch.Tensor:
    """(K, S, S) crop logits -> (K, ch, ceil(cw / 8)) bit-packed masks at the
    crop's own extent: low -> (s_in, s_in), the valid (rh, rw) sliced,
    -> (ch, cw) (antialiased where it shrinks), thresholded, the width
    padded to a multiple of 8 and packed."""
    if bucket is not None:
        masks_low = masks_low[:bucket]
    up = amg_utils.resize_bilinear(masks_low, (s_in, s_in))[:, :rhw[0], :rhw[1]]
    return _pack_bits(amg_utils.resize_bilinear(up, chw) > threshold)


class AutomaticMaskGenerator:
    """The reference generator's ``generate()`` contract, on the model's
    device: ``device`` (the card by default) must be the model's."""

    def __init__(self, model, cfg: Optional[SamConfig] = None,
                 amg: Optional[AMGConfig] = None, *, device="cuda"):
        self.device = require(device)
        if next(model.parameters()).device.type != self.device.type:
            raise ValueError(f"the model is on {next(model.parameters()).device}, "
                             f"not {self.device}")
        self.model = model
        self.cfg = cfg or model.cfg
        self.amg = amg or AMGConfig()
        self._grid = amg_utils.build_point_grid(self.amg.points_per_side)
        self._aside = None    # the overflow path's stream on the card (_overflow_bitmaps)

    def generate(self, image: np.ndarray) -> List[Dict]:
        """image (H, W, 3) uint8 with its longest side <= the SAM input size
        -> reference-schema annotations sorted by area, descending."""
        return self.finish(self.submit(image))

    @torch.inference_mode()
    def submit(self, image: np.ndarray) -> Dict:
        """Enqueue the device work (encode + select) without waiting for it."""
        h, w = image.shape[:2]
        s_in = self.cfg.encoder.img_size
        if max(h, w) > s_in:
            raise ValueError(f"image {h}x{w} exceeds the SAM input {s_in}; "
                             "resize its longest side first")
        request = profiling.next_request()
        with profiling.span("amg.submit", request=request):
            if self.amg.crop_n_layers > 0:
                handle = self._submit_crops(image)
            else:
                handle = {"out": self._submit_one(image, self._grid), "hw": (h, w)}
        handle["request"] = request
        return handle

    def _submit_one(self, image: np.ndarray, grid: np.ndarray, crop_box=None,
                    orig_hw=None) -> Dict:
        """Encode + select one frame: the image, or one resized crop of it.
        grid (P, 2) in [0, 1]."""
        h, w = image.shape[:2]
        s_in = self.cfg.encoder.img_size
        padded = np.zeros((s_in, s_in, 3), image.dtype)
        padded[:h, :w] = image
        # an upload from pageable memory waits for the stream: the image for
        # the previous image's work, then the grid for nothing more; from
        # here to the end of a whole image's submit nothing waits (a crop's
        # edge test uploads its boxes)
        with profiling.span("amg.upload"):
            x = torch.from_numpy(padded)[None].to(self.device)
            # the grid in pixels and, in its last row, the extent (h, w)
            grid_hw = np.concatenate([grid * np.array([w, h]), [[h, w]]])
            grid_hw = torch.from_numpy(grid_hw.astype(np.float32)).to(self.device)
        points, valid_hw = grid_hw[:-1], grid_hw[-1]
        # normalise, then zero outside the image, as the reference pads
        region = torch.zeros(1, s_in, s_in, 1, device=self.device)
        region[:, :h, :w] = 1.0
        with profiling.span("amg.encode"):
            emb = sam_lib.encode_image(self.model, sam_lib.preprocess(x, self.cfg) * region)
        kw = {}
        if crop_box is not None:
            x0, y0, x1, y1 = crop_box
            kw = dict(crop_box=crop_box, orig_box=(0, 0, orig_hw[1], orig_hw[0]),
                      box_scale=((x1 - x0) / w, (y1 - y0) / h))
        return amg_select(self.model, self.amg, emb, points, valid_hw, **kw)

    def _submit_crops(self, image: np.ndarray) -> Dict:
        """The crop cascade: the full frame and 4^i overlapping crops a
        layer, each resized so that its longest side is the SAM input (as
        the reference's predictor does) and selected on its layer's grid;
        the cross-crop dedup is ``finish``'s."""
        h, w = image.shape[:2]
        s_in = self.cfg.encoder.img_size
        crop_boxes, layer_idxs = amg_utils.generate_crop_boxes(
            (h, w), self.amg.crop_n_layers, self.amg.crop_overlap_ratio)
        grids = amg_utils.build_all_layer_point_grids(
            self.amg.points_per_side, self.amg.crop_n_layers,
            self.amg.crop_n_points_downscale_factor)
        crops = []
        for (x0, y0, x1, y1), layer in zip(crop_boxes, layer_idxs):
            crop = image[y0:y1, x0:x1]
            if max(crop.shape[:2]) != s_in:
                crop = image_ops.resize_longest_side(crop, s_in)
            out = self._submit_one(crop, grids[layer], crop_box=(x0, y0, x1, y1),
                                   orig_hw=(h, w))
            crops.append({"out": out, "crop_box": (x0, y0, x1, y1), "rhw": crop.shape[:2]})
        return {"crops": crops, "hw": (h, w)}

    def _bucket(self, n: int) -> int:
        return min(max(8, 1 << (n - 1).bit_length()), self.amg.max_masks)

    @staticmethod
    def _pull_survivors(out: Dict):
        """One frame's survivor count and metadata, on the host."""
        with profiling.span("amg.pull"):
            small = {k: out[k].float().cpu().numpy()
                     for k in ("iou", "stability", "boxes", "points")}
            small["valid"] = out["valid"].cpu().numpy()
        n = int(small["valid"].sum())
        profiling.count("amg.survivors", n)
        return n, small

    @torch.inference_mode()
    def prefetch(self, handle: Dict) -> Dict:
        """Pull the survivor metadata and enqueue the survivors' upscale
        (run boundaries on the device, or bit-packed bitmaps when small
        regions are cleaned; in the crop cascade, each crop's bitmaps at
        its own extent) and, for a whole image, its copy to the host.
        Called before the next image's ``submit``, it lets that image's
        device work overlap this one's ``finish``.  Idempotent; ``finish``
        calls it."""
        if ("staged" if "crops" in handle else "n") in handle:
            return handle
        with profiling.span("amg.prefetch", request=handle.get("request")):
            if "crops" in handle:
                handle["staged"] = self._stage_crops(handle)
            else:
                self._prefetch_one(handle)
        return handle

    def _prefetch_one(self, handle: Dict) -> None:
        out = handle["out"]
        n, small = self._pull_survivors(out)
        handle["n"], handle["small"] = n, small
        if not n:
            return
        s_in = self.cfg.encoder.img_size
        with profiling.span("amg.upscale"):
            if self.amg.min_mask_region_area == 0:
                dev = device_rle.upscale_rle(
                    out["masks_low"], handle["hw"], (s_in, s_in), self.cfg.mask_threshold,
                    bucket=self._bucket(n), max_per_col=MAX_RUNS_PER_COL)
            else:
                dev = (upscale_binary(out["masks_low"], (s_in, s_in), self.cfg.mask_threshold,
                                      bucket=self._bucket(n)),)
            handle["host"], handle["ready"] = _to_host(dev)

    def finish(self, handle: Dict) -> List[Dict]:
        """Download a submit()'s survivors and assemble the annotations."""
        with profiling.span("amg.finish", request=handle.get("request")):
            self.prefetch(handle)
            return self._finish(handle)

    def _finish(self, handle: Dict) -> List[Dict]:
        h, w = handle["hw"]
        if "crops" in handle:
            with profiling.span("amg.rle"):
                return self._assemble(*self._finish_crops(handle), h, w)
        s_in = self.cfg.encoder.img_size
        n, small = handle["n"], handle["small"]
        if n == 0:
            return []
        iou, stability, pts = small["iou"][:n], small["stability"][:n], small["points"][:n]
        with profiling.span("amg.download"):
            if handle["ready"] is not None:
                handle["ready"].synchronize()
            host = [t.numpy() for t in handle["host"]]
        if self.amg.min_mask_region_area == 0:
            with profiling.span("amg.rle"):
                return self._assemble_rle(*host, handle, n, iou, stability, pts, h, w)
        with profiling.span("amg.rle"):
            masks = np.unpackbits(host[0][:n], axis=-1, count=s_in).reshape(n, s_in, s_in)
            masks = masks[:, :h, :w].astype(bool)
            return self._assemble(masks, iou, stability, pts, [(0, 0, w, h)] * n, h, w)

    def _overflow_bitmaps(self, handle: Dict, n: int) -> np.ndarray:
        """The survivors' bit-packed bitmaps on the host.  On the card they
        are made on a stream of their own that starts after the image's
        upscale (``handle["ready"]``), so they wait neither for nor behind
        the work enqueued since on the current stream (the next image's)."""
        s_in = self.cfg.encoder.img_size
        masks_low = handle["out"]["masks_low"]

        def bitmaps():
            return upscale_binary(masks_low, (s_in, s_in), self.cfg.mask_threshold,
                                  bucket=self._bucket(n)).cpu().numpy()

        if handle["ready"] is None:
            return bitmaps()
        if self._aside is None:
            self._aside = torch.cuda.Stream(self.device)
        self._aside.wait_event(handle["ready"])
        with torch.cuda.stream(self._aside):   # its copy to the host syncs this stream
            return bitmaps()

    def _assemble_rle(self, payload16, meta32, handle, n: int, iou, stability, pts,
                      h: int, w: int) -> List[Dict]:
        """Annotations from the device run boundaries; masks whose columns
        overflowed take the bit-packed path, in one batch."""
        decoded = device_rle.annotations_from_rle_payload(payload16, meta32, n, h, w,
                                                          self.cfg.encoder.img_size,
                                                          MAX_RUNS_PER_COL)
        overflowed = sum(d is None for d in decoded)
        profiling.count("amg.rle_overflow", overflowed)
        if overflowed:
            with profiling.span("amg.overflow_path"), torch.inference_mode():
                packed = self._overflow_bitmaps(handle, n)
                decoded = [rle.encode_packed(packed[i], h, w) if d is None else d
                           for i, d in enumerate(decoded)]
        anns = []
        for i, (r, area_i, bbox) in enumerate(decoded):
            if area_i == 0:
                continue
            anns.append({"segmentation": r, "area": int(area_i),
                         "bbox": [float(v) for v in bbox],
                         "predicted_iou": float(iou[i]),
                         "point_coords": [[float(pts[i][0]), float(pts[i][1])]],
                         "stability_score": float(stability[i]),
                         "crop_box": [0, 0, w, h]})
        anns.sort(key=lambda a: a["area"], reverse=True)
        return anns

    def _stage_crops(self, handle: Dict) -> List:
        """Each crop's survivors: their metadata, their points in the full
        image's pixels, and their bit-packed masks at the crop's extent
        (enqueued on the device)."""
        s_in = self.cfg.encoder.img_size
        staged = []
        for c in handle["crops"]:
            out = c["out"]
            n, small = self._pull_survivors(out)
            if n == 0:
                continue
            x0, y0, x1, y1 = box = c["crop_box"]
            rh, rw = c["rhw"]
            scale = torch.tensor([(x1 - x0) / rw, (y1 - y0) / rh], dtype=torch.float32)
            pts = amg_utils.uncrop_points(torch.from_numpy(small["points"][:n]) * scale, box)
            with profiling.span("amg.upscale"):
                packed = upscale_crop_binary(out["masks_low"], (rh, rw), (y1 - y0, x1 - x0),
                                             s_in, self.cfg.mask_threshold,
                                             bucket=self._bucket(n))
            staged.append((box, n, small, pts.numpy(), packed))
        return staged

    def _finish_crops(self, handle: Dict):
        """Every crop's nonempty survivors on full-image canvases, then the
        cross-crop NMS (run when there is more than one crop) that scores a
        mask 1 / its crop's area, so the smaller crop's mask wins; the kept
        ones stay in their order.  Returns (masks, iou, stability, points,
        crop boxes)."""
        h, w = handle["hw"]
        all_masks, all_iou, all_stab, all_pts, all_crop = [], [], [], [], []
        for box, n, small, pts, packed in handle["staged"]:
            x0, y0, x1, y1 = box
            bits = np.unpackbits(packed.cpu().numpy()[:n], axis=-1, count=x1 - x0).astype(bool)
            for i in range(n):
                if not bits[i].any():
                    continue
                canvas = np.zeros((h, w), bool)
                canvas[y0:y1, x0:x1] = bits[i]
                all_masks.append(canvas)
                all_iou.append(small["iou"][i])
                all_stab.append(small["stability"][i])
                all_pts.append(pts[i])
                all_crop.append(box)
        if not all_masks:
            return [], [], [], [], []
        masks, iou, stability, pts = (np.stack(all_masks), np.asarray(all_iou),
                                      np.asarray(all_stab), np.asarray(all_pts))
        if len(handle["crops"]) > 1:
            scores = np.asarray([1.0 / ((cb[2] - cb[0]) * (cb[3] - cb[1])) for cb in all_crop])
            keep = np.sort(amg_utils.nms_host(_mask_boxes_np(masks), scores,
                                              self.amg.crop_nms_thresh))
            masks, iou, stability, pts = masks[keep], iou[keep], stability[keep], pts[keep]
            all_crop = [all_crop[i] for i in keep]
        return masks, iou, stability, pts, all_crop

    def _assemble(self, masks, iou, stability, pts, crop_boxes, h: int, w: int) -> List[Dict]:
        """Small-region cleanup, the re-dedup NMS, and the annotations."""
        if len(masks) == 0:
            return []
        if self.amg.min_mask_region_area > 0:
            # remove holes and islands, then NMS with score 1 for unchanged
            # masks and 0 for changed ones, so a cleaned duplicate dies
            cleaned, unchanged = [], []
            for m in masks:
                mm, ch_h = amg_utils.remove_small_regions(
                    m.astype(bool), self.amg.min_mask_region_area, "holes")
                mm, ch_i = amg_utils.remove_small_regions(
                    mm, self.amg.min_mask_region_area, "islands")
                cleaned.append(mm)
                unchanged.append(not (ch_h or ch_i))
            masks = np.stack(cleaned)
            keep = np.sort(amg_utils.nms_host(
                _mask_boxes_np(masks), np.asarray(unchanged, np.float32),
                max(self.amg.box_nms_thresh, self.amg.crop_nms_thresh)))
            masks, iou, stability, pts = masks[keep], iou[keep], stability[keep], pts[keep]
            crop_boxes = [crop_boxes[i] for i in keep]
        anns = []
        for i in range(len(masks)):
            r, area, bbox = rle.encode_stats(masks[i].astype(np.uint8))
            if area == 0:
                continue
            cb = crop_boxes[i]
            anns.append({"segmentation": r, "area": area, "bbox": bbox,
                         "predicted_iou": float(iou[i]),
                         "point_coords": [[float(pts[i][0]), float(pts[i][1])]],
                         "stability_score": float(stability[i]),
                         "crop_box": [int(cb[0]), int(cb[1]),
                                      int(cb[2] - cb[0]), int(cb[3] - cb[1])]})
        anns.sort(key=lambda a: a["area"], reverse=True)
        return anns


def _mask_boxes_np(masks: np.ndarray) -> np.ndarray:
    """(N, H, W) bool -> inclusive-edge xyxy boxes, zeros for empty masks."""
    out = np.zeros((len(masks), 4), np.float64)
    for i, m in enumerate(masks):
        ys, xs = np.nonzero(m)
        if len(ys):
            out[i] = [xs.min(), ys.min(), xs.max(), ys.max()]
    return out
