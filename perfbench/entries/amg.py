"""Entry ``amg``: SAM everything-mode mask generation through the program's
``AutomaticMaskGenerator``, pipelined one image deep as the program's
``cli/prepare.py`` drives it: the previous image's ``prefetch``, this
image's ``submit``, then the previous image's ``finish``.  An image counts
when ``finish`` has returned its annotations.

Traffic parameters (``workloads/<cell>.json``): ``sizes`` (h, w of the
images, taken in turn), ``pool_images`` (distinct images, drawn from
``image_seed``), ``amg`` (the generator's settings), ``warmup_images``,
``check_images`` (finished images the reference recomputes, drawn from the
run's seed).

The images are blobby discs plus noise (a frozen copy of
``chip_smoke.amg_images``, :1291), drawn with a ``torch.Generator`` on the
device and brought to the host once, in set-up.  Every run has the same
pool, so the same work; the run's seed sets the order in which the window
cycles through it and the images the check samples.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from pbcore import sub_seed, weights
from reference import sam_ref

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def program_config(doc: Dict):
    from llmseg_tpu_torch import config as C
    e, pr, dc = doc["encoder"], doc["prompt"], doc["decoder"]
    if e["mlp_act"] != "gelu_tanh" or e["layer_norm_eps"] != 1e-6 or dc["layer_norm_eps"] != 1e-6:
        raise ValueError("the port's SAM has tanh-GELU MLPs and LayerNorm eps 1e-6")
    if dc["attention_downsample_rate"] != 2:
        raise ValueError("the port's two-way transformer downsamples its cross attention by 2")
    return C.SamConfig(
        encoder=C.SamEncoderConfig(img_size=e["image_size"], patch_size=e["patch_size"],
                                   embed_dim=e["embed_dim"], depth=e["depth"],
                                   num_heads=e["num_heads"], mlp_ratio=e["mlp_ratio"],
                                   out_chans=e["out_chans"], use_rel_pos=True,
                                   window_size=e["window_size"],
                                   global_attn_indexes=tuple(e["global_attn_indexes"])),
        prompt=C.SamPromptConfig(embed_dim=pr["embed_dim"],
                                 image_embedding_size=pr["image_embedding_size"],
                                 input_image_size=pr["input_image_size"],
                                 mask_in_chans=pr["mask_in_chans"]),
        decoder=C.SamDecoderConfig(transformer_dim=dc["transformer_dim"],
                                   transformer_depth=dc["transformer_depth"],
                                   transformer_mlp_dim=dc["transformer_mlp_dim"],
                                   transformer_num_heads=dc["transformer_num_heads"],
                                   num_multimask_outputs=dc["num_multimask_outputs"],
                                   iou_head_depth=dc["iou_head_depth"],
                                   iou_head_hidden_dim=dc["iou_head_hidden_dim"]),
        pixel_mean=tuple(doc["pixel_mean"]), pixel_std=tuple(doc["pixel_std"]),
        mask_threshold=doc["mask_threshold"])


def amg_config(traffic: Dict):
    from llmseg_tpu_torch import config as C
    return C.AMGConfig(**traffic["amg"])


def make_image(traffic: Dict, index: int, device) -> np.ndarray:
    """uint8 (h, w, 3): ``discs`` discs of random centre, colour and radius
    in ``radius`` over uniform noise of amplitude ``noise``, the size
    ``sizes[index % len(sizes)]``, drawn from ``image_seed``."""
    h, w = traffic["sizes"][index % len(traffic["sizes"])]
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(traffic["image_seed"], "image", index))
    kw = dict(generator=g, device=device)
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    img = torch.zeros(h, w, 3, device=device)
    r0, r1 = traffic["radius"]
    for _ in range(traffic["discs"]):
        c = torch.rand(3, **kw)
        cy, cx, r = c[0] * h, c[1] * w, r0 + c[2] * (r1 - r0)
        img += ((yy - cy) ** 2 + (xx - cx) ** 2 < r * r)[..., None] * torch.rand(3, **kw) * 120
    img += torch.rand(h, w, 3, **kw) * traffic["noise"]
    return img.clamp(0, 255).to(torch.uint8).cpu().numpy()


def rle_to_mask(rle: Dict) -> np.ndarray:
    """COCO's compressed RLE string (column-major runs, zeros first) ->
    bool (h, w)."""
    h, w = rle["size"]
    counts, s = [], rle["counts"].encode() if isinstance(rle["counts"], str) else rle["counts"]
    p = 0
    while p < len(s):
        x, k, more = 0, 0, True
        while more:
            c = s[p] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    flat = np.zeros(h * w, bool)
    pos, val = 0, False
    for n in counts:
        flat[pos:pos + n] = val
        pos += n
        val = not val
    return flat.reshape(w, h).T


def compare(anns: List[Dict], ref: Dict, s_in: int, threshold: float) -> Dict[str, float]:
    """The program's (or a control's) annotations of one image against the
    reference's candidates.  Each annotation is matched to the one of its
    point's three candidates nearest to it, by its mask's margin (below)
    plus the predicted IoU's gap (random weights can give a point three
    alike masks).

    ``mask_margin``: over the pixels where the annotation's decoded mask
    and the candidate's disagree, the widest distance of the reference's
    upscaled logit from the threshold, as a share of the candidate's
    widest (0 where they agree; rounding flips only pixels near the
    threshold, and a mask moved, transposed or swapped for another reads
    up to 1); ``iou_gap``: the widest gap of the matched predicted IoUs (of
    max(1, |ref|)); ``rank_gap``: how far the weakest match's reference IoU
    lies below the reference's last kept one (0 while the program keeps
    what the reference keeps);
    ``box_area_err``: annotations whose area or box differs from those of
    their own decoded mask; ``count_gap``: how far the number of
    annotations differs from the reference's."""
    h, w = ref["hw"]
    pts = ref["points"].cpu().numpy()
    out = {"mask_margin": 0.0, "iou_gap": 0.0, "rank_gap": 0.0, "box_area_err": 0.0,
           "count_gap": float(abs(len(anns) - len(ref["anns"])))}
    for a in anns:
        m = a["mask"] if "mask" in a else torch.from_numpy(rle_to_mask(a["segmentation"]))
        m = m.to(ref["low"].device)
        if a["area"] != int(m.sum()) or list(a["bbox"]) != sam_ref.mask_box(m):
            out["box_area_err"] += 1
        pc = np.asarray(a["point_coords"][0])
        p = int(np.argmin(np.abs(pts - pc).sum(-1)))
        if np.abs(pts[p] - pc).max() > 0.5:
            return {k: float("inf") for k in out}
        logits = sam_ref.upscale_logits(ref["low"][3 * p:3 * p + 3], (h, w), s_in) - threshold
        best = None
        for j in range(3):
            z = logits[j].abs()
            wrong = (logits[j] > 0) != m
            margin = float(z[wrong].max() / z.max()) if bool(wrong.any()) else 0.0
            r_iou = float(ref["iou"][3 * p + j])
            gap = abs(a["predicted_iou"] - r_iou) / max(1.0, abs(r_iou))
            if best is None or margin + gap < best[0] + best[1]:
                best = (margin, gap, r_iou)
        out["mask_margin"] = max(out["mask_margin"], best[0])
        out["iou_gap"] = max(out["iou_gap"], best[1])
        out["rank_gap"] = max(out["rank_gap"], ref["kth_iou"] - best[2])
    return out


class Entry:
    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        self.cfg, self.traffic = cfg, traffic
        self.seed, self.device = seed, torch.device(device)
        self.dtype = DTYPES[cfg["dtype"]]
        self.outputs: Dict[int, List[Dict]] = {}    # pool index -> the annotations
        self.images = 0

    def setup(self) -> None:
        from llmseg_tpu_torch.models.sam import amg, sam
        self.specs = sam_ref.param_specs(self.cfg)
        model = sam.build(program_config(self.cfg), device=self.device, dtype=self.dtype)
        weights.load_into(model, self.specs, self._weights_seed(), self.device, self.dtype)
        self.model = model
        self.gen = amg.AutomaticMaskGenerator(model, amg=amg_config(self.traffic),
                                              device=self.device)
        self.pool = [make_image(self.traffic, i, self.device)
                     for i in range(self.traffic["pool_images"])]
        g = torch.Generator().manual_seed(sub_seed(self.seed, "order"))
        self.order = torch.randperm(len(self.pool), generator=g).tolist()
        self.window(0.0, max_steps=self.traffic["warmup_images"])
        self.images = 0
        # the loop is host-bound: one host thread for PyTorch's CPU operators,
        # and set-up's objects out of the collector's way, for steady runs
        torch.set_num_threads(1)
        gc.collect()
        gc.freeze()

    def _weights_seed(self) -> int:
        """The configuration's fixed ``weights_seed``: a draw of SAM's
        weights sets how intricate every mask is, and so the host's RLE
        work an image."""
        return sub_seed(self.cfg["weights_seed"], "weights")

    def window(self, seconds: float, max_steps: int = 0) -> Dict:
        """Images in turn through the pipeline until ``seconds`` have passed
        (or ``max_steps`` images have been finished); the image in flight at
        the close is finished after it and not counted."""
        gen, done, finish_s = self.gen, 0, 0.0
        pending = None
        t0 = time.perf_counter()
        t_last = t0
        while True:
            if max_steps:
                if done >= max_steps:
                    break
            elif time.perf_counter() - t0 >= seconds:
                break
            i = self.order[self.images % len(self.pool)]
            self.images += 1
            if pending is not None:
                ts = time.perf_counter()
                gen.prefetch(pending[1])
                finish_s += time.perf_counter() - ts
            handle = gen.submit(self.pool[i])
            if pending is not None:
                ts = time.perf_counter()
                self.outputs[pending[0]] = gen.finish(pending[1])
                t_last = time.perf_counter()
                finish_s += t_last - ts
                done += 1
            pending = (i, handle)
        if pending is not None:
            self.outputs[pending[0]] = gen.finish(pending[1])
        elapsed = t_last - t0
        # steps: images through the device path, the one finished after the close too
        return {"metrics": {"amg_img_per_s": done / elapsed if done else 0.0},
                "attempted": done, "failed": 0, "steps": done + (pending is not None),
                "host": {"finish_ms": 1e3 * finish_s / max(done, 1),
                         "step_s": elapsed / max(done, 1), "elapsed_s": elapsed}}

    def release(self) -> None:
        del self.model, self.gen
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def _sample(self) -> List[int]:
        """Finished images drawn from the seed, one of each size first."""
        done = sorted(self.outputs)
        g = torch.Generator().manual_seed(sub_seed(self.seed, "check"))
        order = [done[int(i)] for i in torch.randperm(len(done), generator=g)]
        n_sizes = len(self.traffic["sizes"])
        first = {}
        for i in order:
            first.setdefault(i % n_sizes, i)
        picked = list(first.values())
        picked += [i for i in order if i not in picked]
        return picked[:self.traffic["check_images"]]

    def _reference(self, precision: str, tensors, index: int) -> Dict:
        return sam_ref.amg(tensors, self.cfg, self.traffic["amg"],
                           make_image(self.traffic, index, self.device),
                           precision, self.device)

    def _numbers(self, precision=None) -> Dict[str, float]:
        from reference.common import no_tf32
        no_tf32()
        tensors = weights.as_dict(self.specs, self._weights_seed(), self.device, self.dtype)
        s_in, thr = self.cfg["encoder"]["image_size"], self.cfg["mask_threshold"]
        worst: Dict[str, float] = {}
        for i in self._sample():
            ref = self._reference("fp32", tensors, i)
            anns = self.outputs[i] if precision is None else self._reference(
                precision, tensors, i)["anns"]
            for k, v in compare(anns, ref, s_in, thr).items():
                worst[k] = max(worst.get(k, 0.0), v)
            del ref
        return worst

    def check(self) -> Dict[str, float]:
        """The numbers of :func:`compare`, the worst over the sampled
        images: the program's annotations against the float32 reference's."""
        return self._numbers()

    def control(self, precision: str) -> Dict[str, float]:
        """The same numbers for the reference computed at ``precision`` in
        the program's place."""
        return self._numbers(precision)
