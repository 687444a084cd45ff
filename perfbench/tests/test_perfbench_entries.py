"""Each entry driven by the harness on the CPU at a tiny size, against its
reference; the planted faults and the control."""

import time

import pytest
import torch

from pbcore import runner


def _run(cell, seed=7, seconds=0.5):
    lines = []
    res = runner.run_cell(cell.name, seed, seconds, False, t_start=time.perf_counter(),
                          device="cpu", cell=cell, log=lines.append)
    return res, lines


def test_predict_tiny_gqa_matches_reference(predict_cell):
    assert predict_cell.config["llm"]["num_key_value_heads"] < \
        predict_cell.config["llm"]["num_attention_heads"]
    res, lines = _run(predict_cell)
    assert res["correct"], res["checks"]
    assert all(c["value"] < 1e-4 for c in res["checks"].values()), res["checks"]
    assert list(res)[-1] == "checks" and lines[-1].startswith("check ")
    assert res["metrics"]["predict_img_per_s"]["value"] > 0
    assert set(res["metrics"]) == {"predict_img_per_s", "predict_ms_p95", "setup_s"}


def test_amg_tiny_matches_reference(amg_cell):
    res, _ = _run(amg_cell)
    assert res["correct"], res["checks"]
    c = res["checks"]
    assert c["iou_gap"]["value"] < 1e-4 and c["rank_gap"]["value"] <= 1e-5, c
    assert c["mask_margin"]["value"] < 1e-3, c
    assert c["box_area_err"]["value"] == 0 and c["count_gap"]["value"] == 0, c
    assert res["attempted"] > 0


def test_predict_altered_answer_fails(predict_cell, monkeypatch):
    from llmseg_tpu_torch.models import selection_head

    real = selection_head.SelectionHead.forward

    def altered(self, *a, **k):
        sim, iou, feat = real(self, *a, **k)
        return sim.index_add(1, torch.tensor([0]), torch.full_like(sim[:, :1], 0.5)), iou, feat

    monkeypatch.setattr(selection_head.SelectionHead, "forward", altered)
    res, _ = _run(predict_cell)
    assert not res["correct"], res["checks"]


def test_amg_altered_answer_fails(amg_cell, monkeypatch):
    from llmseg_tpu_torch.models.sam import amg

    real = amg.amg_select

    def altered(*a, **k):
        out = real(*a, **k)
        out["iou"] = out["iou"] + 0.5 * (torch.arange(len(out["iou"])) == 0)  # one score
        return out

    monkeypatch.setattr(amg, "amg_select", altered)
    res, _ = _run(amg_cell)
    assert not res["correct"], res["checks"]


def _plant(monkeypatch, fault):
    """Break AMG's timed path where a mask or its record is produced."""
    from llmseg_tpu_torch.models.sam import amg

    real_select, real_payload = amg.amg_select, amg.device_rle.annotations_from_rle_payload
    real_binary = amg.upscale_binary

    def select(*a, **k):
        out = real_select(*a, **k)
        if fault == "transposed":
            out["masks_low"] = out["masks_low"].transpose(-1, -2).contiguous()
        else:                                   # emptied: one survivor's logits all below
            out["masks_low"] = out["masks_low"].clone()
            out["masks_low"][0] = -10.0
        return out

    def payload(*a, **k):
        got = real_payload(*a, **k)
        if fault == "box":
            return [(r, area, [bbox[0] + 1.0] + bbox[1:]) for r, area, bbox in got]
        return [None] * len(got)                # every survivor takes the bit-packed path

    def binary(*a, **k):                        # each survivor gets the next one's bitmap
        return real_binary(*a, **k).roll(1, 0)

    if fault in ("transposed", "emptied"):
        monkeypatch.setattr(amg, "amg_select", select)
    if fault in ("box", "overflow", "overflow_corrupt"):
        monkeypatch.setattr(amg.device_rle, "annotations_from_rle_payload", payload)
    if fault == "overflow_corrupt":
        monkeypatch.setattr(amg, "upscale_binary", binary)


def test_amg_overflow_path_matches_reference(amg_cell, monkeypatch):
    """Every survivor through the host's bit-packed fallback: still correct."""
    _plant(monkeypatch, "overflow")
    res, _ = _run(amg_cell)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault, number", [("transposed", "mask_margin"),
                                           ("emptied", "count_gap"),
                                           ("overflow_corrupt", "mask_margin"),
                                           ("box", "box_area_err")])
def test_amg_mask_fault_fails(amg_cell, monkeypatch, fault, number):
    _plant(monkeypatch, fault)
    res, _ = _run(amg_cell)
    assert not res["correct"], res["checks"]
    c = res["checks"][number]
    assert c["value"] > c["limit"], res["checks"]


@pytest.mark.parametrize("which", ["predict", "amg"])
def test_control_reads_far_above_the_program(which, predict_cell, amg_cell):
    """The fp8 control's numbers exceed the float32 program's by far at the
    tiny size too (the limits themselves are set at the cell's size)."""
    cell = predict_cell if which == "predict" else amg_cell
    entry = cell.entry().Entry(cell.config, cell.traffic, 3, "cpu")
    entry.setup()
    entry.window(0.0, max_steps=2)
    entry.release()
    prog = entry.check()
    ctrl = entry.control("fp8")
    key = "sim_gap" if which == "predict" else "iou_gap"
    assert ctrl[key] > 100 * max(prog[key], 1e-6), (ctrl, prog)
