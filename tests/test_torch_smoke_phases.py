"""``chip_smoke.py``'s phases of the SFT slice, run small on the CPU as the
card runs them (no launches here): ``sft`` (``cli.sft`` in its three
regimes at ``tiny``, the decode stood in for), ``ddp`` (the Trainer's
data-parallel path at world size 1 on gloo against the Trainer outside a
process group, to the bit), ``rle`` (AMG ``finish`` with NMS off at
``sam_tiny`` on the native codec and on the numpy path, the annotations
equal) and the full-SFT reckoning that picks the third run's size."""

import json

import numpy as np
import pytest
import torch

import chip_smoke as CS
from llmseg_tpu_torch import config as TC
from llmseg_tpu_torch.data.synthetic import make_batch
from llmseg_tpu_torch.ops import attention as A

torch.set_num_threads(2)


def _lines(capsys, phase):
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    return [r for r in out if r.get("phase") == phase]


def test_smoke_sft_phase_runs_small_on_the_cpu(capsys):
    recs = CS.sft_phase(TC, A, device="cpu", sizes=("tiny", "tiny", "tiny"),
                        images=((30, 40), (40, 30), (28, 28), (33, 50)), text_rows=2, mml=320)
    lines = _lines(capsys, "sft")
    assert [r["run"] for r in lines] == ["lora", "projector", "full"]
    for r in lines:
        assert r["ok"], r
        assert r["frozen_checksums_unchanged"] and r["checkpoint_read_back_equal"]
        assert np.isfinite(r["ce_loss_first"]) and np.isfinite(r["ce_loss_last"])
    assert [r["steps"] for r in recs] == [CS.SFT_LORA_STEPS, CS.SFT_PROJECTOR_STEPS,
                                          CS.SFT_FULL_STEPS]
    # the projector regime trains the projector alone; full SFT the LLM too
    assert recs[1]["trainable_tensors"] == 2
    assert recs[2]["trainable_tensors"] > recs[0]["trainable_tensors"] > 2


def test_full_sft_reckoning_picks_small_at_7b():
    """Full SFT of LLaVA-7B needs more than the card's 70 GB budget by this
    reckoning (bf16 weights, gradients, the clip's copy, two AdamW moments
    and a foreach temporary: 6 copies of 7B parameters), so the smoke runs
    it at ``small``."""
    r = CS.sft_full_peak_gb(TC.LlavaConfig())
    assert r["total_gb"] > CS.SFT_FULL_LIMIT_GB
    assert 13 < r["parts_gb"]["grads"] < 14.5 and r["parts_gb"]["adamw_moments"] > 26
    small = CS.sft_full_peak_gb(TC.llmseg_small().llava)
    assert small["total_gb"] < CS.SFT_FULL_LIMIT_GB


def test_smoke_ddp_phase_runs_small_on_the_cpu(capsys, tmp_path):
    rec = CS.ddp_phase(TC, make_batch, A, device="cpu", cfg=TC.llmseg_tiny(),
                       log_dir=str(tmp_path))
    (line,) = _lines(capsys, "ddp")
    assert line["ok"] and rec["backend"] == "gloo" and rec["world_size"] == 1
    assert rec["grads_equal_to_the_bit"] and rec["params_equal_to_the_bit"]
    assert not torch.distributed.is_initialized()


def test_smoke_rle_phase_runs_small_on_the_cpu(capsys):
    from llmseg_tpu_torch.models.sam import amg as AMG
    from llmseg_tpu_torch.models.sam import sam as S

    cfg = TC.sam_tiny()
    model = S.init(cfg, seed=0, device="cpu")
    gen = AMG.AutomaticMaskGenerator(model, cfg, TC.AMGConfig(
        points_per_side=8, pred_iou_thresh=-1e9, stability_score_thresh=-1.0,
        box_nms_thresh=1.0), device="cpu")
    rng = np.random.RandomState(0)
    images = [rng.randint(0, 255, (48, 64, 3)).astype(np.uint8),
              rng.randint(0, 255, (64, 40, 3)).astype(np.uint8)]
    rec = CS.rle_phase(gen, images, device="cpu")
    (line,) = _lines(capsys, "rle")
    assert line["ok"] and all(i["equal"] and i["annotations"] > 1 for i in rec["images"])


def test_smoke_mpt_phase_runs_on_the_cpu(capsys):
    """The phase's code on the CPU against itself (the card's run holds the
    card against the CPU)."""
    rec = CS.mpt_phase(TC, device="cpu")
    (line,) = _lines(capsys, "mpt")
    assert line["ok"] and set(rec["max_err_vs_max_ref"]) == {"alibi", "mqa_qk_ln_clip"}


def test_smoke_amg_crops_phase_runs_small_on_the_cpu(capsys):
    """``chip_smoke.py``'s amg_crops phase with ``device="cpu"`` (its card
    side on the CPU too, so no launches), at ``sam_tiny`` from the CPU
    tests' seeded weights, one case at crop layers 1 and one at 2 with the
    small-region cleanup: generate equal to the reference run, crop masks
    staged and deduplicated with full-frame and crop masks among the
    survivors; cli.prepare over three images, equal, five frames an image;
    the bf16 run matched by box; a line a run and one for the phase."""
    from llmseg_tpu_torch.cli import prepare as CP
    from llmseg_tpu_torch.models.sam import amg as AMG
    from llmseg_tpu_torch.models.sam import sam as S
    from llmseg_tpu_torch.ops import relpos_attention as R
    from llmseg_tpu_torch.ops import twoway_kernel as TK

    rec = CS.amg_crops_phase(TC, S, AMG, CP, A.KERNELS + R.KERNELS + TK.KERNELS, device="cpu",
                             cfg=TC.sam_tiny(), weights=dict(seed=1, amp=0.5),
                             cases=((1, 0), (2, 20)))
    lines = _lines(capsys, "amg_crops")
    assert [r["run"] for r in lines] == ["generate_layers_1_min_area_0",
                                         "generate_layers_2_min_area_20",
                                         "prepare_crop_layers_1", "generate_layers_1_bf16", "all"]
    assert all(r["ok"] for r in lines)
    for r, frames in zip(lines[:2], (5, 21)):
        assert r["equal_to_cpu"] and r["launches_ok"] and r["frames"] == frames
        assert r["staged"] > r["annotations"] and r["full_frame"] > 0 and r["from_crops"] > 0
    prep = lines[2]
    assert prep["equal_to_cpu"] and prep["frames"] == 15 and sum(prep["from_crops"]) > 0
    assert lines[3]["matched_iou_median"] == 1.0 and lines[3]["equal_to_cpu"]
    assert set(rec["launches_per_frame"].values()) == {0}


def test_crop_sam_frames_take_e_f_and_g_on_the_card():
    """Why amg_crops runs ``crop_sam`` and not ``sam_tiny``: a frame of
    ``sam_tiny`` (a 4 x 4 grid) takes neither kernel E (its global block's
    16 tokens go to F) nor G (16 image tokens: the decode's plain route), a
    frame of ``crop_sam`` takes E, F and G, G once a chunk of 16 prompts."""
    from llmseg_tpu_torch.ops import relpos_attention as R
    from llmseg_tpu_torch.ops import twoway_kernel as TK

    names = [k.name for k in R.KERNELS + TK.KERNELS]
    amg = TC.AMGConfig(**CS.CROP_AMG, crop_n_layers=1)
    tiny = CS.crop_expected_per_frame(TC.sam_tiny(), amg, names, cuda=True)
    crop = CS.crop_expected_per_frame(CS.crop_sam(TC), amg, names, cuda=True)
    assert (tiny["relpos_fwd"], tiny["relpos_window"], tiny["factored_decode"]) == (0, 2, 0)
    assert (crop["relpos_fwd"], crop["relpos_window"], crop["factored_decode"]) == (1, 1, 4)
    assert set(CS.crop_expected_per_frame(CS.crop_sam(TC), amg, names, cuda=False).values()) \
        == {0}


def test_smoke_pixel_in_place_plants_seg_on_the_cpu(capsys):
    """``chip_smoke.py``'s pixel_in_place at ``llmseg_tiny`` + ``sam_tiny``
    with ``device="cpu"`` (both routes plain here): the rows share no
    generated token, so the planted run gives every row row 0's CLIP image
    and text, declares its first emitted token [SEG], and every row keeps
    its mask (over -1e8) through evaluate's select."""
    from llmseg_tpu_torch.models import generate as GEN
    from llmseg_tpu_torch.models import pixel_decoder as PD
    from llmseg_tpu_torch.models.sam import image_encoder as IE
    from llmseg_tpu_torch.models.sam import sam as S
    from llmseg_tpu_torch.ops import relpos_attention as R
    from llmseg_tpu_torch.ops import twoway_kernel as TK

    rec = CS.pixel_in_place(TC, S, R, TK, IE, PD, GEN, make_batch, A, device="cpu",
                            cfg=TC.llmseg_tiny(), scfg=TC.sam_tiny(), images=4,
                            hw=dict(input_hw=(48, 64), original_hw=(96, 128)), text_len=32)
    lines = _lines(capsys, "pixel_in_place")
    assert [r.get("run") for r in lines] == [None, "planted_seg"]
    assert all(r["ok"] for r in lines)
    seg = rec["planted_seg"]
    assert seg["rows_with_seg"] == seg["rows"] == 4
    assert seg["mask_min"] > -1e8 and seg["finite"] and seg["masks_err_vs_max_ref"] == 0.0
