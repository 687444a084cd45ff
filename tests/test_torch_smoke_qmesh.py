"""``chip_smoke.py``'s quantized mesh phases run small on the CPU as the
card runs them (no launches here): the one-process references, then two
ranks on gloo (``chip_smoke.mesh_ranks``) at ``llmseg_tiny``:
``qmesh_in_place``'s W8A8 ``predict`` at tp=2 equal to one process's to
the bit, its QLoRA int8 at tp=2 and int4 at fsdp=2 under MESH_LIMIT, and
``qmesh``'s calibrated W8A8 ``predict`` at tp=2 and QLoRA steps (the fsdp
sub-run's LLaMA cut to one layer), each rank's lines printed."""

import json

import torch

import chip_smoke as CS
from llmseg_tpu_torch import config as TC
from llmseg_tpu_torch.data.synthetic import make_batch
from llmseg_tpu_torch.ops import attention as A
from llmseg_tpu_torch.ops import quant as Q

torch.set_num_threads(2)


def test_smoke_qmesh_phases_run_small_on_the_cpu(capsys):
    recs = CS.qmesh_phase(TC, make_batch, A, Q, device="cpu", in_place_cfg=TC.llmseg_tiny(),
                          full_cfg=TC.llmseg_tiny(), fsdp_layers=1, text_len=32)
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    lines = {(r["phase"], r["run"]) for r in out if r.get("phase", "").startswith("qmesh")}
    assert lines == {("qmesh_in_place", "in_place_w8a8_tp2"),
                     ("qmesh_in_place", "in_place_int8_tp2"),
                     ("qmesh_in_place", "in_place_int4_fsdp2"),
                     ("qmesh", "full_w8a8_tp2"), ("qmesh", "full_int8_tp2"),
                     ("qmesh", "full_int4_fsdp2")}
    assert sum(r["phase"] == "mesh_rank" for r in out) == 12      # 2 ranks x 6 sub-runs
    assert all(r["ok"] for r in recs.values())
    w8a8 = recs["in_place_w8a8_tp2"]
    assert w8a8["equal_to_one_process_to_the_bit"] and w8a8["ranks_equal"]
    assert w8a8["mesh"] == {"dp": 1, "fsdp": 1, "tp": 2}
    for name in ("in_place_int8_tp2", "in_place_int4_fsdp2"):
        r = recs[name]
        assert r["replicated_equal_to_the_bit"] and r["worst_llama_grad_err"] <= CS.MESH_LIMIT
    assert recs["full_int8_tp2"]["collective_calls"]["all_reduce"] > 0
    fsdp = recs["full_int4_fsdp2"]
    assert "LLaMA cut to 1 of 2 layers" in fsdp["config"]
    assert fsdp["collective_calls"]["all_gather"] > 0
    assert recs["full_w8a8_tp2"]["calibrate_s"][0] > 0
    assert not torch.distributed.is_initialized()
