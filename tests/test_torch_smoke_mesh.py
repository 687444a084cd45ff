"""``chip_smoke.py``'s mesh phases run small on the CPU as the card runs
them (no launches here): the one-process references, then two ranks on
gloo (``chip_smoke.mesh_ranks``) at ``llmseg_tiny`` for both sub-runs,
``mesh_in_place`` at tp=2 and fsdp=2 in float32 under MESH_LIMIT and
``mesh`` at tp=2 (with ``predict``) and fsdp=2 (its LLaMA cut to one
layer), each rank's lines printed, the replicated parameters equal to the
bit on both ranks."""

import json

import torch

import chip_smoke as CS
from llmseg_tpu_torch import config as TC
from llmseg_tpu_torch.data.synthetic import make_batch
from llmseg_tpu_torch.ops import attention as A

torch.set_num_threads(2)


def test_smoke_mesh_phases_run_small_on_the_cpu(capsys):
    recs = CS.mesh_phase(TC, make_batch, A, device="cpu", in_place_cfg=TC.llmseg_tiny(),
                         full_cfg=TC.llmseg_tiny(), fsdp_layers=1, text_len=32,
                         predict_images=2)
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    lines = {(r["phase"], r["run"]): r for r in out if r.get("phase", "").startswith("mesh")}
    assert {k for k in lines if k[0] != "mesh_rank"} == {
        ("mesh_in_place", "in_place_tp2"), ("mesh_in_place", "in_place_fsdp2"),
        ("mesh", "full_tp2"), ("mesh", "full_fsdp2")}
    assert sum(r["phase"] == "mesh_rank" for r in out) == 8      # 2 ranks x 4 sub-runs
    assert all(r["ok"] for r in recs.values())
    for name in ("in_place_tp2", "in_place_fsdp2"):
        r = recs[name]
        assert r["replicated_equal_to_the_bit"] and r["worst_llama_grad_err"] <= CS.MESH_LIMIT
        assert max(r["head_grad_err"]) <= CS.MESH_LIMIT
        assert r["images_a_rank"] == (2 if name.endswith("tp2") else 1)
    tp = recs["full_tp2"]
    assert tp["predict_ranks_equal"] and tp["mesh"] == {"dp": 1, "fsdp": 1, "tp": 2}
    assert tp["collective_calls"]["all_reduce"] > 0
    fsdp = recs["full_fsdp2"]
    assert "LLaMA cut to 1 of 2 layers" in fsdp["config"]
    assert fsdp["collective_calls"]["all_gather"] > 0 and fsdp["collective_calls"][
        "reduce_scatter"] > 0
    assert not torch.distributed.is_initialized()
