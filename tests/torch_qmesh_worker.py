"""One process of ``tests/test_torch_qmesh.py``'s runs on the CPU (gloo):
``python tests/torch_qmesh_worker.py <dir> <case>[,<case>...]`` with
``torchrun``'s environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT).  It reads ``<dir>/inputs.pkl`` (the JAX parameter tree as
numpy, each case's mesh and runs, the global batches split by data rank,
the train config's fields) and runs the port's quantized LLaMA on each
case's (dp, fsdp, tp) mesh in turn, in the one process group (every mesh
of the world's size makes its own groups):

  * ``leaves``: the model sharded, then ``quantize_llama_inplace`` in
    int8, int4 and W8A8 (lm_head included): every quantized buffer
    gathered whole and this rank's block shapes; with ``predict`` each
    mode's ``predict`` on the data rank's images (W8A8 also with the
    outlier decomposition on);
  * ``fold``: ``calibrate_quant_stats`` on the data rank's calibration
    rows (the statistics it gives), then, from one process's statistics
    (``inputs["stats"]``), the SmoothQuant (W8A8) and AWQ-style (int4)
    folds with the live LoRA compensated, quantized: the gathered
    tensors, and with ``predict`` the folded W8A8 ``predict``;
  * ``qlora8`` / ``qlora4``: the ``Trainer`` with ``quantize_frozen``:
    two steps, the trainables after them, ``save_best``.

It writes what the test checks to ``<dir>/<case>_rank<r>.pt``.  It imports
the port and torch only."""

import datetime
import os
import pickle
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from llmseg_tpu_torch import config as C  # noqa: E402
from llmseg_tpu_torch.import_weights.from_jax import load_  # noqa: E402
from llmseg_tpu_torch.models import llmseg  # noqa: E402
from llmseg_tpu_torch.ops import quant  # noqa: E402
from llmseg_tpu_torch.parallel import ddp  # noqa: E402
from llmseg_tpu_torch.parallel import mesh as M  # noqa: E402
from llmseg_tpu_torch.train.trainer import Trainer  # noqa: E402

LORA = C.LoraConfig(rank=2)
MODES = {"int8": (8, False), "int4": (4, False), "w8a8": (8, True)}
KEYS = ("pred_similarity", "pred_iou")
OUTLIER_K = 4           # LLMSEG_W8A8_OUTLIER_K of the outlier run


def _model(inputs, mesh):
    model = load_(llmseg.build(C.llmseg_tiny(), device="cpu", lora_cfg=LORA), inputs["params"])
    M.shard_params(model, mesh)
    return model


def _quantized(model) -> dict:
    """Every quantized buffer, whole; and this rank's block shapes."""
    full = M.gather_full(model)
    names = [n for n in full if n.rsplit(".", 1)[1] in ("w_q", "w_q8a", "w_scale", "w_q4",
                                                          "w_scale4")]
    blocks = {n: tuple(t.shape) for n, t in M._named_tensors(model).items() if n in names}
    return {n: full[n].clone() for n in names}, blocks


def _predict(model, inputs, mesh):
    batch = inputs["predict"][mesh.data_size][mesh.data_rank]
    out = llmseg.predict(model, {k: torch.from_numpy(v) for k, v in batch.items()},
                         device="cpu")
    return {k: out[k].clone() for k in KEYS}


def leaves(inputs, mesh, case, root):
    out = {}
    for mode, (bits, w8a8) in MODES.items():
        model = _model(inputs, mesh)
        quant.quantize_llama_inplace(model.llava.llm, bits=bits, w8a8=w8a8)
        whole, blocks = _quantized(model)
        out[mode] = {"leaves": whole, "blocks": blocks}
        if inputs["cases"][case].get("predict"):
            counts = {k.name: k.launches for k in quant.MESH_KERNELS}
            out[mode]["predict"] = _predict(model, inputs, mesh)
            out[mode]["launches"] = {k.name: k.launches - counts[k.name]
                                     for k in quant.MESH_KERNELS}
            if w8a8:     # the opt-in outlier decomposition: the row split gathered
                quant.W8A8_OUTLIER_K = OUTLIER_K
                try:
                    out[mode]["predict_outlier"] = _predict(model, inputs, mesh)
                finally:
                    quant.W8A8_OUTLIER_K = 0
    return out


def fold(inputs, mesh, case, root):
    calib = inputs["calib"][mesh.data_size][mesh.data_rank]
    out = {"stats": llmseg.calibrate_quant_stats(_model(inputs, mesh), {
        k: torch.from_numpy(v) for k, v in calib.items()})}
    head_dim = C.llmseg_tiny().llava.llm.head_dim
    for mode, bits, w8a8 in (("w8a8", 8, True), ("int4", 4, False)):
        model = _model(inputs, mesh)
        quant.quantize_llama_inplace(model.llava.llm, bits=bits, w8a8=w8a8,
                                     smooth_stats=inputs["stats"], lora=model.lora,
                                     head_dim=head_dim)
        out[mode] = {"tensors": {n: t.detach().clone() for n, t in
                                 M.gather_full(model).items()}}
        if w8a8 and inputs["cases"][case].get("predict"):
            out[mode]["predict"] = _predict(model, inputs, mesh)
    return out


def qlora(bits):
    def run(inputs, mesh, case, root):
        dp, fsdp, tp = inputs["cases"][case]["mesh"]
        tcfg = C.TrainConfig(**inputs["train"], mesh=C.MeshConfig(data=dp, fsdp=fsdp, tensor=tp),
                             lora=LORA, quantize_frozen=True, quantize_bits=bits,
                             log_dir=os.path.join(root, f"{case}_q{bits}_log{ddp.rank()}"))
        model = load_(llmseg.build(C.llmseg_tiny(), device="cpu", lora_cfg=LORA),
                      inputs["params"])
        trainer = Trainer(C.ExperimentConfig(model=C.llmseg_tiny(), train=tcfg), lora_cfg=LORA,
                          model=model, device="cpu")
        d = trainer.rank
        frozen = {n: b.clone() for n, b in model.named_buffers()}
        metrics = [{k: v.item() for k, v in trainer.step(trainer.to_device(b[d])).items()}
                   for b in inputs["shards"][trainer.world]]
        return {"metrics": metrics,
                "params": {n: p.detach().clone() for n, p in trainer.full_params().items()},
                "frozen_kept": all(torch.equal(b, frozen[n]) for n, b in model.named_buffers()),
                "quantized": sum(quant.is_quantized(m) for m in model.modules()),
                "specs_cover_buffers": all(n in trainer.specs for n in M._named_tensors(model)),
                "saved": trainer.save_best({"giou": 0.5})}
    return run


RUNS = {"leaves": leaves, "fold": fold, "qlora8": qlora(8), "qlora4": qlora(4)}


def main(root: str, cases: str) -> None:
    torch.set_num_threads(1)
    ddp.init_from_env("cpu", timeout=datetime.timedelta(seconds=60))
    rank = ddp.rank()
    with open(os.path.join(root, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    for case in cases.split(","):
        spec = inputs["cases"][case]
        dp, fsdp, tp = spec["mesh"]
        mesh = M.make_mesh(C.MeshConfig(data=dp, fsdp=fsdp, tensor=tp))
        out = {"data_rank": mesh.data_rank}
        for run in spec["runs"]:
            out[run] = RUNS[run](inputs, mesh, case, root)
        torch.save(out, os.path.join(root, f"{case}_rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
