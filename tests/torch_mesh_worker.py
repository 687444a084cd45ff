"""One process of ``tests/test_torch_mesh.py``'s runs on the CPU (gloo):
``python tests/torch_mesh_worker.py <dir> <case>`` with ``torchrun``'s
environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT).  It
reads ``<dir>/inputs.pkl`` (the JAX parameter tree as numpy, each case's
mesh, the global batches split by data rank, the train config's fields),
runs the port's ``Trainer`` on that (dp, fsdp, tp) mesh: ``predict`` on its
data rank's rows, two steps, ``validate`` and ``save_best``; and writes
what the test checks to ``<dir>/<case>_rank<r>.pt``.  It imports the port
and torch only."""

import datetime
import os
import pickle
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from llmseg_tpu_torch import config as C  # noqa: E402
from llmseg_tpu_torch.import_weights.from_jax import load_  # noqa: E402
from llmseg_tpu_torch.models import llama, llmseg  # noqa: E402
from llmseg_tpu_torch.parallel import ddp  # noqa: E402
from llmseg_tpu_torch.parallel import mesh as M  # noqa: E402
from llmseg_tpu_torch.train.trainer import Trainer  # noqa: E402


def main(root: str, case: str) -> None:
    torch.set_num_threads(1)
    ddp.init_from_env("cpu", timeout=datetime.timedelta(seconds=60))
    rank = ddp.rank()
    with open(os.path.join(root, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    dp, fsdp, tp = inputs["cases"][case]
    lora = C.LoraConfig(rank=2)
    tcfg = C.TrainConfig(**inputs["train"], mesh=C.MeshConfig(data=dp, fsdp=fsdp, tensor=tp),
                         lora=lora, log_dir=os.path.join(root, f"{case}_log{rank}"))
    cfg = C.ExperimentConfig(model=C.llmseg_tiny(), train=tcfg)
    model = load_(llmseg.build(C.llmseg_tiny(), device="cpu", lora_cfg=lora), inputs["params"])
    trainer = Trainer(cfg, lora_cfg=lora, model=model, device="cpu")
    mesh, d = trainer.mesh, trainer.rank
    out = {"data_rank": d, "data_size": trainer.world, "coords": {
        a: mesh.coord(a) for a in M.AXES}}

    heads = set()
    attention = llama.attention

    def counting(q, k, v, **kw):
        heads.add((q.shape[2], k.shape[2]))
        return attention(q, k, v, **kw)

    llama.attention = counting
    pred = llmseg.predict(model, trainer.to_device(inputs["predict"][trainer.world][d]),
                          device="cpu")
    out["predict"] = {k: pred[k].clone() for k in ("pred_similarity", "pred_iou")}

    grads = []
    step = trainer.opt.step

    def recording(norm=None):
        grads.append({n: M.gather_tensor(p.grad.detach(), trainer.specs[n], mesh).clone()
                      for n, p in trainer.trainable.items()})
        return step(norm)

    trainer.opt.step = recording
    out["metrics"] = []
    for b in inputs["shards"][trainer.world]:
        m = trainer.step(trainer.to_device(b[d]))
        out["metrics"].append({k: v.item() for k, v in m.items()})
    out["heads"] = sorted(heads)
    out["grads"] = grads
    out["params"] = {n: p.detach().clone() for n, p in trainer.full_params().items()}
    emb = trainer.trainable["llava.llm.embed_tokens.weight"]
    state = trainer.opt.adamw.state[emb]
    out["embed_block"] = [tuple(emb.shape), tuple(state["exp_avg"].shape),
                          tuple(state["exp_avg_sq"].shape)]
    out["val"] = trainer.validate(inputs["val"][trainer.world][d], strategy="argmax")
    out["saved"] = trainer.save_best({"giou": 0.5})
    torch.save(out, os.path.join(root, f"{case}_rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
