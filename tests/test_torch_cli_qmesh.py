"""The port's command line on a tp=2 mesh with a quantized LLaMA against
the JAX CLI on the same mesh, on the CPU at ``llmseg_tiny``, float32, from
the same seeded weights (``tests/test_torch_cli.py``'s ``Runs``).

The port runs ``cli.train`` under ``--multihost --mesh_dp 1 --mesh_tp 2``
in two processes on gloo (``tests/torch_cli_qmesh_worker.py``), JAX's
``cli/train.py`` with ``--mesh_dp 1 --mesh_tp 2`` over two of conftest's
CPU devices: ``--quantize_frozen`` (an int8 QLoRA epoch of two steps, then
the val loop), then ``--eval_only --load_8bit --w8a8 --calib_batches 1``.
Both sides round the vocabulary up to an even size (the byte tokenizer's
263 ids do not split over tp = 2, on either side).
Tolerances as in ``tests/test_torch_cli.py``: the training meters within
1e-4 relative, gIoU and cIoU equal; W8A8's SmoothQuant statistics within
1e-5 relative and its scores within half the mode's quantization error
(the largest |JAX W8A8 - JAX float32| of the same scores); both ranks
report the same."""

import os
import pickle
import time

import numpy as np
import pytest
import torch

from cli import common as jcommon
from cli import train as jtrain
from llmseg_tpu.native import loader as jnative

from test_torch_cli import (METER_RTOL, STATS_TOL, TIE_FRACTION, Runs, _common_argv, _weights,
                            write_reason_seg)
from test_torch_mesh import _launch, _wait
from torch_cli_qmesh_worker import even_vocab

WORKER = os.path.join(os.path.dirname(__file__), "torch_cli_qmesh_worker.py")
MESH = ["--mesh_tp", "2"]          # _common_argv gives --mesh_dp 1


@pytest.fixture(autouse=True)
def numpy_labels(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)


def _take(log, tag):
    return [v for t, v in log if t == tag]


def test_cli_train_qlora_and_w8a8_validate_on_tp2_match_jax(tmp_path, monkeypatch):
    root = write_reason_seg(tmp_path, np.random.RandomState(0))
    base = _common_argv(root, "q") + ["--dataset", "reason_seg", "--sample_rates", "1",
                                      "--num_classes_per_sample", "1"] + MESH
    qlora = base + ["--quantize_frozen", "--exp_name", "qlora"]
    w8a8 = base + ["--eval_only", "--load_8bit", "--w8a8", "--calib_batches", "1",
                   "--exp_name", "w8a8"]
    fp32 = base + ["--eval_only", "--exp_name", "fp32"]
    runs = Runs(monkeypatch)
    monkeypatch.setattr(jcommon, "align_model_to_tokenizer",
                        even_vocab(jcommon.align_model_to_tokenizer))
    args = jcommon.build_parser("train").parse_args(qlora)
    cfg = jcommon.to_config(args)
    cfg = jcommon.align_model_to_tokenizer(cfg, jcommon.build_tokenizer(args, cfg))
    runs.tree = _weights(cfg.model, cfg.train.lora)
    port = ["--multihost", "--device", "cpu", "--log_base_dir", str(root / "port")]
    with open(root / "inputs.pkl", "wb") as f:
        pickle.dump({"tree": runs.tree, "runs": [qlora + port, w8a8 + port]}, f)
    t0 = time.time()
    procs = _launch(str(root), "cli", 2, WORKER)

    for argv in (qlora, w8a8, fp32):
        jtrain.main(argv + ["--log_base_dir", str(root / "jax")])
    _wait(procs)
    print(f"workers and JAX: {time.time() - t0:.1f} s")
    logs = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(2)]
    assert [a for t, a in logs[0] if t == "run"] == [qlora + port, w8a8 + port]

    jmeters, jval = runs.take("jax", "train"), runs.take("jax", "val")
    jscores, (jstats,) = runs.take("jax", "scores"), runs.take("jax", "stats")
    for log in logs:
        (tmeters,), tval = _take(log, "train"), _take(log, "val")
        assert len(jmeters) == 1 and set(tmeters) == set(jmeters[0])
        for k, v in jmeters[0].items():
            assert np.isfinite(tmeters[k])
            np.testing.assert_allclose(tmeters[k], v, rtol=METER_RTOL, atol=0, err_msg=k)
        # the QLoRA epoch's val loop, then the W8A8 one (JAX also ran the float32 one)
        assert len(tval) == 2 and len(jval) == 3
        assert tval[0] == {k: float(v) for k, v in jval[0].items()}
        assert tval[1] == {k: float(v) for k, v in jval[1].items()}

        (tstats,) = _take(log, "stats")
        assert len(tstats) == len(jstats) == 2
        for a, b in zip(jstats, tstats):
            for k in a:
                np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]), **STATS_TOL,
                                           err_msg=k)
        tscores = _take(log, "scores")
        n = len(tscores) // 2
        assert n > 0 and len(jscores) == 3 * n
        for key in ("pred_similarity", "pred_iou"):
            got, q, f = (np.concatenate([np.asarray(s[key], np.float32).reshape(-1)
                                         for s in run]) for run in
                         (tscores[n:], jscores[n:2 * n], jscores[2 * n:]))
            qerr = np.abs(q - f).max()
            assert qerr > 1e-5, qerr
            assert np.abs(got - q).max() <= TIE_FRACTION * qerr, (key, np.abs(got - q).max())
    for tag in ("train", "val", "stats", "scores"):
        a, b = _take(logs[0], tag), _take(logs[1], tag)
        assert len(a) == len(b)
        if tag in ("train", "val"):
            assert a == b
