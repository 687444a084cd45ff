"""The port's ``finetune`` and ``validate`` against the JAX CLI's on the
CPU at ``llmseg_tiny``, on an LLM-Seg40K-layout corpus written from a seed,
both from the same seeded weights (``tests/test_torch_cli.py``'s ``Runs``),
float32.  Tolerances as in ``tests/test_torch_cli.py``: the training
meters within 1e-4 relative, gIoU and cIoU equal; W8A8 validation's
SmoothQuant statistics within 1e-5 relative and its scores within half
the mode's quantization error."""

import numpy as np
import pytest
import torch

from cli import finetune as jfinetune
from cli import validate as jvalidate
from llmseg_tpu.native import loader as jnative
from llmseg_tpu_torch.cli import finetune as tfinetune
from llmseg_tpu_torch.cli import validate as tvalidate

from test_torch_cli import (STATS_TOL, TIE_FRACTION, Runs, _assert_meters_close, _both,
                            _common_argv, write_llmseg40k)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def numpy_labels(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)


def test_finetune_then_validate_match_jax(tmp_path, monkeypatch):
    """``finetune`` on an LLM-Seg40K-layout corpus (a shuffled loader,
    ``LLMSeg|val`` at batch 1), a second ``finetune`` of the same run that
    resumes its weights only, then ``validate`` of the run (the full
    resume), plain and ``--load_8bit --w8a8 --calib_batches 1``."""
    root = write_llmseg40k(tmp_path, np.random.RandomState(3))
    runs = Runs(monkeypatch)
    argv = _common_argv(root, "ft")
    for _ in range(2):
        _both(runs, jfinetune.main, tfinetune.main, argv, root)
        _assert_meters_close(runs.take("jax", "train"), runs.take("port", "train"))
        jv, tv = runs.take("jax", "val"), runs.take("port", "val")
        assert tv == [{k: float(v) for k, v in r.items()} for r in jv]
        runs.take("jax", "scores"), runs.take("port", "scores")
    argv += ["--val_dataset", "LLMSeg|val", "--val_batch_size", "2"]
    jres, tres = _both(runs, jvalidate.main, tvalidate.main, argv, root)
    assert tres == {k: float(v) for k, v in jres.items()}
    jf, tf = runs.take("jax", "scores"), runs.take("port", "scores")

    jres, tres = _both(runs, jvalidate.main, tvalidate.main,
                       argv + ["--load_8bit", "--w8a8", "--calib_batches", "1"], root)
    (js,), (ts,) = runs.take("jax", "stats"), runs.take("port", "stats")
    assert len(js) == len(ts) == 2
    for a, b in zip(js, ts):
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]), **STATS_TOL, err_msg=k)
    jq, tq = runs.take("jax", "scores"), runs.take("port", "scores")
    assert len(jq) == len(tq) == len(jf) == len(tf) == 2
    for key in ("pred_similarity", "pred_iou"):
        got, q, f = (np.concatenate([np.asarray(s[key], np.float32).reshape(-1)
                                     for s in run]) for run in (tq, jq, jf))
        qerr = np.abs(q - f).max()
        assert qerr > 1e-5, qerr
        assert np.abs(got - q).max() <= TIE_FRACTION * qerr, (key, np.abs(got - q).max(), qerr)
    assert 0 <= tres["giou"] <= 1 and 0 <= tres["ciou"] <= 1
