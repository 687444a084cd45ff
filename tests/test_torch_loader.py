"""``llmseg_tpu_torch.train.loader.BatchLoader`` against
``llmseg_tpu.train.loader.BatchLoader`` (order, tiling, per-process shard,
prefetch, thread pool, error propagation), the loader over a real corpus
against direct ``dataset[i]`` + ``collate`` calls, and the port's
``Trainer.train_epoch`` fed by the loader against the JAX ``Trainer`` fed by
its own, at ``llmseg_tiny`` with LoRA rank 2, float32, from the same
weights and an LLM-Seg40K-layout corpus written from a seed.

Tolerances: the loader's index order and batches are exact.  The epoch's
averaged loss terms within 1e-5 relative and each trainable tensor within
1e-5 relative in the Frobenius norm, ``tests/test_torch_train.py``'s
tolerances (and its rule for the selection head's key biases, whose exact
gradient is zero: they move no more than 2 lr per update).  The two
corpora's proposal grids differ by the resampler's 1e-6 (cv2 against the
port's ``cv2_resize``), far inside these."""

import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from llmseg_tpu import config as JC
from llmseg_tpu.data import collate as jcollate
from llmseg_tpu.data import datasets as JD
from llmseg_tpu.data.tokenizer import ByteTokenizer as JTok
from llmseg_tpu.data.tokenizer import seg_token_id as jseg_id
from llmseg_tpu.models import llmseg as jllmseg
from llmseg_tpu.native import loader as jnative
from llmseg_tpu.train import loader as jloader
from llmseg_tpu.train import optim as joptim
from llmseg_tpu.train.trainer import Trainer as JTrainer
from llmseg_tpu_torch import config as TC
from llmseg_tpu_torch.data import collate as tcollate
from llmseg_tpu_torch.data import datasets as TD
from llmseg_tpu_torch.data.tokenizer import ByteTokenizer as TTok
from llmseg_tpu_torch.data.tokenizer import seg_token_id as tseg_id
from llmseg_tpu_torch.import_weights.from_jax import flatten_paths, load_
from llmseg_tpu_torch.models import llmseg as tllmseg
from llmseg_tpu_torch.train import loader as tloader
from llmseg_tpu_torch.train.trainer import Trainer as TTrainer

from test_torch_data import assert_tree_equal
from test_torch_datasets import _llmseg_readers, assert_samples_equal, write_llmseg

torch.set_num_threads(1)
MML = 480            # model_max_length: rows keep their [SEG] (the answer ends the row)


@pytest.fixture(autouse=True)
def numpy_labels(monkeypatch):
    """The JAX labels on their numpy path, which the port copies (see
    tests/test_torch_datasets.py)."""
    monkeypatch.setattr(jnative, "available", lambda: False)


class Echo:
    """A dataset whose sample is its index; ``fail_at`` raises there."""

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise KeyError(f"bad sample {i}")
        return {"i": np.array([i]), "thread": threading.get_ident()}


def echo_collate(samples):
    return {"i": np.concatenate([s["i"] for s in samples])}, {"n": len(samples)}


@pytest.mark.parametrize("n,batch,steps,shuffle,seed,epoch,rank,world", [
    (10, 2, 3, False, 0, 0, 0, 1), (10, 3, 7, False, 0, 0, 0, 1),     # tiled
    (10, 2, 5, True, 4, 0, 0, 1), (10, 2, 5, True, 4, 3, 0, 1),       # epochs reshuffle
    (11, 2, 3, True, 1, 1, 1, 3), (11, 2, 3, False, 0, 0, 2, 3),      # shards
    (3, 4, 2, True, 0, 0, 1, 2), (1, 1, 5, False, 0, 0, 0, 1)])
def test_loader_indices_and_batches_match_jax(n, batch, steps, shuffle, seed, epoch, rank, world):
    kw = dict(shuffle=shuffle, seed=seed, process_index=rank, process_count=world)
    j = jloader.BatchLoader(Echo(n), echo_collate, batch, steps, **kw)
    t = tloader.BatchLoader(Echo(n), echo_collate, batch, steps, **kw)
    assert t._indices(epoch) == j._indices(epoch) and len(t) == len(j) == steps
    for threads in (1, 3):
        j.num_threads = t.num_threads = threads
        got, ref = list(t.epoch(epoch)), list(j.epoch(epoch))
        assert len(got) == steps
        assert_tree_equal(got, ref)


@pytest.mark.parametrize("fail_at,threads", [(0, 1), (5, 1), (5, 3)])
def test_loader_propagates_worker_errors_like_jax(fail_at, threads):
    outs = []
    for lib in (jloader, tloader):
        loader = lib.BatchLoader(Echo(8, fail_at=fail_at), echo_collate, 2, 4,
                                 num_threads=threads, prefetch=1)
        seen = []
        with pytest.raises(KeyError, match=f"bad sample {fail_at}"):
            for b, _ in loader.epoch(0):
                seen.append(b["i"].tolist())
        outs.append(seen)
    assert outs[0] == outs[1] == [[2 * k, 2 * k + 1] for k in range(fail_at // 2)]


def test_loader_runs_the_pool_in_threads():
    """With num_threads > 1 the samples of a batch are drawn by the pool's
    threads, not by the consumer's."""
    seen = set()

    class Spy(Echo):
        def __getitem__(self, i):
            seen.add(threading.get_ident())
            return super().__getitem__(i)

    loader = tloader.BatchLoader(Spy(16), echo_collate, 8, 2, num_threads=4)
    assert [b["i"].tolist() for b, _ in loader.epoch(0)] == [list(range(8)),
                                                             list(range(8, 16))]
    assert threading.get_ident() not in seen


def test_pin_batch_keeps_the_item_shape(monkeypatch):
    """``pin_batch`` turns the batch dict's arrays into CPU tensors of the
    same bits (pinning itself needs the card: here ``pin_memory`` is the
    identity) and leaves the extras alone."""
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: self)
    batch, extras = echo_collate([Echo(4)[i] for i in range(4)])
    batch["f"] = np.random.RandomState(0).rand(2, 3).astype(np.float32)
    got, got_extras = tloader.pin_batch((batch, extras))
    assert got_extras is extras and set(got) == set(batch)
    for k, v in batch.items():
        assert isinstance(got[k], torch.Tensor)
        np.testing.assert_array_equal(got[k].numpy(), v)


# ---------------------------------------------------------------------------
# a corpus through the loader and the trainers
# ---------------------------------------------------------------------------


def _aligned(cfg, tok, seg_token_id):
    """cli/common.align_model_to_tokenizer: the [SEG] id from the tokenizer
    and an LLM vocab that covers it."""
    llm = dataclasses.replace(cfg.llava.llm, vocab_size=max(cfg.llava.llm.vocab_size,
                                                            tok.vocab_size))
    return dataclasses.replace(cfg, llava=dataclasses.replace(cfg.llava, llm=llm),
                               seg_token_id=seg_token_id(tok))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = write_llmseg(tmp_path_factory.mktemp("llmseg40k"), np.random.RandomState(8))
    jtok, ttok = JTok(model_max_length=MML), TTok(model_max_length=MML)
    jcfg = _aligned(JC.llmseg_tiny(), jtok, jseg_id)
    tcfg = _aligned(TC.llmseg_tiny(), ttok, tseg_id)
    sizes = dict(image_size=jcfg.dino.img_size, clip_size=jcfg.llava.vision.img_size,
                 seg_grid=jcfg.seg_grid)
    args = (str(root / "train.json"), str(root / "coco" / "train2017"),
            str(root / "ego_objects" / "images"))
    jr, tr = _llmseg_readers(root)

    def dataset(D, seed=3):
        r = jr if D is JD else tr
        return D.LLMSegDataset(*args, r["coco"], r["ego"], seed=seed, **sizes)

    kw = dict(num_image_tokens=jcfg.llava.num_image_tokens, rows_per_sample=2,
              max_proposals=jcfg.max_proposals, model_max_length=MML)
    return dict(jcfg=jcfg, tcfg=tcfg, dataset=dataset,
                jcollate=lambda s: jcollate.collate(s, jtok, **kw),
                tcollate=lambda s: tcollate.collate(s, ttok, **kw))


def _assert_batches_close(got, ref):
    """Collated batches: sam_segs within the resampler's tolerance, the rest
    equal to the bit."""
    (gb, ge), (rb, re_) = got, ref
    np.testing.assert_allclose(gb["sam_segs"], rb["sam_segs"], rtol=0, atol=1e-6)
    assert_tree_equal(({k: v for k, v in gb.items() if k != "sam_segs"}, ge),
                      ({k: v for k, v in rb.items() if k != "sam_segs"}, re_))


def test_loader_over_a_corpus_equals_direct_calls(corpus):
    """num_threads=1: the loader's batches are dataset[i] + collate in
    order, and equal the JAX loader's over the JAX dataset."""
    loader = tloader.BatchLoader(corpus["dataset"](TD, 5), corpus["tcollate"], 2, 4,
                                 num_threads=1)
    got = list(loader.epoch(0))
    idx, direct_ds = loader._indices(0), corpus["dataset"](TD, 5)
    direct = [corpus["tcollate"]([direct_ds[i] for i in idx[2 * b:2 * b + 2]]) for b in range(4)]
    assert_tree_equal(got, direct)
    ref = list(jloader.BatchLoader(corpus["dataset"](JD, 5), corpus["jcollate"], 2, 4,
                                   num_threads=1).epoch(0))
    for g, r in zip(got, ref):
        _assert_batches_close(g, r)


def test_samples_of_the_corpus_match_jax(corpus):
    jds, tds = corpus["dataset"](JD), corpus["dataset"](TD)
    for i in range(len(jds)):
        assert_samples_equal(tds[i], jds[i])


def _params(jcfg, seed=1):
    """llmseg.init of the aligned tiny config with every leaf jittered
    (tests/test_torch_loss_fn.jittered_params' recipe)."""
    p = jllmseg.init(jax.random.PRNGKey(0), jcfg, lora_cfg=JC.LoraConfig(rank=2))
    rng = np.random.RandomState(seed)
    p["lora"] = jax.tree.map(lambda x: rng.randn(*np.shape(x)) / np.sqrt(np.shape(x)[0]),
                             p["lora"])
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.randn(*np.shape(x))).astype(np.float32), p)


def test_trainer_epoch_over_the_loader_matches_jax(corpus, tmp_path):
    """Four micro-steps of one image (two rows, one of them padding) in two
    updates of grad_accum_steps 2, the JAX Trainer fed by its loader over
    the JAX dataset and the port's by its own."""
    train = dict(grad_accum_steps=2, epochs=1, steps_per_epoch=2, warmup_steps=0, lr=1e-4,
                 precision="fp32", print_freq=1)
    jexp = JC.ExperimentConfig(model=corpus["jcfg"], train=JC.TrainConfig(
        log_dir=str(tmp_path / "jax"), mesh=JC.MeshConfig(data=1),
        lora=JC.LoraConfig(rank=2), **train))
    texp = TC.ExperimentConfig(model=corpus["tcfg"], train=TC.TrainConfig(
        log_dir=str(tmp_path / "port"), lora=TC.LoraConfig(rank=2), **train))
    params = _params(corpus["jcfg"])
    start = flatten_paths(joptim.partition(params)[0])
    jt = JTrainer(jexp, params=params)
    model = load_(tllmseg.build(corpus["tcfg"], device="cpu", lora_cfg=texp.train.lora), params)
    tt = TTrainer(texp, model=model, device="cpu")
    kw = dict(num_threads=1, prefetch=2)
    jm = jt.train_epoch(jloader.BatchLoader(corpus["dataset"](JD), corpus["jcollate"], 1, 4,
                                            **kw).epoch(0), epoch=0)
    tm = tt.train_epoch(tloader.BatchLoader(corpus["dataset"](TD), corpus["tcollate"], 1, 4,
                                            **kw).epoch(0), epoch=0)
    assert tt.global_step == jt.global_step == 2
    assert set(tm) == set(jm)
    for k in jm:
        assert np.isfinite(tm[k])
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=0, err_msg=k)
    jparams = flatten_paths(jax.tree.map(np.asarray, jt.trainable))
    for name, p in tt.trainable.items():
        got = p.detach().numpy()
        if name.startswith("select.") and name.endswith(".k.bias"):
            assert np.abs(got - start[name]).max() <= 2 * 2 * 1e-4, name
        else:
            rel = np.linalg.norm(got - jparams[name]) / max(np.linalg.norm(jparams[name]), 1e-30)
            assert rel <= 1e-5, name
    assert any(not np.array_equal(p.detach().numpy(), start[n]) for n, p in tt.trainable.items())


def test_trainer_takes_numpy_and_tensor_batches_alike(corpus, tmp_path):
    """The same collated batch as numpy arrays (what the loader gives) and
    as tensors gives the same step, bit for bit; profile_steps writes a
    trace."""
    exp = TC.ExperimentConfig(model=corpus["tcfg"], train=TC.TrainConfig(
        grad_accum_steps=1, steps_per_epoch=1, warmup_steps=0, precision="fp32",
        log_dir=str(tmp_path), lora=TC.LoraConfig(rank=2)))
    batch = corpus["tcollate"]([corpus["dataset"](TD)[0]])
    runs = []
    for as_tensor in (False, True):
        b = {k: torch.from_numpy(v) for k, v in batch[0].items()} if as_tensor else batch[0]
        tr = TTrainer(exp, device="cpu")
        m = tr.train_epoch([(b, batch[1])], epoch=0, profile_steps=1 if as_tensor else 0)
        runs.append((m, {n: p.detach().clone() for n, p in tr.trainable.items()}))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(p, runs[1][1][n]) for n, p in runs[0][1].items())
    assert (tmp_path / "profile" / "trace.json").is_file()
    on_device = tr.to_device(batch[0])
    for k, v in batch[0].items():
        assert on_device[k].dtype == torch.from_numpy(v).dtype
        np.testing.assert_array_equal(on_device[k].numpy(), v)


def test_smoke_data_phase_runs_small_on_the_cpu(capsys, monkeypatch, tmp_path):
    """``chip_smoke.py``'s data phase as the card runs it, but at
    ``llmseg_tiny`` on the CPU with small images (60 x 80, 80 x 60,
    53 x 80) and 6 proposals each: its gates hold (no launches here), it
    reports every part of a sample's time, and its Trainer is freed when it
    returns."""
    import json

    import weakref

    import chip_smoke as CS
    from llmseg_tpu_torch.ops import attention as A
    monkeypatch.setattr(CS, "OUT_DIR", str(tmp_path))
    made, init = [], TTrainer.__init__

    def tracked(self, *a, **kw):
        made.append(weakref.ref(self))
        init(self, *a, **kw)

    monkeypatch.setattr(TTrainer, "__init__", tracked)
    rec = CS.data_phase(TC, A, base=TC.llmseg_tiny(), device="cpu",
                        shapes=((60, 80), (80, 60), (53, 80)), proposals=6)
    # no reference cycle keeps the phase's model alive for the phases after it
    assert len(made) == 1 and made[0]() is None
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "data" and line["ok"], line
    assert rec["val_images"] == 13 and rec["val_batches"] == 2 and rec["global_step"] == 4
    assert set(rec["getitem_ms_by_part"]) == {"rle_decode", "pad_to_square", "seg_resize",
                                              "iou_iop_labels", "preprocess_dino",
                                              "preprocess_clip"}
    assert all(v > 0 for v in rec["getitem_ms_by_part"].values())
    assert len(rec["step_ms"]) == len(rec["data_ms"]) == 8
