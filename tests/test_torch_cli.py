"""The port's command line (``llmseg_tpu_torch.cli``) against the JAX
package's (``cli/``), on the CPU at ``llmseg_tiny``: the parser's flags and
defaults, ``to_config`` and ``apply_overrides``, the initial weights from a
checkpoint set in the reference's layouts, and ``train`` end to end
(``--precision fp32``) on a corpus written from a seed (``finetune`` and
``validate``: ``tests/test_torch_cli_finetune.py``), both CLIs from the
same seeded weights
(``import_initial_params`` patched on both sides to return them; JAX's LoRA
init hashes names, so the weights are drawn from numpy).

Tolerances: the parser, the configs and the initial weights are equal (the
weights to the bit).  The per-epoch training meters within 1e-4 relative
(the loss of a float32 model summed in two libraries, the datasets'
proposals 1e-6 apart through the resampler); gIoU and cIoU equal.  W8A8
validation (``tests/test_torch_cli_finetune.py``): the SmoothQuant
statistics within 1e-5 relative (a statistic taken after the whole float32
model, on proposals 1e-6 apart: 1.7e-6 seen), and the scores within half
the mode's quantization error (the largest |JAX W8A8 - JAX float32| of the
same scores): a rounding tie that one side's float32 sums put on the other
side of .5 flips one int8 code.  JAX runs with ``--mesh_dp 1``: its conftest
gives it 8 CPU devices, and its global batch is ``--batch_size`` times the
data axis; the port's is ``--batch_size``."""

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
from cli import common as jcommon
from cli import finetune as jfinetune
from cli import train as jtrain
from cli import validate as jvalidate
from llmseg_tpu import config as JC
from llmseg_tpu.models import llmseg as jllmseg
from llmseg_tpu.native import loader as jnative
from llmseg_tpu.train import evaluate as jeval
from llmseg_tpu.train.trainer import Trainer as JTrainer
from llmseg_tpu_torch import config as TC
from llmseg_tpu_torch.cli import common as tcommon
from llmseg_tpu_torch.cli import finetune as tfinetune
from llmseg_tpu_torch.cli import train as ttrain
from llmseg_tpu_torch.cli import validate as tvalidate
from llmseg_tpu_torch.import_weights import torch_import as TI
from llmseg_tpu_torch.import_weights.from_jax import load_
from llmseg_tpu_torch.models import llmseg as tllmseg
from llmseg_tpu_torch.models.sam import sam as tsam
from llmseg_tpu_torch.ops import rle as trle
from llmseg_tpu_torch.train import evaluate as teval
from llmseg_tpu_torch.train.trainer import Trainer as TTrainer

from test_torch_datasets import write_jpg
from test_torch_import import POS_TOL, _filled, _seg_cfgs

torch.set_num_threads(1)
METER_RTOL = 1e-4
STATS_TOL = dict(rtol=1e-5, atol=0)
TIE_FRACTION = 0.5


@pytest.fixture(autouse=True)
def numpy_labels(monkeypatch):
    """The JAX labels on their numpy path, which the port copies (see
    tests/test_torch_datasets.py)."""
    monkeypatch.setattr(jnative, "available", lambda: False)


# ---------------------------------------------------------------------------
# the parser, the config and the overrides
# ---------------------------------------------------------------------------


class _Parsed(Exception):
    pass


def _parsed_args(module, common, monkeypatch, argv):
    """The namespace an entry's ``main`` parses from ``argv``, taken from its
    parser as it parses and before anything else runs."""
    build = common.build_parser

    def spy(name):
        parser = build(name)

        def parse_args(args=None):
            raise _Parsed(argparse.ArgumentParser.parse_args(parser, args))
        parser.parse_args = parse_args
        return parser

    monkeypatch.setattr(common, "build_parser", spy)
    with pytest.raises(_Parsed) as got:
        module.main(argv)
    return vars(got.value.args[0])


@pytest.mark.parametrize("entry", ["train", "finetune", "validate"])
def test_parser_flags_and_defaults_match_jax(entry, monkeypatch):
    """Each entry's parsed defaults (after its own ``set_defaults``) and one
    parse of given flags equal JAX's; the port adds ``--device`` alone, the
    card by default."""
    jmod = {"train": jtrain, "finetune": jfinetune, "validate": jvalidate}[entry]
    tmod = {"train": ttrain, "finetune": tfinetune, "validate": tvalidate}[entry]
    for argv in ([], ["--lr", "3e-5", "--lora_r", "4", "--eval_strategy", "iou_iop",
                      "--no_eval", "--val_batch_size", "2", "--w8a8"]):
        j = _parsed_args(jmod, jcommon, monkeypatch, list(argv))
        t = _parsed_args(tmod, tcommon, monkeypatch, list(argv))
        assert t.pop("device") == "cuda"
        assert t == j
    jp, tp = jcommon.build_parser("x"), tcommon.build_parser("x")

    def flags(p):
        return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type, a.nargs,
                         getattr(a, "const", None)) for a in p._actions if a.dest != "help"}
    tf = flags(tp)
    assert tf.pop("device")[1] == "cuda"
    assert tf == flags(jp)


TO_CONFIG_ARGV = [
    ["--model_size", "tiny"],
    ["--lr", "2e-4", "--sample_rates", "2,1", "--dataset", "sem_seg||reason_seg",
     "--model_size", "tiny", "--precision", "fp32", "--batch_size", "2", "--mesh_dp", "1"],
    ["--lora_r", "4", "--lora_alpha", "8", "--lora_dropout", "0", "--lora_target_modules",
     "q_proj", "--quantize_frozen", "--quantize_bits", "4", "--remat_policy", "full",
     "--no_eval", "--exp_name", "x", "--log_base_dir", "/tmp/r", "--image_size", "448",
     "--ce_loss_weight", "0.5", "--grad_accumulation_steps", "3", "--seed", "7"],
    ["--model_size", "small", "--val_dataset", "LLMSeg|val", "--exclude_val", "--workers", "4",
     "--mesh_dp", "1", "--mesh_fsdp", "1", "--mesh_tp", "1", "--model_max_length", "256"],
]


@pytest.mark.parametrize("argv", TO_CONFIG_ARGV, ids=["tiny", "lr_rates", "lora_qlora", "small"])
def test_to_config_matches_jax(argv):
    """The same fields and values; JAX's global batch is --batch_size times
    its data axis (its 8 CPU devices unless --mesh_dp is given)."""
    jargs = jcommon.build_parser("t").parse_args(argv)
    targs = tcommon.build_parser("t").parse_args(argv)
    j = dataclasses.asdict(jcommon.to_config(jargs))
    t = dataclasses.asdict(tcommon.to_config(targs))
    dp = jargs.mesh_dp if jargs.mesh_dp > 0 else len(jax.devices())
    assert j["train"]["batch_size"] == targs.batch_size * dp
    assert t["train"]["batch_size"] == targs.batch_size
    j["train"]["batch_size"] = t["train"]["batch_size"]
    assert t == j


@pytest.mark.parametrize("argv,error", [
    (["--mesh_dp", "3"], ValueError), (["--mesh_tp", "2"], NotImplementedError),
    (["--mesh_fsdp", "2"], NotImplementedError), (["--mesh_dp", "2"], ValueError)])
def test_to_config_refuses_more_than_one_device(argv, error):
    """Outside a process group the world is one process: a data axis of
    more than one device is refused, and the sharded axes always are (their
    message names their ROADMAP item).  ``tests/test_torch_ddp.py`` runs the
    data axis over two processes."""
    with pytest.raises(error, match="world size 1" if error is ValueError else "item 19"):
        tcommon.to_config(tcommon.build_parser("t").parse_args(argv))


@pytest.mark.parametrize("overrides", [
    {"train.lr": 5e-5, "model.max_proposals": 32},
    {"train.lr": 1, "data.dataset": "reason_seg", "amg.crop_n_layers": 1},
    {"model.llava.llm.num_layers": 2.0, "model.sam": "anything"},
    {"train.lr": "fast"}, {"model.max_proposals": "50"}, {"data.sample_rates": [1, 2]}])
def test_apply_overrides_matches_jax(overrides):
    def run(C):
        try:
            return dataclasses.asdict(C.apply_overrides(C.ExperimentConfig(), overrides))
        except TypeError as e:
            return ("TypeError", str(e))
    assert run(TC) == run(JC)
    cfg = TC.ExperimentConfig()
    TC.apply_overrides(cfg, {"train.lr": 5e-5})
    assert cfg.train.lr == 1e-4      # the original is untouched


# ---------------------------------------------------------------------------
# the initial weights from a checkpoint set
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_import_initial_params_matches_jax(precision, tmp_path):
    """A checkpoint set in the reference's layouts (HF LLaVA dir, CLIP dir,
    hub DINOv2 on a 2 x 2 grid, LLM-Seg DeepSpeed with LoRA) written from
    seeded weights at ``llmseg_tiny``: the port's model equals, every
    parameter to the bit, the one ``from_jax`` makes of the JAX CLI's tree;
    the DINOv2 position table resized to 4 x 4 is the port's own resize to
    the bit and JAX's within 1e-6 (``tests/test_torch_import.py``: float64
    against float32 bicubic weights), within a bf16 step in bf16."""
    jcfg, tcfg = _seg_cfgs()
    src = _filled(tllmseg.build(tcfg, device="cpu", lora_cfg=TC.LoraConfig()), 7, scale=0.05)
    pos_hub = torch.tensor(np.random.RandomState(8).randn(1, 5, 32) * 0.05, dtype=torch.float32)
    paths = CS.write_checkpoints(str(tmp_path), src, tsam.build(TC.sam_tiny(), device="cpu"),
                                 pos_hub)
    argv = ["--version", paths["llava"], "--clip_dir", paths["clip"], "--dinov2_ckpt",
            paths["dinov2"], "--resume_ckpt", paths["llmseg"], "--precision", precision]
    jargs = jcommon.build_parser("t").parse_args(argv)
    targs = tcommon.build_parser("t").parse_args(argv + ["--device", "cpu"])
    jtree = jcommon.import_initial_params(jargs, JC.ExperimentConfig(model=jcfg),
                                          JC.LoraConfig())
    got = tcommon.import_initial_params(targs, TC.ExperimentConfig(model=tcfg), TC.LoraConfig())
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    ref = load_(tllmseg.build(tcfg, device="cpu", dtype=dtype, lora_cfg=TC.LoraConfig()),
                jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), jtree))
    gp, rp = dict(got.named_parameters()), dict(ref.named_parameters())
    assert set(gp) == set(rp) and all(p.device.type == "cpu" for p in gp.values())
    for name in gp:
        assert gp[name].dtype == dtype, name
        if name != "dino.pos_embed":
            assert torch.equal(gp[name], rp[name]), name
    pos = gp["dino.pos_embed"]
    assert torch.equal(pos, TI.interpolate_pos_embed(pos_hub, 2, 4).to(dtype))
    np.testing.assert_allclose(pos.detach().float().numpy(), rp["dino.pos_embed"].detach().float()
                               .numpy(), atol=POS_TOL, rtol=0 if precision == "fp32" else 2 ** -8)


# ---------------------------------------------------------------------------
# train, finetune and validate end to end
# ---------------------------------------------------------------------------


def _masks_doc(names, rng, h=60, w=80, k=5):
    path_doc = []
    for name in names:
        masks = []
        for _ in range(k):
            m = np.zeros((h, w), np.uint8)
            y, x = rng.randint(0, h - 20), rng.randint(0, w - 20)
            m[y:y + rng.randint(6, 20), x:x + rng.randint(6, 20)] = 1
            r, area, bbox = trle.encode_stats(m)
            masks.append({"segmentation": r, "area": area, "bbox": bbox,
                          "predicted_iou": 0.9, "stability_score": 0.95,
                          "point_coords": [[1.0, 1.0]], "crop_box": [0, 0, w, h]})
        path_doc.append({"image": name, "target_size": [h, w], "masks": masks})
    return path_doc


def write_reason_seg(root, rng, n=3):
    """ReasonSeg's layout: dataset/reason_seg/ReasonSeg/{train,val}/img*.jpg
    with their polygon json, sam_masks/ReasonSeg_{train,val}_masks.json."""
    for split in ("train", "val"):
        d = root / "dataset" / "reason_seg" / "ReasonSeg" / split
        names = []
        for i in range(n):
            write_jpg(d / f"img{i}.jpg", rng)
            (d / f"img{i}.json").write_text(json.dumps({
                "shapes": [{"label": "target",
                            "points": [[5, 5], [30 + i, 5], [30, 30 + i], [5, 30]]}],
                "text": [f"the thing {i}"], "is_sentence": bool(i % 2)}))
            names.append(f"img{i}.jpg")
        (root / "sam_masks").mkdir(exist_ok=True)
        (root / "sam_masks" / f"ReasonSeg_{split}_masks.json").write_text(
            json.dumps(_masks_doc(names, rng)))
    return root


def write_llmseg40k(root, rng, n_train=3, n_val=3):
    """LLM-Seg40K's layout: dataset/llm_seg/{train,validation}.json, images
    under dataset/coco/train2017 and dataset/ego_objects/images, and
    sam_masks/{llmseg40k_train,llmseg40k_val,egoobjects}_masks.json."""
    data = root / "dataset"
    docs = {"llmseg40k_train": [], "llmseg40k_val": [], "egoobjects": []}
    for split, count, key in (("train", n_train, "llmseg40k_train"),
                              ("validation", n_val, "llmseg40k_val")):
        doc = {}
        for i in range(count):
            src = "coco" if i % 2 == 0 else "ego_objects"
            name = f"{split}_{src}_{i}.jpg"
            sub = "coco/train2017" if src == "coco" else "ego_objects/images"
            write_jpg(data / sub / name, rng)
            gt = np.zeros((60, 80), np.uint8)
            gt[5 + i:30, 3:40 + i] = 1
            doc[name] = {"from_dataset": src, "qa_pairs": [
                {"question": f"What would hold item {i}?", "answer": "The box [SEG].",
                 "rle_seg": trle.encode(gt)}]}
            docs[key if src == "coco" else "egoobjects"].append(name)
        (data / "llm_seg").mkdir(parents=True, exist_ok=True)
        (data / "llm_seg" / f"{split}.json").write_text(json.dumps(doc))
    (root / "sam_masks").mkdir(exist_ok=True)
    for key, names in docs.items():
        (root / "sam_masks" / f"{key}_masks.json").write_text(json.dumps(_masks_doc(names, rng)))
    return root


def _weights(jcfg, lora_cfg, seed=1):
    """llmseg.init of the run's config, LoRA drawn from numpy and every leaf
    jittered (tests/test_torch_loader.py's recipe), as numpy."""
    p = jllmseg.init(jax.random.PRNGKey(0), jcfg, lora_cfg=lora_cfg)
    rng = np.random.RandomState(seed)
    p["lora"] = jax.tree.map(lambda x: rng.randn(*np.shape(x)) / np.sqrt(np.shape(x)[0]),
                             p["lora"])
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.randn(*np.shape(x))).astype(np.float32), p)


class Runs:
    """Both CLIs patched to start from the same weights, with every
    ``train_epoch``, ``validate``, score and calibration recorded."""

    def __init__(self, monkeypatch):
        self.tree = None
        self.log = {"jax": [], "port": []}
        mp = monkeypatch

        def jweights(args, cfg, lora_cfg):
            if self.tree is None:
                self.tree = _weights(cfg.model, lora_cfg)
            return jax.tree.map(jnp.asarray, self.tree)

        def tweights(args, cfg, lora_cfg):
            return load_(tllmseg.build(cfg.model, device=args.device, lora_cfg=lora_cfg),
                         self.tree)

        mp.setattr(jcommon, "import_initial_params", jweights)
        mp.setattr(tcommon, "import_initial_params", tweights)
        for side, trainer, ev, model_mod in (("jax", JTrainer, jeval, jllmseg),
                                             ("port", TTrainer, teval, tllmseg)):
            self._record(mp, side, trainer, "train_epoch", "train")
            self._record(mp, side, trainer, "validate", "val")
            self._record(mp, side, model_mod, "calibrate_quant_stats", "stats")
            run_validation = ev.run_validation

            def scored(step, params, batches, *a, _side=side, _rv=run_validation, **kw):
                def rec(p, b):
                    out = step(p, b)
                    self.log[_side].append(("scores", {
                        k: v.detach().float().numpy() if isinstance(v, torch.Tensor)
                        else np.asarray(v) for k, v in out.items()}))
                    return out
                return _rv(rec, params, batches, *a, **kw)
            mp.setattr(ev, "run_validation", scored)

    def _record(self, mp, side, owner, attr, tag):
        fn = getattr(owner, attr)

        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            self.log[side].append((tag, out))
            return out
        mp.setattr(owner, attr, wrapped)

    def take(self, side, tag):
        out = [v for t, v in self.log[side] if t == tag]
        self.log[side] = [(t, v) for t, v in self.log[side] if t != tag]
        return out


def _assert_meters_close(jm, tm):
    assert len(jm) == len(tm) > 0
    for j, t in zip(jm, tm):
        assert set(j) == set(t)
        for k in j:
            assert np.isfinite(t[k])
            np.testing.assert_allclose(t[k], j[k], rtol=METER_RTOL, atol=0, err_msg=k)


def _common_argv(root, name):
    return ["--model_size", "tiny", "--precision", "fp32", "--lora_dropout", "0",
            "--dataset_dir", str(root / "dataset"), "--sam_masks_dir", str(root / "sam_masks"),
            "--epochs", "1", "--steps_per_epoch", "2", "--grad_accumulation_steps", "1",
            "--warmup_steps", "1", "--image_size", "56", "--model_max_length", "480",
            "--mesh_dp", "1", "--exp_name", name]


def _both(runs, jmain, tmain, argv, root):
    jout = jmain(argv + ["--log_base_dir", str(root / "jax")])
    tout = tmain(argv + ["--log_base_dir", str(root / "port"), "--device", "cpu"])
    return jout, tout


def test_train_matches_jax(tmp_path, monkeypatch):
    """``train`` on a ReasonSeg-layout corpus: one epoch of two steps and
    the val loop (three images in one batch of 8, the filler rows marked
    invalid), then the best checkpoint; the meters agree, the scores
    agree."""
    root = write_reason_seg(tmp_path, np.random.RandomState(0))
    runs = Runs(monkeypatch)
    argv = _common_argv(root, "t1") + ["--dataset", "reason_seg", "--sample_rates", "1",
                                       "--num_classes_per_sample", "1"]
    _both(runs, jtrain.main, ttrain.main, argv, root)
    _assert_meters_close(runs.take("jax", "train"), runs.take("port", "train"))
    jv, tv = runs.take("jax", "val"), runs.take("port", "val")
    assert len(jv) == len(tv) == 1
    assert tv[0] == {k: float(v) for k, v in jv[0].items()}
    assert (root / "port" / "t1" / "best_meta.json").is_file()
    assert (root / "port" / "t1" / "ckpt" / "latest").is_file()


def test_quantized_training_is_refused():
    base = ["--model_size", "tiny", "--device", "cpu"]
    for argv in (["--load_8bit"], ["--eval_only", "--w8a8"],
                 ["--eval_only", "--load_4bit", "--w8a8"]):
        with pytest.raises(SystemExit):
            ttrain.main(base + argv)
