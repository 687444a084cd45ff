"""The manifest's rules, and that a new configuration, cell and metric
are found by name with no file edited."""

import json
import re
import shutil
from pathlib import Path

from pbcore import manifest

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_names_units_and_keys():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        assert (ROOT / b["paths"][0] / "metrics" / f"{m['name']}.py").exists()
    for w in b["workloads"]:
        assert (ROOT / b["paths"][0] / "workloads" / f"{w['name']}.json").exists()
    for c in b["configs"]:
        assert c["file"].startswith(b["paths"][0] + "/") and (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in _bench()["workloads"]:
        cell = manifest.load(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    """A copy of the benchmark with one more configuration, cell and
    metric: only new files and new manifest entries."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = _bench()
    cfg = json.loads((ROOT / "perfbench/configs/llmseg_mistral7b.json").read_text())
    cfg["name"] = "llmseg_other"
    (root / "perfbench/configs/llmseg_other.json").write_text(json.dumps(cfg))
    work = json.loads((ROOT / "perfbench/workloads/llmseg_mistral7b.predict_b4.json").read_text())
    work["traffic"]["images_per_batch"] = 8
    (root / "perfbench/workloads/llmseg_other.predict_b8.json").write_text(json.dumps(work))
    (root / "perfbench/metrics/steps.predict.py").write_text("def read(ctx):\n    return ctx.steps\n")
    b["configs"].append({"name": "llmseg_other", "source": "x", "file":
                         "perfbench/configs/llmseg_other.json", "reduced": [], "why": "x"})
    b["workloads"].append({"name": "llmseg_other.predict_b8", "config": "llmseg_other",
                           "traffic": "predict_b8", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "steps.predict", "unit": "count", "better": "lower",
                           "source": "program_counter", "layer": "entry", "moves":
                           "predict_img_per_s", "workloads": ["llmseg_other.predict_b8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = manifest.load("llmseg_other.predict_b8", root)
    assert cell.config["name"] == "llmseg_other" and cell.traffic["images_per_batch"] == 8
    assert [m["name"] for m in cell.per_layer] == ["steps.predict"]
    assert cell.metric_reader("steps.predict").read(type("C", (), {"steps": 3})) == 3
    assert hasattr(cell.entry(), "Entry")
