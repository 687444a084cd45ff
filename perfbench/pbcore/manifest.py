"""The manifest (``BENCHMARK.json``) and the files it names, found by name:
``configs/<config>.json`` (through the manifest's ``file``),
``workloads/<cell>.json`` (the entry, the traffic's parameters and the
limits of the check), ``entries/<entry>.py`` and ``metrics/<metric>.py``."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict                  # the configuration document
    work: Dict                    # the workload file: entry, traffic, check
    end_to_end: List[Dict]        # the manifest's end-to-end metrics this cell reports
    per_layer: List[Dict]         # ... and its per-layer metrics
    bench_dir: Path

    @property
    def traffic(self) -> Dict:
        return self.work["traffic"]

    def entry(self) -> ModuleType:
        return load_module(self.bench_dir / "entries" / f"{self.work['entry']}.py",
                           f"pb_entry_{self.work['entry']}")

    def metric_reader(self, name: str) -> ModuleType:
        return load_module(self.bench_dir / "metrics" / f"{name}.py",
                           "pb_metric_" + name.replace(".", "_").replace("-", "_"))


def _covers(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s manifest."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    bench_dir = root / manifest["paths"][0]
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    work = json.loads((bench_dir / "workloads" / f"{name}.json").read_text())
    return Cell(name=name, chips=w["chips"], config=config, work=work,
                end_to_end=[m for m in manifest["end_to_end"] if _covers(m, name)],
                per_layer=[m for m in manifest["per_layer"] if _covers(m, name)],
                bench_dir=bench_dir)
