"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's file is the one its ``configs`` entry gives; the mix is
``mixes/<traffic>.json``, whose ``driver`` key names
``drivers/<driver>.py``; a per-layer metric ``<name>`` is read by
``metrics/<name>.py``; a configuration with a ``model_type`` (a served
LM) is built, counted and judged by ``archs/<model_type>.py``.  Nothing
here knows a cell, a mix, a metric or an architecture by name, so a new
one is new files and new entries.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parents[1]  # portbench/
ROOT = HERE.parent  # the checkout


@dataclass
class Cell:
    name: str
    chips: int
    traffic: str
    config: Dict[str, Any]
    mix: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    files: Dict[str, Path] = field(default_factory=dict)

    @property
    def driver(self) -> str:
        return self.mix["driver"]


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, bench: Optional[Dict[str, Any]] = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, mix and the metrics it
    reports: the end-to-end metrics that list it (or list no cells), and
    the per-layer metrics that list it (or, listing none, move an
    end-to-end metric the cell reports)."""
    bench = bench if bench is not None else load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload '{name}' in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    cfg_path = root / cfg_entry["file"]
    mix_path = root / "portbench" / "mixes" / f"{w['traffic']}.json"
    mix = json.loads(mix_path.read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [
        m for m in bench["per_layer"]
        if (name in m["workloads"] if "workloads" in m else m["moves"] in names)
    ]
    cell = Cell(
        name=name, chips=int(w["chips"]), traffic=w["traffic"],
        config=json.loads(cfg_path.read_text()), mix=mix, end_to_end=e2e,
        per_layer=per_layer,
    )
    cell.files = {
        "config": cfg_path,
        "mix": mix_path,
        "driver": driver_path(cell.driver, root),
        **{f"metric:{m['name']}": metric_path(m["name"], root) for m in per_layer},
    }
    if "model_type" in cell.config:
        cell.files["arch"] = arch_path(cell.config["model_type"], root)
    return cell


def driver_path(driver: str, root: Path = ROOT) -> Path:
    return root / "portbench" / "drivers" / f"{driver}.py"


def metric_path(metric: str, root: Path = ROOT) -> Path:
    return root / "portbench" / "metrics" / f"{metric}.py"


def arch_path(model_type: str, root: Path = ROOT) -> Path:
    return root / "portbench" / "archs" / f"{model_type}.py"


def load_file(path: Path, prefix: str) -> ModuleType:
    """Import ``path`` as a module of its own (metric names hold dots)."""
    mod_name = f"portbench.{prefix}." + path.stem.replace(".", "_").replace("-", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_driver(cell: Cell) -> ModuleType:
    return load_file(cell.files["driver"], "drivers")


def load_metric(name: str, root: Path = ROOT) -> ModuleType:
    return load_file(metric_path(name, root), "metrics")


def load_arch(model_type: str, root: Path = ROOT) -> ModuleType:
    """The architecture module of ``model_type``; an unknown one fails
    here, naming the path looked for."""
    path = arch_path(model_type, root)
    if not path.is_file():
        raise FileNotFoundError(f"no architecture module for model_type {model_type!r}: "
                                f"{path} does not exist")
    return load_file(path, "archs")
