"""BENCHMARK.json against its required shape, every entry resolved to its
files, and a cell added as data alone."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench.tests import tiny  # noqa: F401 - puts src/ on the path
from portbench.harness import cells

ROOT = cells.ROOT
BENCH = cells.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|_rank$|head|expan|experts_per)")


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_shape():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["command"][:1] == ["python3"] and len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    for word in BENCH["command"][1:]:
        assert any(word == p or word.startswith(p + "/") for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_configs_and_workloads():
    used = {w["config"] for w in BENCH["workloads"]}
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert _line(c["source"]) and _line(c["why"]) and c["name"] in used
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTH.search(k), k
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    pairs = set()
    fours = 0
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4) and w["config"] in names
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        fours += w["chips"] == 4
    assert fours <= max(1, len(BENCH["workloads"]) // 4)
    assert 1 <= len(BENCH["workloads"]) <= 24


def test_metrics_shape():
    cell_names = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    seen = set()
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cell_names
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert "workloads" not in moved or w in moved["workloads"], (m["name"], w)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(name):
    cell = cells.resolve(name)
    for path in cell.files.values():
        assert path.is_file(), path
        assert path.resolve().is_relative_to((ROOT / "portbench").resolve())
    assert hasattr(cells.load_driver(cell), "Bench")
    for m in cell.per_layer:
        assert callable(cells.load_metric(m["name"]).read)
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer


def test_throwaway_cell_is_found_as_data(tmp_path):
    """A new cell, mix, driver and metric are new files and entries: the
    harness finds them without an edit to a file that exists."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "mlda-paper-throwaway", "config": "tohoku-paper",
                               "traffic": "throwaway", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "throwaway_rounds", "unit": "rounds", "better": "higher",
                               "source": "program_counter", "layer": "ensemble driver",
                               "moves": "fine_samples_per_s",
                               "workloads": ["mlda-paper-throwaway"]})
    bench["end_to_end"][0]["workloads"].append("mlda-paper-throwaway")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.loads((ROOT / "portbench/mixes/paper.json").read_text())
    mix["driver"] = "throwaway_driver"
    (root / "portbench/mixes/throwaway.json").write_text(json.dumps(mix))
    (root / "portbench/drivers/throwaway_driver.py").write_text("class Bench:\n    pass\n")
    (root / "portbench/metrics/throwaway_rounds.py").write_text(
        "def read(facts, trace):\n    return facts.get('rounds')\n")
    cell = cells.resolve("mlda-paper-throwaway", root=root)
    assert cell.driver == "throwaway_driver"
    assert [m["name"] for m in cell.per_layer][-1] == "throwaway_rounds"
    assert cells.load_file(cell.files["driver"], "throwaway").Bench
    assert cells.load_metric("throwaway_rounds", root).read({"rounds": 3}, None) == 3
