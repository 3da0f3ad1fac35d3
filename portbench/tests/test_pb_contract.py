"""BENCHMARK.json keeps the shape its checker refuses a file over: keys,
names, units, lengths, bounds, and which metric each cell reports."""

from __future__ import annotations

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    for w in BENCH["command"]:
        assert not w.startswith("/") and ".." not in w
        if "/" in w:
            assert any(w.startswith(p + "/") for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_configs_and_cells():
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] in (1, 4) and _line(w["why"])
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    assert {w["config"] for w in cells} == set(names)


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = BENCH["end_to_end"]
    layer = BENCH["per_layer"]
    all_names = [m["name"] for m in e2e + layer]
    assert len(set(all_names)) == len(all_names)
    assert 1 <= len(e2e) <= 16 and 1 <= len(layer) <= 128
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in e2e)
    e2e_names = {m["name"] for m in e2e}
    for m in layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e_names and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in e2e + layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
        assert set(m.get("workloads", [])) <= cells
    for w in cells:
        mine = [m for m in e2e if w in m.get("workloads", [w])]
        assert len(mine) >= 2 and "setup_s" in {m["name"] for m in mine}
        moved = {m["name"] for m in mine}
        per = [m for m in layer if w in m.get("workloads", [w] if m["moves"] in moved else [])]
        assert per and all(m["moves"] in moved for m in per)
    for m in layer:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_files_under_paths_are_named_from_names():
    for p in (ROOT / "portbench").rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
