"""BENCHMARK.json, and finding what it names by name."""

import json
import re

import pytest

from portbench import registry

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def test_every_cell_resolves_to_its_files():
    bench = registry.benchmark()
    for w in bench["workloads"]:
        cell = registry.cell(bench, w["name"])
        assert cell.cfg["name"] == w["config"]
        assert registry.system(cell.cfg["system"]).build
        assert cell.traffic["batch"] >= 1
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        for m in cell.end_to_end + cell.per_layer:
            assert callable(registry.metric(m["name"]).read)


def test_names_units_and_bounds_keep_to_the_contract():
    bench = registry.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.fullmatch(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    reported = {w["name"]: {m["name"] for m in bench["end_to_end"]
                            if w["name"] in m.get("workloads", [w["name"]])}
                for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert all(m["moves"] in reported[c] for c in m["workloads"])
    for c in bench["configs"]:
        with open(registry.ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    assert len(json.dumps(bench)) < 64 * 1024


def test_a_name_cannot_leave_its_folder():
    for bad in ("../BENCHMARK", "a/b", "", ".hidden/x"):
        with pytest.raises(ValueError):
            registry.traffic(bad)
    with pytest.raises(KeyError):
        registry.cell(registry.benchmark(), "no-such-cell")
