"""Finds everything by name: a cell in BENCHMARK.json, its configuration
file, its traffic mix (traffic/<name>.json), the systems module that
drives its configuration (systems/<system>.py) and each metric's reader
(metrics/<metric>.py). Adding one of these is adding files and entries;
nothing here names a cell."""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _name(name: str) -> str:
    if not NAME.fullmatch(name) or ".." in name:
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


@dataclass
class Cell:
    """One workload of BENCHMARK.json with what it names, resolved."""

    name: str
    chips: int
    cfg: dict
    traffic: dict
    end_to_end: List[dict]        # the metric entries this cell reports
    per_layer: List[dict]


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell `name`: its configuration and traffic loaded, and the
    metrics it reports (an entry's `workloads`, where given, lists the
    cells; a per-layer metric without one is reported wherever the
    end-to-end metric it moves is)."""
    try:
        w = next(w for w in bench["workloads"] if w["name"] == name)
    except StopIteration:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json") from None
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(root / entry["file"]) as f:
        cfg = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return Cell(name=name, chips=int(w["chips"]), cfg=cfg,
                traffic=traffic(w["traffic"]), end_to_end=e2e,
                per_layer=per_layer)


def traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{_name(name)}.json") as f:
        return json.load(f)


def _module(kind: str, name: str):
    path = HERE / kind / f"{_name(name)}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def system(name: str):
    """The module that makes a configuration's inputs, builds and drives
    its system under test and judges its answers."""
    return _module("systems", name)


def metric(name: str):
    """A metric's reader: its module's read(run) returns the value, or
    None where the run holds nothing to read."""
    return _module("metrics", name)
