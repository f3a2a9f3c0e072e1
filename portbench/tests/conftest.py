"""Cells of BENCHMARK.json cut to a size the CPU runs in a second: the
same configuration, traffic and metrics, with fewer and narrower rows."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import registry  # noqa: E402

TINY_ROWS = {"rows": 6000, "dim": 64, "centers": 120}
TINY_IVF = {"nlist": 16, "nprobe": 4}
TINY_POOL = 256


def tiny(name: str, **cfg) -> registry.Cell:
    """The cell `name` at a CPU size: 6,000 rows of width 64, a pool of
    256 queries, the IVF index at 16 lists; the flat index on its int8
    path (auto takes the exact product off the card). No expect_info: it
    states the full-size index."""
    cell = copy.deepcopy(registry.cell(registry.benchmark(), name))
    cell.cfg.update(TINY_ROWS, **cfg)
    cell.cfg.pop("expect_info", None)
    idx = cell.cfg["index"]
    idx.update(TINY_IVF if "nlist" in idx else {"search_path": "quant"})
    cell.traffic["pool"] = TINY_POOL
    return cell


@pytest.fixture
def cpu():
    return torch.device("cpu")
