"""A cell for a few seconds on the card, through the command.

Run on the card:
python -m pytest -m cuda portbench/tests/test_portbench_cuda.py
"""

import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

pytestmark = pytest.mark.cuda


def test_a_cell_runs_on_the_card_and_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "flat-1m-768.b64",
         "--seed", str(2 ** 31 + 21), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, proc.stderr[-4000:]
    assert result["device"]["platform"] == "gpu"
    assert result["metrics"]["ops_per_s"]["value"] > 0
