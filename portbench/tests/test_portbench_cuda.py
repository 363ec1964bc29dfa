"""On the card only: one short run of each cell through the benchmark's
command, which must print a correct result as its last line."""

import json
import subprocess
import sys

import pytest

from portbench.harness.common import ROOT, Manifest


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python3 -m pytest "
                    "portbench/tests -m cuda)")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in Manifest().data["workloads"]])
def test_cell_runs_correct(card, cell):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell,
                          "--seed", "2147483659", "--seconds", "5", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result
