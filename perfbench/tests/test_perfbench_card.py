"""Each cell, run as the check runs it, on the card: the command ends with
a result line that is correct and names the card."""

import json
import subprocess
import sys

import pytest

from perfbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", [w["name"] for w in harness.manifest()["workloads"]])
def test_a_cell_runs_correct(name, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", name, "--seed",
                          "3000000099", "--seconds", "3", "--trace", str(trace)],
                         cwd=str(harness.CHECKOUT), capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu", result
    assert result["metrics"]
