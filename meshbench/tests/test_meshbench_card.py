"""The benchmark's command on the card: one short traced run of each cell,
correct, with the device named in the result."""
import json
import subprocess
import sys

import pytest

from meshbench.registry import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["vae5k.train", "vae80k.train"])
def test_command_runs_a_cell_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "meshbench.run", "--workload", workload,
         "--seed", str(2**31 + 5), "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().split("\n")[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0


def test_command_refuses_without_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("the card is here")
    out = subprocess.run(
        [sys.executable, "-m", "meshbench.run", "--workload", "vae5k.train",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
