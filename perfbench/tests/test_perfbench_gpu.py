"""On the card: the control and the faults fail ``correct`` at each cell's own
size, on three seeds, and sound runs pass it; a whole run through the command
prints a correct result.  Each test skips itself where PyTorch sees no card:

    python -m pytest -m gpu perfbench/tests/test_perfbench_gpu.py -q
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import readings
from perfbench.core import check, spec

pytestmark = pytest.mark.gpu
ROOT = Path(__file__).resolve().parents[2]
WORKLOADS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
# faults each limit is set to catch on every seed; one answer given another
# frame's (``one_misplaced``) is caught on most seeds only, since frames of
# noise get answers alike (PERF.md, section 2)
CAUGHT = ("misplaced", "altered", "half", "one_altered")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_and_faults_fail_and_sound_runs_pass(workload):
    _card()
    cell = spec.cell(workload)
    limits = cell.config["checks"]["limits"]
    for seed in (2**31 + 901, 2**31 + 902, 2**31 + 903):
        r = readings.reading(cell, seed, 2.0, "cuda")
        assert check.verdict(r["program"], limits)[0], r["program"]
        assert not check.verdict(r["control"], limits)[0], r["control"]
        for name in CAUGHT:
            assert not check.verdict(r["faults"][name], limits)[0], (name, r["faults"][name])


def test_a_run_through_the_command():
    _card()
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", WORKLOADS[0], "--seed",
         str(2**31 + 905), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["failed"] == 0
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
