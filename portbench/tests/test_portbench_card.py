"""Each cell end to end on the card, for a few seconds: the command
as the benchmark runs it. Needs an NVIDIA card; skips without one."""

import json
import os
import subprocess
import sys

import pytest

from portbench.tests.conftest import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(workload, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", "2147483999", "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
    if trace:
        assert res["device"]["busy_s"] > 0
        assert "breakdown" in res
