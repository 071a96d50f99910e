"""The import guard, and the harness without the program or a card."""

import os
import shutil
import subprocess
import sys
import types

from portbench import core
from portbench.tests.conftest import ROOT


def test_guard_passes_with_the_port_loaded():
    import jepsen_tpu_torch.checker.linearizable  # noqa: F401

    assert "jepsen_tpu_torch" in sys.modules
    assert core.forbidden_modules() == []


def test_guard_fails_with_a_jax_package_module():
    sys.modules["jepsen_tpu.x"] = types.ModuleType("jepsen_tpu.x")
    try:
        assert core.forbidden_modules() == ["jepsen_tpu.x"]
    finally:
        del sys.modules["jepsen_tpu.x"]
    assert core.forbidden_modules({"jax.numpy": 1, "jaxtyping": 1,
                                   "flax": 1}) == ["flax", "jax.numpy"]


def test_no_result_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and portbench/: no result
    line and a nonzero exit."""
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(tmp_path, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "keyed-independent", "--seed", "1", "--seconds", "1",
         "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode != 0
    assert "correct" not in p.stdout
