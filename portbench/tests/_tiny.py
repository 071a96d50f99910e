"""A checkout in a temporary directory: a copy of portbench/ and
BENCHMARK.json whose configuration is cut to sizes the CPU's plain
kernels check in milliseconds (fewer and shorter keys, the nemesis's
clock scaled down with them), the program linked in beside them."""

import json
import os
import shutil

from portbench.tests.conftest import ROOT

TINY = {
    "etcd-keyed": {"keys": 6, "ops_per_key": 60, "nemesis_interval_s": 0.5,
                   "timeout_s": 0.25, "election_s": 0.05},
}


def tiny_checkout(tmp) -> str:
    root = os.path.join(str(tmp), "checkout")
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "jepsen_tpu_torch"),
               os.path.join(root, "jepsen_tpu_torch"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        path = os.path.join(root, c["file"])
        with open(path) as f:
            cfg = json.load(f)
        cfg.update(TINY[c["name"]])
        with open(path, "w") as f:
            json.dump(cfg, f)
    return root


def config(name="etcd-keyed", **over):
    """A configuration of the benchmark, cut to the tests' size."""
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as f:
        cfg = json.load(f)
    cfg.update(TINY[name])
    cfg.update(over)
    return cfg


def run(root, workload, seed=7, seconds=1.0, trace=False, entry=None):
    from portbench import core

    return core.run_cell(root, workload, seed, seconds, trace,
                         device="cpu", pkg=os.path.join(root, "portbench"),
                         judge_processes=1, entry=entry)
