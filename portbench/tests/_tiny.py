"""A checkout in a temporary directory: a copy of portbench/ and
BENCHMARK.json whose configurations are cut to sizes the CPU's plain
kernels check in milliseconds, the program linked in beside them.

Each configuration's CPU size is a file of its own,
`tests/tiny/<config name>.json`: the keys it overrides in the
configuration's file (fewer and shorter keys, a shorter history, the
nemesis's clock scaled down with them). A configuration added to
BENCHMARK.json brings its tiny file with it."""

import json
import os
import shutil

from portbench.tests.conftest import ROOT

TINY_DIR = os.path.join("portbench", "tests", "tiny")


def tiny_sizes(root: str, name: str) -> dict:
    """The CPU sizes of configuration `name`, from the checkout at
    `root`."""
    path = os.path.join(root, TINY_DIR, name + ".json")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"configuration {name!r} has no CPU size for the tests: add "
            f"{path}")
    with open(path) as f:
        return json.load(f)


def copy_checkout(dst: str, src: str = ROOT) -> str:
    """portbench/ and BENCHMARK.json of `src` copied to `dst`, the
    program linked in beside them; returns `dst`."""
    shutil.copytree(os.path.join(src, "portbench"),
                    os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "jepsen_tpu_torch"),
               os.path.join(dst, "jepsen_tpu_torch"))
    shutil.copy(os.path.join(src, "BENCHMARK.json"), dst)
    return dst


def tiny_checkout(tmp, src: str = ROOT) -> str:
    """A copy of the checkout at `src` with every configuration of its
    BENCHMARK.json cut to its tiny file's sizes."""
    root = copy_checkout(os.path.join(str(tmp), "checkout"), src)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        path = os.path.join(root, c["file"])
        with open(path) as f:
            cfg = json.load(f)
        cfg.update(tiny_sizes(root, c["name"]))
        with open(path, "w") as f:
            json.dump(cfg, f)
    return root


def config(name="etcd-keyed", **over):
    """A configuration of the benchmark, cut to the tests' size."""
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as f:
        cfg = json.load(f)
    cfg.update(tiny_sizes(ROOT, name))
    cfg.update(over)
    return cfg


def run(root, workload, seed=7, seconds=1.0, trace=False, entry=None):
    from portbench import core

    return core.run_cell(root, workload, seed, seconds, trace,
                         device="cpu", pkg=os.path.join(root, "portbench"),
                         judge_processes=1, entry=entry)


def control_readings(root, workload, name, seed=7, seconds=1.0):
    """The control `name`, found by name among those of the cell's
    configuration, in the program's place through the harness's run."""
    from portbench import control

    return control.readings(root, workload, seed, seconds, 1, name,
                            pkg=os.path.join(root, "portbench"))
