"""The harness finds a configuration, a traffic mix and a per-layer
metric added as new files, with no file that was there edited; and it
runs every cell of BENCHMARK.json on the CPU."""

import json
import os

import pytest

from portbench import spec
from portbench.tests._tiny import run, tiny_checkout


def _snapshot(pkg):
    out = {}
    for d, _, files in os.walk(pkg):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[p] = fh.read()
    return out


def test_new_files_are_found_by_name(tmp_path):
    root = tiny_checkout(tmp_path)
    pkg = os.path.join(root, "portbench")
    before = _snapshot(pkg)
    cfg = json.load(open(os.path.join(pkg, "configs", "etcd-keyed.json")))
    cfg.update(name="etcd-keyed-narrow", keys=3, concurrency=5)
    json.dump(cfg, open(os.path.join(pkg, "configs", "narrow.json"), "w"))
    json.dump({"generator": "keyed", "entry": "independent",
               "pool": 2, "corrupt_every": 4,
               "corrupt": [[0, 1, 0.5]]},
              open(os.path.join(pkg, "traffic", "burst.json"), "w"))
    with open(os.path.join(pkg, "metrics", "checks_answered.py"), "w") as f:
        f.write("def read(run):\n"
                "    return float(sum(r.verdict is not None"
                " for r in run.records))\n")
    found = spec.discover(pkg)
    assert "narrow" in found["configs"]
    assert "burst" in found["traffic"]
    assert "checks_answered" in found["metrics"]
    assert "_kernel_a" not in found["metrics"]
    # the new cell, in BENCHMARK.json only
    bench_path = os.path.join(root, "BENCHMARK.json")
    bench = json.load(open(bench_path))
    bench["configs"].append({"name": "etcd-keyed-narrow", "source": "x",
                             "file": "portbench/configs/narrow.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "narrow-burst",
                               "config": "etcd-keyed-narrow",
                               "traffic": "burst", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "checks_answered", "unit": "count",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "x", "moves": "ops_per_s",
                               "workloads": ["narrow-burst"]})
    json.dump(bench, open(bench_path, "w"))
    res = run(root, "narrow-burst", trace=True)
    assert res["correct"]
    assert res["metrics"]["checks_answered"]["value"] == res["attempted"]
    after = _snapshot(pkg)
    for path, data in before.items():
        assert after[path] == data, path


@pytest.mark.parametrize("workload", [
    w["name"] for w in json.load(open(os.path.join(
        os.path.dirname(spec.PKG), "BENCHMARK.json")))["workloads"]])
def test_every_cell_runs_on_the_cpu(tmp_path, workload):
    root = tiny_checkout(tmp_path)
    res = run(root, workload)
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) >= {"ops_per_s", "setup_s"}
    assert "build_s" in res
    traced = run(root, workload, trace=True)
    assert traced["correct"]
    assert "ops_per_s" not in traced["metrics"]
