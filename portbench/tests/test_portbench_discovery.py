"""The harness finds a configuration, a traffic mix, a per-layer metric
and the configuration's CPU size added as new files, with no file that
was there edited; every configuration has its CPU size; and the harness
runs every cell of BENCHMARK.json on the CPU."""

import json
import os

import pytest

from portbench import spec
from portbench.tests._tiny import (copy_checkout, run, tiny_checkout,
                                   tiny_sizes)
from portbench.tests.conftest import ROOT


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
    """A configuration, a traffic mix, a per-layer metric and the
    configuration's CPU size, added as new files with new entries in
    BENCHMARK.json before the tests' checkout is made: the harness and
    the tests' checkout find them all, and every file that was there is
    byte-identical."""
    src = copy_checkout(os.path.join(str(tmp_path), "src"))
    pkg = os.path.join(src, "portbench")
    before = _snapshot(pkg)
    cfg = json.load(open(os.path.join(pkg, "configs", "etcd-keyed.json")))
    cfg.update(name="etcd-keyed-narrow", keys=3, concurrency=5)
    json.dump(cfg, open(os.path.join(pkg, "configs", "narrow.json"), "w"))
    json.dump({"keys": 3, "ops_per_key": 40, "nemesis_interval_s": 0.5,
               "timeout_s": 0.25, "election_s": 0.05},
              open(os.path.join(pkg, "tests", "tiny",
                                "etcd-keyed-narrow.json"), "w"))
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
    bench_path = os.path.join(src, "BENCHMARK.json")
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
    root = tiny_checkout(tmp_path, src=src)
    narrow = json.load(open(os.path.join(root, "portbench", "configs",
                                         "narrow.json")))
    assert narrow["ops_per_key"] == 40 and narrow["keys"] == 3
    res = run(root, "narrow-burst", trace=True)
    assert res["correct"]
    assert res["metrics"]["checks_answered"]["value"] == res["attempted"]
    after = _snapshot(pkg)
    for path, data in before.items():
        assert after[path] == data, path


def test_every_configuration_has_its_cpu_size():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for c in bench["configs"]:
        sizes = tiny_sizes(ROOT, c["name"])
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert sizes and set(sizes) <= set(cfg), c["name"]


def test_a_configuration_without_its_cpu_size_is_named(tmp_path):
    src = copy_checkout(os.path.join(str(tmp_path), "src"))
    bench_path = os.path.join(src, "BENCHMARK.json")
    bench = json.load(open(bench_path))
    bench["configs"].append(dict(bench["configs"][0], name="no-tiny"))
    json.dump(bench, open(bench_path, "w"))
    with pytest.raises(FileNotFoundError, match="no-tiny.json"):
        tiny_checkout(tmp_path, src=src)


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
