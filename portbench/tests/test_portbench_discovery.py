"""The harness finds a configuration, its control, a reference of
another model, a traffic mix, a per-layer metric and the configuration's
CPU size added as new files, with no file that was there edited; the
reference that judges a run is the one of the run's own checkout; the
references give the verdicts known of them; a model with no reference
fails at set-up; every configuration has its CPU size; every metric
has its reader and moves an end-to-end metric its cells report; and the
harness runs every cell of BENCHMARK.json on the CPU, each reading its
own metrics."""

import json
import os
import shutil

import pytest

from portbench import control, core, spec
from portbench.tests._tiny import (config, copy_checkout, run,
                                   tiny_checkout, tiny_sizes)
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


#: a reference that judges every history invalid: put in the place of
#: a checkout's cas-register reference, a run of clean histories in
#: that checkout is not correct only if that checkout's file is the one
#: consulted (the tests import portbench from another tree)
ALWAYS_INVALID = '''"""Judges every history invalid."""


def verdict(item):
    return {"valid": False, "failed": None}
'''

#: a control that breaks every guarantee: every history valid
ALL_VALID = '''"""Breaks every guarantee: every history is taken as valid."""


def verdict(item):
    return {"valid": True, "failed": None}
'''


def _run(root, workload, trace=False):
    """A run of the checkout at `root`, judged by two spawned judges."""
    return core.run_cell(root, workload, 7, 1.0, trace, device="cpu",
                         pkg=os.path.join(root, "portbench"),
                         judge_processes=2)


def test_new_files_are_found_by_name(tmp_path):
    """A configuration naming a new control, the reference of another
    model, a traffic mix, a per-layer metric and the configuration's
    CPU size, added as new files with new entries in BENCHMARK.json
    before the tests' checkout is made: the harness and the tests'
    checkout find them all, the spawned judges consult the reference of
    the run's own checkout, the control runs by its name, and every
    file that was there is byte-identical."""
    src = copy_checkout(os.path.join(str(tmp_path), "src"))
    pkg = os.path.join(src, "portbench")
    before = _snapshot(pkg)
    cfg = json.load(open(os.path.join(pkg, "configs", "etcd-keyed.json")))
    cfg.update(name="etcd-keyed-narrow", keys=3, concurrency=5,
               controls=["all-valid"])
    json.dump(cfg, open(os.path.join(pkg, "configs", "narrow.json"), "w"))
    json.dump({"keys": 3, "ops_per_key": 40, "nemesis_interval_s": 0.5,
               "timeout_s": 0.25, "election_s": 0.05},
              open(os.path.join(pkg, "tests", "tiny",
                                "etcd-keyed-narrow.json"), "w"))
    with open(os.path.join(pkg, "controls", "all-valid.py"), "w") as f:
        f.write(ALL_VALID)
    with open(os.path.join(pkg, "reference", "unordered_queue.py"),
              "w") as f:
        f.write(ALWAYS_INVALID)
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
    assert found["reference"] == ["cas_register", "unordered_queue"]
    assert found["controls"] == ["all-valid", "crashed", "fail-ok"]
    assert core.reference(pkg, "unordered-queue").__file__ == os.path.join(
        pkg, "reference", "unordered_queue.py")
    # the new cell, in BENCHMARK.json only
    bench_path = os.path.join(src, "BENCHMARK.json")
    bench = json.load(open(bench_path))
    bench["configs"].append({"name": "etcd-keyed-narrow", "source": "x",
                             "file": "portbench/configs/narrow.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "narrow-burst",
                               "config": "etcd-keyed-narrow",
                               "traffic": "burst", "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "check_s_p95":
            m["workloads"].append("narrow-burst")
    bench["per_layer"].append({"name": "checks_answered", "unit": "count",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "x", "moves": "check_s_p95",
                               "workloads": ["narrow-burst"]})
    json.dump(bench, open(bench_path, "w"))
    root = tiny_checkout(tmp_path, src=src)
    narrow = json.load(open(os.path.join(root, "portbench", "configs",
                                         "narrow.json")))
    assert narrow["ops_per_key"] == 40 and narrow["keys"] == 3
    res = _run(root, "narrow-burst", trace=True)
    assert res["correct"] is True and res["attempted"] > 0
    assert res["metrics"]["checks_answered"]["value"] == res["attempted"]
    ctl = control.readings(root, "narrow-burst", 7, 1.0, 2, "all-valid",
                           pkg=os.path.join(root, "portbench"))
    assert ctl["correct"] is False and ctl["attempted"] > 0
    # the same checkout judged by a reference that finds every history
    # invalid: the program's valid verdicts are wrong
    judged = copy_checkout(os.path.join(str(tmp_path), "judged"), root)
    shutil.copy(os.path.join(pkg, "reference", "unordered_queue.py"),
                os.path.join(judged, "portbench", "reference",
                             "cas_register.py"))
    res = _run(judged, "narrow-burst")
    n = res["attempted"]
    assert res["correct"] is False
    assert res["checks"]["wrong_verdicts"]["value"] == n - n // 4
    after = _snapshot(pkg)
    for path, data in before.items():
        assert after[path] == data, path


def test_the_references_give_the_known_verdicts():
    """The reference of each configuration's model, in this process and
    in spawned judges, gives the verdicts that the benchmark's one judge
    gave on the tiny pools before each model had its own
    (tests/known_verdicts.json)."""
    with open(os.path.join(ROOT, "portbench", "tests",
                           "known_verdicts.json")) as f:
        known = json.load(f)
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    traffic = {w["config"]: w["traffic"] for w in bench["workloads"]}
    assert set(known) <= set(traffic)
    for name, by_seed in known.items():
        cfg = config(name)
        tr = json.load(open(os.path.join(ROOT, "portbench", "traffic",
                                         traffic[name] + ".json")))
        gen = spec.load_module(spec.PKG, "gen", tr["generator"])
        for seed, want in by_seed.items():
            valid, corrupted = gen.build_pool(cfg, tr, int(seed))
            items = valid + corrupted
            used = list(range(len(items)))
            for procs in (1, 2):
                got = core.judge(spec.PKG, cfg["model"], items, used,
                                 procs)
                assert [got[i] for i in used] == want, (name, seed, procs)


def test_a_model_without_its_reference_fails_at_set_up(tmp_path):
    root = tiny_checkout(tmp_path)
    path = os.path.join(root, "portbench", "configs", "etcd-register.json")
    cfg = json.load(open(path))
    cfg["model"] = "mutex"
    json.dump(cfg, open(path, "w"))
    with pytest.raises(LookupError, match=r"reference/mutex\.py"):
        run(root, "register-clean")


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
    cell = spec.load_cell(root, workload)
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert "setup_s" in res["metrics"]
    assert "build_s" in res
    traced = run(root, workload, trace=True)
    assert traced["correct"]
    assert set(traced["metrics"]) <= {m["name"] for m in cell.per_layer}


def test_every_metric_has_a_reader_and_moves_what_its_cells_report():
    """Each metric of BENCHMARK.json has its reader; each per-layer
    metric moves an end-to-end metric that every cell it lists reports,
    and every cell reports `setup_s`, another end-to-end metric and a
    per-layer one."""
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    found = spec.discover()
    cells = {w["name"]: spec.load_cell(ROOT, w["name"])
             for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert m["name"] in found["e2e"], m["name"]
    for m in bench["per_layer"]:
        assert m["name"] in found["metrics"], m["name"]
        for w in m.get("workloads", cells):
            names = {e["name"] for e in cells[w].end_to_end}
            assert m["moves"] in names, (m["name"], w)
    for name, cell in cells.items():
        names = {e["name"] for e in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2, name
        assert cell.per_layer, name
