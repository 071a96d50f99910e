"""The per-layer shares read from the program's span tree: on a traced
CPU run of the keyed cell each reads a value in [0, 1] (under the
keyed cell's names, which move `check_s_p95`), and with
`sync_wait_share.keyed` they add up to the share of the window inside the
`independent.check` roots; a program without those spans reads
nothing; self time is clipped to the window."""

import json
import os
from types import SimpleNamespace

from portbench import spec
from portbench.metrics._spans import self_share
from portbench.tests._tiny import run, tiny_checkout

SHARES = ["keyloop_share", "sentry_share.keyed", "events_share.keyed",
          "steps_share.keyed", "launch_prep_share.keyed",
          "verdict_share.keyed", "lin_unnamed_share.keyed"]

ROOTS = '''def read(run):
    w0, w1 = run.t_window0 * 1e9, run.t_window1 * 1e9
    return sum(max(min(s["ts"] + s["dur"], w1) - max(s["ts"], w0), 0)
               for s in run.spans
               if s["name"] == "independent.check") / (w1 - w0)
'''


def test_the_shares_add_up_to_the_checks_on_a_traced_cpu_run(tmp_path):
    root = tiny_checkout(tmp_path)
    pkg = os.path.join(root, "portbench")
    with open(os.path.join(pkg, "metrics", "roots_share.py"), "w") as f:
        f.write(ROOTS)
    bench_path = os.path.join(root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["per_layer"].append({
        "name": "roots_share", "unit": "fraction", "better": "lower",
        "source": "program_span", "layer": "x", "moves": "check_s_p95",
        "workloads": ["keyed-independent"]})
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    res = run(root, "keyed-independent", seconds=2.0, trace=True)
    assert res["correct"] and res["failed"] == 0
    m = {k: v["value"] for k, v in res["metrics"].items()}
    for name in SHARES:
        assert 0.0 <= m[name] <= 1.0, name
    assert m["roots_share"] > 0.5
    total = sum(m[name] for name in SHARES) + m["sync_wait_share.keyed"]
    assert abs(total - m["roots_share"]) < 0.01


def _run(spans, w0=0.0, w1=1.0):
    return SimpleNamespace(spans=spans, t_window0=w0, t_window1=w1)


def test_a_program_without_the_spans_reads_nothing():
    # what a program that records only its host syncs leaves
    run_ = _run([{"name": "host_sync", "kind": "host_sync", "ph": "X",
                  "ts": 1e8, "dur": 1e6, "args": {}}])
    for name in SHARES:
        reader = spec.load_module(spec.PKG, "metrics", name)
        assert reader.read(run_) is None, name


def test_self_time_is_clipped_to_the_window():
    # a root across the window's start, a child inside, a child across
    # its end; times in ns, the window 1 s to 2 s
    spans = [
        {"name": "a", "ph": "X", "ts": 0.5e9, "dur": 1.0e9, "id": 1,
         "parent": None},
        {"name": "b", "ph": "X", "ts": 1.1e9, "dur": 0.1e9, "id": 2,
         "parent": 1},
        {"name": "a", "ph": "X", "ts": 1.8e9, "dur": 0.4e9, "id": 3,
         "parent": None},
        {"name": "b", "ph": "X", "ts": 1.9e9, "dur": 0.2e9, "id": 4,
         "parent": 3},
        {"name": "tick", "ph": "i", "ts": 1.5e9, "id": 5, "parent": 1},
    ]
    r = _run(spans, 1.0, 2.0)
    assert abs(self_share(r, ("a",)) - (0.4 + 0.1)) < 1e-9
    assert abs(self_share(r, ("b",)) - (0.1 + 0.1)) < 1e-9
    assert abs(self_share(r, ("a", "b")) - 0.7) < 1e-9
    assert self_share(r, ("c",)) is None
