"""The PyTorch port stands alone: importing every module of
jepsen_tpu_torch pulls in neither jax nor any module of jepsen_tpu, and
its entry points refuse to run without CUDA unless the caller asks for
the CPU.

The import check runs in a subprocess: this test process already has
jax (tests/conftest.py imports it for every test)."""

import json
import os
import re
import random
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, json, pkgutil, sys
import jepsen_tpu_torch
names = ["jepsen_tpu_torch"]
for m in pkgutil.walk_packages(jepsen_tpu_torch.__path__, "jepsen_tpu_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.")
             or k == "jepsen_tpu" or k.startswith("jepsen_tpu."))
print(json.dumps({"modules": names, "forbidden": bad}))
"""


def test_port_imports_neither_jax_nor_jepsen_tpu():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    want = {
        "jepsen_tpu_torch.device",
        "jepsen_tpu_torch.convert",
        "jepsen_tpu_torch.sim",
        "jepsen_tpu_torch.checker.events",
        "jepsen_tpu_torch.checker.linearizable",
        "jepsen_tpu_torch.checker.wgl_bitset",
        "jepsen_tpu_torch.checker.wgl_kfrontier",
        "jepsen_tpu_torch.checker.wgl_torch",
        "jepsen_tpu_torch.checker.wgl_oracle",
        "jepsen_tpu_torch.checker.wgl_native",
        "jepsen_tpu_torch.checker.sharded",
        "jepsen_tpu_torch.independent",
        "jepsen_tpu_torch.store",
        "jepsen_tpu_torch.history.history",
        "jepsen_tpu_torch.history.sentry",
        "jepsen_tpu_torch.checker.chaos",
        "jepsen_tpu_torch.checker.dispatch",
        "jepsen_tpu_torch.checker.checkpoint",
        "jepsen_tpu_torch.checker.streaming",
        "jepsen_tpu_torch.checker.failure_viz",
        "jepsen_tpu_torch.checker.core",
        "jepsen_tpu_torch.checker.bank",
        "jepsen_tpu_torch.checker.adya",
        "jepsen_tpu_torch.checker.longfork",
        "jepsen_tpu_torch.checker.reductions",
        "jepsen_tpu_torch.checker.txn_graph",
        "jepsen_tpu_torch.history.columnar",
        "jepsen_tpu_torch.txn",
        "jepsen_tpu_torch.utils",
        "jepsen_tpu_torch.utils.util",
        "jepsen_tpu_torch.obs",
        "jepsen_tpu_torch.obs.trace",
        "jepsen_tpu_torch.obs.export",
        "jepsen_tpu_torch.obs.snapshot",
        "jepsen_tpu_torch.obs.profiler",
        "jepsen_tpu_torch.checker.monotonic",
        "jepsen_tpu_torch.checker.divergence",
        "jepsen_tpu_torch.workloads",
        "jepsen_tpu_torch.workloads.adya",
        "jepsen_tpu_torch.cli",
        "jepsen_tpu_torch.obs.prom",
        "jepsen_tpu_torch.service",
        "jepsen_tpu_torch.service.admission",
        "jepsen_tpu_torch.service.audit",
        "jepsen_tpu_torch.service.client",
        "jepsen_tpu_torch.service.drain",
        "jepsen_tpu_torch.service.server",
        "jepsen_tpu_torch.service.tenants",
        "jepsen_tpu_torch.service.membership",
        "jepsen_tpu_torch.service.frontdoor",
        "jepsen_tpu_torch.service.supervisor",
        "jepsen_tpu_torch.service.invariants",
        "jepsen_tpu_torch.service.nemesis",
        "jepsen_tpu_torch.pod",
        "jepsen_tpu_torch.pod.launcher",
        "jepsen_tpu_torch.pod.topology",
        "jepsen_tpu_torch.pod.faultdomains",
        "jepsen_tpu_torch.pod.slicing",
        "jepsen_tpu_torch.obs.trend",
        "jepsen_tpu_torch.perf",
        "jepsen_tpu_torch.perf.knobs",
        "jepsen_tpu_torch.perf.autotune",
        "jepsen_tpu_torch.obs.podtrace",
        "jepsen_tpu_torch.analysis",
        "jepsen_tpu_torch.analysis.callgraph",
        "jepsen_tpu_torch.analysis.concurrency",
        "jepsen_tpu_torch.analysis.determinism",
        "jepsen_tpu_torch.analysis.engine",
        "jepsen_tpu_torch.analysis.findings",
        "jepsen_tpu_torch.analysis.hotpath",
        "jepsen_tpu_torch.analysis.lockorder",
        "jepsen_tpu_torch.analysis.obsrules",
        "jepsen_tpu_torch.analysis.podrules",
        "jepsen_tpu_torch.analysis.sarif",
        "jepsen_tpu_torch.generator",
        "jepsen_tpu_torch.generator.pure",
        "jepsen_tpu_torch.generator.simulate",
        "jepsen_tpu_torch.runtime",
        "jepsen_tpu_torch.runtime.client",
        "jepsen_tpu_torch.runtime.core",
        "jepsen_tpu_torch.control",
        "jepsen_tpu_torch.control.core",
        "jepsen_tpu_torch.db",
        "jepsen_tpu_torch.workloads.register",
        "jepsen_tpu_torch.workloads.bank",
        "jepsen_tpu_torch.workloads.set",
        "jepsen_tpu_torch.workloads.counter",
        "jepsen_tpu_torch.workloads.monotonic",
        "jepsen_tpu_torch.workloads.dirty_reads",
        "jepsen_tpu_torch.workloads.long_fork",
        "jepsen_tpu_torch.workloads.txn_graph",
    } | set(FAULT_LAYER)
    assert want <= set(got["modules"])


def test_port_sources_name_no_jax_import():
    """No source file of the port imports jax or jepsen_tpu, even in a
    branch the import probe above does not execute."""
    pat = re.compile(r"^\s*(from|import)\s+(jax|jepsen_tpu)(\.|\s|$)", re.M)
    pkg = REPO / "jepsen_tpu_torch"
    for path in list(pkg.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        assert not pat.search(path.read_text()), path


def test_port_builds_only_its_own_sources():
    """The port's native and CUDA libraries build from its own csrc/
    (the C++ host code is a copy, never the JAX package's
    resources/*.cc by path), into build/jepsen_tpu_torch/."""
    from jepsen_tpu_torch.checker import _build

    pkg = REPO / "jepsen_tpu_torch"
    assert _build._SRC_DIR == pkg / "csrc"
    assert _build.BUILD_DIR == REPO / "build" / "jepsen_tpu_torch"
    for name in ("wgl_native", "wgl_prep"):
        assert (pkg / "csrc" / f"{name}.cc").exists()
    # the node tools' sources are the port's own resources/ (uploaded
    # to the nodes and built there), never the JAX package's
    from jepsen_tpu_torch import faultfs, nemesis_time

    for mod in (faultfs, nemesis_time):
        assert Path(mod._RES) == pkg / "resources"
    named = set()
    for path in pkg.rglob("*.py"):
        text = path.read_text()
        if "resources" in text:
            named.add(path.relative_to(pkg).as_posix())
        assert not re.search(r"\bjepsen_tpu/resources", text), path
        assert not re.search(r"[\"']jepsen_tpu[\"']", text), path
    assert named == {"faultfs.py", "nemesis.py", "nemesis_time.py"}


_PERF_PROBE = """
import json, sys
from jepsen_tpu_torch.obs import trend
from jepsen_tpu_torch.perf import autotune, knobs
knobs.ensure_profile("cuda")
knobs.ensure_profile("cpu")
trend.gate_trend([], 0.1)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.")
             or k == "jepsen_tpu" or k.startswith("jepsen_tpu."))
import torch
print(json.dumps({"forbidden": bad,
                  "cuda_initialized": torch.cuda.is_initialized(),
                  "tuned": knobs.tuned()}))
"""


def test_perf_layer_imports_neither_jax_nor_jepsen_tpu(tmp_path):
    """perf/ and obs/trend.py: their imports, and the constructors'
    profile consult with no profile present, pull in neither jax nor
    the JAX package, and initialize no CUDA context."""
    env = dict(os.environ, JEPSEN_TPU_PROFILE_DIR=str(tmp_path))
    env.pop("JEPSEN_TPU_PROFILE", None)
    proc = subprocess.run(
        [sys.executable, "-c", _PERF_PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120, env=env,
    )
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"forbidden": [], "cuda_initialized": False,
                   "tuned": False}
    for path in [*(REPO / "jepsen_tpu_torch" / "perf").glob("*.py"),
                 REPO / "jepsen_tpu_torch" / "obs" / "trend.py"]:
        assert not re.search(
            r"^\s*(from|import)\s+(jax|jepsen_tpu)(\.|\s|$)",
            path.read_text(), re.M), path


_POD_PROBE = """
import json, sys
from jepsen_tpu_torch.checker import sharded
from jepsen_tpu_torch.pod import faultdomains, launcher, slicing, topology
snap = sharded.mesh_stats_snapshot()
cfg = topology.PodConfig.from_env({topology.ENV_COORDINATOR: "h:1"})
mesh = sharded.virtual_mesh("cpu", 4, hosts=2)
rungs = faultdomains.degradation_ladder(mesh)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.")
             or k == "jepsen_tpu" or k.startswith("jepsen_tpu."))
import torch
print(json.dumps({"forbidden": bad, "rungs": rungs,
                  "hosts": snap["topology"]["n_hosts"],
                  "cuda_initialized": torch.cuda.is_initialized()}))
"""


def test_pod_layer_imports_neither_jax_nor_jepsen_tpu():
    """pod/ (topology, faultdomains, slicing, launcher) and the mesh
    half of checker/sharded.py: importing them, reading the topology
    and building a virtual mesh pull in neither jax nor the JAX
    package, and initialize no CUDA context."""
    proc = subprocess.run(
        [sys.executable, "-c", _POD_PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"forbidden": [], "hosts": 1, "cuda_initialized": False,
                   "rungs": ["pod", "host-quarantined pod",
                             "local host mesh", "single device", "oracle"]}


_LINT_PROBE = """
import json, sys
from jepsen_tpu_torch import analysis
from jepsen_tpu_torch.obs import podtrace
rules = analysis.rules_total()
clean = analysis.run_lint() == []
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.")
             or k == "jepsen_tpu" or k.startswith("jepsen_tpu."))
print(json.dumps({"forbidden": bad, "rules": rules, "clean": clean,
                  "torch": "torch" in sys.modules,
                  "env": podtrace.ENV_TRACE_DIR}))
"""


def test_lint_and_podtrace_import_neither_jax_nor_torch():
    """analysis/ (stdlib ast only) and obs/podtrace.py: importing them
    and linting the whole tree pull in neither jax nor the JAX package,
    and neither imports torch."""
    proc = subprocess.run(
        [sys.executable, "-c", _LINT_PROBE], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"forbidden": [], "rules": 27, "clean": True,
                   "torch": False, "env": "JEPSEN_TPU_TRACE_DIR"}


@pytest.fixture
def no_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _events():
    from jepsen_tpu_torch.checker.events import history_to_events
    from jepsen_tpu_torch.sim import gen_register_history

    return history_to_events(
        gen_register_history(random.Random(3), n_ops=20, n_procs=3)
    )


def test_entry_points_raise_without_cuda(no_cuda, tmp_path, capsys):
    from jepsen_tpu_torch.checker.linearizable import (
        LinearizableChecker,
        check_events_bucketed,
    )
    from jepsen_tpu_torch.sim import gen_register_history

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        check_events_bucketed(_events())
    h = gen_register_history(random.Random(3), n_ops=20, n_procs=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LinearizableChecker().check(None, h)
    from jepsen_tpu_torch.checker.dispatch import DispatchPlane

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DispatchPlane()
    from jepsen_tpu_torch.checker.checkpoint import CheckpointSink
    from jepsen_tpu_torch.checker.streaming import StreamingCheck

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamingCheck()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LinearizableChecker().check_streaming()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LinearizableChecker().check(
            None, h, checkpoint=CheckpointSink(str(tmp_path)))
    assert not os.path.exists(tmp_path / "checkpoint.json")
    # the CLI: no --backend means the card, so it exits 254 (crash)
    # with the same error, and writes no verdict
    from jepsen_tpu_torch import cli
    from jepsen_tpu_torch.history.history import History
    from jepsen_tpu_torch.store import Store

    st = Store(str(tmp_path / "store"))
    test = {"name": "nocuda", "history": History(h.ops)}
    st.save_1(test)
    capsys.readouterr()
    assert cli.main(["analyze", test["run_dir"], "--store",
                     str(tmp_path / "store")]) == cli.EXIT_CRASH
    assert "CUDA is not available" in capsys.readouterr().err
    assert st.load_results(test["run_dir"]) is None
    out = check_events_bucketed(_events(), device="cpu")
    assert out["valid?"] is True and out["method"] == "gpu-wgl-bitset"


def test_columnar_checkers_raise_without_cuda(no_cuda):
    """The checkers with a device program default to the card, whatever
    the history's size, and run on the CPU only when asked."""
    from jepsen_tpu_torch import sim
    from jepsen_tpu_torch.checker.bank import BankChecker
    from jepsen_tpu_torch.checker.longfork import LongForkChecker
    from jepsen_tpu_torch.checker.reductions import CounterChecker

    bank = sim.gen_bank_history(random.Random(3), n_ops=20)
    fork = sim.gen_long_fork_history(random.Random(3), n_groups=2,
                                     ops_per_group=8)
    for chk, h in ((BankChecker(), bank), (LongForkChecker(), fork),
                   (CounterChecker(), [])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            chk.check({}, h)
    assert BankChecker(device="cpu").check({}, bank)["valid?"] is True
    assert LongForkChecker(device="cpu").check({}, fork)["valid?"] is True
    assert CounterChecker(device="cpu").check({}, [])["valid?"] is True


def test_kernel_wrappers_take_plain_version_only_on_cpu_tensors():
    """A CPU tensor runs the plain version; the kernel route is taken
    for CUDA tensors only (and never falls back)."""
    import numpy as np
    import torch

    from jepsen_tpu_torch.checker import wgl_bitset as bs
    from jepsen_tpu_torch.checker import wgl_kfrontier as kf
    from jepsen_tpu_torch.checker.events import events_to_steps

    st = events_to_steps(_events(), W=12)
    win, meta = bs.pack_steps(st)
    fr0 = bs.init_frontier(st.init_state, 8, 12)[None]
    before = bs.bitset_scan.launches
    out, _ = bs.bitset_scan(torch.from_numpy(win[None]),
                            torch.from_numpy(meta[None]),
                            torch.from_numpy(fr0), "cas-register", 8, 12)
    assert bs.bitset_scan.launches == before
    assert out.shape == (1, 1, bs.OUT_COLS) and int(out[0, 0, 0]) == 1
    kw, km = kf.pack_steps(events_to_steps(_events(), W=8))
    before = kf.kfrontier_scan.launches
    o = kf.kfrontier_scan(torch.from_numpy(kw[None]),
                          torch.from_numpy(km[None]), "cas-register", 16, 8)
    assert kf.kfrontier_scan.launches == before
    assert np.asarray(o)[0, 0, 0] == 1


_HARNESS_PROBE = """
import json, random, sys
from jepsen_tpu_torch import db, independent
from jepsen_tpu_torch.control import DummyRemote
from jepsen_tpu_torch.generator import pure as gen
from jepsen_tpu_torch.runtime import AtomClient, run
from jepsen_tpu_torch.workloads import register
g = gen.clients(gen.limit(20, register.op_mix(random.Random(1))))
test = run({"client": AtomClient(), "generator": g, "concurrency": 3,
            "nodes": ["n1", "n2"], "remote": DummyRemote(), "db": db.DB()})
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.")
             or k == "jepsen_tpu" or k.startswith("jepsen_tpu."))
import torch
print(json.dumps({"forbidden": bad, "ops": len(test["history"].ops),
                  "valid": test["results"]["valid?"],
                  "cuda_initialized": torch.cuda.is_initialized()}))
"""


def test_harness_imports_neither_jax_nor_jepsen_tpu():
    """generator/, runtime/, control/, db.py and the workloads: their
    imports and a whole in-memory run (no checker) pull in neither jax
    nor the JAX package, and initialize no CUDA context: the worker
    threads never touch the card."""
    proc = subprocess.run(
        [sys.executable, "-c", _HARNESS_PROBE], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"forbidden": [], "ops": 40, "valid": True,
                   "cuda_initialized": False}


#: the fault layer and the host checkers, and what they import
FAULT_LAYER = (
    "jepsen_tpu_torch.net",
    "jepsen_tpu_torch.nemesis",
    "jepsen_tpu_torch.nemesis_time",
    "jepsen_tpu_torch.faketime",
    "jepsen_tpu_torch.faultfs",
    "jepsen_tpu_torch.os",
    "jepsen_tpu_torch.control.util",
    "jepsen_tpu_torch.utils.cc",
    "jepsen_tpu_torch.checker.timeline",
    "jepsen_tpu_torch.checker.perf",
    "jepsen_tpu_torch.checker.causal",
    "jepsen_tpu_torch.checker.schedule",
)

_FAULT_PROBE = """
import importlib, json, sys
for name in %r:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.")
             or k == "jepsen_tpu" or k.startswith("jepsen_tpu."))
print(json.dumps({"forbidden": bad, "torch": "torch" in sys.modules}))
""" % (FAULT_LAYER,)


def test_fault_layer_imports_neither_jax_nor_jepsen_tpu():
    """The fault layer and the host checkers alone: neither jax nor the
    JAX package, and no torch either (they are host code)."""
    proc = subprocess.run(
        [sys.executable, "-c", _FAULT_PROBE], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"forbidden": [], "torch": False}


NODE_TOOLS = ("bump_time", "strobe_time", "strobe_time_experiment",
              "faultfs", "fusefaultfs")


@pytest.mark.parametrize("name", NODE_TOOLS)
def test_node_tool_sources_are_byte_equal_copies(name):
    ours = REPO / "jepsen_tpu_torch" / "resources" / f"{name}.cc"
    theirs = REPO / "jepsen_tpu" / "resources" / f"{name}.cc"
    assert ours.read_bytes() == theirs.read_bytes()


def test_resources_hold_only_the_node_tools():
    """The WGL oracle's C++ stays in csrc/ (the port's native
    libraries); resources/ holds the node tools only."""
    got = sorted(p.name for p in
                 (REPO / "jepsen_tpu_torch" / "resources").iterdir())
    assert got == sorted(f"{n}.cc" for n in NODE_TOOLS)


def test_local_build_cache_is_the_ports_own():
    """A departure from jepsen_tpu.utils.cc: the port's local builds
    go to build/jepsen_tpu_torch/native/ in the checkout, never the
    reference's ~/.cache/jepsen_tpu/native that the JAX package's
    processes share through $HOME."""
    from jepsen_tpu.utils import cc as r_cc

    from jepsen_tpu_torch.utils import cc

    assert Path(cc.CACHE_DIR) == REPO / "build" / "jepsen_tpu_torch" / \
        "native"
    assert cc.CACHE_DIR != r_cc.CACHE_DIR
    assert Path(r_cc.CACHE_DIR).parts[-3:] == (".cache", "jepsen_tpu",
                                               "native")
