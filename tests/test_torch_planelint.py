"""planelint for the port (jepsen_tpu_torch.analysis): the per-rule
corpus in PyTorch spelling (every rule fires exactly once on its
positive snippet and never on the sanctioned negative), the parity of
Families B-E with the JAX package's planelint on the same stdlib-only
snippets, the retargeted Family A's seams (the funnel, follow-up
fetches, device masks, mesh products, record_use), the tables grown to
torch.distributed, the suppression and baseline machinery, SARIF, the
`lint` command's exit codes, and the repo-clean gate over
jepsen_tpu_torch/ with planelint_torch_baseline.json."""

import ast
import json
import os
import subprocess
import sys

import pytest

from jepsen_tpu import analysis as r_analysis

from jepsen_tpu_torch import analysis
from jepsen_tpu_torch.analysis import (
    apply_baseline,
    lint_source,
    load_baseline,
    run_lint,
    save_baseline,
)

pytestmark = pytest.mark.lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --------------------------------------------------------------------
# Rule corpus: (positive, negative) per rule. The positive must yield
# EXACTLY one finding, of exactly that rule; the negative — the
# sanctioned spelling of the same operation — must lint clean.
# --------------------------------------------------------------------

CASES = {
    "JT000": (
        """
def f(:
    pass
""",
        """
def f():
    pass
""",
    ),
    "JT001": (
        """
def f():
    x = 1.0  # planelint: disable=JT101
    return x
""",
        """
def f():
    x = 1.0  # planelint: disable=JT101 reason=corpus negative
    return x
""",
    ),
    "JT101": (
        # a scalar pulled off the card outside the funnel
        """
import torch

def f(dev):
    x = torch.zeros(4, device=dev).sum()
    return float(x)
""",
        """
import torch

def f(dev):
    x = torch.zeros(4, device=dev).sum()
    return float(_host_get(x))
""",
    ),
    "JT102": (
        """
import torch

def f(x):
    torch.cuda.synchronize()
    return x
""",
        """
def f(x):
    return _host_get(x)
""",
    ),
    "JT103": (
        # a kernel launch with no launch accounting
        """
def f(win, meta, fr):
    out, fr = bitset_scan(win, meta, fr, "cas-register", 8, 4)
    return out
""",
        """
def f(win, meta, fr):
    _bump_launch("launches")
    out, fr = bitset_scan(win, meta, fr, "cas-register", 8, 4)
    return out
""",
    ),
    "JT104": (
        """
def f(x):
    return x.cpu()
""",
        """
def f(x):
    return resilient_call(lambda: x.cpu(), site="launch")
""",
    ),
    "JT105": (
        # a tensor made on another stream, used by a launch on the
        # plane's stream, then freed with no record_use
        """
def f(win, meta, fr, stream):
    _bump_launch("launches")
    with on_stream(stream):
        out, fr2 = bitset_scan(win, meta, fr, "cas-register", 8, 4)
    del fr
    return out, fr2
""",
        """
def f(win, meta, fr, stream):
    _bump_launch("launches")
    with on_stream(stream):
        record_use((win, meta, fr))
        out, fr2 = bitset_scan(win, meta, fr, "cas-register", 8, 4)
    del fr
    return out, fr2
""",
    ),
    "JT106": (
        # a kernel wrapper with a mutable default
        """
from jepsen_tpu_torch.checker import _build

def bitset_scan(win, meta, fr, opts={}):
    return _build.load("bitset_scan")
""",
        """
from jepsen_tpu_torch.checker import _build

def bitset_scan(win, meta, fr, opts=None):
    return _build.load("bitset_scan")
""",
    ),
    "JT107": (
        """
GRAPH_BUCKETS = (4, 8, 16)

def plan(n):
    for b in GRAPH_BUCKETS:
        if n <= b:
            return b
    return GRAPH_BUCKETS[-1]
""",
        """
GRAPH_BUCKETS = (4, 8, 16)

def _graph_buckets():
    from jepsen_tpu_torch.perf import knobs as _perf_knobs
    try:
        return _perf_knobs.resolve("txn_graph.graph_buckets")
    except Exception:
        return GRAPH_BUCKETS

def plan(n, buckets=GRAPH_BUCKETS):
    for b in _graph_buckets():
        if n <= b:
            return b
    return buckets[-1]
""",
    ),
    "JT201": (
        """
LAUNCH_STATS = {"launches": 0}

def f():
    LAUNCH_STATS["launches"] += 1
""",
        """
import threading

LAUNCH_STATS = {"launches": 0}
_launch_stats_lock = threading.Lock()

def f():
    with _launch_stats_lock:
        LAUNCH_STATS["launches"] += 1
""",
    ),
    "JT202": (
        # the kernel build's wait under a plane lock
        """
import subprocess
import threading

_lock = threading.Lock()

def f(cmd):
    proc = subprocess.Popen(cmd)
    with _lock:
        proc.communicate()
""",
        """
import subprocess
import threading

_lock = threading.Lock()

def f(cmd):
    proc = subprocess.Popen(cmd)
    proc.communicate()
    with _lock:
        n = 1
""",
    ),
    "JT203": (
        """
import threading

def f():
    threading.Thread(target=print, daemon=True).start()
""",
        """
import threading

def f():
    t = threading.Thread(target=print)
    t.start()
    t.join(timeout=1.0)
""",
    ),
    "JT204": (
        """
import threading

_lock = threading.Lock()

def fire(on_fault):
    with _lock:
        on_fault("cuda:0")
""",
        """
import threading

_lock = threading.Lock()

def fire(on_fault):
    with _lock:
        label = "cuda:0"
    on_fault(label)
""",
    ),
    "JT205": (
        """
LAUNCH_STATS = {"launches": 0}

def f():
    return dict(LAUNCH_STATS)
""",
        """
import threading

LAUNCH_STATS = {"launches": 0}
_launch_stats_lock = threading.Lock()

def launch_stats_snapshot():
    with _launch_stats_lock:
        return dict(LAUNCH_STATS)
""",
    ),
    "JT206": (
        """
import threading

class Registry:
    def __init__(self):
        self._membership_lock = threading.Lock()
        self._members = {}

    def note_join(self, mid, url):
        self._members[mid] = url
""",
        """
import threading

class Registry:
    def __init__(self):
        self._membership_lock = threading.Lock()
        self._members = {}

    def note_join(self, mid, url):
        with self._membership_lock:
            self._members[mid] = url
""",
    ),
    "JT207": (
        """
import subprocess
import threading

class Supervisor:
    def __init__(self):
        self._registry_lock = threading.Lock()
        self.procs = {}

    def respawn(self, mid):
        with self._registry_lock:
            self.procs[mid] = subprocess.Popen(["member", str(mid)])
""",
        """
import subprocess
import threading

class Supervisor:
    def __init__(self):
        self._registry_lock = threading.Lock()
        self.procs = {}

    def respawn(self, mid):
        with self._registry_lock:
            due = [mid]
        for m in due:
            self.procs[m] = subprocess.Popen(["member", str(m)])
""",
    ),
    "JT301": (
        """
from jepsen_tpu_torch.obs import trace as obs_trace

def f(x):
    s = obs_trace.span("collect", kind="collect")
    s.__enter__()
    return x
""",
        """
from jepsen_tpu_torch.obs import trace as obs_trace

def f(x):
    with obs_trace.span("collect", kind="collect"):
        return x
""",
    ),
    "JT302": (
        """
import threading

from jepsen_tpu_torch.obs import trace as obs_trace

_launch_stats_lock = threading.Lock()

def f():
    with _launch_stats_lock:
        obs_trace.instant("launches", kind="launch_stat")
""",
        """
import threading

from jepsen_tpu_torch.obs import trace as obs_trace

_launch_stats_lock = threading.Lock()

def f():
    with _launch_stats_lock:
        pass
    obs_trace.instant("launches", kind="launch_stat")
""",
    ),
    "JT303": (
        # emission inside a function torch.compile traces
        """
import torch

from jepsen_tpu_torch.obs import trace as obs_trace

def _impl(a):
    obs_trace.instant("step", kind="corpus")
    return a

scan = torch.compile(_impl)

def f(a):
    _bump_launch("launches")
    return scan(a)
""",
        """
import torch

from jepsen_tpu_torch.obs import trace as obs_trace

def _impl(a):
    return a

scan = torch.compile(_impl)

def f(a):
    _bump_launch("launches")
    obs_trace.instant("step", kind="corpus")
    return scan(a)
""",
    ),
    "JT304": (
        """
from jepsen_tpu_torch.obs import trace as obs_trace

def collect(devices):
    out = []
    for d in devices:
        out.append(str(d))
        obs_trace.instant("collect", kind="mesh", device=str(d))
    return out
""",
        """
from jepsen_tpu_torch.obs import trace as obs_trace

def collect(devices):
    out = []
    for d in devices:
        out.append(str(d))
    obs_trace.instant("collect", kind="mesh", n=len(devices))
    return out
""",
    ),
    "JT305": (
        """
def drain_stream(stream_appends):
    verdicts = []
    for chunk in stream_appends:
        steps = encode_tail(chunk)
        verdicts.append(check_steps_bitset_segmented(steps))
    return verdicts
""",
        """
def drain_stream(plane, stream_appends):
    futs = []
    for chunk in stream_appends:
        steps = encode_tail(chunk)
        futs.append(plane.submit_stream_tail(steps, None))
    return [f.result() for f in futs]
""",
    ),
    "JT401": (
        """
import threading

_lock_a = threading.Lock()
_lock_b = threading.Lock()

def f():
    with _lock_a:
        with _lock_b:
            pass

def g():
    with _lock_b:
        with _lock_a:
            pass
""",
        """
import threading

_lock_a = threading.Lock()
_lock_b = threading.Lock()

def f():
    with _lock_a:
        with _lock_b:
            pass

def g():
    with _lock_a:
        with _lock_b:
            pass
""",
    ),
    "JT402": (
        # a torch.distributed collective under a plane lock
        """
import threading

import torch.distributed as dist

_lock = threading.Lock()

def f(t):
    with _lock:
        dist.all_reduce(t)
""",
        """
import threading

import torch.distributed as dist

_lock = threading.Lock()

def f(t):
    with _lock:
        n = t.numel()
    dist.all_reduce(t)
""",
    ),
    "JT403": (
        """
import threading

_lock = threading.Lock()

def _drain(t):
    t.join()

def f(t):
    with _lock:
        _drain(t)
""",
        """
import threading

_lock = threading.Lock()

def _drain(t):
    t.join()

def f(t):
    with _lock:
        n = 1
    _drain(t)
""",
    ),
    "JT501": (
        # a gather only rank 0 enters
        """
import torch.distributed as dist

def f(table, row):
    if dist.get_rank() == 0:
        dist.all_gather_object(table, row)
    return table
""",
        # is_initialized() and get_world_size() agree on every rank
        """
import torch.distributed as dist

def f(table, row):
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.all_gather_object(table, row)
    return table
""",
    ),
    "JT502": (
        """
import torch.distributed as dist

def f(t, fast):
    if fast:
        dist.all_reduce(t)
        dist.barrier()
    else:
        dist.barrier()
        dist.all_reduce(t)
    return t
""",
        """
import torch.distributed as dist

def f(t, fast):
    if fast:
        dist.all_reduce(t)
        dist.barrier()
    else:
        dist.all_reduce(t)
        dist.barrier()
    return t
""",
    ),
    "JT503": (
        """
import time

def check_id(model, body):
    return check_id_for(model, body + str(time.time()).encode())
""",
        """
import hashlib

def f():
    items = {"a", "b"}
    h = hashlib.sha256()
    for k in sorted(items):
        h.update(k.encode())
    return h.hexdigest()
""",
    ),
}


@pytest.mark.parametrize("rule", sorted(CASES))
def test_rule_fires_exactly_once(rule):
    pos, _ = CASES[rule]
    found = lint_source(pos, rel="checker/corpus.py")
    assert [f.rule for f in found] == [rule], (
        f"{rule} positive produced {[f.render() for f in found]}"
    )


@pytest.mark.parametrize("rule", sorted(CASES))
def test_rule_negative_is_clean(rule):
    _, neg = CASES[rule]
    found = lint_source(neg, rel="checker/corpus.py")
    assert found == [], (
        f"{rule} negative produced {[f.render() for f in found]}"
    )


def test_rule_catalog_covers_corpus_and_keeps_the_reference_ids():
    assert set(CASES) == set(analysis.RULES) == set(r_analysis.RULES)
    assert analysis.FAMILY_RULES == r_analysis.FAMILY_RULES
    assert analysis.META_RULES == r_analysis.META_RULES
    family_rules = [r for fam in sorted(analysis.FAMILY_RULES)
                    for r in analysis.FAMILY_RULES[fam]]
    all_rules = list(analysis.META_RULES) + family_rules
    assert len(all_rules) == len(set(all_rules))
    assert analysis.rules_total() == len(analysis.RULES) == 27


# --------------------------------------------------------------------
# Families B-E: the same findings as the JAX package's planelint on
# the same stdlib-only snippets
# --------------------------------------------------------------------

_REF_STDLIB = {
    # the JAX package's corpus spellings that import no jax
    "JT202": """
import threading
import time

_lock = threading.Lock()

def f():
    with _lock:
        time.sleep(0.1)
""",
    "JT402": """
import threading

_lock = threading.Lock()

def f(arrs, mesh):
    with _lock:
        return global_view(arrs, mesh)
""",
    "JT501": """
def f(arrs, mesh, process_index):
    if process_index() == 0:
        return global_view(arrs, mesh)
    return None
""",
    "JT502": """
def f(arrs, mesh, fast):
    if fast:
        a = global_view(arrs, mesh)
        b = init_pod()
    else:
        b = init_pod()
        a = global_view(arrs, mesh)
    return a, b
""",
    "JT503": """
import hashlib
import time

def f(rows):
    h = hashlib.sha256()
    h.update(str(time.time()).encode())
    for r in set(rows):
        h.update(r)
    return h.hexdigest()
""",
    "JT403-cross": """
import threading

_lock_a = threading.Lock()
_lock_b = threading.Lock()

def _inner(t):
    with _lock_b:
        t.result()

def f(t):
    with _lock_a:
        _inner(t)

def g():
    with _lock_b:
        with _lock_a:
            pass
""",
}

_PARITY = {}
for _rule in sorted(CASES):
    if _rule[:3] in ("JT2", "JT3", "JT4", "JT5") and _rule not in (
            "JT202", "JT303", "JT402", "JT501", "JT502"):
        for _i, _src in enumerate(CASES[_rule]):
            _PARITY[f"{_rule}-{('pos', 'neg')[_i]}"] = _src
_PARITY.update({f"{k}-ref": v for k, v in _REF_STDLIB.items()})


def _key(f):
    return (f.rule, f.file, f.line, f.col, f.severity, f.symbol)


@pytest.mark.parametrize("name", sorted(_PARITY))
def test_families_b_to_e_match_the_reference(name):
    """Families B-E: the port's findings on a stdlib-only snippet are
    the reference's (rule, place, severity and symbol)."""
    src = _PARITY[name].replace("jepsen_tpu_torch.", "jepsen_tpu.")
    fams = ("B", "C", "D", "E")
    got = lint_source(_PARITY[name], rel="checker/corpus.py",
                      families=fams)
    want = r_analysis.lint_source(src, rel="checker/corpus.py",
                                  families=fams)
    assert [_key(f) for f in got] == [_key(f) for f in want]
    if name.endswith("-pos") or name.endswith("-ref"):
        assert got


# --------------------------------------------------------------------
# Family A retargeted: the seams
# --------------------------------------------------------------------


def _rules(src, families=("A",)):
    return [f.rule for f in lint_source(src, rel="checker/corpus.py",
                                        families=families)]


def test_the_funnel_itself_is_exempt():
    """device.py's own crossings (.cpu(), .numpy(), an event's
    synchronize) are the sanctioned ones."""
    with open(os.path.join(analysis.package_root(), "device.py")) as f:
        assert lint_source(f.read(), rel="device.py") == []
    src = """
def _host_get(x, follow_up=False):
    _bump_launch("host_syncs")
    return x.cpu().numpy()

def wait_train(target):
    target.event.synchronize()
"""
    assert _rules(src) == []


@pytest.mark.parametrize("spelling,want", [
    ("x.item()", ["JT101"]),
    ("x.tolist()", ["JT101"]),
    ("x.numpy()", ["JT101"]),
    ("int(x)", ["JT101"]),
    ("bool(x)", ["JT101"]),
    ("np.asarray(x)", ["JT101"]),
    ("[v for v in x]", ["JT101"]),
    ("1 if (x > 0).any() else 0", ["JT101"]),
    ("x > 0", []),
    ("x.shape[0] > 2", []),
    ("x.numel()", []),
    ("x is None", []),
    ("_host_get(x).tolist()", []),
    ("host_value(x).item()", []),
    ("x.cpu()", ["JT104"]),
    ('x.to("cpu")', ["JT104"]),
    ('x.to(device="cpu")', ["JT104"]),
    ("x.to(torch.int64).item()", ["JT101"]),
    ("torch.cuda.current_stream().synchronize()", ["JT102"]),
])
def test_device_value_spellings(spelling, want):
    """A device value (a factory on a device, an upload, a kernel
    wrapper's output) and what syncs it."""
    src = f"""
import numpy as np
import torch

def f(dev, a):
    x = upload(a, dev).reshape(-1)
    return {spelling}
"""
    assert _rules(src) == want


def test_host_factories_and_host_tensors_are_not_device_values():
    src = """
import numpy as np
import torch

def f(a):
    t = torch.from_numpy(a)
    u = torch.zeros(4, dtype=torch.int32)
    w = torch.zeros(4, device="cpu")
    return t.tolist(), u.sum().item(), float(w[0]), list(t)
"""
    assert _rules(src) == []
    src = """
import torch

def f(a, dev):
    t = torch.from_numpy(a).to(dev)
    return t.tolist()
"""
    assert _rules(src) == ["JT101"]


def test_kernel_outputs_are_device_values_and_tuples_unpack():
    src = """
def f(win, meta, fr):
    _bump_launch("launches")
    out, fr2 = bitset_scan(win, meta, fr, "cas-register", 8, 4)
    if out.any():
        return fr2.tolist()
"""
    assert _rules(src) == ["JT101", "JT101"]


def test_host_get_in_a_loop_pays_per_element_but_follow_up_does_not():
    src = """
def f(outs):
    return [_host_get(o) for o in outs]
"""
    assert _rules(src) == ["JT101"]
    src = """
def f(outs, frs):
    got = _host_get(tuple(outs))
    return [_host_get(fr, follow_up=True) for fr in frs], got
"""
    assert _rules(src) == []


def test_a_mesh_product_is_a_host_list_of_device_values():
    """Iterating what a make_sharded_* product returns (one entry per
    slot) is host iteration; its elements are device values, and the
    call is a launch that needs accounting."""
    src = """
def f(mesh, blocks):
    fn = make_sharded_bitset(mesh, "cas-register", 8, 4, False)
    note_sharded_launch(2)
    outs = [o for o, _ in fn(blocks)]
    return global_view([(o,) for o in outs], mesh)
"""
    assert _rules(src) == []
    src = """
def f(mesh, blocks):
    fn = make_sharded_bitset(mesh, "cas-register", 8, 4, False)
    outs = [o for o, _ in fn(blocks)]
    return outs[0].item()
"""
    assert _rules(src) == ["JT103", "JT101"]


def test_a_kernel_wrapper_and_a_mesh_factory_do_not_account_themselves():
    src = """
def make_sharded_bitset(mesh, name, S, W, exact):
    def run(blocks):
        return [bitset_scan(*b, name, S, W) for b in blocks]
    return run

def kfrontier_scan(win, meta, fr):
    return _build.load("kfrontier_scan")(win, meta, fr)
"""
    assert _rules(src) == []


def test_kernel_b_launch_sites_and_the_gloo_staging_are_in_scope():
    """Kernel B's launches (checker/wgl_kfrontier.py) and the mesh's
    gloo staging (pod/slicing.py) are Family A files: an uncounted
    kfrontier_scan launch there is JT103, a bare .cpu() JT104."""
    from jepsen_tpu_torch.analysis.engine import families_for

    assert "A" in families_for("checker/wgl_kfrontier.py")
    assert "A" in families_for("pod/slicing.py")
    src = """
def check(win, meta, dev):
    out = kfrontier_scan(win, meta, "cas-register", 128, 8)
    return _host_get(out)
"""
    rel = "checker/wgl_kfrontier.py"
    assert [f.rule for f in lint_source(
        src, rel=rel, families=families_for(rel))] == ["JT103"]
    counted = src.replace(
        "    out =", '    _bump_launch("launches")\n    out =')
    assert lint_source(counted, rel=rel, families=families_for(rel)) == []
    src = """
def stage(local):
    return local.cpu()
"""
    rel = "pod/slicing.py"
    assert [f.rule for f in lint_source(
        src, rel=rel, families=families_for(rel))] == ["JT104"]


def test_cross_stream_rebind_and_in_place_write():
    """JT105 fires on a rebind or an in-place write after the stream
    block, not when the tensor was made inside the block."""
    for tail in ("fr = None", "fr.zero_()", "fr[0] = 1", "fr += 1"):
        src = f"""
def f(win, meta, fr, stream):
    _bump_launch("launches")
    with on_stream(stream):
        out, fr2 = bitset_scan(win, meta, fr, "cas-register", 8, 4)
    {tail}
    return out
"""
        assert _rules(src) == ["JT105"], tail
    src = """
import torch

def f(win, meta, dev, stream):
    _bump_launch("launches")
    with on_stream(stream):
        fr = torch.zeros(4, device=dev)
        out, fr2 = bitset_scan(win, meta, fr, "cas-register", 8, 4)
    fr = None
    return out
"""
    assert _rules(src) == []


def test_build_cache_hazard_on_a_mutable_module_global():
    src = """
from jepsen_tpu_torch.checker import _build

FLAGS = ["-O3"]

def library_key(name):
    return _build.library_path(name), FLAGS
"""
    assert _rules(src) == ["JT106"]
    assert _rules(src.replace('["-O3"]', '("-O3",)')) == []


# --------------------------------------------------------------------
# Tables grown to torch.distributed, and the blocking-set precision
# --------------------------------------------------------------------


@pytest.mark.parametrize("call", [
    "dist.all_reduce(t)", "dist.all_gather(ts, t)",
    "dist.all_gather_object(rows, t)", "dist.broadcast(t, 0)",
    "dist.barrier()", "dist.new_group(backend='nccl')",
    "dist.init_process_group('gloo', rank=0, world_size=2)",
])
def test_torch_distributed_collectives_under_a_lock(call):
    src = f"""
import threading

import torch.distributed as dist

_lock = threading.Lock()

def f(t, ts, rows):
    with _lock:
        {call}
"""
    assert _rules(src, ("D",)) == ["JT402"]


def test_get_rank_is_divergent_and_world_size_is_uniform():
    src = """
import torch.distributed as dist

def f(t):
    if dist.get_rank() == 0:
        dist.barrier()
"""
    assert _rules(src, ("E",)) == ["JT501"]
    src = """
import torch.distributed as dist

def f(t):
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
"""
    assert _rules(src, ("E",)) == []


def test_a_string_join_is_not_a_blocking_call():
    src = """
import threading

_lock = threading.Lock()

def _key(flags):
    return " ".join(flags)

def f(flags, t):
    with _lock:
        a = ",".join(flags)
        b = _key(flags)
        t.join()
"""
    assert _rules(src, ("B", "D")) == ["JT202"]


def test_the_port_hash_funnels():
    """JT503's funnels are the port's, with the reference's names."""
    for funnel in ("steps_content_hash", "_payload_sha", "_prefix_sha",
                   "check_id_for"):
        src = f"""
import os

def f(steps):
    return {funnel}(steps, os.getpid())
"""
        assert _rules(src, ("E",)) == ["JT503"], funnel
    root = analysis.package_root()
    for rel, name in (("checker/checkpoint.py", "steps_content_hash"),
                      ("checker/checkpoint.py", "_payload_sha"),
                      ("checker/streaming.py", "_prefix_sha"),
                      ("service/server.py", "check_id_for")):
        with open(os.path.join(root, rel)) as f:
            tree = ast.parse(f.read())
        assert name in {n.name for n in tree.body
                        if isinstance(n, ast.FunctionDef)}, (rel, name)


# --------------------------------------------------------------------
# The interprocedural core resolves the port's own imports
# --------------------------------------------------------------------


def test_lockorder_sees_cross_file_cycles_through_port_imports():
    from jepsen_tpu_torch.analysis.lockorder import check_lockorder

    m1 = """
import threading

from jepsen_tpu_torch.checker.m2 import locked_b

_lock_a = threading.Lock()

def locked_a():
    with _lock_a:
        pass

def f():
    with _lock_a:
        locked_b()
"""
    m2 = """
import threading

from jepsen_tpu_torch.checker.m1 import locked_a

_lock_b = threading.Lock()

def locked_b():
    with _lock_b:
        pass

def g():
    with _lock_b:
        locked_a()
"""
    graph = analysis.CallGraph.from_trees({
        "checker/m1.py": ast.parse(m1),
        "checker/m2.py": ast.parse(m2),
    })
    found = check_lockorder(graph, {"checker/m1.py", "checker/m2.py"})
    assert [f.rule for f in found] == ["JT401"]
    assert "m1.py::_lock_a" in found[0].message
    assert "m2.py::_lock_b" in found[0].message


def test_repo_graph_is_substantive():
    """The port's graph is not vacuous: it resolves calls across
    modules, and reaches collectives and blocking calls."""
    trees = {}
    root = analysis.package_root()
    for dirpath, _, filenames in os.walk(root):
        for name in filenames:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                rel = os.path.relpath(path, root).replace(os.sep, "/")
                with open(path, encoding="utf-8") as f:
                    trees[rel] = ast.parse(f.read())
    graph = analysis.CallGraph.from_trees(trees)
    assert len(graph.nodes) > 500
    cross = [ev for n in graph.nodes.values() for ev in n.events
             if ev.resolved and ev.resolved.split("::")[0] != n.rel]
    assert len(cross) > 200
    wit = graph.collective_witness()
    assert "pod/topology.py::init_pod" in wit
    assert "pod/slicing.py::global_view" in wit
    assert len(graph.blocking_witness()) > 50


# --------------------------------------------------------------------
# Suppressions
# --------------------------------------------------------------------

_SYNC = """
import torch

def f(dev):
    x = torch.ones(4, device=dev).sum()
    return float(x){tail}
"""


def test_trailing_suppression_silences_its_line():
    src = _SYNC.format(tail="  # planelint: disable=JT101 reason=corpus")
    assert lint_source(src, rel="checker/corpus.py") == []


def test_standalone_suppression_governs_next_line():
    src = _SYNC.replace(
        "    return float(x)",
        "    # planelint: disable=JT101 reason=corpus\n    return float(x)",
    ).format(tail="")
    assert lint_source(src, rel="checker/corpus.py") == []


def test_suppression_is_rule_specific():
    src = _SYNC.format(tail="  # planelint: disable=JT102 reason=wrong")
    assert [f.rule for f in lint_source(src, rel="checker/corpus.py")] \
        == ["JT101"]


def test_multi_rule_suppression():
    src = """
def f(x):
    return x.cpu().item()  # planelint: disable=JT104,JT101 reason=corpus
"""
    assert lint_source(src, rel="checker/corpus.py") == []


def test_suppression_reason_may_contain_commas_and_equals():
    from jepsen_tpu_torch.analysis import scan_suppression_entries

    src = ("x = 1  # planelint: disable=JT205,JT101 "
           "reason=serialized by design, see dispatch; invariant=held\n")
    assert scan_suppression_entries(src) == [
        (1, ("JT101", "JT205"),
         "serialized by design, see dispatch; invariant=held"),
    ]


def test_suppression_scanner_survives_syntax_errors():
    from jepsen_tpu_torch.analysis import scan_suppression_entries

    src = """
x = 1  # planelint: disable=JT101 reason=still scanned
def f(:
    pass
"""
    assert scan_suppression_entries(src) == [
        (2, ("JT101",), "still scanned"),
    ]
    assert [f.rule for f in lint_source(src, rel="checker/corpus.py")] \
        == ["JT000"]


# --------------------------------------------------------------------
# Baseline
# --------------------------------------------------------------------


def test_baseline_round_trip(tmp_path):
    found = lint_source(CASES["JT101"][0], rel="checker/corpus.py")
    path = str(tmp_path / "baseline.json")
    save_baseline(path, found)
    baseline = load_baseline(path)
    assert baseline == {"checker/corpus.py::f::JT101": 1}
    new, matched = apply_baseline(found, baseline)
    assert new == [] and matched == {"checker/corpus.py::f::JT101": 1}


def test_baseline_counts_are_a_budget_not_a_waiver():
    src = """
import torch

def f(dev):
    x = torch.ones(4, device=dev).sum()
    y = torch.ones(5, device=dev).sum()
    return float(x) + float(y)
"""
    found = lint_source(src, rel="checker/corpus.py")
    assert len(found) == 2
    new, matched = apply_baseline(found, {"checker/corpus.py::f::JT101": 1})
    assert len(new) == 1 and new[0].rule == "JT101"
    assert matched == {"checker/corpus.py::f::JT101": 1}


def test_stale_baseline_entries_detects_dead_keys(tmp_path):
    pkg = tmp_path / "pkg" / "checker"
    pkg.mkdir(parents=True)
    (pkg / "streaming.py").write_text("def f():\n    pass\n")
    baseline = {
        "checker/streaming.py::f::JT104": 1,
        "checker/streaming.py::gone::JT104": 1,
        "checker/deleted.py::f::JT104": 1,
        "malformed-key": 1,
    }
    assert analysis.stale_baseline_entries(
        baseline, str(tmp_path / "pkg")) == [
        "checker/deleted.py::f::JT104",
        "checker/streaming.py::gone::JT104",
        "malformed-key",
    ]
    assert load_baseline(str(tmp_path / "missing.json")) == {}


# --------------------------------------------------------------------
# SARIF
# --------------------------------------------------------------------


def test_sarif_emitter_validates_and_carries_findings():
    found = lint_source(CASES["JT104"][0], rel="checker/corpus.py")
    doc = analysis.to_sarif(found, analysis.RULES)
    assert analysis.validate_sarif(doc) == []
    assert r_analysis.validate_sarif(doc) == []
    run = doc["runs"][0]
    assert run["tool"]["driver"]["name"] == "planelint"
    assert len(run["tool"]["driver"]["rules"]) == 27
    (res,) = run["results"]
    assert res["ruleId"] == "JT104"
    loc = res["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"] == (
        "jepsen_tpu_torch/checker/corpus.py")
    assert loc["region"]["startLine"] >= 1


def test_sarif_validator_rejects_malformed_docs():
    assert analysis.validate_sarif({"version": "2.1.0"}) != []
    doc = analysis.to_sarif([], analysis.RULES)
    doc["runs"][0]["tool"]["driver"].pop("name")
    assert analysis.validate_sarif(doc) != []


# --------------------------------------------------------------------
# The `lint` command and the repo-clean gate
# --------------------------------------------------------------------


def _run_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.cli", "lint", *args],
        capture_output=True, text=True, timeout=120, cwd=REPO,
    )


def test_repo_lints_clean_against_checked_in_baseline():
    """THE gate: the port's tree carries no finding that is neither
    suppressed inline with a reason nor baselined."""
    findings = run_lint()
    baseline = load_baseline(analysis.default_baseline_path())
    new, _ = apply_baseline(findings, baseline)
    assert new == [], "non-baselined planelint findings:\n" + "\n".join(
        f.render() for f in new)


def test_runtime_core_is_in_families_b_and_d_as_in_the_reference():
    """The port's runtime is linted as the reference lints its own:
    Families B and D name runtime/core.py in both packages, and every
    file of the reference's B and D lists is in the port's (the port
    adds device.py and its kernel build)."""
    from jepsen_tpu.analysis import engine as r_engine
    from jepsen_tpu_torch.analysis import engine as t_engine

    assert os.path.exists(os.path.join(analysis.package_root(),
                                       "runtime", "core.py"))
    for eng in (r_engine, t_engine):
        assert {"B", "D"} <= set(eng.families_for("runtime/core.py"))
    for fam in ("FAMILY_B_FILES", "FAMILY_D_FILES"):
        ref, port = getattr(r_engine, fam), getattr(t_engine, fam)
        assert set(ref) <= set(port), (fam, set(ref) - set(port))
        assert set(port) - set(ref) <= {"device.py", "checker/_build.py"}
    got = [f for f in run_lint() if f.file == "runtime/core.py"]
    assert got == []


def test_checked_in_baseline_is_the_ports_own_and_empty():
    path = analysis.default_baseline_path()
    assert os.path.basename(path) == "planelint_torch_baseline.json"
    assert os.path.dirname(path) == REPO
    with open(path) as f:
        assert json.load(f)["findings"] == {}
    assert analysis.package_root() == os.path.join(REPO, "jepsen_tpu_torch")


_SETTLED = [
    # the sites the JAX package's planelint found over the port's tree
    ("checker/dispatch.py", "JT302"),
    ("service/server.py", "JT202"),
    ("checker/chaos.py", "JT203"),
    ("checker/_build.py", "JT403"),
    ("checker/wgl_bitset.py", "JT101"),
    ("checker/streaming.py", "JT101"),
    # kernel B's uncounted launches and the gloo staging, in Family A
    # since it covers wgl_kfrontier.py and pod/slicing.py
    ("checker/wgl_kfrontier.py", "JT103"),
    ("pod/slicing.py", "JT104"),
]


def test_cli_json_contract():
    proc = _run_cli("--json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rec = json.loads(proc.stdout)
    assert rec["clean"] is True and rec["findings"] == []
    assert rec["total"] == 0 and rec["baselined"] == 0
    assert rec["rules_total"] == analysis.rules_total() == 27
    assert set(rec["rules"]) == set(analysis.RULES)
    census = rec["suppressions"]
    for ent in census.values():
        assert ent["count"] == len(ent["sites"]) >= 1
        for site in ent["sites"]:
            assert set(site) == {"file", "line", "reason"}
            assert site["reason"]
    sites = {(s["file"], rid) for rid, ent in census.items()
             for s in ent["sites"]}
    for want in _SETTLED:
        assert want in sites, want
    assert rec["stale_baseline"] == []


def test_cli_sarif_output_validates(tmp_path):
    out = tmp_path / "lint.sarif"
    proc = _run_cli("--sarif", str(out))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(out.read_text())
    assert analysis.validate_sarif(doc) == []
    assert doc["runs"][0]["results"] == []


def test_cli_exit_codes_on_a_dirty_tree(tmp_path):
    """A temp tree with one corpus positive: exit 5, the finding
    rendered; grandfathered, the same tree exits 0."""
    pkg = tmp_path / "checker"
    pkg.mkdir()
    (pkg / "streaming.py").write_text(CASES["JT101"][0])
    baseline = str(tmp_path / "baseline.json")
    proc = _run_cli("--root", str(tmp_path), "--baseline", baseline)
    assert proc.returncode == 5, proc.stdout + proc.stderr
    assert "JT101" in proc.stdout
    proc = _run_cli("--root", str(tmp_path), "--baseline", baseline,
                    "--update-baseline")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    proc = _run_cli("--root", str(tmp_path), "--baseline", baseline)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _git(*args, cwd):
    subprocess.run(
        ["git", "-c", "user.email=t@example.com", "-c", "user.name=t",
         *args], cwd=cwd, check=True, capture_output=True)


def test_cli_changed_only_scopes_findings(tmp_path):
    root = tmp_path / "pkg"
    pkg = root / "checker"
    pkg.mkdir(parents=True)
    (pkg / "streaming.py").write_text(CASES["JT104"][0])
    _git("init", "-q", cwd=tmp_path)
    _git("add", "-A", cwd=tmp_path)
    _git("commit", "-q", "-m", "seed", cwd=tmp_path)
    (pkg / "sharded.py").write_text(CASES["JT104"][0])  # untracked
    assert analysis.changed_files(str(root)) == ["checker/sharded.py"]
    baseline = str(tmp_path / "baseline.json")
    proc = _run_cli("--root", str(root), "--baseline", baseline)
    assert proc.returncode == 5, proc.stdout + proc.stderr
    assert "streaming.py:" in proc.stdout and "sharded.py:" in proc.stdout
    proc = _run_cli("--root", str(root), "--baseline", baseline,
                    "--changed-only")
    assert proc.returncode == 5, proc.stdout + proc.stderr
    assert "sharded.py:" in proc.stdout
    assert "streaming.py:" not in proc.stdout


def test_update_baseline_warns_and_prunes_stale_entries(tmp_path):
    pkg = tmp_path / "pkg" / "checker"
    pkg.mkdir(parents=True)
    (pkg / "streaming.py").write_text(CASES["JT104"][0])
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({
        "version": 1, "findings": {"checker/gone.py::f::JT104": 1}}))
    root = str(tmp_path / "pkg")
    proc = _run_cli("--root", root, "--baseline", str(path))
    assert proc.returncode == 5, proc.stdout + proc.stderr
    assert "stale baseline entry checker/gone.py::f::JT104" in proc.stderr
    proc = _run_cli("--root", root, "--baseline", str(path),
                    "--update-baseline")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "pruned 1 stale" in proc.stdout
    assert load_baseline(str(path)) == {"checker/streaming.py::f::JT104": 1}
