"""The port's `analyze --resume` and `analyze --follow --resume` against
the JAX package's, on the CPU.

A durable analysis killed at a segment boundary resumes with strictly
fewer launches and the cold run's verdict; a tampered checkpoint runs
cold. A checkpoint.json or stream.json written by either package's CLI
resumes under the other's. The kills are an after_save hook raising
in process, and real SIGKILLs of an `analyze` subprocess: a `python -c`
wrapper installs a CheckpointSink.after_save hook that kills its own
pid at boundary k (or, for a stream, follows a prefix and kills
itself), then calls jepsen_tpu_torch.cli.main.

Both packages run with the small_w seam (W buckets 4 and 5 prepended)
and JEPSEN_TPU_SEG_MIN_LEN=1, as the reference's own kill tests do, so
the interpret-mode kernels compile few shapes. Tolerance: exact
equality."""

import json
import os
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from jepsen_tpu import cli as r_cli
from jepsen_tpu import store as r_store
from jepsen_tpu.checker import checkpoint as r_cp
from jepsen_tpu.checker import dispatch as r_dp
from jepsen_tpu.checker import linearizable as r_lin
from jepsen_tpu.checker import sharded as r_sharded
from jepsen_tpu.checker import wgl_bitset as r_bs

from jepsen_tpu_torch import cli
from jepsen_tpu_torch import store as t_store
from jepsen_tpu_torch.checker import checkpoint as t_cp
from jepsen_tpu_torch.checker import wgl_bitset as t_bs
from jepsen_tpu_torch.checker.streaming import stream_stats
from jepsen_tpu_torch.history import ops as t_ops
from jepsen_tpu_torch.history.history import History as THistory

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore_reference_mesh_policy(monkeypatch):
    """The reference's `analyze --devices 1` pins its process-wide mesh
    policy (sharded._MESH_POLICY) and never unpins it, and so does the
    port's `analyze --backend cpu`: restore both packages' keys after
    each test, so a later test in this worker still sees the ambient
    mesh of either."""
    from jepsen_tpu_torch.checker import sharded as t_sharded

    for pol in (r_sharded._MESH_POLICY, t_sharded._MESH_POLICY):
        for k in ("devices", "backend"):
            monkeypatch.setitem(pol, k, pol[k])


@pytest.fixture(autouse=True)
def durable_env(monkeypatch):
    """small W buckets in both packages, one segment per boundary, the
    reference in interpret mode with its racer off."""
    monkeypatch.setattr(r_bs, "W_BUCKETS", (4, 5) + r_bs.W_BUCKETS)
    monkeypatch.setattr(t_bs, "W_BUCKETS", (4, 5) + t_bs.W_BUCKETS)
    monkeypatch.setenv("JEPSEN_TPU_SEG_MIN_LEN", "1")
    monkeypatch.setenv("JEPSEN_TPU_INTERPRET", "1")
    monkeypatch.setattr(r_lin, "_race_eligible", lambda *a: False)
    monkeypatch.setattr(r_dp, "_race_eligible", lambda *a: False)


def burst_ops(ops, rounds=2, pairs=30, bad_tail=False, nburst=5):
    """tests/test_checkpoint.py's burst_history, as a package's ops."""
    out = []
    for _ in range(rounds):
        for i in range(pairs):
            out.append(ops.invoke_op(0, "write", i % 3))
            out.append(ops.ok_op(0, "write", i % 3))
        for p in range(nburst):
            out.append(ops.invoke_op(p, "write", p % 3))
        for p in range(nburst):
            out.append(ops.ok_op(p, "write", p % 3))
    if bad_tail:
        out.append(ops.invoke_op(0, "read"))
        out.append(ops.ok_op(0, "read", 7))
    return out


def stored_run(root, name, rounds=4, bad_tail=False, n_ops=None):
    ops = burst_ops(t_ops, rounds=rounds, bad_tail=bad_tail)
    test = {"name": name, "workload": "register",
            "history": THistory(ops[:n_ops] if n_ops else ops)}
    return t_store.Store(root).save_1(test), ops


def copy_run(d, tag):
    out = f"{d}.{tag}"
    shutil.copytree(d, out)
    return out


def port(d, root, *extra):
    return cli.main(["analyze", d, "--store", root, "--backend", "cpu",
                     "--workload", "register", *extra])


def ref(d, root, *extra):
    return r_cli.main(["analyze", d, "--store", root, "--devices", "1",
                       "--workload", "register", *extra])


def verdict(res):
    return {k: res.get(k) for k in ("valid?", "failed_op_index", "failure")}


class Die(Exception):
    pass


def kill_at(monkeypatch, cp_mod, k):
    """Every CheckpointSink of cp_mod raises after its boundary-k save."""
    init = cp_mod.CheckpointSink.__init__

    def hooked(self, *a, **kw):
        init(self, *a, **kw)

        def after_save(sink, st):
            if st.get("segments_done", 0) >= k and st.get("verdict") is None:
                raise Die(f"killed at boundary {st['segments_done']}")
        self.after_save = after_save

    monkeypatch.setattr(cp_mod.CheckpointSink, "__init__", hooked)


def results(d):
    return t_store.Store().load_results(d)


@pytest.mark.parametrize("bad", [False, True], ids=["valid", "invalid"])
def test_resume_after_a_kill_at_a_boundary(tmp_path, monkeypatch, bad):
    root = str(tmp_path / "store")
    d, _ = stored_run(root, "resume", rounds=4, bad_tail=bad)
    cold = copy_run(d, "cold")
    want = cli.EXIT_INVALID if bad else cli.EXIT_VALID
    assert port(cold, root, "--resume") == want
    res_c = results(cold)
    with monkeypatch.context() as m:
        kill_at(m, t_cp, 2)
        assert port(d, root, "--resume") == cli.EXIT_CRASH
    assert results(d) is None
    assert json.load(open(os.path.join(d, "checkpoint.json")))[
        "segments_done"] >= 2
    assert port(d, root, "--resume") == want
    res_k = results(d)
    assert verdict(res_k) == verdict(res_c)
    lk = res_k["engine_stats"]["launch"]["launches"]
    lc = res_c["engine_stats"]["launch"]["launches"]
    assert 0 < lk < lc
    ck = res_k["engine_stats"]["checkpoint"]
    assert ck["resumes"] == 1 and ck["resumed_segments"] >= 2
    # a finished checkpoint replays with no launch at all
    assert port(d, root, "--resume") == want
    again = results(d)["engine_stats"]
    assert again["checkpoint"]["replays"] == 1
    assert again["launch"]["launches"] == 0


def test_tampered_checkpoint_runs_cold(tmp_path, monkeypatch):
    root = str(tmp_path / "store")
    d, _ = stored_run(root, "tamper", rounds=4)
    with monkeypatch.context() as m:
        kill_at(m, t_cp, 2)
        assert port(d, root, "--resume") == cli.EXIT_CRASH
    p = os.path.join(d, "checkpoint.json")
    st = json.load(open(p))
    st["segments_done"] = 1  # no payload_sha recompute
    json.dump(st, open(p, "w"))
    assert port(d, root, "--resume") == cli.EXIT_VALID
    res = results(d)
    assert res["valid?"] is True
    ck = res["engine_stats"]["checkpoint"]
    assert ck["rejected"] >= 1 and ck["resumes"] == 0


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_checkpoint_files_resume_across_packages(tmp_path, monkeypatch,
                                                 writer):
    """A checkpoint.json the other package's `analyze --resume` left at
    boundary 2 resumes here, to the same verdict as a cold run."""
    root = str(tmp_path / "store")
    d, _ = stored_run(root, "xcp", rounds=4, bad_tail=True)
    cold = copy_run(d, "cold")
    assert ref(cold, root, "--resume") == cli.EXIT_INVALID
    res_c = r_store.Store(root).load_results(cold)
    first, second = (ref, port) if writer == "ref" else (port, ref)
    with monkeypatch.context() as m:
        kill_at(m, r_cp if writer == "ref" else t_cp, 2)
        assert first(d, root, "--resume") == cli.EXIT_CRASH
    assert second(d, root, "--resume") == cli.EXIT_INVALID
    res = r_store.Store(root).load_results(d)
    assert verdict(res) == verdict(res_c)
    ck = res["engine_stats"]["checkpoint"]
    assert ck["resumes"] == 1 and ck["rejected"] == 0
    assert 0 < res["engine_stats"]["launch"]["launches"] < \
        res_c["engine_stats"]["launch"]["launches"]


def append_ops(d, ops):
    with open(os.path.join(d, "history.jsonl"), "a") as f:
        for o in ops:
            f.write(json.dumps(t_store.op_to_json(o)) + "\n")


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_stream_files_resume_across_packages(tmp_path, writer):
    """A stream.json the other package's `analyze --follow --resume`
    left over a prefix resumes here over the grown history: only the
    tail is checked, to the one-shot verdict."""
    root = str(tmp_path / "store")
    d, ops = stored_run(root, "xst", rounds=3, n_ops=70)
    first, second = (ref, port) if writer == "ref" else (port, ref)
    assert first(d, root, "--follow", "--resume", "--follow-idle",
                 "0") == cli.EXIT_VALID
    assert os.path.exists(os.path.join(d, "stream.json"))
    append_ops(d, ops[70:] + [t_ops.invoke_op(0, "read"),
                              t_ops.ok_op(0, "read", 7)])
    from jepsen_tpu.checker.streaming import stream_stats as r_stream_stats

    assert second(d, root, "--follow", "--resume", "--follow-idle",
                  "0") == cli.EXIT_INVALID
    st = stream_stats() if second is port else r_stream_stats()
    assert st["resumes"] == 1 and st["invalidations"] == 0


# -- real SIGKILLs ----------------------------------------------------------

_CHILD = """
import os, signal, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from jepsen_tpu_torch import cli
from jepsen_tpu_torch.checker import checkpoint as cp
from jepsen_tpu_torch.checker import wgl_bitset as bs

bs.W_BUCKETS = (4, 5) + bs.W_BUCKETS
init = cp.CheckpointSink.__init__


def hooked(self, *a, **kw):
    init(self, *a, **kw)

    def after_save(sink, st):
        if st.get("segments_done", 0) >= {k}:
            os.kill(os.getpid(), signal.SIGKILL)
    self.after_save = after_save


cp.CheckpointSink.__init__ = hooked
rc = cli.main({argv!r})
if {kill_at_end!r}:
    os.kill(os.getpid(), signal.SIGKILL)
sys.exit(rc)
"""


def sigkill_child(argv, k=10 ** 9, kill_at_end=False):
    env = dict(os.environ, JEPSEN_TPU_SEG_MIN_LEN="1")
    env.pop("JEPSEN_TPU_INTERPRET", None)
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD.format(
            repo=str(REPO), k=k, argv=argv, kill_at_end=kill_at_end)],
        env=env, timeout=300, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    return proc


@pytest.mark.parametrize("tamper", [False, True], ids=["resume", "tamper"])
def test_sigkill_analyze_resume(tmp_path, tamper):
    """A real SIGKILL of `analyze --resume` at boundary 3 (no cleanup):
    the re-run resumes with strictly fewer launches than a cold run and
    its verdict; over a tampered checkpoint it runs cold."""
    root = str(tmp_path / "store")
    d, _ = stored_run(root, "soak", rounds=6)
    cold = copy_run(d, "cold")
    argv = ["analyze", d, "--store", root, "--backend", "cpu",
            "--workload", "register", "--resume"]
    proc = sigkill_child(argv, k=3)
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    assert results(d) is None  # died mid-check
    p = os.path.join(d, "checkpoint.json")
    assert json.load(open(p))["segments_done"] >= 3
    if tamper:
        st = json.load(open(p))
        st["segments_done"] = 1
        json.dump(st, open(p, "w"))
    assert port(d, root, "--resume") == cli.EXIT_VALID
    assert port(cold, root, "--resume") == cli.EXIT_VALID
    res_k, res_c = results(d), results(cold)
    assert verdict(res_k) == verdict(res_c)
    ck = res_k["engine_stats"]["checkpoint"]
    lk = res_k["engine_stats"]["launch"]["launches"]
    lc = res_c["engine_stats"]["launch"]["launches"]
    if tamper:
        assert ck["rejected"] >= 1 and ck["resumes"] == 0 and lk == lc
    else:
        assert ck["resumes"] == 1 and ck["resumed_segments"] >= 3
        assert 0 < lk < lc


def test_sigkill_stream_resume(tmp_path):
    """A real SIGKILL of a durable `analyze --follow --resume` after it
    checked a prefix: a fresh follow over the grown history resumes and
    reaches the one-shot verdict."""
    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker

    root = str(tmp_path / "store")
    d, ops = stored_run(root, "ssoak", rounds=3, n_ops=70)
    argv = ["analyze", d, "--store", root, "--backend", "cpu",
            "--workload", "register", "--follow", "--resume",
            "--follow-idle", "0"]
    proc = sigkill_child(argv, kill_at_end=True)
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    assert os.path.exists(os.path.join(d, "stream.json"))
    tail = [t_ops.invoke_op(0, "read"), t_ops.ok_op(0, "read", 0),
            t_ops.invoke_op(0, "read"), t_ops.ok_op(0, "read", 1)]
    append_ops(d, ops[70:] + tail)
    want = LinearizableChecker(device="cpu").check(
        None, THistory(ops + tail))
    assert port(d, root, "--follow", "--resume", "--follow-idle", "0") \
        == cli._exit_code(want) == cli.EXIT_INVALID
    assert stream_stats()["resumes"] == 1
