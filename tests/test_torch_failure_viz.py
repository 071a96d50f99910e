"""The failure artifact (knossos' linear.svg) of the port's
LinearizableChecker against the JAX package's, on the CPU: the copy of
failure_viz renders the same bytes, and every exit of the checker that
renders in the reference (the synchronous check, check_async's
resolver, the per-value queue route, and each invalid key under
IndependentChecker) returns the same failure_svg and writes the same
linear.svg.

This pins a repaired fault: before the port had failure_viz and
_render_failure, an invalid verdict there carried no failure_svg and
wrote nothing into the run directory.

The reference runs its bitset tier in interpret mode, without its
history sentry (the port's sentry leaves these clean histories as they
are) and, on a plane, with mesh=False and no racer. failure_svg is a
path: each package writes into a directory of its own, so the paths are
compared relative to it. Tolerance: exact (file bytes)."""

import importlib
import json
import os
import random

import pytest
import torch

from jepsen_tpu import independent as r_ind
from jepsen_tpu.checker import failure_viz as r_viz
from jepsen_tpu.history.history import History as RHistory
from jepsen_tpu.sim import corrupt_history, gen_register_history

from jepsen_tpu_torch import independent as t_ind
from jepsen_tpu_torch import sim as t_sim
from jepsen_tpu_torch.checker import failure_viz as t_viz
from jepsen_tpu_torch.checker import linearizable as t_lin
from jepsen_tpu_torch.checker.dispatch import DispatchPlane
from jepsen_tpu_torch.history.history import History as THistory

r_lin = importlib.import_module("jepsen_tpu.checker.linearizable")
r_dp = importlib.import_module("jepsen_tpu.checker.dispatch")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _register(seed, corrupt=True):
    h = gen_register_history(random.Random(seed), n_ops=30, n_procs=3,
                             p_crash=0.05)
    if corrupt:
        h = corrupt_history(h, random.Random(seed))
    return h.to_dicts()


def _files(root):
    return {
        os.path.relpath(p, root): open(p, "rb").read()
        for p in sorted(str(x) for x in root.rglob("*")) if os.path.isfile(p)
    }


def _same_artifact(got, want, d_got, d_want):
    assert got["valid?"] is want["valid?"] is False
    assert got["failed_op_index"] == want["failed_op_index"]
    assert got["failure"] == want["failure"]
    assert os.path.relpath(got["failure_svg"], d_got) == os.path.relpath(
        want["failure_svg"], d_want) == "linear.svg"
    assert _files(d_got) == _files(d_want)


def test_render_copy_matches_reference():
    """The copy renders any report to the reference's bytes, index or
    not, and escapes markup in op labels and states."""
    failure = {
        "failed_op": {"f": "read", "value": "<x&y>"},
        "configs": [
            {"state": 1, "linearized": [{"slot": 2, "f": "write",
                                         "value": 1}],
             "pending": [{"slot": 0, "f": "cas", "value": [1, 2]}]},
            {"state": "<s>", "linearized": [],
             "pending": [{"slot": 0, "f": "cas", "value": [1, 2]},
                         {"slot": 2, "f": "write", "value": 1}]},
        ],
    }
    for idx in (None, 7):
        assert t_viz.render_failure_svg(failure, idx) == \
            r_viz.render_failure_svg(failure, idx)
    assert t_viz.render_failure_svg({}) == r_viz.render_failure_svg({})


def test_synchronous_check_writes_the_reference_svg(tmp_path):
    """Random(701): valid? False at op 26, with failure_svg and
    linear.svg byte-equal to the reference's."""
    ops = _register(701)
    d_ref, d_port = tmp_path / "ref", tmp_path / "port"
    want = r_lin.LinearizableChecker(interpret=True, sentry=False).check(
        {"run_dir": str(d_ref)}, RHistory(ops))
    got = t_lin.LinearizableChecker(device="cpu").check(
        {"run_dir": str(d_port)}, THistory(ops))
    assert got["failed_op_index"] == 26
    _same_artifact(got, want, d_port, d_ref)


def test_opts_subdirectory_wins_and_no_render_without_cause(tmp_path):
    """opts["subdirectory"] takes precedence over the test's run_dir; a
    valid verdict, or a check with no directory, renders nothing."""
    chk = t_lin.LinearizableChecker(device="cpu")
    sub = tmp_path / "sub"
    out = chk.check({"run_dir": str(tmp_path / "run")}, THistory(
        _register(701)), {"subdirectory": str(sub)})
    assert out["failure_svg"] == str(sub / "linear.svg")
    assert not (tmp_path / "run").exists()
    out = chk.check({"run_dir": str(tmp_path / "valid")},
                    THistory(_register(701, corrupt=False)))
    assert out["valid?"] is True and "failure_svg" not in out
    assert not (tmp_path / "valid").exists()
    out = chk.check(None, THistory(_register(701)))
    assert out["valid?"] is False and "failure_svg" not in out


def test_unwritable_run_dir_keeps_the_verdict(tmp_path):
    """An OSError of the write is swallowed, as in the reference: the
    verdict comes back whole, without failure_svg."""
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ops = _register(701)
    want = r_lin.LinearizableChecker(interpret=True, sentry=False).check(
        {"run_dir": str(blocker)}, RHistory(ops))
    got = t_lin.LinearizableChecker(device="cpu").check(
        {"run_dir": str(blocker)}, THistory(ops))
    assert "failure_svg" not in got and "failure_svg" not in want
    assert got["failure"] == want["failure"]
    assert got["failed_op_index"] == want["failed_op_index"] == 26


def test_check_async_resolver_writes_the_reference_svg(tmp_path):
    """The plane's exit: check_async's resolver renders as check()
    does."""
    ops = _register(701)
    d_ref, d_port = tmp_path / "ref", tmp_path / "port"
    with r_dp.DispatchPlane(interpret=True, mesh=False, race=False) as rp:
        res = r_lin.LinearizableChecker(
            plane=rp, interpret=True, sentry=False,
        ).check_async({"run_dir": str(d_ref)}, RHistory(ops))
        rp.flush()
        want = res()
    with DispatchPlane(device="cpu") as tp:
        res = t_lin.LinearizableChecker(plane=tp).check_async(
            {"run_dir": str(d_port)}, THistory(ops))
        tp.flush()
        got = res()
    _same_artifact(got, want, d_port, d_ref)


def test_queue_route_writes_the_reference_svg(tmp_path):
    """The per-value queue route: an overdrawn value's failure report
    renders into the run directory, as the reference's does."""
    h = t_sim.gen_queue_history(random.Random(501), n_ops=120, n_procs=5,
                                n_values=12, p_crash=0.05)
    ops = t_sim.overdraw_queue_history(h, 5).to_dicts()
    d_ref, d_port = tmp_path / "ref", tmp_path / "port"
    want = r_lin.LinearizableChecker(
        model="unordered-queue", mesh=False, sentry=False,
    ).check({"run_dir": str(d_ref)}, RHistory(ops))
    got = t_lin.LinearizableChecker("unordered-queue", device="cpu").check(
        {"run_dir": str(d_port)}, THistory(ops))
    assert got["method"].startswith("per-value:")
    assert got["failed_value"] == want["failed_value"] == 5
    _same_artifact(got, want, d_port, d_ref)


def test_independent_checker_tree_matches_reference(tmp_path):
    """IndependentChecker(LinearizableChecker) with a run_dir: the same
    per-key tree (results, history, and linear.svg for each invalid key)
    with the same bytes, through the real sub-checker."""
    ops = []
    for k in range(3):
        for o in _register(700 + k, corrupt=bool(k % 2)):
            ops.append(dict(o, process=o["process"] + 10 * k,
                            value=(k, o["value"])))
    trees = {}
    for name, ind, lin, Hist in (
        ("ref", r_ind, r_lin.LinearizableChecker(interpret=True,
                                                 sentry=False), RHistory),
        ("port", t_ind, t_lin.LinearizableChecker(device="cpu"), THistory),
    ):
        run = tmp_path / name
        hops = [dict(o, value=ind.KV(*o["value"])) for o in ops]
        out = ind.IndependentChecker(lin).check({"run_dir": str(run)},
                                                Hist(hops))
        trees[name] = (out, _files(run))
    (want, want_files), (got, got_files) = trees["ref"], trees["port"]
    assert got["valid?"] is want["valid?"] is False
    assert [r.get("valid?") for r in got["results"].values()] == [
        r.get("valid?") for r in want["results"].values()]
    assert "independent/1/linear.svg" in got_files
    assert set(got_files) == set(want_files)
    for f in got_files:
        if f.endswith("results.json"):
            # the verdicts' method names (tpu-* / gpu-*), walls,
            # absolute failure_svg paths and the reference's
            # race_winner (the port races only when asked) differ; the
            # rest is equal
            g, w = (_verdict(json.loads(x[f]), d) for x, d in (
                (got_files, tmp_path / "port"), (want_files, tmp_path / "ref")))
            assert g == w, f
        else:
            assert got_files[f] == want_files[f], f


def _verdict(r, root):
    out = {k: v for k, v in r.items()
           if k not in ("method", "wall_s", "race_winner")}
    if "failure_svg" in out:
        out["failure_svg"] = os.path.relpath(out["failure_svg"], root)
    return out
