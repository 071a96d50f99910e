"""The port's perf plane (jepsen_tpu_torch.perf: the knob registry,
profiles keyed by the device, the verdict-parity sweep; cli tune,
--profile and perf-trend) against the JAX package's (jepsen_tpu.perf,
jepsen_tpu.obs.trend, jepsen_tpu.cli), on the CPU.

The port's counterpart of each test in tests/test_perf_plane.py but
the packed-word kernel cache (the port's graph program has no packed
branch), then the differentials, both packages in one process:

- ``config_hash()`` and ``active_config()`` equal on the defaults and
  on a planted override set;
- each package reads the other's profile as foreign and stays on the
  defaults;
- each probe's parity signature equals the reference's on the same
  seeded input (the reference in interpret mode);
- ``tune``'s and ``perf-trend``'s exit codes equal the reference's on
  the same inputs, and perf-trend prints the same table.

Every test starts on registry defaults in both packages with a private
profile directory, and leaves no active profile behind. The port's
probes and sweeps run with device="cpu". Tolerance: exact equality."""

from __future__ import annotations

import argparse
import json
import os
import random

import pytest
import torch

from jepsen_tpu import cli as r_cli
from jepsen_tpu.obs import trend as r_trend
from jepsen_tpu.perf import autotune as r_autotune
from jepsen_tpu.perf import knobs as r_knobs

from jepsen_tpu_torch import cli, sim
from jepsen_tpu_torch.checker import dispatch as dp
from jepsen_tpu_torch.checker import txn_graph as tg
from jepsen_tpu_torch.checker import wgl_bitset as bs
from jepsen_tpu_torch.checker.events import history_to_events
from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
from jepsen_tpu_torch.checker.streaming import StreamingCheck
from jepsen_tpu_torch.obs import trend
from jepsen_tpu_torch.perf import autotune, knobs

#: a fixed profile key wherever the test must not depend on the ambient
#: torch install (current_key() is exercised separately)
FAKE_KEY = {"backend": "cpu", "n_devices": 1, "device_name": "cpu",
            "torch_version": "9.9.9", "cuda_version": "none"}

#: a planted override set, one of each kind
PLANTED = {
    "dispatch.coalesce_hold_s": 0.0005,
    "dispatch.max_batch": 128,
    "wgl_bitset.w_buckets": (12, 14, 16, 18, 19),
    "txn_graph.graph_buckets": (4, 16, 64, 256, 1024),
    "streaming.gc_window": 64,
}


@pytest.fixture(autouse=True)
def _clean_perf_state(monkeypatch, tmp_path):
    """Both packages on registry defaults with an empty, private profile
    store; no active profile or load latch leaks either way."""
    for mod in (autotune, r_autotune):
        monkeypatch.delenv(mod.PROFILE_ENV, raising=False)
        monkeypatch.delenv(mod.FAKE_CLOCK_ENV, raising=False)
    monkeypatch.delenv(knobs.NO_PROFILE_ENV, raising=False)
    monkeypatch.setenv(autotune.PROFILE_DIR_ENV,
                       str(tmp_path / "profiles"))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                       str(tmp_path / "jax_cache"))
    knobs._reset_for_tests()
    r_knobs._reset_for_tests()
    yield
    knobs._reset_for_tests()
    r_knobs._reset_for_tests()
    dp.reset_default_plane()


# -- registry ----------------------------------------------------------------


def test_registry_defaults_match_module_constants():
    """Each knob defaults to exactly the port's module constant it
    supersedes, and every default is one of its own sweep rungs."""
    published = {
        "wgl_bitset.w_buckets": bs.W_BUCKETS,
        "wgl_bitset.rows_bucket_growth": bs.ROWS_BUCKET_GROWTH,
        "txn_graph.graph_buckets": tg.GRAPH_BUCKETS,
        "streaming.tail_len_bucket": dp.STREAM_TAIL_BUCKET,
    }
    for name, want in published.items():
        assert knobs.KNOBS[name].default == want, name
    assert {n for n, k in knobs.KNOBS.items() if k.const} == set(
        published)
    # the plane's constants carry no const field, as in the reference,
    # but they are the defaults all the same
    assert knobs.KNOBS["dispatch.max_batch"].default == dp.MAX_BATCH
    assert (knobs.KNOBS["dispatch.coalesce_hold_s"].default
            == dp.COALESCE_HOLD_S)
    assert (knobs.KNOBS["dispatch.max_inflight_trains"].default
            == dp.MAX_INFLIGHT_TRAINS)
    for name, k in knobs.KNOBS.items():
        assert k.default in k.domain, name
        assert k.owner.startswith("jepsen_tpu_torch/"), name


def test_registry_is_the_references_but_one_domain():
    """Same names, order, kinds, defaults and probes; the domains too,
    but txn_graph.packed_word_max_n's, which the port sweeps at its one
    default rung (nothing in the port reads it)."""
    assert list(knobs.KNOBS) == list(r_knobs.KNOBS)
    for name, k in knobs.KNOBS.items():
        r = r_knobs.KNOBS[name]
        assert (k.kind, k.default, k.probe) == (r.kind, r.default,
                                                r.probe), name
        if name == "txn_graph.packed_word_max_n":
            assert k.domain == (32,) and k.const is None
        else:
            assert k.domain == r.domain, name


def test_config_hash_tracks_overrides():
    base = knobs.config_hash()
    knobs.set_active({"dispatch.max_batch": 64}, source="test")
    assert knobs.config_hash() != base
    assert knobs.tuned()
    snap = knobs.perf_snapshot()
    assert snap["profile"] == "test"
    assert snap["overrides"] == {"dispatch.max_batch": 64}
    knobs.set_active({}, source=None)
    assert knobs.config_hash() == base and not knobs.tuned()


@pytest.mark.parametrize("overrides", [{}, PLANTED],
                         ids=["defaults", "planted"])
def test_config_hash_and_config_equal_the_reference(overrides):
    knobs.set_active(overrides, source="test")
    r_knobs.set_active(overrides, source="test")
    assert knobs.active_config() == r_knobs.active_config()
    assert knobs.config_hash() == r_knobs.config_hash()
    assert knobs.perf_snapshot() == r_knobs.perf_snapshot()


def test_set_active_rejects_garbage_loudly():
    with pytest.raises(ValueError):
        knobs.set_active({"nope.such_knob": 1}, source="test")
    with pytest.raises(ValueError):
        knobs.set_active({"dispatch.max_batch": -4}, source="test")
    with pytest.raises(ValueError):
        knobs.set_active(
            {"wgl_bitset.w_buckets": (19, 12)}, source="test")
    assert not knobs.tuned()


# -- profile store -----------------------------------------------------------


def test_profile_round_trip_and_byte_stability():
    overrides = {
        "dispatch.max_batch": 128,
        "wgl_bitset.w_buckets": [12, 14, 16, 19],
    }
    path = autotune.write_profile(
        overrides, key=FAKE_KEY, evidence={"rows": []})
    got = autotune.load_profile(path, key=FAKE_KEY)
    assert got is not None
    loaded, doc = got
    assert loaded["dispatch.max_batch"] == 128
    assert loaded["wgl_bitset.w_buckets"] == (12, 14, 16, 19)
    assert doc["key"] == FAKE_KEY
    assert doc["config_hash"] == r_knobs.config_hash(
        {**r_knobs.active_config(), **loaded})
    assert os.path.exists(path[: -len(".json")] + ".evidence.json")
    first = open(path, "rb").read()
    autotune.write_profile(overrides, key=FAKE_KEY)
    assert open(path, "rb").read() == first


@pytest.mark.parametrize("field,value", [
    ("backend", "cuda"), ("n_devices", 4),
    ("device_name", "NVIDIA H100 80GB HBM3"), ("torch_version", "0.0.1"),
    ("cuda_version", "12.4"),
])
def test_foreign_or_stale_key_degrades_to_defaults(field, value):
    """Another backend, device count or card is foreign; other torch or
    CUDA versions are stale: each reads as no profile."""
    path = autotune.write_profile(
        {"dispatch.max_batch": 128}, key=FAKE_KEY)
    assert autotune.load_profile(path, key=FAKE_KEY) is not None
    assert autotune.load_profile(
        path, key=dict(FAKE_KEY, **{field: value})) is None


def test_profile_defects_degrade_to_defaults(tmp_path):
    path = autotune.write_profile(
        {"dispatch.max_batch": 128}, key=FAKE_KEY)
    bad = str(tmp_path / "corrupt.json")
    with open(bad, "w") as f:
        f.write(open(path).read()[:40])
    assert autotune.load_profile(bad, key=FAKE_KEY) is None
    doc = json.load(open(path))
    doc["knobs"]["dispatch.max_batch"] = 512
    doctored = str(tmp_path / "doctored.json")
    with open(doctored, "w") as f:
        json.dump(doc, f)
    assert autotune.load_profile(doctored, key=FAKE_KEY) is None
    assert autotune.load_profile(
        str(tmp_path / "absent.json"), key=FAKE_KEY) is None
    with pytest.raises(ValueError):
        autotune.write_profile({"nope": 1}, key=FAKE_KEY)


def test_current_key_names_the_device_and_versions(monkeypatch):
    key = autotune.current_key("cpu")
    assert key == {"backend": "cpu", "n_devices": 1,
                   "device_name": "cpu",
                   "torch_version": torch.__version__,
                   "cuda_version": str(torch.version.cuda or "none")}
    stem = os.path.basename(autotune.profile_path(key))
    assert stem.startswith("cpu-1dev-cpu-torch") and stem.endswith(".json")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        autotune.current_key()


def test_ensure_profile_loads_for_the_constructors_backend():
    """A profile persisted for this process's CPU key is found and
    installed by ensure_profile("cpu"); a corrupt one in the same slot
    is not."""
    key = autotune.current_key("cpu")
    path = autotune.write_profile({"dispatch.max_batch": 128}, key=key)
    knobs._reset_for_tests()
    knobs.ensure_profile("cpu")
    assert knobs.resolve("dispatch.max_batch") == 128
    assert knobs.perf_snapshot()["profile"] == path
    with open(path, "w") as f:
        f.write("{not json")
    knobs._reset_for_tests()
    knobs.ensure_profile("cpu")
    assert knobs.resolve("dispatch.max_batch") == 256
    assert not knobs.tuned()


def test_the_card_profile_is_never_read_for_the_cpu(monkeypatch):
    """The latch is kept per backend: a CPU constructor reads only the
    CPU's key. With no card, the card's load fails quietly (defaults),
    and the CPU's profile still loads afterwards."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    autotune.write_profile({"dispatch.max_batch": 128},
                           key=dict(FAKE_KEY, backend="cuda",
                                    device_name="NVIDIA H100 80GB HBM3"))
    knobs.ensure_profile("cpu")
    assert not knobs.tuned()
    knobs.ensure_profile("cuda")  # no card: defaults, never raises
    assert not knobs.tuned()
    autotune.write_profile({"dispatch.max_batch": 64},
                           key=autotune.current_key("cpu"))
    knobs.ensure_profile("cpu")  # latched: a process reads once
    assert not knobs.tuned()
    knobs._reset_for_tests()
    knobs.ensure_profile("cpu")
    assert knobs.resolve("dispatch.max_batch") == 64


def test_constructors_consult_the_profile():
    """DispatchPlane, TxnGraphChecker, StreamingCheck and
    LinearizableChecker load the persisted profile of their backend at
    construction; explicit arguments still beat it."""
    coarse = knobs.KNOBS["txn_graph.graph_buckets"].domain[-1]
    autotune.write_profile(
        {
            "dispatch.max_batch": 128,
            "dispatch.max_inflight_trains": 3,
            "dispatch.coalesce_hold_s": 0.005,
            "streaming.tail_len_bucket": 32,
            "streaming.persist_every": 4,
            "streaming.gc_window": 64,
            "txn_graph.graph_buckets": coarse,
        },
        key=autotune.current_key("cpu"),
    )
    knobs._reset_for_tests()
    with dp.DispatchPlane(device="cpu") as plane:
        assert plane.max_batch == 128
        assert plane.max_inflight_trains == 3
        assert plane._tail_bucket == 32
        assert plane.coalesce_wait_s == 0.005
    assert tg.TxnGraphChecker(device="cpu").buckets == tuple(coarse)
    sc = StreamingCheck(model="cas-register", device="cpu")
    assert sc.persist_every == 4 and sc.gc_window == 64
    # explicit arguments still beat the profile
    with dp.DispatchPlane(device="cpu", max_inflight_trains=1,
                          coalesce_wait_us=0.0) as plane:
        assert plane.max_inflight_trains == 1
        assert plane.coalesce_wait_s == 0.0
    sc = StreamingCheck(model="cas-register", device="cpu",
                        persist_every=2, gc_window=None)
    assert sc.persist_every == 2 and sc.gc_window is None
    assert tg.TxnGraphChecker(device="cpu", buckets=(8,)).buckets == (8,)


def test_linearizable_checker_loads_the_plan_time_ladders():
    """The W ladder and the rows quantum resolve at plan time, once the
    checker's construction has loaded the profile."""
    autotune.write_profile(
        {"wgl_bitset.w_buckets": (13, 15, 17, 19),
         "wgl_bitset.rows_bucket_growth": 16},
        key=autotune.current_key("cpu"))
    knobs._reset_for_tests()
    assert bs.w_bucket(12) == 12 and bs._rows_bucket(3) == 8
    LinearizableChecker(device="cpu")
    assert bs.w_bucket(12) == 13 and bs._rows_bucket(3) == 16


def test_max_batch_knob_flushes_the_bucket():
    """dispatch.max_batch tunes something real: the bucket occupancy at
    which the plane flushes on the submitting thread."""
    streams = []
    for i in range(2):
        h = sim.gen_register_history(random.Random(7000 + i), n_ops=40,
                                     n_procs=4, p_crash=0.0)
        streams.append(history_to_events(h))
    for cap, flushed in ((256, 0), (2, 1)):
        knobs.set_active({"dispatch.max_batch": cap}, source="test")
        dp.reset_dispatch_stats()
        with dp.DispatchPlane(device="cpu") as plane:
            futs = [plane.submit(ev) for ev in streams]
            assert dp.dispatch_stats()["batches"] == flushed, cap
            assert all(f.result()["valid?"] is True for f in futs)


def test_no_profile_env_disables_loading(monkeypatch):
    autotune.write_profile({"dispatch.max_batch": 128},
                           key=autotune.current_key("cpu"))
    monkeypatch.setenv(knobs.NO_PROFILE_ENV, "1")
    knobs._reset_for_tests()
    knobs.ensure_profile("cpu")
    assert knobs.resolve("dispatch.max_batch") == 256


def test_profiles_read_as_foreign_across_packages():
    """Both packages' profiles in the one shared directory: each reads
    the other's as foreign (its key lacks the fields the reader
    checks) and stays on the defaults."""
    t_path = autotune.write_profile({"dispatch.max_batch": 128},
                                    key=autotune.current_key("cpu"))
    r_path = r_autotune.write_profile({"dispatch.max_batch": 64},
                                      key=r_autotune.current_key())
    assert os.path.dirname(t_path) == os.path.dirname(r_path)
    assert t_path != r_path
    cpu_key = autotune.current_key("cpu")
    assert autotune.load_profile(r_path, key=cpu_key) is None
    assert r_autotune.load_profile(t_path) is None
    # the port reads its own, the reference its own
    assert autotune.load_profile(t_path, key=cpu_key)[0] == {
        "dispatch.max_batch": 128}
    assert r_autotune.load_profile(r_path)[0] == {
        "dispatch.max_batch": 64}
    os.unlink(r_path)
    r_knobs._reset_for_tests()
    r_knobs.ensure_profile()
    assert not r_knobs.tuned()  # only the port's profile is there
    os.unlink(t_path)
    r_autotune.write_profile({"dispatch.max_batch": 64},
                             key=r_autotune.current_key())
    assert not autotune.any_profile_present()
    knobs._reset_for_tests()
    knobs.ensure_profile("cpu")
    assert not knobs.tuned()  # only the reference's profile is there


# -- probes and sweep ---------------------------------------------------------


@pytest.mark.parametrize("probe", ["linear", "txn", "stream"])
def test_probe_signature_equals_the_reference(probe):
    """The same seeded probe input through the port's checkers on the
    CPU and the reference's in interpret mode: equal parity
    signatures."""
    got = autotune._PROBES[probe]("cpu")()
    want = r_autotune._PROBES[probe]()()
    assert got == want
    assert got.get("valid?") is not None


def _planted_measure(table):
    def measure(run, name, idx):
        return float(table[name][idx]), run()

    return measure


def test_sweep_picks_planted_fastest_rung():
    res = autotune.run_sweep(
        budget_s=600.0, only=["streaming.persist_every"], device="cpu",
        measure=_planted_measure(
            {"streaming.persist_every": [3.0, 2.0, 1.0]}),
    )
    assert res["overrides"] == {"streaming.persist_every": 16}
    rows = res["evidence"]["streaming.persist_every"]
    assert [r["rung"] for r in rows] == [1, 4, 16]
    assert all(r["parity"] for r in rows)
    assert res["skipped"] == []
    assert res["key"] == autotune.current_key("cpu")
    assert not knobs.tuned()


def test_sweep_fake_clock_env(monkeypatch):
    monkeypatch.setenv(
        autotune.FAKE_CLOCK_ENV,
        json.dumps(
            {"streaming.persist_every": {"0": 0.5, "1": 2.0, "2": 2.0}}),
    )
    res = autotune.run_sweep(
        budget_s=600.0, only=["streaming.persist_every"], device="cpu")
    assert res["overrides"]["streaming.persist_every"] == 1
    assert len(res["evidence"]["streaming.persist_every"]) == 3


def test_sweep_rejects_verdict_flipping_rungs():
    def measure(run, name, idx):
        verdict = run()
        if idx == 0:  # cheapest rung "flips" the verdict
            return 0.0, {"valid?": "flipped"}
        return 1.0 + idx, verdict

    res = autotune.run_sweep(
        budget_s=600.0, only=["streaming.persist_every"], device="cpu",
        measure=measure)
    rows = res["evidence"]["streaming.persist_every"]
    assert rows[0]["parity"] is False
    assert res["overrides"]["streaming.persist_every"] == 4


def test_sweep_restores_an_active_profile():
    knobs.set_active({"dispatch.max_batch": 64}, source="p.json")
    autotune.run_sweep(
        budget_s=600.0, only=["txn_graph.packed_word_max_n"],
        device="cpu", measure=_planted_measure(
            {"txn_graph.packed_word_max_n": [1.0]}))
    assert knobs.active_overrides() == {"dispatch.max_batch": 64}


def test_sweep_unknown_knob_raises():
    with pytest.raises(ValueError):
        autotune.run_sweep(only=["nope.such_knob"], device="cpu")


def test_full_sweep_holds_parity_on_every_rung():
    """Every knob, every rung, on the CPU: each verdict equals its
    probe's baseline, so every rung is admissible."""
    res = autotune.run_sweep(
        budget_s=600.0, device="cpu",
        measure=lambda run, name, idx: (1.0 + idx, run()))
    assert sorted(res["evidence"]) == sorted(knobs.KNOBS)
    for name, rows in res["evidence"].items():
        assert len(rows) == len(knobs.KNOBS[name].domain), name
        assert all(r["parity"] for r in rows), name
    assert res["overrides"] == {n: k.domain[0]
                                for n, k in knobs.KNOBS.items()}


def test_verdict_parity_under_extreme_knobs():
    extreme = {
        "dispatch.max_batch": 64,
        "txn_graph.graph_buckets":
            knobs.KNOBS["txn_graph.graph_buckets"].domain[-1],
        "streaming.gc_window": 1,
        "streaming.persist_every": 1,
        "streaming.tail_len_bucket": 16,
    }
    for probe in ("linear", "txn", "stream"):
        run = autotune._PROBES[probe]("cpu")
        knobs.set_active({}, source=None)
        base = run()
        knobs.set_active(extreme, source="test-extreme")
        try:
            got = run()
        finally:
            knobs.set_active({}, source=None)
        assert got == base, f"{probe}: {got} != {base}"
        assert base.get("valid?") is not None, probe


# -- cli ----------------------------------------------------------------------


def test_cli_tune_exit_codes(monkeypatch, capsys):
    assert cli.main(["tune", "--backend", "cpu", "--dry-run"]) == 0
    out = capsys.readouterr().out
    assert "tune plan" in out and "dispatch.max_batch" in out
    assert not os.path.isdir(autotune.profile_dir()) or not os.listdir(
        autotune.profile_dir())
    assert cli.main(["tune", "--backend", "cpu", "--knobs",
                     "nope.such_knob"]) == cli.EXIT_USAGE
    assert cli.main(["tune", "--backend", "cpu", "--budget-s=-1"]) == 1
    assert "no profile written" in capsys.readouterr().out
    monkeypatch.setenv(
        autotune.FAKE_CLOCK_ENV,
        json.dumps({"streaming.persist_every": {"2": 0.1}}))
    assert cli.main(["tune", "--backend", "cpu", "--budget-s", "600",
                     "--knobs", "streaming.persist_every"]) == 0
    out = capsys.readouterr().out
    path = autotune.profile_path(autotune.current_key("cpu"))
    assert os.path.exists(path) and path in out
    got = autotune.load_profile(path, key=autotune.current_key("cpu"))
    assert got is not None
    assert got[0]["streaming.persist_every"] == 16
    knobs._reset_for_tests()
    knobs.ensure_profile("cpu")
    assert knobs.resolve("streaming.persist_every") == 16


@pytest.mark.parametrize("argv", [
    ["tune", "--dry-run"], ["tune", "--knobs", "nope.such_knob"],
    ["tune", "--budget-s=-1"],
])
def test_cli_tune_exits_as_the_reference(argv, capsys):
    """The same arguments (the port's on --backend cpu): the same exit;
    the dry-run's plan names the same knobs, the rung count of
    txn_graph.packed_word_max_n aside."""
    want = r_cli.main(argv)
    r_out = capsys.readouterr().out
    got = cli.main(argv + ["--backend", "cpu"])
    t_out = capsys.readouterr().out
    assert got == want

    def lines(out):
        return [ln for ln in out.splitlines()
                if "packed_word_max_n" not in ln]

    assert lines(t_out) == lines(r_out)


@pytest.mark.parametrize("argv", [["tune"], ["tune", "--dry-run"]])
def test_cli_tune_without_a_card_exits_254(monkeypatch, capsys, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(argv) == cli.EXIT_CRASH
    assert "CUDA is not available" in capsys.readouterr().err


def test_cli_analyze_profile_flag_warns_on_bad_profile(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text("{nope")
    cli._perf_setup(argparse.Namespace(profile=str(bad), backend="cpu"))
    assert "invalid, foreign, or stale" in capsys.readouterr().err
    assert not knobs.tuned()


def test_cli_profile_flag_loads_and_refuses_a_reference_profile(
        tmp_path, capsys):
    """--profile names a file: the port's loads (for the command's
    device), the reference's warns and leaves the defaults."""
    r_path = r_autotune.write_profile({"dispatch.max_batch": 64},
                                      key=r_autotune.current_key())
    cli._perf_setup(argparse.Namespace(profile=r_path, backend="cpu"))
    assert "invalid, foreign, or stale" in capsys.readouterr().err
    assert not knobs.tuned()
    t_path = autotune.write_profile(
        {"dispatch.max_batch": 128}, key=autotune.current_key("cpu"),
        path=str(tmp_path / "mine.json"))
    cli._perf_setup(argparse.Namespace(profile=t_path, backend="cpu"))
    assert capsys.readouterr().err == ""
    assert knobs.perf_snapshot()["profile"] == t_path
    assert knobs.resolve("dispatch.max_batch") == 128


def test_daemon_profile_flag_loads_before_the_plane(tmp_path, monkeypatch,
                                                   capsys):
    """`daemon --profile PATH` installs the profile before the daemon
    builds its plane, so the plane resolves the profile's knobs."""
    from jepsen_tpu_torch.service import server

    seen = {}

    class Daemon:
        url, member_id = "http://127.0.0.1:0", 0

        def __init__(self, **kw):
            plane = dp.DispatchPlane(device=kw["device"])
            seen["max_batch"] = plane.max_batch
            plane.close()

        def serve_forever(self):
            seen["tuned"] = knobs.tuned()

        def drain(self):
            pass

        def close(self):
            pass

    monkeypatch.setattr(server, "CheckerDaemon", Daemon)
    path = autotune.write_profile(
        {"dispatch.max_batch": 64}, key=autotune.current_key("cpu"),
        path=str(tmp_path / "p.json"))
    assert cli.main(["daemon", "--backend", "cpu", "--store",
                     str(tmp_path / "store"), "--port", "0",
                     "--profile", path]) == 0
    assert seen == {"max_batch": 64, "tuned": True}
    assert "drained. (code 0)" in capsys.readouterr().out


def test_analyze_with_profile_discloses_it(tmp_path):
    """`analyze --profile` on a stored run: the tuned profile is in
    engine_stats["perf"], and the verdict equals the untuned run's."""
    from jepsen_tpu_torch.history.history import History
    from jepsen_tpu_torch.store import Store

    root = str(tmp_path / "store")
    st = Store(root)
    h = sim.corrupt_history(
        sim.gen_register_history(random.Random(701), n_ops=30, n_procs=3,
                                 p_crash=0.05),
        random.Random(701))
    runs = [st.save_1({"name": f"r{i}", "workload": "register",
                       "history": History(h.ops, indexed=True)})
            for i in range(2)]
    assert cli.main(["analyze", runs[0], "--store", root,
                     "--backend", "cpu"]) == 1
    untuned = st.load_results(runs[0])
    path = autotune.write_profile(
        {"wgl_bitset.w_buckets": (13, 15, 17, 19),
         "dispatch.max_batch": 64},
        key=autotune.current_key("cpu"), path=str(tmp_path / "p.json"))
    assert cli.main(["analyze", runs[1], "--store", root, "--backend",
                     "cpu", "--profile", path]) == 1
    tuned = st.load_results(runs[1])
    perf = tuned["engine_stats"]["perf"]
    assert perf["tuned"] is True and perf["profile"] == path
    assert perf["config_hash"] == knobs.config_hash()
    assert untuned["engine_stats"]["perf"]["tuned"] is False
    keys = ("valid?", "failed_op_index", "failure", "window")
    assert untuned["valid?"] is False
    assert {k: tuned.get(k) for k in keys} == {
        k: untuned.get(k) for k in keys}


def test_engine_snapshot_discloses_perf_plane():
    from jepsen_tpu_torch.obs.snapshot import engine_snapshot

    knobs.set_active({"dispatch.max_batch": 64}, source="/tmp/p.json")
    snap = engine_snapshot()
    assert snap["perf"]["tuned"] is True
    assert snap["perf"]["profile"] == "/tmp/p.json"
    assert len(snap["perf"]["config_hash"]) == 12


# -- perf-trend --------------------------------------------------------------

_ROW = {"ts": "2026-08-06T00:00:00+00:00", "ops_per_sec": 1000.0,
        "vs_baseline": 2.0, "vs_python_oracle": 30.0,
        "syncs_per_check": 1.0, "sync_floor_ms": 94.0,
        "double_buffer_occupancy": 2.0, "trace_overhead_pct": 0.4,
        "smoke": False}


def _row(**kw):
    return dict(_ROW, **kw)


_HW = [_row(ts=f"2026-08-0{d}T00:00:00+00:00", vs_baseline=v,
            mode="hardware") for d, v in ((1, 11.0), (2, 11.2))]
_SMOKE = [_row(ts=f"2026-08-0{d}T01:00:00+00:00", vs_baseline=v,
               mode="smoke", smoke=True) for d, v in ((3, 2.5), (4, 2.6))]

#: ledger cases: (rows or None for no file, extra argv)
_LEDGERS = {
    "missing": (None, []),
    "empty": ([], []),
    "one_row": ([_ROW], []),
    "two_rows_ok": ([_ROW, _row(ts="2026-08-07T00:00:00+00:00",
                                vs_baseline=2.1)], []),
    "regression": ([_ROW, _row(ts="2026-08-07", vs_baseline=2.1),
                    _row(ts="2026-08-08", vs_baseline=1.0)], []),
    "tight_budget": ([_row(vs_baseline=2.1), _ROW],
                     ["--max-regression", "0.01"]),
    "modes_apart": (_HW + _SMOKE, []),
    "smoke_regressed": (_HW + _SMOKE + [_row(ts="2026-08-05T01", mode=
                        "smoke", smoke=True, vs_baseline=1.0)], []),
    "fleet_apart": ([_row(vs_baseline=5.0, fleet_size=2),
                     _row(vs_baseline=2.0),
                     _row(vs_baseline=5.1, fleet_size=2)], []),
    "config_drift": ([_row(vs_baseline=11.0, config_hash="aaaa11112222"),
                      _row(vs_baseline=5.0, config_hash="bbbb33334444",
                           tuned=True)], []),
    "repo_ledger": ("repo", []),
}


@pytest.mark.parametrize("case", sorted(_LEDGERS))
def test_perf_trend_equals_the_reference(case, tmp_path, capsys):
    """The same ledger through both packages' perf-trend: the same exit
    (0 ok, 1 regression, 2 no ledger) and the same printed table."""
    rows, extra = _LEDGERS[case]
    if rows == "repo":
        ledger = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "bench_runs", "trend.jsonl")
        assert os.path.exists(ledger)
    else:
        ledger = str(tmp_path / "trend.jsonl")
        if rows is not None:
            with open(ledger, "w") as f:
                f.write("".join(json.dumps(r) + "\n" for r in rows))
    argv = ["perf-trend", "--ledger", ledger, *extra]
    want = r_cli.main(argv)
    r_out = capsys.readouterr().out
    got = cli.main(argv)
    t_out = capsys.readouterr().out
    assert got == want
    assert t_out == r_out
    expect = {"missing": 2, "empty": 2, "regression": 1,
              "tight_budget": 1, "smoke_regressed": 1,
              "config_drift": 1}.get(case, 0)
    if case != "repo_ledger":
        assert got == expect


def test_trend_rows_carry_config_identity(tmp_path, capsys):
    """A row stamped with the port's config identity (its hash, the
    tuned mark, the resolved knobs, ladders as lists) is plain JSON,
    renders with its mark, and a hash change between two rows reads as
    config drift."""
    default_hash = knobs.config_hash()
    knobs.set_active({"dispatch.max_batch": 64}, source="p.json")
    row = _row(ts="2026-08-08", vs_baseline=1.0,
               config_hash=knobs.config_hash(), tuned=knobs.tuned(),
               knobs={k: list(v) if isinstance(v, tuple) else v
                      for k, v in knobs.active_config().items()})
    assert row["knobs"]["dispatch.max_batch"] == 64
    assert isinstance(row["knobs"]["wgl_bitset.w_buckets"], list)
    ledger = tmp_path / "trend.jsonl"
    ledger.write_text(json.dumps(_row(config_hash=default_hash)) + "\n"
                      + json.dumps(row) + "\n")
    assert cli.main(["perf-trend", "--ledger", str(ledger)]) == 1
    out = capsys.readouterr().out
    assert row["config_hash"][:8] + "*" in out
    assert (f"config drift: {default_hash[:8]} -> "
            f"{row['config_hash'][:8]}") in out


def test_gate_trend_attributes_drift_as_the_reference():
    base = {"mode": "hardware", "smoke": False}

    def mk(v, h=None):
        return dict(base, vs_baseline=v,
                    **({"config_hash": h} if h else {}))

    cases = [
        [mk(11.0, "aaaa11112222"), mk(5.0, "aaaa11112222")],
        [mk(11.0, "aaaa11112222"), mk(5.0, "bbbb33334444")],
        [mk(11.0), mk(5.0)],
        [mk(11.0), mk(11.5)],
        [mk(0.0), mk(1.0)],
    ]
    for rows in cases:
        for budget in (0.1, 0.5):
            assert trend.gate_trend(rows, budget) == r_trend.gate_trend(
                rows, budget)
    ok, msgs = trend.gate_trend(cases[1], 0.1)
    assert not ok
    assert any("config drift: aaaa1111 -> bbbb3333" in m for m in msgs)
    assert trend.drift_attribution({}, {}) == r_trend.drift_attribution(
        {}, {})
    for r in (_ROW, _HW[0], _SMOKE[0], _row(fleet_size="x"),
              _row(fleet_size=3)):
        assert trend.trend_key(r) == r_trend.trend_key(r)
