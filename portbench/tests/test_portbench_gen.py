"""The keyed generator against its configuration: the same seed gives
the same history, every key gets its ops, and crashes come only from
the threads on the cut-off nodes while the nemesis has the cluster cut,
as read back from the history itself; the benchmark's own window count
agrees with the program's."""

import pytest

from jepsen_tpu_torch.checker.events import history_to_events
from jepsen_tpu_torch.history.history import History
from portbench.gen import keyed
from portbench.reference import cas_register
from portbench.tests._tiny import config

FULL = config(keys=16, ops_per_key=300, nemesis_interval_s=10.0,
              timeout_s=5.0, election_s=1.0)


def _cuts(ops):
    """[(start, end, isolated node numbers)] from the nemesis's ops."""
    out, start = [], None
    for o in ops:
        if o["process"] != "nemesis" or o["value"] is None:
            continue
        if o["f"] == "start":
            start = (o["time"], {int(n[1:]) - 1 for n in
                                 o["value"].split()[1:]})
        elif start is not None:
            out.append((start[0], o["time"], start[1]))
            start = None
    if start is not None:
        out.append((start[0], float("inf"), start[1]))
    return out


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**62 + 5])
def test_history_follows_the_partition_schedule(seed):
    cfg = FULL
    ops = keyed.etcd_history(cfg, seed)
    assert ops == keyed.etcd_history(cfg, seed)
    cuts = _cuts(ops)
    assert cuts and cuts[0][0] == cfg["nemesis_interval_s"] * 1e9
    invoked_at = {}
    crashed_keys = set()
    for o in ops:
        p = o["process"]
        if not isinstance(p, int):
            continue
        if o["type"] == "invoke":
            invoked_at[p] = o
            continue
        inv = invoked_at.pop(p)
        if o["type"] == "info" or (o["type"] == "fail"
                                   and o["f"] == "read"):
            node = (p % cfg["concurrency"]) % cfg["nodes"]
            t = inv["time"]
            assert any(a <= t < b and node in iso for a, b, iso in cuts), o
            assert o["time"] - t == pytest.approx(cfg["timeout_s"] * 1e9,
                                                  abs=1)
            if o["type"] == "info":
                crashed_keys.add(o["value"][0])
                assert o["f"] in ("write", "cas")
    subs = cas_register.split_keys(ops)
    assert sorted(subs) == list(range(cfg["keys"]))
    healthy = []
    for k, sub in subs.items():
        assert sum(o["type"] == "invoke" for o in sub) == cfg["ops_per_key"]
        t0, t1 = sub[0]["time"], max(o["time"] for o in sub)
        if not any(a < t1 and t0 < b for a, b, _ in cuts):
            healthy.append(k)
            assert k not in crashed_keys
    # the first cut comes after about 10 s of healthy keys
    assert len(healthy) >= 6 and crashed_keys


@pytest.mark.parametrize("seed", [3, 2**40 + 1])
def test_window_count_matches_the_program(seed):
    ops = keyed.etcd_history(FULL, seed)
    for sub in cas_register.split_keys(ops).values():
        ev = history_to_events(History(sub), model="cas-register")
        assert ev.window == cas_register.peak_window(sub)


def test_pool():
    cfg = config()
    tr = {"pool": 2, "corrupt": [[0, 1, 0.5], [1, 8, 0.3]]}
    valid, corrupted = keyed.build_pool(cfg, tr, 123)
    assert len(valid) == 2 and len(corrupted) == 2
    for it in valid:
        assert it["invoked"] == cfg["keys"] * cfg["ops_per_key"]
        assert it["keyed"] and not it["corrupt"]
    diffs = [i for i, (a, b) in enumerate(zip(valid[1]["ops"],
                                              corrupted[1]["ops"])) if a != b]
    assert len(diffs) == 1
    assert corrupted[1]["ops"][diffs[0]]["value"] == [8 % cfg["keys"], None]
    again, _ = keyed.build_pool(cfg, tr, 123)
    assert again[0]["ops"] == valid[0]["ops"]
