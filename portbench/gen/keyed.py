"""Keyed register histories as the etcd suite records them under its
partition nemesis, as plain op dicts.

A discrete-event model of the suite's run (the configuration file names
its source and every assumption):

- One group of `concurrency` threads works one key at a time
  (jepsen.independent's concurrent generator): each thread sleeps a
  uniform random `[0, 2 * stagger_s)` before each op, draws read, write
  or cas in equal shares over `values` values, and invokes it on the
  group's current key. Once `ops_per_key` ops of a key have been
  invoked the group moves to the next key; an op still open completes
  on the key it was invoked on. The run ends with `keys` keys.
- Thread t talks to node `t mod nodes`. The nemesis sleeps
  `nemesis_interval_s`, cuts the nodes into random halves, sleeps again,
  heals, and so on. While cut, an op sent to a node of the minority half
  times out after `timeout_s`: a read fails (:fail), a write or cas
  crashes (:info) and its thread takes a new process. When the cut
  leaves the leader in the minority, the majority's ops wait
  `election_s` for a new leader.
- Every other op completes after a latency drawn from `latency_s`.
- Every op takes effect at a point inside its interval, so the history
  is linearizable by construction: a completed op at its invocation or
  at its completion, in equal shares; a crashed write or cas at its
  invocation with probability `p_info_applied`, else never.

Keys are disjoint registers; every client op's value is [key, value].
The nemesis's own ops (process "nemesis") are in the history too, as
Jepsen records them.
"""

from __future__ import annotations

import heapq
import random
from typing import List

from portbench.gen._ops import corrupt_key_read, item, pool_seeds

NS = 1_000_000_000


def _apply(state, f, v):
    """The cas register: (ok, value to report, state')."""
    if f == "read":
        return True, state, state
    if f == "write":
        return True, v, v
    if state == v[0]:
        return True, v, v[1]
    return False, v, state


def etcd_history(config: dict, seed: int) -> List[dict]:
    """One run's history, deterministic in `seed`."""
    rng = random.Random(f"portbench-etcd:{seed}")
    n_threads = config["concurrency"]
    n_nodes = config["nodes"]
    n_keys = config["keys"]
    per_key = config["ops_per_key"]
    n_values = config["values"]
    stagger = config["stagger_s"]
    timeout = config["timeout_s"]
    interval = config["nemesis_interval_s"]
    election = config["election_s"]
    lat_lo, lat_hi = config["latency_s"]
    p_applied = config["p_info_applied"]
    minority = n_nodes // 2

    ops: List[dict] = []
    state = {}
    # nemesis: cut k covers [cut_at(k), cut_at(k) + interval)
    cuts = {}  # k -> (minority nodes, leader lost?)
    leader = rng.randrange(n_nodes)

    def cut_of(t):
        k = int(t // interval)
        if k % 2 == 0:
            return None
        return k

    def cut(k):
        nonlocal leader
        if k not in cuts:
            nodes = list(range(n_nodes))
            rng.shuffle(nodes)
            lost = leader in nodes[:minority]
            cuts[k] = (frozenset(nodes[:minority]), lost)
            if lost:
                leader = rng.choice(nodes[minority:])
        return cuts[k]

    events = []  # (time, seq, kind, thread, payload)
    seq = 0

    def push(t, kind, thread, payload=None):
        nonlocal seq
        heapq.heappush(events, (t, seq, kind, thread, payload))
        seq += 1

    process = list(range(n_threads))
    key = 0
    issued = 0
    for t in range(n_threads):
        push(rng.uniform(0, 2 * stagger), "free", t)
    next_nemesis = interval
    done = False
    while events:
        t, _, kind, th, payload = heapq.heappop(events)
        while next_nemesis <= t:
            k = int(round(next_nemesis / interval))
            tn = int(next_nemesis * NS)
            f = "start" if k % 2 else "stop"
            desc = None
            if f == "start":
                nodes, _lost = cut(k)
                desc = "isolated " + " ".join(f"n{n + 1}"
                                              for n in sorted(nodes))
            ops.append({"type": "info", "f": f, "value": None,
                        "process": "nemesis", "time": tn})
            ops.append({"type": "info", "f": f, "value": desc,
                        "process": "nemesis", "time": tn})
            next_nemesis += interval
        if kind == "free":
            if issued == per_key:
                key += 1
                issued = 0
            if key == n_keys:
                done = True
                continue
            f = rng.choice(("read", "write", "cas"))
            v = (None if f == "read" else rng.randrange(n_values)
                 if f == "write" else [rng.randrange(n_values),
                                       rng.randrange(n_values)])
            p = process[th]
            ops.append({"type": "invoke", "f": f, "value": [key, v],
                        "process": p, "time": int(t * NS)})
            issued += 1
            k = cut_of(t)
            node = th % n_nodes
            s = state.get(key)
            if k is not None and node in cut(k)[0]:
                # the node cannot reach a quorum: a timeout
                if f != "read" and rng.random() < p_applied:
                    _ok, _r, state[key] = _apply(s, f, v)
                push(t + timeout, "crash", th, (key, f, v, p))
                continue
            start = t
            if k is not None and cut(k)[1]:
                start = max(t, k * interval + election)
            t_done = start + rng.uniform(lat_lo, lat_hi)
            if rng.random() < 0.5:  # takes effect at its invocation
                ok, r, state[key] = _apply(s, f, v)
                push(t_done, "done", th, (key, f, v, p, (ok, r)))
            else:
                push(t_done, "done", th, (key, f, v, p, None))
        elif kind == "crash":
            k_, f, v, p = payload
            ops.append({"type": "fail" if f == "read" else "info", "f": f,
                        "value": [k_, v], "process": p, "time": int(t * NS)})
            if f != "read":
                process[th] += n_threads
            if not done:
                push(t + rng.uniform(0, 2 * stagger), "free", th)
        else:
            k_, f, v, p, early = payload
            if early is None:  # takes effect at its completion
                ok, r, state[k_] = _apply(state.get(k_), f, v)
            else:
                ok, r = early
            ops.append({"type": "ok" if ok else "fail", "f": f,
                        "value": [k_, r], "process": p,
                        "time": int(t * NS)})
            if not done:
                push(t + rng.uniform(0, 2 * stagger), "free", th)
    return ops


def build_pool(config: dict, traffic: dict, seed: int):
    """(valid items, corrupted items): `traffic["pool"]` histories, and
    for each [history, key, fraction] in `traffic["corrupt"]` a copy of
    that history with one read of that key corrupted (history and key
    taken modulo the pool's and the run's)."""
    seeds = pool_seeds(seed, traffic["pool"])
    valid = [item(etcd_history(config, s), f"h{i}", False, True)
             for i, s in enumerate(seeds)]
    corrupted = []
    for h, k, frac in traffic["corrupt"]:
        src = valid[h % len(valid)]
        k %= config["keys"]
        corrupted.append(item(corrupt_key_read(src["ops"], k, frac),
                              f"{src['label']}k{k}@{frac}", True, True))
    return valid, corrupted
