"""Single-register histories as Jepsen's etcd tutorial test records them
with no nemesis, as plain op dicts.

A discrete-event model of the run (the configuration file names its
source and every assumption):

- `concurrency` client threads, thread t as process t on node
  `t mod nodes`. Each thread sleeps a uniform random `[0, 2 * stagger_s)`
  before each op, draws read, write or cas in equal shares over `values`
  values, and invokes it on the one register. The run ends once
  `invocations` ops have been invoked and every one has completed.
- Every op completes after a latency drawn from `latency_s`, and takes
  effect at a uniform random point inside its interval on one shared
  register that starts at nil. A read sees the register's value then; a
  cas whose expected value differs from it fails (:fail) and changes
  nothing. No op crashes: a clean run has no :info op, and the process
  ids stay those of the threads.
- Each op carries its position in the history as its `index`, as
  Jepsen records every op of a history (and the port's store keeps
  it).

The history is linearizable by construction: the effect points are a
linearization.
"""

from __future__ import annotations

import heapq
import random
from typing import List

from portbench.gen._ops import item, pool_seeds
from portbench.gen.keyed import NS, _apply


def register_history(config: dict, seed: int) -> List[dict]:
    """One run's history, deterministic in `seed`."""
    rng = random.Random(f"portbench-register:{seed}")
    n_threads = config["concurrency"]
    n_ops = config["invocations"]
    n_values = config["values"]
    stagger2 = 2 * config["stagger_s"]
    lat_lo, lat_hi = config["latency_s"]
    uniform, randrange, choice = rng.uniform, rng.randrange, rng.choice

    ops: List[dict] = []
    state = None
    # (time, seq, thread, kind, op): kind 0 invokes, 1 takes effect,
    # 2 completes; seq keeps the heap's order total and stable
    events = [(uniform(0, stagger2), t, t, 0, None) for t in range(n_threads)]
    heapq.heapify(events)
    seq = n_threads
    issued = 0
    push, pop = heapq.heappush, heapq.heappop
    while events:
        t, _, th, kind, op = pop(events)
        if kind == 0:
            if issued == n_ops:
                continue
            issued += 1
            f = choice(("read", "write", "cas"))
            v = (None if f == "read" else randrange(n_values)
                 if f == "write" else [randrange(n_values),
                                       randrange(n_values)])
            ops.append({"type": "invoke", "f": f, "value": v,
                        "process": th, "time": int(t * NS),
                        "index": len(ops)})
            t_done = t + uniform(lat_lo, lat_hi)
            op = [f, v, None]
            push(events, (uniform(t, t_done), seq, th, 1, op))
            push(events, (t_done, seq + 1, th, 2, op))
            seq += 2
        elif kind == 1:
            f, v, _ = op
            ok, r, state = _apply(state, f, v)
            op[2] = (ok, r)
        else:
            f, _v, (ok, r) = op
            ops.append({"type": "ok" if ok else "fail", "f": f, "value": r,
                        "process": th, "time": int(t * NS),
                        "index": len(ops)})
            push(events, (t + uniform(0, stagger2), seq, th, 0, None))
            seq += 1
    if any(o["type"] == "info" for o in ops):
        raise RuntimeError("a clean run recorded an :info op")
    return ops


def corrupt_read(ops: List[dict], frac: float) -> List[dict]:
    """A copy of a register history in which the first ok read at or
    after `frac` of the history, and that saw a value, sees nil instead.
    No op writes nil, so once a write has completed the read cannot be
    linearized: the history fails at that read."""
    for i in range(int(frac * len(ops)), len(ops)):
        o = ops[i]
        if o["type"] == "ok" and o["f"] == "read" and o["value"] is not None:
            out = list(ops)
            out[i] = dict(o, value=None)
            return out
    raise ValueError(f"no ok read to corrupt after {frac}")


def build_pool(config: dict, traffic: dict, seed: int):
    """(valid items, corrupted items): `traffic["pool"]` histories, and
    for each [history, fraction] in `traffic["corrupt"]` a copy of that
    history (modulo the pool's size) with one read corrupted."""
    seeds = pool_seeds(seed, traffic["pool"])
    valid = [item(register_history(config, s), f"h{i}", False, False)
             for i, s in enumerate(seeds)]
    corrupted = []
    for h, frac in traffic["corrupt"]:
        src = valid[h % len(valid)]
        corrupted.append(item(corrupt_read(src["ops"], frac),
                              f"{src['label']}@{frac}", True, False))
    return valid, corrupted
