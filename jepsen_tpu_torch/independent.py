"""Independent keyed-shard lifting: the counterpart of
jepsen_tpu.independent (the reference's
jepsen/src/jepsen/independent.clj). `tuple` values pair a key with the
underlying op value (:21-29); `sequential_generator` walks keys one at
a time (:31-64); `concurrent_generator` partitions threads into fixed
groups of n per key, rotating groups over the key sequence (:66-220);
`checker` splits the history into per-key subhistories and checks each
(:247-298). The generators are stdlib copies of the reference's; the
checker modules import this one, so it never imports the runtime.
"""

from __future__ import annotations

import os
import urllib.parse
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence

from jepsen_tpu_torch.generator import pure as gen


class KV:
    """A [key value] tuple value (independent.clj:21-29). Equality and
    hashing are structural; repr matches the reference's [k v] print."""

    __slots__ = ("key", "value")

    def __init__(self, key, value):
        self.key = key
        self.value = value

    def __iter__(self):
        return iter((self.key, self.value))

    def __eq__(self, other):
        return (
            isinstance(other, KV)
            and self.key == other.key
            and self.value == other.value
        )

    def __hash__(self):
        try:
            return hash((self.key, self.value))
        except TypeError:
            return hash(self.key)

    def __repr__(self):
        return f"[{self.key!r} {self.value!r}]"


def tuple_(key, value) -> KV:
    return KV(key, value)


def _wrap_kv(key):
    def wrap(op):
        op = dict(op)
        op["value"] = KV(key, op.get("value"))
        return op

    return wrap


class SequentialGenerator(gen.Generator):
    """One key at a time: runs gen_fn(key) to exhaustion, then moves to
    the next key (independent.clj:31-64)."""

    def __init__(self, keys: Sequence[Any], gen_fn: Callable[[Any], Any],
                 _active=None):
        self.keys = list(keys)
        self.gen_fn = gen_fn
        self._active = _active

    def op(self, test, ctx):
        keys, active = list(self.keys), self._active
        while True:
            if active is None:
                if not keys:
                    return None
                k = keys.pop(0)
                active = gen.gmap(_wrap_kv(k), self.gen_fn(k))
            pair = gen.op(active, test, ctx)
            if pair is None:
                active = None
                continue
            o, g2 = pair
            return o, SequentialGenerator(keys, self.gen_fn, g2)

    def update(self, test, ctx, event):
        if self._active is None:
            return self
        return SequentialGenerator(
            self.keys, self.gen_fn,
            gen.update(self._active, test, ctx, event),
        )


def sequential_generator(keys, gen_fn) -> SequentialGenerator:
    return SequentialGenerator(keys, gen_fn)


class ConcurrentGenerator(gen.Generator):
    """Thread groups of size n, each group working its own key: group g
    serves keys g, g+G, g+2G, ... where G is the group count
    (independent.clj:66-220). Requires concurrency to be a multiple of
    n; the nemesis thread is untouched."""

    def __init__(self, n: int, keys: Sequence[Any],
                 gen_fn: Callable[[Any], Any], _state=None):
        self.n = n
        self.keys = list(keys)
        self.gen_fn = gen_fn
        # per-group: {"gen": current sub-gen or None, "next": next key
        # index to claim}
        self._state = _state

    def _group_of(self, thread) -> Optional[int]:
        if isinstance(thread, str):
            return None
        return thread // self.n

    def _init_state(self, ctx) -> Dict[int, dict]:
        client_threads = [
            t for t in gen.all_threads(ctx) if not isinstance(t, str)
        ]
        if len(client_threads) % self.n:
            raise ValueError(
                f"concurrency ({len(client_threads)} client threads) "
                f"must be a multiple of the group size {self.n}"
            )
        n_groups = max(len(client_threads) // self.n, 1)
        return {
            "groups": {
                g: {"gen": None, "fresh": True, "next": g}
                for g in range(n_groups)
            },
            "n_groups": n_groups,
        }

    def op(self, test, ctx):
        st = self._state or self._init_state(ctx)
        groups = {g: dict(v) for g, v in st["groups"].items()}
        n_groups = st["n_groups"]

        for thread in gen.free_threads(ctx):
            g = self._group_of(thread)
            if g is None or g not in groups:
                continue
            grp = groups[g]
            # Claim keys until we find one with work (or run out).
            while True:
                if grp["gen"] is None:
                    if grp["next"] >= len(self.keys):
                        break
                    k = self.keys[grp["next"]]
                    grp["next"] += n_groups
                    grp["gen"] = gen.gmap(_wrap_kv(k), self.gen_fn(k))
                sub_ctx = gen.on_threads_context(
                    lambda t, g=g: self._group_of(t) == g, ctx
                )
                pair = gen.op(grp["gen"], test, sub_ctx)
                if pair is None:
                    grp["gen"] = None
                    continue
                o, g2 = pair
                if o is gen.PENDING:
                    break
                grp["gen"] = g2
                new_state = {
                    "groups": groups, "n_groups": n_groups,
                }
                return o, ConcurrentGenerator(
                    self.n, self.keys, self.gen_fn, new_state
                )
        if all(
            grp["gen"] is None and grp["next"] >= len(self.keys)
            for grp in groups.values()
        ):
            return None
        return gen.PENDING, ConcurrentGenerator(
            self.n, self.keys, self.gen_fn,
            {"groups": groups, "n_groups": n_groups},
        )

    def update(self, test, ctx, event):
        if self._state is None:
            return self
        val = event.get("value")
        if not isinstance(val, KV):
            return self
        thread = gen.process_to_thread(ctx, event.get("process"))
        g = self._group_of(thread) if thread is not None else None
        if g is None or g not in self._state["groups"]:
            return self
        groups = {h: dict(v) for h, v in self._state["groups"].items()}
        grp = groups[g]
        if grp["gen"] is not None:
            sub_ctx = gen.on_threads_context(
                lambda t: self._group_of(t) == g, ctx
            )
            ev = dict(event)
            ev["value"] = val.value
            grp["gen"] = gen.update(grp["gen"], test, sub_ctx, ev)
        return ConcurrentGenerator(
            self.n, self.keys, self.gen_fn,
            {"groups": groups, "n_groups": self._state["n_groups"]},
        )


def concurrent_generator(n, keys, gen_fn) -> ConcurrentGenerator:
    return ConcurrentGenerator(n, keys, gen_fn)


class IndependentChecker:
    """Splits a history of KV-valued ops into per-key subhistories and
    checks each with the sub-checker (independent.clj:247-298); the
    verdict is valid iff every key's is, with per-key results. Where
    the test has a run directory (opts["subdirectory"], else
    test["run_dir"]), each key's results.json and history.jsonl go to
    <run_dir>/independent/<key>/ (independent.clj:266-288)."""

    def __init__(self, checker):
        self.checker = checker

    def check(self, test, history, opts=None) -> dict:
        from jepsen_tpu_torch.history.history import History
        from jepsen_tpu_torch.store import (
            write_history_jsonl,
            write_results_json,
        )

        if not isinstance(history, History):
            history = History(list(history))
        subhistories: Dict[Any, List] = {}
        for op in history.ops:
            v = op.value
            if not isinstance(v, KV):
                continue
            subhistories.setdefault(v.key, []).append(
                op.with_(value=v.value)
            )
        run_dir = (opts or {}).get("subdirectory") or (
            test.get("run_dir") if isinstance(test, dict) else None
        )
        used_names: Dict[str, int] = {}

        def key_dirname(k) -> str:
            # Percent-encode (no separators), uniquify colliding str()
            # forms (int 1 vs str "1"), and guard the dot names quote()
            # leaves unescaped. Generated names register too: quote()
            # leaves '~' alone, so a literal key "1~1" must not collide.
            name = urllib.parse.quote(str(k), safe="")
            if name in ("", ".", ".."):
                name = f"k_{name.replace('.', '_')}"
            while True:
                n = used_names.get(name, 0)
                used_names[name] = n + 1
                if n == 0:
                    return name
                name = f"{name}~{n}"

        results = {}
        any_false = any_unknown = False
        for k, ops in sorted(
            subhistories.items(), key=lambda kv: str(kv[0])
        ):
            sub = History(ops)
            sub_opts = dict(opts or {})
            key_dir = None
            if run_dir:
                key_dir = os.path.join(
                    run_dir, "independent", key_dirname(k)
                )
                os.makedirs(key_dir, exist_ok=True)
                sub_opts["subdirectory"] = key_dir
            r = self.checker.check(test, sub, sub_opts)
            results[k] = r
            if key_dir:
                write_results_json(os.path.join(key_dir, "results.json"), r)
                write_history_jsonl(
                    os.path.join(key_dir, "history.jsonl"), sub.ops
                )
            v = r.get("valid?")
            if v is False:
                any_false = True
            elif v is not True:
                any_unknown = True
        # merge lattice: False dominates unknown dominates True
        # (checker.clj:26-69's merge-valid)
        out = {
            "valid?": (
                False if any_false else ("unknown" if any_unknown else True)
            ),
            "key_count": len(subhistories),
            "results": results,
        }
        stats = engine_stats(results.values())
        if stats is not None:
            out["engine_stats"] = stats
        return out


def independent_checker(checker) -> IndependentChecker:
    return IndependentChecker(checker)


def engine_stats(verdicts) -> Optional[dict]:
    """Aggregate engine statistics over per-key verdicts: which engine
    decided each key, the window distribution, escalation and taint
    counts. None when no verdict carries engine fields
    (non-linearizability checkers)."""
    engines: Counter = Counter()
    windows: Counter = Counter()
    escalations = 0
    taints = 0
    seen = False
    for r in verdicts:
        if not isinstance(r, dict) or "method" not in r:
            continue
        seen = True
        engines[r["method"]] += 1
        escalations += r.get("escalations", 0) or 0
        if r.get("taint"):
            taints += 1
        w = r.get("window")
        if w is not None:
            windows[w] += 1
    if not seen:
        return None
    return {
        "engines": dict(engines),
        "windows": {str(k): v for k, v in sorted(windows.items())},
        "escalations": escalations,
        "taints": taints,
    }
