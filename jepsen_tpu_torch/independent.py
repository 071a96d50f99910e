"""Independent keyed-shard lifting, the analysis side: the counterpart of
jepsen_tpu.independent's KV values and IndependentChecker (the
reference's jepsen/src/jepsen/independent.clj: `tuple` values pair a
key with the underlying op value, :21-29; `checker` splits the history
into per-key subhistories and checks each, :247-298). The generators
(:31-220) are control plane and are not ported.
"""

from __future__ import annotations

import os
import urllib.parse
from collections import Counter
from typing import Any, Dict, List, Optional


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
