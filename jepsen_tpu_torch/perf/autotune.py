"""Profile store + min-of-N verdict-parity-checked knob sweep: a copy of
jepsen_tpu.perf.autotune over the port's checkers.

A profile is one JSON per key. The reference keys by backend, device
count and jax version; the port keys by backend ("cuda" or "cpu"), the
device count, the card's name and the torch and CUDA versions
(``current_key``): a sweep right for one card is wrong for another and
for the CPU, and a torch or CUDA upgrade moves the kernels' builds
under the knobs. Profiles share the reference's directory
(``~/.cache/jepsen_tpu/perf_profiles``, ``JEPSEN_TPU_PROFILE_DIR``) and
are told apart by their file stems; a profile written by either package
carries the other's key fields as missing, so it reads as foreign there
and gives the defaults. Loading is paranoid and silent: a corrupt,
foreign-keyed or stale profile degrades to registry defaults; the perf
plane may never change a verdict or break a construction.

The sweep is coordinate descent over the registry in declaration order:
each knob's rungs are timed min-of-N on a small probe workload (the
reference's three probe inputs, seed for seed: a CAS-register history,
a txn history with a G1c cycle, a chunked streaming append run), run
through the port's checkers on the sweep's device, each run on a fresh
DispatchPlane that it closes. On the card the linear and stream probes
launch kernel A (csrc/bitset_scan.cu) and the txn probe the graph
program (txn_graph.graph_counts_torch). A rung is only eligible if its
verdict is identical to the all-defaults verdict for that probe.
Timings order rungs; parity decides admission. A wall budget caps the
whole sweep: knobs the budget never reached keep their defaults.

The profile file is byte-stable by construction (canonical JSON, sorted
keys, no timestamps); sweep evidence (timings, parity verdicts, what
the budget skipped) goes to a sibling ``*.evidence.json`` that makes no
stability promise. The reference's persistent XLA compile cache has no
counterpart: the port's kernels build into ``build/jepsen_tpu_torch/``.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from jepsen_tpu_torch.perf import knobs as _kn

#: profile file schema version (bump on incompatible layout change)
PROFILE_SCHEMA = 1

#: explicit profile path override (cli analyze --profile exports it;
#: tests point it at fixtures)
PROFILE_ENV = "JEPSEN_TPU_PROFILE"

#: profile directory override (tests; multi-user hosts)
PROFILE_DIR_ENV = "JEPSEN_TPU_PROFILE_DIR"

#: planted-cost table for deterministic sweeps (tests): JSON mapping
#: knob name -> {rung_index: cost_s}; probes still run once per rung so
#: parity stays real, only the clock is planted
FAKE_CLOCK_ENV = "JEPSEN_TPU_TUNE_FAKE_CLOCK"

#: the fields of a profile key, all compared on load
KEY_FIELDS = ("backend", "n_devices", "device_name", "torch_version",
              "cuda_version")

#: every port profile's stem carries this (profile_path), so the
#: construction gate ignores the reference's profiles in the shared
#: directory and never initializes CUDA for them
_STEM_MARK = "-torch"


# -- the cache-root convention ----------------------------------------------


def cache_root() -> str:
    """``~/.cache/jepsen_tpu``: the reference's root, shared by both
    packages' profiles (told apart by their stems)."""
    return os.path.expanduser("~/.cache/jepsen_tpu")


def profile_dir() -> str:
    return os.environ.get(PROFILE_DIR_ENV) or os.path.join(
        cache_root(), "perf_profiles"
    )


def current_key(device=None) -> dict:
    """The profile key of ``device`` (None: the card, raising without
    one; "cpu": the CPU). Touching a CUDA device initializes CUDA, so
    callers on the no-profile fast path must not get here."""
    import torch

    from jepsen_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        idx = (dev.index if dev.index is not None
               else torch.cuda.current_device())
        name, n = torch.cuda.get_device_name(idx), torch.cuda.device_count()
    else:
        name, n = "cpu", 1
    return {
        "backend": dev.type,
        "n_devices": int(n),
        "device_name": str(name),
        "torch_version": str(torch.__version__),
        "cuda_version": str(torch.version.cuda or "none"),
    }


def profile_path(key: Optional[dict] = None) -> str:
    key = key or current_key()
    stem = "{}-{}dev-{}-torch{}-cuda{}".format(
        key["backend"], key["n_devices"], key["device_name"],
        key["torch_version"], key["cuda_version"],
    )
    stem = re.sub(r"[^A-Za-z0-9._-]", "_", stem)
    return os.path.join(profile_dir(), stem + ".json")


def any_profile_present() -> bool:
    """Cheap torch-free gate for knobs.ensure_profile: is there a port
    profile (or an explicit env override) worth keying against? The
    reference's profiles in the shared directory do not count."""
    if os.environ.get(PROFILE_ENV):
        return True
    d = profile_dir()
    try:
        names = os.listdir(d)
    except OSError:
        return False
    return any(
        n.endswith(".json") and not n.endswith(".evidence.json")
        and _STEM_MARK in n
        for n in names
    )


# -- profile read/write ------------------------------------------------------


def _canonical_profile(overrides: Dict[str, Any], key: dict) -> str:
    """The byte-stable profile document: canonical JSON, sorted keys,
    ladders as lists, no timestamps."""
    cfg = {n: _kn.KNOBS[n].default for n in _kn.KNOBS}
    cfg.update({n: _kn.coerce(n, v) for n, v in overrides.items()})
    doc = {
        "schema": PROFILE_SCHEMA,
        "key": {k: key[k] for k in KEY_FIELDS},
        "knobs": {
            n: list(v) if isinstance(v, tuple) else v
            for n, v in sorted(overrides.items())
        },
        "config_hash": _kn.config_hash(cfg),
    }
    return json.dumps(doc, sort_keys=True, indent=2) + "\n"


def write_profile(
    overrides: Dict[str, Any],
    key: Optional[dict] = None,
    evidence: Optional[dict] = None,
    path: Optional[str] = None,
) -> str:
    """Atomically persist a winning override set for a key (None: the
    card's); returns the profile path. Evidence (timings, parity,
    budget skips) goes to a sibling ``.evidence.json`` so the profile
    itself stays byte-stable."""
    from jepsen_tpu_torch.store import atomic_write_text

    key = key or current_key()
    path = path or profile_path(key)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    # bad overrides fail HERE (loudly, at tune time), not at load time
    for n, v in overrides.items():
        if n not in _kn.KNOBS:
            raise ValueError(f"unknown knob: {n}")
        _kn.coerce(n, v)
    atomic_write_text(path, _canonical_profile(overrides, key))
    if evidence is not None:
        atomic_write_text(
            re.sub(r"\.json$", "", path) + ".evidence.json",
            json.dumps(evidence, sort_keys=True, indent=2,
                       default=str) + "\n",
        )
    return path


def load_profile(
    path: Optional[str] = None, key: Optional[dict] = None
) -> Optional[Tuple[Dict[str, Any], dict]]:
    """Parse + validate one profile file against ``key`` (None: the
    card's). Returns (overrides, doc) or None on ANY defect:
    missing file, torn/corrupt JSON, wrong schema, a foreign key
    (another backend, device count or card, or a profile of the
    reference), stale torch or CUDA versions, an out-of-kind knob
    value, or a config_hash that does not match the knobs it claims to
    describe. The caller never sees an exception: a bad profile IS the
    defaults."""
    try:
        want = key or current_key()
        if path is None:
            path = profile_path(want)
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        if not isinstance(doc, dict) or doc.get("schema") != PROFILE_SCHEMA:
            return None
        pkey = doc.get("key")
        if not isinstance(pkey, dict):
            return None
        for field in KEY_FIELDS:
            if pkey.get(field) != want[field]:
                return None  # foreign (backend/devices/card) or stale
        raw = doc.get("knobs")
        if not isinstance(raw, dict):
            return None
        overrides: Dict[str, Any] = {}
        for n, v in raw.items():
            if n not in _kn.KNOBS:
                continue  # a future/retired knob: ignore, keep the rest
            overrides[n] = _kn.coerce(n, v)
        cfg = {n: _kn.KNOBS[n].default for n in _kn.KNOBS}
        cfg.update(overrides)
        if doc.get("config_hash") != _kn.config_hash(cfg):
            return None  # edited/corrupt: hash no longer matches
        return overrides, doc
    except Exception:
        return None


def load_active_profile(device=None) -> Optional[str]:
    """Load the persisted profile of ``device``'s key (or the explicit
    JEPSEN_TPU_PROFILE path, checked against that key) and install it
    as the active override set. Returns the path on success, None when
    the process stays on defaults."""
    try:
        key = current_key(device)
    except Exception:
        return None
    path = os.environ.get(PROFILE_ENV) or profile_path(key)
    got = load_profile(path, key=key)
    if got is None:
        return None
    overrides, _doc = got
    _kn.set_active(overrides, source=path)
    return path


# -- probe workloads ---------------------------------------------------------
#
# The reference's probe inputs, seeded so every sweep on every host
# replays the identical histories. Each probe returns a zero-arg runner
# whose return value is the probe's PARITY SIGNATURE: the verdict fields
# a knob is never allowed to change.


def _probe_linear(device) -> Callable[[], dict]:
    import random

    from jepsen_tpu_torch import sim

    hist = sim.gen_register_history(
        random.Random(1234), n_ops=24, n_procs=3
    )

    def run() -> dict:
        from jepsen_tpu_torch.checker import dispatch as dp
        from jepsen_tpu_torch.checker.linearizable import (
            LinearizableChecker,
        )

        plane = dp.DispatchPlane(device=device)
        try:
            out = LinearizableChecker(plane=plane).check(
                {"name": "tune-probe"}, hist
            )
        finally:
            plane.close()
        return {"valid?": out.get("valid?")}

    return run


def _probe_txn(device) -> Callable[[], dict]:
    import random

    from jepsen_tpu_torch import sim

    hist = sim.gen_txn_graph_history(
        random.Random(99), n_txns=24, txns_per_group=8,
        anomaly="g1c",
    )

    def run() -> dict:
        from jepsen_tpu_torch.checker import dispatch as dp
        from jepsen_tpu_torch.checker.txn_graph import TxnGraphChecker

        plane = dp.DispatchPlane(device=device)
        try:
            v = TxnGraphChecker(plane=plane).check(
                {"name": "tune-probe"}, hist
            )
        finally:
            plane.close()
        return {"valid?": v.get("valid?"), "census": v.get("census")}

    return run


def _probe_stream(device) -> Callable[[], dict]:
    import random
    import tempfile

    from jepsen_tpu_torch import sim

    ops = list(sim.gen_register_history(
        random.Random(7), n_ops=24, n_procs=3
    ))

    def run() -> dict:
        from jepsen_tpu_torch.checker import dispatch as dp
        from jepsen_tpu_torch.checker.streaming import StreamingCheck

        out: dict = {}
        plane = dp.DispatchPlane(device=device)
        try:
            with tempfile.TemporaryDirectory() as td:
                sc = StreamingCheck(
                    model="cas-register", device=device, plane=plane,
                    path=os.path.join(td, "stream.json"),
                )
                for i in range(0, len(ops), 6):
                    out = sc.append(ops[i:i + 6])
        finally:
            plane.close()
        return {"valid?": out.get("valid?")}

    return run


_PROBES = {
    "linear": _probe_linear,
    "txn": _probe_txn,
    "stream": _probe_stream,
}


# -- the sweep ---------------------------------------------------------------


def _fake_measure_from_env() -> Optional[Callable]:
    raw = os.environ.get(FAKE_CLOCK_ENV)
    if not raw:
        return None
    if raw.startswith("@"):
        with open(raw[1:], encoding="utf-8") as f:
            table = json.load(f)
    else:
        table = json.loads(raw)

    def measure(run, name, idx):
        verdict = run()  # parity stays real; only the clock is planted
        cost = table.get(name, {}).get(
            str(idx), 1.0 + idx * 1e-3
        )
        return float(cost), verdict

    return measure


def run_sweep(
    budget_s: float = 60.0,
    only: Optional[List[str]] = None,
    *,
    device=None,
    clock: Callable[[], float] = time.perf_counter,
    measure: Optional[Callable] = None,
    reps: int = 2,
) -> dict:
    """Coordinate descent over the registry under a wall budget, with
    the probes on ``device`` (None: the card, raising without one).

    ``measure(run, knob_name, rung_index) -> (cost_s, verdict)`` is
    the seam the fake-clock tests inject; the default times ``run()``
    min-of-``reps``. Returns a result dict with the winning
    ``overrides``, per-knob ``evidence``, what the budget ``skipped``,
    and the sweep ``key``."""
    for n in only or ():
        if n not in _kn.KNOBS:
            raise ValueError(f"unknown knob: {n}")
    selected = [n for n in _kn.KNOBS if only is None or n in set(only)]

    if measure is None:
        measure = _fake_measure_from_env()
    if measure is None:
        def measure(run, name, idx):  # noqa: F811 - the default seam
            best, verdict = None, None
            for _ in range(max(1, reps)):
                t0 = clock()
                verdict = run()
                dt = clock() - t0
                best = dt if best is None else min(best, dt)
            return best, verdict

    from jepsen_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    key = current_key(dev)
    prior = _kn.active_overrides()
    start = clock()
    winners: Dict[str, Any] = {}
    evidence: Dict[str, Any] = {}
    skipped: List[str] = []
    baselines: Dict[str, dict] = {}
    runners: Dict[str, Callable] = {}
    try:
        _kn.set_active({}, source=None)  # sweep from clean defaults
        for name in selected:
            if clock() - start > budget_s:
                skipped.append(name)
                continue
            k = _kn.KNOBS[name]
            if k.probe not in runners:
                runners[k.probe] = _PROBES[k.probe](dev)
            run = runners[k.probe]
            if k.probe not in baselines:
                # the parity target: the verdict under the sweep's
                # current winners (each itself parity-checked, so the
                # chain grounds out at the all-defaults verdict)
                _kn.set_active(winners, source="sweep")
                baselines[k.probe] = run()
            base = baselines[k.probe]
            rows = []
            best_cost, best_val = None, None
            for idx, rung in enumerate(k.domain):
                if clock() - start > budget_s:
                    break
                _kn.set_active({**winners, name: rung},
                               source="sweep")
                cost, verdict = measure(run, name, idx)
                parity = verdict == base
                rows.append({
                    "rung": list(rung) if isinstance(rung, tuple)
                    else rung,
                    "cost_s": cost,
                    "parity": parity,
                })
                if parity and (best_cost is None or cost < best_cost):
                    best_cost, best_val = cost, rung
            evidence[name] = rows
            if best_val is not None:
                winners[name] = best_val
            elif rows:
                # no rung held parity (should be impossible: the
                # default is always a rung): keep the default and say
                # so in the evidence
                evidence[name].append({"kept_default": True})
    finally:
        _kn.set_active(prior or {},
                       source="sweep-restore" if prior else None)

    return {
        "key": key,
        "overrides": winners,
        "evidence": evidence,
        "skipped": skipped,
        "elapsed_s": clock() - start,
        "budget_s": budget_s,
    }


def run_tune(
    budget_s: float = 60.0,
    only: Optional[List[str]] = None,
    dry_run: bool = False,
    out: Callable[[str], None] = print,
    device=None,
) -> int:
    """The ``cli tune`` body. Exit codes: 0 = profile written (or
    dry-run plan printed), 1 = the sweep produced nothing persistable
    (budget spent before any knob finished). Unknown ``--knobs`` names
    raise ValueError: the CLI maps that to its usage exit."""
    for n in only or ():
        if n not in _kn.KNOBS:
            raise ValueError(f"unknown knob: {n}")
    if dry_run:
        out(f"tune plan ({len(only or _kn.KNOBS)} knob(s), "
            f"budget {budget_s:g}s):")
        for name in _kn.KNOBS:
            if only is not None and name not in set(only):
                continue
            k = _kn.KNOBS[name]
            out(f"  {name}: {len(k.domain)} rung(s), probe={k.probe}, "
                f"default={k.default!r}")
        return 0
    res = run_sweep(budget_s=budget_s, only=only, device=device)
    swept = sorted(res["evidence"])
    if not swept:
        out("tune: budget exhausted before any knob was swept; "
            "no profile written")
        return 1
    path = write_profile(
        res["overrides"], key=res["key"],
        evidence={k: res[k] for k in ("evidence", "skipped",
                                      "elapsed_s", "budget_s")},
    )
    tuned = {n: v for n, v in res["overrides"].items()
             if v != _kn.KNOBS[n].default}
    out(f"tune: swept {len(swept)} knob(s) in "
        f"{res['elapsed_s']:.1f}s ({len(res['skipped'])} skipped on "
        f"budget); {len(tuned)} off-default winner(s)")
    for n, v in sorted(tuned.items()):
        out(f"  {n}: {_kn.KNOBS[n].default!r} -> {v!r}")
    out(f"tune: profile written to {path}")
    return 0
