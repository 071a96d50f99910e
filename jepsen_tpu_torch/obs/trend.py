"""The bench trend ledger's reader and regression gate, a copy of
jepsen_tpu.obs.trend (stdlib only) for the port's ``cli perf-trend``.

The port has no bench yet, so nothing in it writes the ledger: the rows
in bench_runs/trend.jsonl are the JAX package's bench rows (TPU
hardware and CPU smoke), and perf-trend renders and gates them as they
are, never as the card's numbers.

One compact JSON row per bench run lands in bench_runs/trend.jsonl.
Rows carry a ``mode``: "smoke" rows are flow validations on whatever
host ran them (CPU interpret, virtual meshes), "hardware" rows are
real measurements. The two populations measure different things — a
CPU smoke geomean around 2.5 against a TPU hardware geomean around 11
is not a regression, it is a category error — so every comparison in
this module is WITHIN one mode's trajectory, never across. Rows from
before the mode field infer it from the older ``smoke`` bool.

Rows may additionally carry ``fleet_size`` (the fleet bench stamps
the member count; solo rows omit it and default to 1). A
2-member fleet's aggregate throughput against a solo daemon's is the
same category error as smoke-vs-hardware, so trajectories key on
(mode, fleet_size) — rendered as "smoke/fleet2" — and each is gated
against its own history only.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

#: default ledger location (the reference's bench.py appends, perf-trend
#: reads)
TREND_LEDGER_PATH = "bench_runs/trend.jsonl"


def ledger_path(path: Optional[str] = None) -> str:
    return path or os.environ.get(
        "JEPSEN_TPU_TREND_LEDGER", TREND_LEDGER_PATH
    )


def load_trend_rows(path: Optional[str] = None) -> List[dict]:
    """Every row in the ledger, in append order ([] when absent —
    callers distinguish missing-vs-empty via os.path.exists)."""
    path = ledger_path(path)
    rows: List[dict] = []
    if not os.path.exists(path):
        return rows
    with open(path, encoding="utf-8") as f:
        for ln in f:
            ln = ln.strip()
            if ln:
                rows.append(json.loads(ln))
    return rows


def trend_mode(row: dict) -> str:
    """A row's trajectory: the explicit mode field when present,
    inferred from the legacy smoke bool otherwise."""
    mode = row.get("mode")
    if isinstance(mode, str) and mode:
        return mode
    return "smoke" if row.get("smoke") else "hardware"


def trend_fleet(row: dict) -> int:
    """A row's fleet size: the stamped member count, 1 (solo) when
    absent or unparseable — every pre-fleet row is a solo row."""
    try:
        n = int(row.get("fleet_size", 1))
    except (TypeError, ValueError):
        return 1
    return n if n >= 1 else 1


def trend_key(row: dict) -> str:
    """The trajectory a row belongs to: its mode, suffixed with the
    fleet size when fleeted ("smoke/fleet2"). Solo rows keep the bare
    mode, so existing single-daemon trajectories are unbroken."""
    n = trend_fleet(row)
    mode = trend_mode(row)
    return mode if n == 1 else f"{mode}/fleet{n}"


def drift_attribution(prev: dict, cur: dict) -> str:
    """Classify a regression between two adjacent rows: when both
    carry the perf plane's ``config_hash``, a hash change means the
    resolved knob config differed between the runs ("config drift" —
    suspect the tuned profile or a registry-default change before
    blaming the code), identical hashes mean the knobs were identical
    and the drop is attributable to the code under them ("code
    drift"). Rows predating the config_hash schema can't be split."""
    ph, ch = prev.get("config_hash"), cur.get("config_hash")
    if not (isinstance(ph, str) and ph and isinstance(ch, str) and ch):
        return "drift source unknown (row predates config_hash)"
    if ph != ch:
        return f"config drift: {ph[:8]} -> {ch[:8]}"
    return f"code drift: config unchanged ({ch[:8]})"


def gate_trend(
    rows: List[dict], max_regression: float
) -> Tuple[bool, List[str]]:
    """The regression gate, per trajectory: within each (mode,
    fleet_size) trajectory, the latest row's vs_baseline geomean must
    not sit more than ``max_regression`` (fractional) below its
    predecessor's. Returns (ok, messages) — ok False when ANY
    trajectory regressed. Trajectories with under two comparable rows
    pass vacuously (the message says so). Regression messages carry a
    drift attribution (config vs code) from the rows' config_hash
    stamps."""
    by_mode: dict = {}
    for r in rows:
        by_mode.setdefault(trend_key(r), []).append(r)
    ok = True
    msgs: List[str] = []
    for mode in sorted(by_mode):
        traj = [
            r for r in by_mode[mode]
            if isinstance(r.get("vs_baseline"), (int, float))
        ]
        if len(traj) < 2:
            msgs.append(
                f"{mode}: {len(traj)} comparable row(s); "
                "nothing to compare yet"
            )
            continue
        prev = traj[-2]["vs_baseline"]
        cur = traj[-1]["vs_baseline"]
        if prev <= 0:
            msgs.append(f"{mode}: non-positive baseline; no gate")
            continue
        drop = (prev - cur) / prev
        if drop > max_regression:
            ok = False
            msgs.append(
                f"{mode}: REGRESSION: vs_baseline {prev:.3f} -> "
                f"{cur:.3f} ({drop * 100:.1f}% drop > "
                f"{max_regression * 100:.1f}% budget; "
                f"{drift_attribution(traj[-2], traj[-1])})"
            )
        else:
            msgs.append(
                f"{mode}: ok: vs_baseline {prev:.3f} -> {cur:.3f} "
                f"({len(traj)} runs on record)"
            )
    return ok, msgs
