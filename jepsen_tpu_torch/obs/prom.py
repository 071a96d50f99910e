"""Prometheus text exposition for the engine: a copy of
jepsen_tpu.obs.prom.

Folds every ``*_STATS`` surface (via the consolidated
``obs.snapshot.engine_snapshot()``) into gauges named
``jepsen_tpu_<section>_<path>``, plus trace-derived latency
histograms per span kind when the flight recorder is enabled, the
per-tenant labelled families of the service's TenantLedger rows and the
quarantine gauges. The metric names are the reference's, so one
dashboard reads either package's daemon, and on the same snapshot the
text is the reference's byte for byte. The daemon serves it at ``GET
/metrics`` (text/plain; version=0.0.4).

Stdlib-only; the snapshot module (which imports the checker modules) is
imported lazily inside ``prometheus_text`` so importing this module
costs nothing.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

#: histogram bucket upper bounds, in seconds — spans range from µs
#: bitset probes to multi-second collect trains behind the ~94 ms
#: sync floor, so a decade ladder covers the dynamic range
BUCKETS_S = (0.001, 0.01, 0.1, 1.0, 10.0)

_NAME_OK = re.compile(r"[^a-zA-Z0-9_]")


def _sanitize(part: str) -> str:
    return _NAME_OK.sub("_", str(part))


def _flatten(prefix: str, obj: dict, out: List[Tuple[str, float]]) -> None:
    for k in sorted(obj):
        v = obj[k]
        name = f"{prefix}_{_sanitize(k)}"
        if isinstance(v, bool):
            out.append((name, 1.0 if v else 0.0))
        elif isinstance(v, (int, float)):
            out.append((name, float(v)))
        elif isinstance(v, dict):
            _flatten(name, v, out)
        elif isinstance(v, (list, tuple)):
            # lists (e.g. quarantined device labels) expose their size;
            # the labels themselves belong in the JSON surfaces
            out.append((name, float(len(v))))
        # strings and None carry no gauge value


def _escape_label(value: str) -> str:
    """Escape a label VALUE per the exposition format: backslash,
    double-quote, and newline are the three characters that corrupt
    the text format; everything else (including UTF-8 tenant names)
    passes through verbatim."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _tenant_lines(tenants: Dict[str, dict], lines: List[str]) -> None:
    """Per-tenant labeled gauge families from TenantLedger rows:
    ``jepsen_tpu_tenant_<counter>{tenant="..."}``. One HELP/TYPE per
    family, every tenant a sample under it — the exposition-format
    shape scrapers require (a family's samples must be contiguous)."""
    counters: List[str] = sorted(
        {k for row in tenants.values()
         for k, v in row.items() if isinstance(v, (bool, int, float))}
    )
    for counter in counters:
        name = f"jepsen_tpu_tenant_{_sanitize(counter)}"
        lines.append(f"# HELP {name} Per-tenant ledger counter "
                     f"{counter}.")
        lines.append(f"# TYPE {name} gauge")
        for tenant in sorted(tenants):
            v = tenants[tenant].get(counter)
            if isinstance(v, bool):
                v = 1.0 if v else 0.0
            elif not isinstance(v, (int, float)):
                continue
            lines.append(
                f'{name}{{tenant="{_escape_label(tenant)}"}} {v:g}'
            )


def _quarantine_lines(snapshot: dict, lines: List[str]) -> None:
    """Labeled per-device / per-host-domain quarantine gauges from the
    resilience ledgers (the unlabeled gauges only carry the counts)."""
    res = snapshot.get("resilience")
    if not isinstance(res, dict):
        return
    for key, name, label in (
        ("quarantined_devices", "jepsen_tpu_device_quarantined",
         "device"),
        ("quarantined_hosts", "jepsen_tpu_host_domain_quarantined",
         "host"),
    ):
        entries = res.get(key)
        if not isinstance(entries, (list, tuple)) or not entries:
            continue
        lines.append(f"# HELP {name} Quarantined {label} (1 = out of "
                     "the mesh until probation passes).")
        lines.append(f"# TYPE {name} gauge")
        for entry in sorted(str(e) for e in entries):
            lines.append(f'{name}{{{label}="{_escape_label(entry)}"}} 1')


def _histograms(events: List[dict]) -> Dict[str, Tuple[List[int], float, int]]:
    """Per-kind duration histograms from complete events: kind ->
    (cumulative bucket counts, sum_seconds, count)."""
    hists: Dict[str, Tuple[List[int], float, int]] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        dur_s = e.get("dur", 0) / 1e9
        kind = _sanitize(e.get("kind", "span"))
        if kind not in hists:
            hists[kind] = ([0] * (len(BUCKETS_S) + 1), 0.0, 0)
        counts, total, n = hists[kind]
        for i, le in enumerate(BUCKETS_S):
            if dur_s <= le:
                counts[i] += 1
        counts[-1] += 1  # +Inf
        hists[kind] = (counts, total + dur_s, n + 1)
    return hists


def prometheus_text(snapshot: Optional[dict] = None,
                    events: Optional[List[dict]] = None,
                    tenants: Optional[Dict[str, dict]] = None) -> str:
    """Render the full exposition. Pass ``snapshot``/``events`` to
    render a captured state (tests, trace-summary); default reads the
    live engine. ``tenants`` (TenantLedger.snapshot() rows) adds the
    per-tenant labeled gauge families the daemon serves."""
    if snapshot is None:
        from jepsen_tpu_torch.obs.snapshot import engine_snapshot

        snapshot = engine_snapshot()
    if events is None:
        from jepsen_tpu_torch.obs import trace as _trace

        events = _trace.spans() if _trace.TRACER.enabled else []

    lines: List[str] = []
    gauges: List[Tuple[str, float]] = []
    for section in sorted(snapshot):
        sec = snapshot[section]
        if isinstance(sec, dict):
            _flatten(f"jepsen_tpu_{_sanitize(section)}", sec, gauges)
        elif isinstance(sec, (bool, int, float)):
            gauges.append((f"jepsen_tpu_{_sanitize(section)}", float(sec)))
    for name, value in gauges:
        lines.append(f"# HELP {name} Engine counter {name}.")
        lines.append(f"# TYPE {name} gauge")
        # %g keeps integers integral and floats short
        lines.append(f"{name} {value:g}")

    if tenants:
        _tenant_lines(tenants, lines)
    _quarantine_lines(snapshot, lines)

    hname = "jepsen_tpu_span_duration_seconds"
    hists = _histograms(events)
    if hists:
        lines.append(f"# HELP {hname} Flight-recorder span durations "
                     "by span kind.")
        lines.append(f"# TYPE {hname} histogram")
        for kind in sorted(hists):
            counts, total, n = hists[kind]
            for le, c in zip(BUCKETS_S, counts):
                lines.append(
                    f'{hname}_bucket{{kind="{kind}",le="{le:g}"}} {c}')
            lines.append(
                f'{hname}_bucket{{kind="{kind}",le="+Inf"}} {counts[-1]}')
            lines.append(f'{hname}_sum{{kind="{kind}"}} {total:g}')
            lines.append(f'{hname}_count{{kind="{kind}"}} {n}')
    return "\n".join(lines) + "\n"
