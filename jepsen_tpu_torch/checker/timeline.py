"""HTML timeline: per-process operation bars.

Reference: jepsen/src/jepsen/checker/timeline.clj — pairs invocations
with completions (:33-53) and renders one column per process with a
div per op, colored by outcome (:97-121,159-179), nemesis activity
shaded behind the columns. Output is a single self-contained
timeline.html in the run directory (when the test has one) or returned
inline.

Departures from the minimal version: nemesis interval bands, rich
hover tooltips (relative start, duration, error text), a legend, and a
cap on rendered ops with a disclosure banner — the reference renders
every op, which is exactly why its reports can take "hours"
(checker.clj:155-158); a 500k-op history does not belong in one HTML
file.

The port's copy of jepsen_tpu.checker.timeline;
tests/test_torch_perf_graphs.py holds the two against each other.
"""

from __future__ import annotations

import html
import os
from typing import List, Optional

_COLOR = {"ok": "#B3F3B5", "info": "#FFEB91", "fail": "#F7B5B5"}

_COL_W = 160
_BAR_W = 150
_TOP_PAD = 26
_PLOT_H = 600

#: rendered-invocation cap (disclosed in the page when hit)
MAX_OPS = 5000


def render(test, history, max_ops: int = MAX_OPS) -> str:
    from jepsen_tpu_torch.history.history import History
    from jepsen_tpu_torch.utils.util import nemesis_intervals

    if not isinstance(history, History):
        history = History(list(history))
    pairs = history.pairs()
    completions = {}
    for op in history.ops:
        if not op.is_invoke:
            inv = pairs.get(op.index)
            if inv is not None:
                completions[inv] = op
    procs: List = sorted(
        {op.process for op in history.ops},
        key=lambda p: (isinstance(p, str), str(p)),
    )
    col = {p: i for i, p in enumerate(procs)}
    t_max = max((op.time for op in history.ops if op.time > 0), default=1)
    scale = float(_PLOT_H) / t_max  # px per nano
    width = len(procs) * _COL_W

    # Nemesis activity bands behind every column (timeline readers ask
    # "was the fault active when this op straddled it?" first).
    bands = []
    intervals = []
    for start, stop in nemesis_intervals(history):
        t0 = max(start.time if start is not None else 0, 0)
        t1 = min(stop.time if stop is not None else t_max, t_max)
        if t1 > t0:
            intervals.append((t0, t1))
    # Merge overlaps: invoke- and info-paired intervals cover the same
    # fault window twice; two stacked translucent bands would darken
    # the overlap and fringe the edges.
    intervals.sort()
    merged = []
    for t0, t1 in intervals:
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    for t0, t1 in merged:
        top = _TOP_PAD + t0 * scale
        height = max((t1 - t0) * scale, 2)
        bands.append(
            f'<div class="nem" style="top:{top:.1f}px;'
            f'height:{height:.1f}px;width:{width}px"></div>'
        )

    divs = []
    invocations = [op for op in history.ops if op.is_invoke]
    shown = invocations[:max_ops]
    for op in shown:
        comp = completions.get(op.index)
        t0 = max(op.time, 0)
        t1 = comp.time if comp is not None and comp.time > 0 else t_max
        outcome = comp.type if comp is not None else "info"
        top = _TOP_PAD + t0 * scale
        height = max((t1 - t0) * scale, 8)
        left = col[op.process] * _COL_W
        val = comp.value if comp is not None and comp.is_ok else op.value
        resolved = comp is not None and comp.time > 0
        dur = (
            f"{(t1 - t0) / 1e6:.1f}ms"
            if resolved
            # Unresolved at end of history: the gap to t_max is a lower
            # bound, not a measured latency.
            else f">={(t1 - t0) / 1e6:.1f}ms (unresolved)"
        )
        tip = (
            f"{op.process} {op.f} {val!r} [{outcome}] "
            f"t+{t0 / 1e9:.3f}s {dur}"
        )
        err = getattr(comp, "error", None) if comp is not None else None
        if err:
            tip += f" error={err}"
        divs.append(
            f'<div class="op" style="top:{top:.1f}px;left:{left}px;'
            f'height:{height:.1f}px;background:{_COLOR.get(outcome, "#ddd")}"'
            f' title="{html.escape(tip)}">'
            f"{html.escape(str(op.f))} {html.escape(repr(val))}</div>"
        )
    heads = "".join(
        f'<div class="head" style="left:{col[p] * _COL_W}px">'
        f"{html.escape(str(p))}</div>"
        for p in procs
    )
    banner = ""
    if len(invocations) > len(shown):
        banner = (
            f"<p><b>showing the first {len(shown)} of "
            f"{len(invocations)} operations</b> (cap: history too "
            f"large for one page; the full history is in "
            f"history.jsonl)</p>"
        )
    legend = " ".join(
        f'<span style="background:{c};padding:1px 8px;'
        f'border:1px solid #888">{k}</span>'
        for k, c in _COLOR.items()
    ) + ' <span style="background:#f3d9ff;padding:1px 8px;' \
        'border:1px solid #888">nemesis active</span>'
    body_h = _TOP_PAD + _PLOT_H + 40
    return (
        "<html><head><style>"
        f".op{{position:absolute;width:{_BAR_W}px;font-size:10px;"
        "border:1px solid #888;overflow:hidden}"
        f".head{{position:absolute;top:0;width:{_BAR_W}px;"
        "font-weight:bold}"
        ".nem{position:absolute;left:0;background:#f3d9ff;"
        "opacity:0.55;z-index:-1}"
        "body{font-family:sans-serif;position:relative}"
        "</style></head><body>"
        f"<h3>{html.escape(str(test.get('name', 'timeline')))}</h3>"
        f"<p>{legend}</p>{banner}"
        f'<div style="position:relative;height:{body_h}px">'
        f'{"".join(bands)}{heads}{"".join(divs)}</div>'
        "</body></html>"
    )


class TimelineChecker:
    """Checker-protocol adapter: renders timeline.html into the test's
    run_dir (timeline.clj:159-179); always valid."""

    def check(self, test, history, opts=None) -> dict:
        doc = render(test, history)
        out: Optional[str] = None
        run_dir = (opts or {}).get("subdirectory") or test.get("run_dir")
        if run_dir:
            os.makedirs(run_dir, exist_ok=True)
            out = os.path.join(run_dir, "timeline.html")
            with open(out, "w") as f:
                f.write(doc)
        return {"valid?": True, "file": out}


def html_timeline() -> TimelineChecker:
    return TimelineChecker()
