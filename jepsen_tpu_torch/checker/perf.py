"""Performance graphs: latency points, latency quantiles, throughput,
and clock-skew plots — self-contained SVG, no gnuplot.

Reference: jepsen/src/jepsen/checker/perf.clj — time-bucketed quantiles
(:20-84), latency/rate breakdown by f x outcome (:94-140), nemesis
interval shading (:183-319), gnuplot rendering (:326-546) — and
checker/clock.clj (per-node offset step plots). The rendering backend
here is a small hand-rolled SVG writer (the framework stays
dependency-free); the data reductions are plain numpy over the history.

The port's copy of jepsen_tpu.checker.perf;
tests/test_torch_perf_graphs.py holds the two against each other.
"""

from __future__ import annotations

import html
import math
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from jepsen_tpu_torch.utils.util import nemesis_intervals

#: f x outcome palette (reference's type->color, perf.clj:94-110)
_OUTCOME_COLOR = {"ok": "#6DB6569E", "fail": "#D2322DCC", "info": "#EFAF41CC"}
_F_SHADE = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
            "#8c564b", "#e377c2"]

W, H = 800, 420
ML, MR, MT, MB = 60, 160, 24, 40  # margins (legend right)


class _SVG:
    def __init__(self, w=W, h=H):
        self.w, self.h = w, h
        self.parts: List[str] = [
            f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" '
            f'height="{h}" font-family="sans-serif" font-size="11">',
            f'<rect width="{w}" height="{h}" fill="white"/>',
        ]

    def rect(self, x, y, w, h, fill, opacity=1.0):
        self.parts.append(
            f'<rect x="{x:.1f}" y="{y:.1f}" width="{w:.1f}" '
            f'height="{h:.1f}" fill="{fill}" opacity="{opacity}"/>'
        )

    def line(self, x1, y1, x2, y2, stroke="#888", width=1):
        self.parts.append(
            f'<line x1="{x1:.1f}" y1="{y1:.1f}" x2="{x2:.1f}" '
            f'y2="{y2:.1f}" stroke="{stroke}" stroke-width="{width}"/>'
        )

    def circle(self, x, y, r, fill):
        self.parts.append(
            f'<circle cx="{x:.1f}" cy="{y:.1f}" r="{r}" fill="{fill}"/>'
        )

    def text(self, x, y, s, anchor="start", size=11, fill="#333"):
        self.parts.append(
            f'<text x="{x:.1f}" y="{y:.1f}" text-anchor="{anchor}" '
            f'font-size="{size}" fill="{fill}">{html.escape(str(s))}</text>'
        )

    def polyline(self, pts, stroke, width=1.5):
        p = " ".join(f"{x:.1f},{y:.1f}" for x, y in pts)
        self.parts.append(
            f'<polyline points="{p}" fill="none" stroke="{stroke}" '
            f'stroke-width="{width}"/>'
        )

    def render(self) -> str:
        return "".join(self.parts) + "</svg>"


def _x_scale(t_max_s: float):
    span = max(t_max_s, 1e-9)
    return lambda t: ML + (W - ML - MR) * (t / span)


def _log_y_scale(v_max: float, v_min: float = 0.1):
    lo, hi = math.log10(v_min), math.log10(max(v_max, v_min * 10))
    return lambda v: H - MB - (H - MT - MB) * (
        (math.log10(max(v, v_min)) - lo) / (hi - lo)
    )


def _lin_y_scale(v_max: float, v_min: float = 0.0):
    span = max(v_max - v_min, 1e-9)
    return lambda v: H - MB - (H - MT - MB) * ((v - v_min) / span)


def _shade_nemesis(svg: _SVG, history, xs, t_max_s: float):
    """Shade nemesis start..stop spans (perf.clj:183-248)."""
    for start, stop in nemesis_intervals(history.ops):
        t0 = (start.time / 1e9) if start is not None else 0.0
        t1 = (stop.time / 1e9) if stop is not None else t_max_s
        svg.rect(xs(t0), MT, max(xs(t1) - xs(t0), 1), H - MT - MB,
                 "#F3B5B5", opacity=0.4)


def _axes(svg: _SVG, t_max_s, y_ticks, title, ylabel):
    svg.line(ML, H - MB, W - MR, H - MB)
    svg.line(ML, MT, ML, H - MB)
    svg.text((W - MR + ML) / 2, 14, title, anchor="middle", size=13)
    svg.text(12, MT - 6, ylabel, size=10)
    n_t = 8
    for i in range(n_t + 1):
        t = t_max_s * i / n_t
        x = ML + (W - ML - MR) * i / n_t
        svg.line(x, H - MB, x, H - MB + 4)
        svg.text(x, H - MB + 16, f"{t:.0f}", anchor="middle", size=9)
    for v, y in y_ticks:
        svg.line(ML - 4, y, ML, y)
        svg.text(ML - 6, y + 3, v, anchor="end", size=9)


def _legend(svg: _SVG, entries: List[Tuple[str, str]]):
    y = MT + 10
    for label, color in entries:
        svg.rect(W - MR + 10, y - 8, 10, 10, color)
        svg.text(W - MR + 24, y, label, size=10)
        y += 16


def latency_graph_svg(test, history) -> str:
    """Latency point graph: one dot per completed op, log-scale ms,
    colored by f, shaded by outcome (perf.clj:372-433)."""
    lats = history.latencies()
    t_max = max((c.time for _, c, _ in lats), default=int(1e9)) / 1e9
    lat_ms = [max(l / 1e6, 0.01) for _, _, l in lats]
    v_max = max(lat_ms, default=1.0)
    xs = _x_scale(t_max)
    ys = _log_y_scale(v_max)
    svg = _SVG()
    _shade_nemesis(svg, history, xs, t_max)
    fs = sorted({str(i.f) for i, _, _ in lats})
    f_color = {f: _F_SHADE[k % len(_F_SHADE)] for k, f in enumerate(fs)}
    for (inv, comp, lat), ms in zip(lats, lat_ms):
        color = (
            f_color[str(inv.f)] if comp.is_ok
            else _OUTCOME_COLOR.get(comp.type, "#999")
        )
        svg.circle(xs(inv.time / 1e9), ys(ms), 1.6, color)
    ticks = []
    v = 0.1
    while v <= v_max * 10:
        ticks.append((f"{v:g}", ys(v)))
        v *= 10
    _axes(svg, t_max, ticks, f"{test.get('name', '')} latency",
          "latency (ms)")
    _legend(svg, [(f, f_color[f]) for f in fs]
            + [(t, c) for t, c in _OUTCOME_COLOR.items() if t != "ok"])
    return svg.render()


def rate_graph_svg(test, history, dt_s: float = 1.0) -> str:
    """Throughput graph: ops/s per f x outcome in dt buckets
    (perf.clj:507-546)."""
    comps = [
        o for o in history.ops
        if o.is_client_op and not o.is_invoke and o.time >= 0
    ]
    t_max = max((o.time for o in comps), default=int(1e9)) / 1e9
    dt_s = max(dt_s, t_max / 100)
    n_b = max(int(t_max / dt_s) + 1, 1)
    series: Dict[Tuple[str, str], np.ndarray] = {}
    for o in comps:
        key = (str(o.f), o.type)
        arr = series.setdefault(key, np.zeros(n_b))
        arr[min(int(o.time / 1e9 / dt_s), n_b - 1)] += 1
    v_max = max((float(a.max()) for a in series.values()), default=1.0)
    v_max /= dt_s
    xs = _x_scale(t_max)
    ys = _lin_y_scale(v_max * 1.05)
    svg = _SVG()
    _shade_nemesis(svg, history, xs, t_max)
    fs = sorted({f for f, _ in series})
    f_color = {f: _F_SHADE[k % len(_F_SHADE)] for k, f in enumerate(fs)}
    entries = []
    for (f, outcome), arr in sorted(series.items()):
        color = (
            f_color[f] if outcome == "ok"
            else _OUTCOME_COLOR.get(outcome, "#999")
        )
        pts = [
            (xs((i + 0.5) * dt_s), ys(arr[i] / dt_s)) for i in range(n_b)
        ]
        svg.polyline(pts, color)
        entries.append((f"{f} {outcome}", color))
    ticks = [(f"{v_max * i / 4:.0f}", ys(v_max * i / 4)) for i in range(5)]
    _axes(svg, t_max, ticks, f"{test.get('name', '')} rate", "ops/s")
    _legend(svg, entries)
    return svg.render()


def clock_plot_svg(test, history) -> str:
    """Per-node clock-offset step plot from nemesis ops carrying
    {"clock-offsets": {node: seconds}} values (clock.clj:13-69)."""
    points: Dict[str, List[Tuple[float, float]]] = {}
    t_max = 1.0
    for o in history.ops:
        if o.process != "nemesis" or not isinstance(o.value, dict):
            continue
        offsets = o.value.get("clock-offsets")
        if not isinstance(offsets, dict):
            continue
        t = o.time / 1e9
        t_max = max(t_max, t)
        for node, off in offsets.items():
            points.setdefault(str(node), []).append((t, float(off)))
    v_max = max(
        (abs(v) for pts in points.values() for _, v in pts), default=1.0
    )
    xs = _x_scale(t_max)
    ys = _lin_y_scale(v_max * 1.1, -v_max * 1.1)
    svg = _SVG()
    _shade_nemesis(svg, history, xs, t_max)
    svg.line(ML, ys(0), W - MR, ys(0), stroke="#bbb")
    entries = []
    for k, (node, pts) in enumerate(sorted(points.items())):
        color = _F_SHADE[k % len(_F_SHADE)]
        steps: List[Tuple[float, float]] = []
        for i, (t, v) in enumerate(pts):
            if steps:
                steps.append((xs(t), steps[-1][1]))
            steps.append((xs(t), ys(v)))
        if steps:
            steps.append((xs(t_max), steps[-1][1]))
            svg.polyline(steps, color)
        entries.append((node, color))
    ticks = [
        (f"{v:.1f}", ys(v))
        for v in (-v_max, -v_max / 2, 0, v_max / 2, v_max)
    ]
    _axes(svg, t_max, ticks, f"{test.get('name', '')} clock skew",
          "offset (s)")
    _legend(svg, entries)
    return svg.render()


class _GraphChecker:
    """Base: render into the run dir; always valid (perf checkers never
    fail a test — checker.clj:736-777)."""

    filename = "graph.svg"

    def render(self, test, history) -> str:  # pragma: no cover
        raise NotImplementedError

    def check(self, test, history, opts=None) -> dict:
        from jepsen_tpu_torch.history.history import History

        if not isinstance(history, History):
            history = History(list(history))
        doc = self.render(test, history)
        out: Optional[str] = None
        run_dir = (opts or {}).get("subdirectory") or test.get("run_dir")
        if run_dir:
            os.makedirs(run_dir, exist_ok=True)
            out = os.path.join(run_dir, self.filename)
            with open(out, "w") as f:
                f.write(doc)
        return {"valid?": True, "file": out}


class LatencyGraphChecker(_GraphChecker):
    filename = "latency-raw.svg"

    def render(self, test, history):
        return latency_graph_svg(test, history)


class RateGraphChecker(_GraphChecker):
    filename = "rate.svg"

    def render(self, test, history):
        return rate_graph_svg(test, history)


class ClockPlotChecker(_GraphChecker):
    filename = "clock-skew.svg"

    def render(self, test, history):
        return clock_plot_svg(test, history)


def latency_graph() -> LatencyGraphChecker:
    return LatencyGraphChecker()


def rate_graph() -> RateGraphChecker:
    return RateGraphChecker()


def clock_plot() -> ClockPlotChecker:
    return ClockPlotChecker()


def perf():
    """Latency + rate bundle (checker.clj:764-777's perf)."""
    from jepsen_tpu_torch.checker.core import compose

    return compose({
        "latency-graph": latency_graph(),
        "rate-graph": rate_graph(),
    })
