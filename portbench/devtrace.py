"""The device trace of a traced run: a `torch.profiler` capture of the
host and the card over the window, reduced to the card's busy time, the
time of each device operation by name, and the idle gaps by what the
host was doing.

Busy time is the union of kernel, copy and memset intervals inside the
window (the `portbench.window` annotation the harness puts around it).
An idle gap is named after the innermost host event that covers its
middle: a torch op, a CUDA runtime call or the harness's annotation
around each check (`portbench.check`)."""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "portbench.window"
CHECK = "portbench.check"
#: the name a gap gets when no host event covers it
UNTRACED = "host Python (no torch op)"


class Capture:
    """start() before the window, stop(window_s) after it."""

    def __init__(self, on_card: bool):
        self.on_card = on_card
        self.prof = None
        self.window = None

    def start(self) -> None:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.window = torch.profiler.record_function(WINDOW)
        self.window.__enter__()

    def stop(self, window_s: float) -> Optional[dict]:
        import torch

        if self.on_card:
            torch.cuda.synchronize()
        self.window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self.prof = None
        return reduce(events, window_s)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce(events: List[dict], window_s: float) -> Optional[dict]:
    """{"busy_s", "window_s", "kernel_s" (by name), "breakdown"}, or
    None without device events (a CPU run). Times in the trace are
    microseconds."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == WINDOW]
    if win:
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
    else:
        w0 = min((float(e["ts"]) for e in xs), default=0.0)
        w1 = w0 + window_s * 1e6
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    if not dev:
        return None
    by_name: Dict[str, float] = {}
    intervals = []
    for e in dev:
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        intervals.append((a, b))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a) * 1e-6
    busy = _union(intervals)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps = []
    t = w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    idle = _label_gaps(gaps, [e for e in xs if e.get("cat") in HOST_CATS
                              and e.get("name") != WINDOW])
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_s,
        "window_s": (w1 - w0) * 1e-6,
        "kernel_s": by_name,
        "breakdown": {
            "device_ops": [[n[:160], s] for n, s in top_ops],
            "idle_gaps": [[n[:160], s] for n, s in top_idle],
        },
    }


def _label_gaps(gaps, host) -> Dict[str, float]:
    """Idle seconds by the innermost host event covering each gap's
    middle."""
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   float(e["dur"]), e["name"]) for e in host)
    out: Dict[str, float] = {}
    active: list = []
    i = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (a + b) / 2
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= mid]
        name = min(active, key=lambda h: h[2])[3] if active else UNTRACED
        out[name] = out.get(name, 0.0) + (b - a) * 1e-6
    return out


def kernel_seconds(run, needle: str) -> Optional[float]:
    """Device seconds in the window of kernels whose name holds
    `needle`; None without a device trace or without such a kernel."""
    if run.devtrace is None:
        return None
    s = sum(v for k, v in run.devtrace["kernel_s"].items() if needle in k)
    return s if s > 0 else None
