"""What the harness reads of the program besides the system under
test: its build, its launch counters and its flight-recorder spans
(jepsen_tpu_torch.checker._build, .device, .obs.trace)."""

from __future__ import annotations

from typing import Dict, List


def build() -> None:
    """Build (where the checkout lacks them, all at once) and load every
    kernel of the program (`_build.KERNELS`) and the host library of the
    step preparation (csrc/wgl_prep.cc), which the check path loads at
    first use, so that set-up can time the build apart from the warm-up
    whichever kernels a configuration's path launches."""
    from jepsen_tpu_torch.checker import _build, wgl_native

    _build.build_all()
    for name in _build.KERNELS:
        _build.load(name)
    wgl_native.prep_available()


def counters() -> Dict[str, float]:
    """Kernel launches, exact re-runs and host syncs so far in this
    process."""
    from jepsen_tpu_torch.device import launch_stats_snapshot

    launch = launch_stats_snapshot()
    return {
        "launches": launch["launches"],
        "escalations": launch["escalations"],
        "host_syncs": launch["host_syncs"],
    }


def delta(before: Dict[str, float], after: Dict[str, float]):
    return {k: after[k] - before[k] for k in after}


def trace_on() -> None:
    from jepsen_tpu_torch.obs import trace as obs_trace

    obs_trace.TRACER.clear()
    obs_trace.enable()


def trace_off() -> List[dict]:
    """Every span recorded since trace_on(); recording stops."""
    from jepsen_tpu_torch.obs import trace as obs_trace

    spans = obs_trace.spans()
    obs_trace.disable()
    obs_trace.TRACER.clear()
    return spans


class Window:
    """The counters (and, traced, the spans) of the program over the
    window: begin() before it, end(run) after it."""

    def begin(self, run) -> None:
        if run.trace:
            trace_on()
        self.c0 = counters()

    def end(self, run) -> None:
        run.counters = delta(self.c0, counters())
        if run.trace:
            run.spans = trace_off()
