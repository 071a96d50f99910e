"""Device tracing with torch.profiler, the port's counterpart of
jepsen_tpu.obs.xla.

``xla_trace(log_dir, device)`` wraps any checking code in a
``torch.profiler.profile`` capture of the host and, on the card, of
the CUDA activity (kernels, copies, syncs), and writes it into
``log_dir`` as a Chrome trace (``PROFILE_FILE``) that Perfetto and
chrome://tracing load. ``cli analyze --xla-trace DIR`` rides it, so the
flight recorder's spans and the device timeline come from one run; with
the recorder on (``--trace``) its spans are annotations in this trace
too, on the profiler's clock (obs/trace.py).

On the CPU a profiler that cannot start makes the capture a no-op, as
the reference's does. On the card it raises instead: a run asked for a
device timeline never quietly has none.
"""

from __future__ import annotations

import contextlib
import os

#: the Chrome-trace file xla_trace writes inside its log_dir
PROFILE_FILE = "torch_profile.json"


@contextlib.contextmanager
def xla_trace(log_dir: str, device=None):
    """Capture a trace of the enclosed block into
    ``log_dir/PROFILE_FILE``. ``device`` is the device the block runs
    on (None: the CUDA card, which must be present)."""
    import torch

    from jepsen_tpu_torch.device import resolve_device

    on_card = resolve_device(device).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    try:
        prof.__enter__()
    except Exception:
        if on_card:
            raise
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            if on_card:
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(os.path.join(log_dir, PROFILE_FILE))
