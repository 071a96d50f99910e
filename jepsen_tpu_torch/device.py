"""Device choice, launch accounting and the device->host funnel.

Entry points take ``device=None``, which means the CUDA card: the port
runs on the card unless the caller asks for the CPU (``device="cpu"``,
as the tests do), and it raises when CUDA is absent rather than
falling back. Kernel wrappers pick their route from the tensor they are
given: a CUDA tensor launches the hand-written kernel, a CPU tensor runs
its plain PyTorch version.

LAUNCH_STATS mirrors jepsen_tpu.checker.wgl_bitset.LAUNCH_STATS:
"launches" counts host dispatches of a check (a chained multi-segment
scan is ONE dispatch, however many kernels it enqueues), "escalations"
counts fast-tier deaths re-run on the exact tier, and "host_syncs"
counts device->host fetches that wait on the device. Every such fetch
goes through _host_get, so a segmented check's contract of one host
sync is countable. "donated_buffers" is the reference's count of chain
launches whose input frontier was donated to the computation; it stays
0 here (see the key's comment).

The dispatch plane's launch trains have a funnel of their own beside
_host_get: each launch copies its outputs into pinned host buffers with
non-blocking copies on the plane's one stream and records a CUDA event
right after (copy_to_host_async); a collect waits once on the event of
the last launch it needs (wait_train: polled under a deadline, else a
blocking synchronize), and the stream's FIFO order makes every earlier
launch of the train ready with it. On the CPU the same calls are plain .numpy() copies.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from jepsen_tpu_torch.obs import trace as obs_trace

LAUNCH_STATS = {
    "launches": 0,
    "escalations": 0,
    "host_syncs": 0,
    # donated_buffers: always 0. PyTorch has no buffer donation, and the
    # chain (checker/wgl_bitset.py _run_chain) takes a new frontier
    # tensor from each bitset_scan rather than updating its input in
    # place. The key is kept so the snapshot, results.json and /metrics
    # carry the reference's launch surface.
    "donated_buffers": 0,
}

_launch_stats_lock = threading.Lock()


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on: None means the CUDA
    card, which must be present; "cpu" runs the plain versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev


def device_type(device=None) -> str:
    """The backend ``device`` names, "cuda" or "cpu", without touching
    CUDA (None means the card): what the perf knob registry keys a
    constructor's profile by."""
    return torch.device("cuda" if device is None else device).type


def _bump_launch(key: str, n: int = 1) -> None:
    with _launch_stats_lock:
        LAUNCH_STATS[key] += n
    # the flight recorder's mirror, emitted after the lock drops: the
    # instants' n summed per name equal the counters' deltas
    obs_trace.instant(key, kind="launch_stat", n=n)


def reset_launch_stats() -> None:
    with _launch_stats_lock:
        for k in LAUNCH_STATS:
            LAUNCH_STATS[k] = 0


def launch_stats_snapshot() -> dict:
    """Point-in-time copy of LAUNCH_STATS under its lock."""
    with _launch_stats_lock:
        return dict(LAUNCH_STATS)


def _host_get(x, follow_up: bool = False):
    """THE device->host fetch: a tensor, or a tuple of tensors of one
    dtype, comes back as numpy. A tuple is concatenated on the device
    first, so one call is one copy and one wait, counted once in
    LAUNCH_STATS["host_syncs"]. follow_up=True marks a fetch of data an
    earlier counted fetch already waited for (a death frontier read
    after its verdict): it is not counted again, as the reference's
    plain device_get of such arrays is not."""
    if follow_up:
        return _to_host(x)
    _bump_launch("host_syncs")
    with obs_trace.span("host_sync", kind="host_sync"):
        return _to_host(x)


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    flat = torch.cat([t.reshape(-1) for t in x]).cpu().numpy()
    out, i = [], 0
    for t in x:
        out.append(flat[i:i + t.numel()].reshape(tuple(t.shape)))
        i += t.numel()
    return tuple(out)


def host_value(x) -> np.ndarray:
    """Host copy of a small tensor that a plain PyTorch version
    branches on: free for a CPU tensor, a counted _host_get for a CUDA
    one (the plain versions are yardsticks, not the card's main path)."""
    if x.device.type == "cpu":
        return x.numpy()
    return _host_get(x)


def device_label(dev) -> str:
    """The label faults are attributed to: "cuda:0" (the index filled
    in from the current device), or "cpu"."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return f"cuda:{torch.cuda.current_device()}"
    return str(dev)


def launch_stream(dev: torch.device):
    """A new CUDA stream on dev for one dispatch plane's uploads,
    launches, exact re-runs and device->host copies; None on the CPU."""
    if dev.type != "cuda":
        return None
    return torch.cuda.Stream(device=dev)


def on_stream(stream):
    """Context that makes ``stream`` current (the kernels launch on the
    current stream); a no-op for None (the CPU)."""
    if stream is None:
        return contextlib.nullcontext()
    return torch.cuda.stream(stream)


def upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array as a tensor on dev. On the card the copy goes
    through a pinned buffer without blocking the host, ordered on the
    current stream (a copy from pageable memory would wait for
    everything queued on the stream first); on the CPU it shares the
    array's memory."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def record_use(tensors: Sequence) -> None:
    """Tell the caching allocator that each CUDA tensor is used on the
    current stream, so its memory is not reused before that stream's
    work on it is done (memoized inputs may have been allocated on
    another stream)."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            t.record_stream(torch.cuda.current_stream(t.device))


class HostCopy:
    """The host side of one launch's outputs: the arrays (pinned buffers
    on the card, filled by non-blocking copies), the event recorded
    after those copies (None on the CPU), and the device outputs, kept
    referenced until the event has fired."""

    __slots__ = ("arrays", "event", "_device")

    def __init__(self, arrays, event, device_tensors):
        self.arrays = arrays
        self.event = event
        self._device = device_tensors


def copy_to_host_async(tensors: Sequence[torch.Tensor],
                       stream=None) -> HostCopy:
    """Start the device->host copies of a launch's outputs on stream
    (the plane's launch stream) and record the event that marks them
    done; nothing waits. On the CPU the arrays are the tensors' own
    numpy views."""
    tensors = list(tensors)
    if stream is None or not any(t.is_cuda for t in tensors):
        return HostCopy([t.numpy() for t in tensors], None, None)
    with torch.cuda.stream(stream):
        pinned = []
        for t in tensors:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            pinned.append(buf)
        event = torch.cuda.Event()
        event.record(stream)
    return HostCopy([b.numpy() for b in pinned], event, tensors)


def wait_train(target: HostCopy, deadline_s: Optional[float] = None,
               ) -> None:
    """Wait until ``target``'s event has fired: on one stream, every
    launch recorded before it is then done too. With no deadline this
    is the event's blocking synchronize. With one it polls the event (a
    blocking synchronize cannot be cut short) with a short, growing
    sleep, and raises chaos.DeadlineExceeded past deadline_s. The
    caller counts the wait once in LAUNCH_STATS["host_syncs"]; the
    wait is the flight recorder's host_sync span (on the CPU there is
    no wait, and no span)."""
    if target.event is None:
        return
    with obs_trace.span("host_sync", kind="host_sync"):
        if deadline_s is None:
            target.event.synchronize()
            return
        end = time.perf_counter() + deadline_s
        nap = 2e-5
        while not target.event.query():
            if time.perf_counter() >= end:
                from jepsen_tpu_torch.checker.chaos import DeadlineExceeded

                raise DeadlineExceeded(
                    f"launch train not ready within {deadline_s}s"
                )
            time.sleep(nap)
            nap = min(2 * nap, 1e-3)
