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
sync is countable.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

LAUNCH_STATS = {
    "launches": 0,
    "escalations": 0,
    "host_syncs": 0,
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


def _bump_launch(key: str, n: int = 1) -> None:
    with _launch_stats_lock:
        LAUNCH_STATS[key] += n


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
    if not follow_up:
        _bump_launch("host_syncs")
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
