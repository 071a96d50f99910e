"""jepsen_tpu_torch: the PyTorch / CUDA (H100) port of jepsen_tpu.

The JAX package stays as the reference; this package imports nothing of
it, nor jax. Entry points run on the CUDA card unless the caller passes
``device="cpu"``; hand-written CUDA kernels live in csrc/ and are built
with nvcc at first use (checker/_build.py).
"""

from jepsen_tpu_torch.device import (
    LAUNCH_STATS,
    launch_stats_snapshot,
    reset_launch_stats,
    resolve_device,
)

__all__ = [
    "LAUNCH_STATS",
    "launch_stats_snapshot",
    "reset_launch_stats",
    "resolve_device",
]
