"""jepsen_tpu_torch: the PyTorch / CUDA (H100) port of jepsen_tpu.

The JAX package stays as the reference; this package imports nothing of
it, nor jax. Entry points run on the CUDA card unless the caller passes
``device="cpu"``; hand-written CUDA kernels live in csrc/ and are built
with nvcc at first use (checker/_build.py).

The launch-accounting names below come from ``device`` on first use,
so the stdlib-only subpackages (``analysis``, ``obs``, ``perf.knobs``)
import without torch.
"""

__all__ = [
    "LAUNCH_STATS",
    "launch_stats_snapshot",
    "reset_launch_stats",
    "resolve_device",
]


def __getattr__(name):
    if name in __all__:
        from jepsen_tpu_torch import device

        return getattr(device, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
