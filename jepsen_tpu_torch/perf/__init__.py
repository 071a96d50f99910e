"""The perf plane of the port: a copy of jepsen_tpu.perf.

``perf.knobs`` is the declarative registry of the engine's hand-picked
launch-shape tunables (bucket ladders, coalescing timers, batch caps,
stream cadences); ``perf.autotune`` is the min-of-N verdict-parity
checked sweep behind ``cli tune`` and the persisted profile the checker
constructors consult, keyed by the backend, the device count, the
card's name and the torch and CUDA versions.

The package root imports nothing heavy: ``knobs`` is stdlib only and
``autotune`` defers torch until a sweep or a profile key needs it, so
checker modules can import the registry at module scope.
"""

from jepsen_tpu_torch.perf import knobs  # noqa: F401  (registry re-export)
