"""The declarative knob registry: every hand-picked perf tunable of the
port, a copy of jepsen_tpu.perf.knobs (stdlib only).

One ``Knob`` row per tunable the engine would otherwise hard-code: its
owner module, the module constant it supersedes (``const``), the
sweepable rung ladder (``domain``), the shipped default, which probe
workload exercises it, and a safety note saying what the knob can and
cannot change (no knob may change a verdict: the sweep parity-checks
every rung before trusting its timing).

The ten names, kinds and defaults are the reference's, and so are the
domains but one, so ``config_hash()`` is the reference's on the
defaults and on the same overrides (a domain is not hashed). The one
departure is ``txn_graph.packed_word_max_n``: the port's graph program
has one closure for every component size and no packed-word branch, so
nothing reads that knob. Its row stays, for the hash and the
``perf_snapshot()``, with the one-rung domain ``(32,)`` so a sweep
spends nothing on it.

Owner modules resolve through :func:`resolve` where they used to read
their module constants; the constants stay as the documented defaults
(and the import surface), and a test pins them equal to the registry's
defaults. The active override set is process-wide and installed either
by :func:`ensure_profile` (the persisted profile of the constructor's
backend, loaded the first time a checker of that backend constructs,
silently staying on defaults when none exists or it fails validation)
or explicitly by the sweep, ``--profile`` and tests via
:func:`set_active`.

This module imports neither torch nor any checker module, so the
checker modules can import it at module scope.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Set, Tuple

#: env switch: never load a persisted profile (tests, bisection runs)
NO_PROFILE_ENV = "JEPSEN_TPU_NO_PROFILE"


@dataclass(frozen=True)
class Knob:
    """One tunable: identity, provenance, sweep ladder, and safety."""

    name: str         # dotted registry name, e.g. "dispatch.max_batch"
    owner: str        # repo-relative owner module
    const: Optional[str]  # module constant it supersedes
    kind: str         # "int" | "float" | "ladder" (tuple of ints)
    default: Any
    domain: Tuple     # candidate rungs the sweep may try
    probe: str        # probe workload that exercises it: linear|txn|stream
    safety: str       # what the knob may change (never a verdict)


#: the registry, in sweep (coordinate-descent) order
KNOBS: Dict[str, Knob] = {
    k.name: k
    for k in (
        Knob(
            name="dispatch.coalesce_hold_s",
            owner="jepsen_tpu_torch/checker/dispatch.py",
            const=None,
            kind="float",
            default=0.002,
            domain=(0.0, 0.0005, 0.001, 0.002, 0.005),
            probe="linear",
            safety=(
                "age-based bucket flush timer; trades sparse-traffic "
                "latency for coalescing width, never verdicts"
            ),
        ),
        Knob(
            name="dispatch.max_batch",
            owner="jepsen_tpu_torch/checker/dispatch.py",
            const=None,
            kind="int",
            default=256,
            domain=(64, 128, 256, 512),
            probe="linear",
            safety=(
                "bucket occupancy at which a flush stops waiting; "
                "bounds one launch's stack height, never verdicts"
            ),
        ),
        Knob(
            name="dispatch.max_inflight_trains",
            owner="jepsen_tpu_torch/checker/dispatch.py",
            const=None,
            kind="int",
            default=2,
            domain=(1, 2, 3, 4),
            probe="linear",
            safety=(
                "double-buffer depth of unresolved collect trains; "
                "deeper overlaps more host prep with device execution "
                "at the cost of pinned device buffers"
            ),
        ),
        Knob(
            name="wgl_bitset.w_buckets",
            owner="jepsen_tpu_torch/checker/wgl_bitset.py",
            const="W_BUCKETS",
            kind="ladder",
            default=(12, 13, 14, 15, 16, 17, 18, 19),
            domain=(
                (12, 13, 14, 15, 16, 17, 18, 19),
                (12, 14, 16, 18, 19),
                (13, 15, 17, 19),
            ),
            probe="linear",
            safety=(
                "W rung ladder for the bitset kernel (2^W-bit config "
                "masks); every candidate tops out at 19, the "
                "reference's envelope the port keeps until it derives "
                "its own for the H100, so wider windows still route "
                "to the K-frontier ladder and verdicts never change"
            ),
        ),
        Knob(
            name="wgl_bitset.rows_bucket_growth",
            owner="jepsen_tpu_torch/checker/wgl_bitset.py",
            const="ROWS_BUCKET_GROWTH",
            kind="int",
            default=8,
            domain=(4, 8, 16),
            probe="linear",
            safety=(
                "state-row (S) padding quantum; coarser rungs stack "
                "more shapes into one compiled kernel, finer rungs "
                "waste fewer padded rows — padding never changes the "
                "scanned rows' verdict"
            ),
        ),
        Knob(
            name="txn_graph.graph_buckets",
            owner="jepsen_tpu_torch/checker/txn_graph.py",
            const="GRAPH_BUCKETS",
            kind="ladder",
            default=(4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192,
                     256, 384, 512, 768, 1024),
            domain=(
                (4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256,
                 384, 512, 768, 1024),
                (4, 8, 16, 32, 64, 128, 256, 512, 1024),
                (4, 16, 64, 256, 1024),
            ),
            probe="txn",
            safety=(
                "component-size ladder for dense adjacency batches; "
                "closure FLOPs grow with N^3 so denser rungs trade "
                "launches for tighter stacks — components above the "
                "last rung still take the oversize path, verdicts "
                "are padding-invariant"
            ),
        ),
        Knob(
            name="txn_graph.packed_word_max_n",
            owner="jepsen_tpu_torch/checker/txn_graph.py",
            const=None,
            kind="int",
            default=32,
            domain=(32,),
            probe="txn",
            safety=(
                "read by nothing in the port: graph_counts_torch has "
                "one bfloat16 closure for every N and no packed-word "
                "branch; the row stays so config_hash and "
                "perf_snapshot match the reference's, with one rung so "
                "a sweep spends no budget on it"
            ),
        ),
        Knob(
            name="streaming.gc_window",
            owner="jepsen_tpu_torch/checker/streaming.py",
            const=None,
            kind="int",
            default=0,
            domain=(0, 64, 256),
            probe="stream",
            safety=(
                "checked-prefix ops retained before seal+archive at a "
                "clean boundary (0 = GC off); the sealed prefix's "
                "digest keeps the verdict chain intact"
            ),
        ),
        Knob(
            name="streaming.persist_every",
            owner="jepsen_tpu_torch/checker/streaming.py",
            const=None,
            kind="int",
            default=1,
            domain=(1, 4, 16),
            probe="stream",
            safety=(
                "verified appends per durable fsync boundary; larger "
                "values amortize the boundary frontier fetch but "
                "widen the crash-replay window — never verdicts"
            ),
        ),
        Knob(
            name="streaming.tail_len_bucket",
            owner="jepsen_tpu_torch/checker/dispatch.py",
            const="STREAM_TAIL_BUCKET",
            kind="int",
            default=64,
            domain=(16, 32, 64, 128),
            probe="stream",
            safety=(
                "length-bucket quantum for coalescing stream tails "
                "into one stacked launch; coarser buckets coalesce "
                "more streams per launch at the cost of padded steps"
            ),
        ),
    )
}


def knob_names() -> Tuple[str, ...]:
    return tuple(KNOBS)


def coerce(name: str, value: Any) -> Any:
    """Validate + canonicalize one knob value (profile JSON carries
    ladders as lists; ints may arrive as floats). Raises ValueError on
    anything that cannot be the knob's kind."""
    k = KNOBS[name]
    if k.kind == "int":
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ValueError(f"{name}: not an int: {value!r}")
        iv = int(value)
        if iv != value:
            raise ValueError(f"{name}: not an int: {value!r}")
        if iv < 0:
            raise ValueError(f"{name}: negative: {value!r}")
        return iv
    if k.kind == "float":
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ValueError(f"{name}: not a float: {value!r}")
        fv = float(value)
        if fv < 0:
            raise ValueError(f"{name}: negative: {value!r}")
        return fv
    # ladder: strictly increasing non-empty tuple of positive ints
    if not isinstance(value, (list, tuple)) or not value:
        raise ValueError(f"{name}: not a ladder: {value!r}")
    out = []
    for v in value:
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise ValueError(f"{name}: non-int rung: {v!r}")
        iv = int(v)
        if iv != v or iv <= 0:
            raise ValueError(f"{name}: bad rung: {v!r}")
        out.append(iv)
    if sorted(set(out)) != out:
        raise ValueError(f"{name}: ladder not strictly increasing")
    return tuple(out)


# -- active profile state ----------------------------------------------------

_state_lock = threading.Lock()
_active: Dict[str, Any] = {}      # validated overrides (subset of KNOBS)
_active_source: Optional[str] = None  # profile path (None = defaults)
#: backends whose ensure_profile ran (hit or miss); None is the default
#: device's
_profile_checked: Set[Optional[str]] = set()


def set_active(overrides: Optional[Dict[str, Any]],
               source: Optional[str] = None) -> None:
    """Install a validated override set process-wide (None/{} = back
    to defaults). Unknown knob names and invalid values raise: the
    profile LOADER is the silent-degrade layer, not this setter."""
    new: Dict[str, Any] = {}
    for name, value in (overrides or {}).items():
        if name not in KNOBS:
            raise ValueError(f"unknown knob: {name}")
        new[name] = coerce(name, value)
    global _active, _active_source
    with _state_lock:
        _active = new
        _active_source = source if new or source else None


_UNSET = object()


def resolve(name: str, fallback: Any = _UNSET) -> Any:
    """The one resolution path: active override else the caller's live
    fallback else the registry default. Const-backed sites pass the
    module constant as ``fallback`` so the import surface (tests
    monkeypatching ``bs.W_BUCKETS`` and the like) keeps steering the
    default while a tuned override still wins."""
    v = _active.get(name)
    if v is not None:
        return v
    if fallback is not _UNSET:
        return fallback
    return KNOBS[name].default


def active_overrides() -> Dict[str, Any]:
    with _state_lock:
        return dict(_active)


def active_config() -> Dict[str, Any]:
    """Every knob's resolved value (defaults + overrides): the hashed
    config surface."""
    return {name: resolve(name) for name in KNOBS}


def config_hash(config: Optional[Dict[str, Any]] = None) -> str:
    """Short stable digest of the resolved knob surface (the
    reference's: the same config hashes the same in both packages)."""
    cfg = config if config is not None else active_config()
    blob = json.dumps(
        {k: list(v) if isinstance(v, tuple) else v
         for k, v in sorted(cfg.items())},
        sort_keys=True, separators=(",", ":"),
    )
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def tuned() -> bool:
    """Whether a persisted/explicit profile is active (vs defaults)."""
    with _state_lock:
        return bool(_active)


def perf_snapshot() -> dict:
    """The perf plane's disclosure block for engine_snapshot: resolved
    config hash, whether a tuned profile is active, and where it came
    from."""
    with _state_lock:
        return {
            "config_hash": config_hash(),
            "tuned": bool(_active),
            "profile": _active_source,
            "overrides": dict(_active),
        }


def ensure_profile(backend: Optional[str] = None) -> None:
    """Load the persisted profile of ``backend`` once per process, if
    one exists. Called by every checker constructor, so it must be
    cheap on the common (no-profile) path and NEVER raise: a corrupt,
    foreign-keyed, or stale profile silently degrades to defaults.

    ``backend`` is the device type the constructor resolved ("cuda" or
    "cpu"; None: the default device, the card). The latch is kept per
    backend: a ``--backend cpu`` run on a card host reads the CPU's
    profile, never the card's. Once an override set is active (a
    profile of another backend, ``--profile``, a sweep), no later call
    replaces it.

    The no-profile fast path does not touch torch: the profile key
    needs the device's name, but when the profile directory holds no
    profile of the port there is nothing to key against, and
    construction-only callers (tests, tooling) must not initialize
    CUDA."""
    if backend in _profile_checked:
        return
    with _state_lock:
        if backend in _profile_checked:
            return
        _profile_checked.add(backend)
        already_active = bool(_active)
    if already_active or os.environ.get(NO_PROFILE_ENV):
        return
    try:
        from jepsen_tpu_torch.perf import autotune

        if not autotune.any_profile_present():
            return
        autotune.load_active_profile(backend)
    except Exception:
        return  # the perf plane never breaks a checker construction


def _reset_for_tests() -> None:
    """Drop the active profile AND the once-per-backend load latch."""
    global _active, _active_source
    with _state_lock:
        _active = {}
        _active_source = None
        _profile_checked.clear()
