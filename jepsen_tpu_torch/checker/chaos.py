"""Plane nemesis + resilience primitives for the dispatch plane: the
single-device half of jepsen_tpu.checker.chaos, for CUDA.

A deterministic fault-injection seam that wraps the dispatch plane's
launch/collect callables, plus the resilience machinery (failure
classifier, bounded exponential-backoff retry, per-call deadlines,
device quarantine) the plane uses to survive what the seam injects.

Fault classes:

- ``transient``  — a launch failure that clears on retry (the device
  busy / could-not-queue class).
- ``persistent`` — a per-device failure that never clears: every call
  placing work on the target device fails. It is shaped as a sticky
  CUDA error (cudaErrorLaunchFailure, 719), which poisons the context:
  classified ``fatal``, never retried.
- ``hang``       — the call blocks far past its budget (the wedged
  device-sync class). The cure is a deadline, not a classifier.
- ``oom``        — an allocation failure (cudaErrorMemoryAllocation, 2;
  retrying the same shape OOMs again).

Faults inject by explicit schedule (an ordered list of ChaosFault
specs, each matching a site/device and firing a bounded number of
times) or by seeded probability (the soak mode) — both deterministic,
so differential tests replay identical fault trains. No plan installed
= the seam is one ``is None`` check.

The resilience side is consumed by dispatch.DispatchPlane (its
degradation ladder: on one device, a spent budget fails the riders with
the PlaneFault, or, on the CPU or with ``degrade=True``, resolves them
from the host oracle with ``degraded`` on the verdict), wgl_bitset's
collect-time exact re-runs, and linearizable's plane entries:

- ``classify_fault``  — transient vs. oom vs. deadline vs. fatal, from
  what PyTorch and the port's ctypes launchers raise
  (torch.cuda.OutOfMemoryError; _build.CudaError's cudaError_t code),
  and "error" for what names no device (a Python error, a kernel that
  did not build): that one is re-raised as it is, never retried or
  degraded.
- ``resilient_call``  — inject + classify + bounded backoff retry +
  optional deadline; raises a structured ``PlaneFault`` when the
  budget is spent (never the raw device exception).
- quarantine registry — per-device failure counts, and per-tenant
  ones under ``tenant:<name>`` pseudo-labels (the service's breaker).
- ``RESILIENCE_STATS`` — retries / deadline_hits / degradations /
  oracle_fallbacks / faults_injected / plane_faults, snapshotted into
  ``dispatch_stats()["resilience"]``.

Stdlib-only: every layer imports it without cost.
"""

from __future__ import annotations

import re
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

from jepsen_tpu_torch.obs import trace as obs_trace

# --------------------------------------------------------------------
# Structured failures
# --------------------------------------------------------------------


class PlaneFault(RuntimeError):
    """The structured failure envelope the plane resolves with when a
    launch/collect could not be saved: site + classified kind + attempt
    count + (when attributable) the device, with the raw exception as
    __cause__. Raw device exceptions never cross ``result()``."""

    def __init__(self, site: str, kind: str, attempts: int,
                 device: Optional[str] = None,
                 cause: Optional[BaseException] = None):
        self.site = site
        self.kind = kind
        self.attempts = attempts
        self.device = device
        self.cause = cause
        msg = f"plane fault at {site}: {kind} after {attempts} attempt(s)"
        if device:
            msg += f" on {device}"
        if cause is not None:
            msg += f" ({type(cause).__name__}: {cause})"
        super().__init__(msg)

    def describe(self) -> dict:
        return {
            "site": self.site,
            "kind": self.kind,
            "attempts": self.attempts,
            "device": self.device,
            "cause": (
                f"{type(self.cause).__name__}: {self.cause}"
                if self.cause is not None else None
            ),
        }


class DeadlineExceeded(Exception):
    """A guarded call blew its per-call deadline (hung device sync)."""


class InjectedCudaError(RuntimeError):
    """The nemesis's stand-in for a CUDA failure: it carries a
    cudaError_t code like the port's launchers' errors
    (_build.CudaError), so the classifier treats injected and real
    failures identically."""

    def __init__(self, msg: str, cuda_error: int,
                 device: Optional[str] = None):
        super().__init__(msg)
        self.cuda_error = cuda_error
        self.chaos_device = device


#: cudaErrorMemoryAllocation
CUDA_OOM = 2
#: cudaErrorLaunchFailure: sticky, the context is lost
CUDA_LAUNCH_FAILURE = 719
#: cudaErrorNotReady: the code the transient class carries (work not
#: yet complete; the call is worth repeating)
CUDA_NOT_READY = 600

# --------------------------------------------------------------------
# Fault specs + the chaos plan
# --------------------------------------------------------------------


@dataclass
class ChaosFault:
    """One scheduled fault. Matches a seam crossing when ``site`` is
    None or equal, and ``device`` is None or a substring of one of the
    crossing's device labels; fires at most ``times`` times (None =
    forever — the persistent class)."""

    kind: str  # "transient" | "persistent" | "hang" | "oom"
    site: Optional[str] = None  # "launch" | "collect" | None = any
    device: Optional[str] = None
    times: Optional[int] = 1
    delay_s: float = 30.0  # hang sleep
    fired: int = 0

    def matches(self, site: str, devices: Sequence[str]) -> bool:
        if self.times is not None and self.fired >= self.times:
            return False
        if self.site is not None and self.site != site:
            return False
        if self.device is not None:
            return any(self.device in d for d in devices)
        return True

    def build(self) -> BaseException:
        if self.kind == "oom":
            return InjectedCudaError(
                "CUDA error: out of memory (cudaErrorMemoryAllocation) "
                "while allocating 137438953472 bytes [injected]",
                CUDA_OOM, device=self.device,
            )
        if self.kind == "persistent":
            return InjectedCudaError(
                "CUDA error: unspecified launch failure "
                f"(cudaErrorLaunchFailure) on {self.device or '?'} "
                "[injected]",
                CUDA_LAUNCH_FAILURE, device=self.device,
            )
        return InjectedCudaError(
            "CUDA error: device busy, launch not queued (transient) "
            "[injected]",
            CUDA_NOT_READY, device=self.device,
        )


def transient_fault(site: Optional[str] = "launch", times: int = 1,
                    device: Optional[str] = None) -> ChaosFault:
    return ChaosFault("transient", site=site, device=device, times=times)


def persistent_device_fault(device: str,
                            site: Optional[str] = None) -> ChaosFault:
    return ChaosFault("persistent", site=site, device=device, times=None)


def hang_fault(site: Optional[str] = "collect", times: int = 1,
               delay_s: float = 30.0,
               device: Optional[str] = None) -> ChaosFault:
    return ChaosFault("hang", site=site, device=device, times=times,
                      delay_s=delay_s)


def oom_fault(site: Optional[str] = "launch", times: int = 1) -> ChaosFault:
    return ChaosFault("oom", site=site, times=times)


@dataclass
class ChaosPlan:
    """A deterministic fault schedule: ordered ChaosFault specs checked
    first-match per seam crossing, plus an optional seeded probabilistic
    mode (``seed``/``p_transient``) that injects transient faults on a
    replayable coin — the soak's traffic-shaped nemesis."""

    faults: List[ChaosFault] = field(default_factory=list)
    seed: Optional[int] = None
    p_transient: float = 0.0

    def __post_init__(self):
        import random

        self._lock = threading.Lock()
        self._rng = random.Random(self.seed if self.seed is not None
                                  else 0)

    def draw(self, site: str, devices: Sequence[str]
             ) -> Optional[ChaosFault]:
        with self._lock:
            for f in self.faults:
                if f.matches(site, devices):
                    f.fired += 1
                    return f
            if self.seed is not None and self.p_transient > 0.0:
                if self._rng.random() < self.p_transient:
                    return ChaosFault("transient", site=site)
        return None


_ACTIVE: Optional[ChaosPlan] = None
_active_lock = threading.Lock()


def install_chaos(plan: ChaosPlan) -> None:
    global _ACTIVE
    with _active_lock:
        _ACTIVE = plan


def clear_chaos() -> None:
    global _ACTIVE
    with _active_lock:
        _ACTIVE = None


@contextmanager
def chaos_plan(*faults: ChaosFault, seed: Optional[int] = None,
               p_transient: float = 0.0):
    """Install a chaos plan for the duration of the block:
    ``with chaos_plan(transient_fault()): ...``."""
    plan = ChaosPlan(list(faults), seed=seed, p_transient=p_transient)
    install_chaos(plan)
    try:
        yield plan
    finally:
        clear_chaos()


def inject(site: str, devices: Sequence[str] = ()) -> None:
    """The seam: called by resilient_call before the guarded callable
    runs. No plan installed = one None check. A matching hang fault
    sleeps (the guarded call then proceeds — a slow sync, cut short by
    the caller's deadline); every other class raises."""
    plan = _ACTIVE
    if plan is None:
        return
    fault = plan.draw(site, devices)
    if fault is None:
        return
    with _stats_lock:
        RESILIENCE_STATS["faults_injected"] += 1
    if fault.kind == "hang":
        time.sleep(fault.delay_s)
        return
    raise fault.build()


# --------------------------------------------------------------------
# Failure classification + device attribution
# --------------------------------------------------------------------

_TRANSIENT_MARKS = (
    "transient", "device busy", "not ready", "connection reset",
)
_OOM_MARKS = ("out of memory", "cudaerrormemoryallocation")
# "oom" must match as a token, not a substring ("boom" is not an OOM).
_OOM_TOKEN = re.compile(r"\boom\b")
# What marks an error as the device's: PyTorch's CUDA errors
# ("CUDA error: ...", torch.AcceleratorError) and the CUDA libraries'.
_DEVICE_MARKS = ("cuda", "acceleratorerror", "cublas", "cudnn",
                 "device-side assert")

def classify_fault(exc: BaseException) -> str:
    """transient (retry), oom (no retry), deadline (retry), fatal (no
    retry), or error: not a device fault at all.

    torch.cuda.OutOfMemoryError and a cudaError_t of
    cudaErrorMemoryAllocation are oom; any other cudaError_t a launcher
    returns (the sticky 700 illegal address and 719 launch failure
    among them, which poison the context) is fatal. Text marks decide
    the rest, and an error that names no device (a Python error in a
    wrapper, a kernel that did not build: _build.BuildError) is
    "error": resilient_call re-raises it as it is, so the plane never
    answers for a broken program from the host oracle."""
    if isinstance(exc, DeadlineExceeded):
        return "deadline"
    names = [c.__name__ for c in type(exc).__mro__]
    if "BuildError" in names:
        return "error"
    if "OutOfMemoryError" in names:
        return "oom"
    code = getattr(exc, "cuda_error", None)
    if code == CUDA_OOM:
        return "oom"
    if code == CUDA_NOT_READY:
        return "transient"
    if code is not None:
        return "fatal"
    text = f"{type(exc).__name__}: {exc}".lower()
    if any(m in text for m in _OOM_MARKS) or _OOM_TOKEN.search(text):
        return "oom"
    if any(m in text for m in _TRANSIENT_MARKS):
        return "transient"
    if any(m in text for m in _DEVICE_MARKS):
        return "fatal"
    return "error"


def attribute_device(exc: BaseException,
                     devices: Sequence[str]) -> Optional[str]:
    """Pin a failure to a device label ("cuda:0") when the evidence
    names one — the injected fault's tag, or a label embedded in the
    message. No evidence = None: quarantine never ejects blind."""
    hint = getattr(exc, "chaos_device", None)
    if hint is not None:
        for d in devices:
            if hint in d:
                return d
        return str(hint)
    text = str(exc)
    for d in devices:
        if d and d in text:
            return d
    return None


# --------------------------------------------------------------------
# Retry policy + deadline
# --------------------------------------------------------------------


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff for retryable fault classes."""

    max_retries: int = 3
    base_delay_s: float = 0.005
    multiplier: float = 2.0
    max_delay_s: float = 0.25

    def delay(self, attempt: int) -> float:
        return min(self.base_delay_s * self.multiplier ** attempt,
                   self.max_delay_s)


DEFAULT_RETRY = RetryPolicy()

#: fault kinds worth retrying in place (oom re-OOMs on the same shape,
#: fatal is a sticky device error: both spend the budget at once)
_RETRYABLE = ("transient", "deadline")


def run_with_deadline(fn: Callable, deadline_s: float):
    """Run fn with a hard wall-clock budget: the call runs on a helper
    thread; blowing the budget raises DeadlineExceeded and abandons the
    thread (the point is the PLANE stays alive and the rider resolves).
    The plane's collect polls its CUDA event under the same budget
    (device.wait_train), so an abandoned collect thread ends too
    instead of blocking in a CUDA call."""
    box: dict = {}
    done = threading.Event()

    def _run():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["error"] = e
        finally:
            done.set()

    # planelint: disable=JT203 reason=a wedged device sync cannot be interrupted; the deadline thread is ABANDONED by design (daemon, never joined) and the caller raises PlaneFault past it
    t = threading.Thread(target=_run, daemon=True, name="plane-deadline")
    t.start()
    if not done.wait(deadline_s):
        raise DeadlineExceeded(
            f"guarded call exceeded its {deadline_s}s deadline"
        )
    if "error" in box:
        raise box["error"]
    return box["value"]


def resilient_call(
    thunk: Callable,
    site: str,
    devices: Sequence[str] = (),
    policy: Optional[RetryPolicy] = None,
    deadline_s: Optional[float] = None,
    on_fault: Optional[Callable[[str, Optional[str], BaseException],
                                None]] = None,
):
    """The guarded execution primitive: inject (the seam) + run, with
    per-call deadline, classification, and bounded backoff retry for
    retryable classes. Exhausted budgets raise PlaneFault — callers
    (the plane's degradation ladder) decide what survives. An error of
    kind "error" (no device fault) is re-raised at once, unwrapped."""
    policy = policy or DEFAULT_RETRY
    attempt = 0
    while True:
        try:
            def _run():
                inject(site, devices)
                return thunk()

            if deadline_s is not None:
                return run_with_deadline(_run, deadline_s)
            return _run()
        except PlaneFault:
            raise  # already structured by a nested guard
        except Exception as e:  # noqa: BLE001 - classified below
            kind = classify_fault(e)
            if kind == "error":
                raise  # the program's fault, not the device's
            device = attribute_device(e, devices)
            if kind == "deadline":
                with _stats_lock:
                    RESILIENCE_STATS["deadline_hits"] += 1
            if on_fault is not None:
                on_fault(kind, device, e)
            if kind in _RETRYABLE and attempt < policy.max_retries:
                with _stats_lock:
                    RESILIENCE_STATS["retries"] += 1
                obs_trace.instant("retry", kind="chaos", site=site,
                                  fault=kind, attempt=attempt + 1)
                time.sleep(policy.delay(attempt))
                attempt += 1
                continue
            raise PlaneFault(site=site, kind=kind, attempts=attempt + 1,
                             device=device, cause=e) from e


# --------------------------------------------------------------------
# Device quarantine + resilience stats
# --------------------------------------------------------------------

#: the resilience ledger: retries = backoff re-attempts, deadline_hits
#: = guarded calls cut by their budget, degradations = ladder steps
#: taken (on one device: to the host oracle), oracle_fallbacks =
#: futures resolved by the host oracle, faults_injected = seam
#: crossings the nemesis fired on, plane_faults = structured failures
#: that reached a future.
RESILIENCE_STATS = {
    "retries": 0,
    "deadline_hits": 0,
    "degradations": 0,
    "oracle_fallbacks": 0,
    "faults_injected": 0,
    "plane_faults": 0,
}

_stats_lock = threading.Lock()

_DEVICE_FAILURES: dict = {}
_QUARANTINED: "list[str]" = []

#: tenant pseudo-labels in the quarantine registry: the dispatch plane
#: appends "tenant:<name>" tags to its guard label lists, so a fault
#: ATTRIBUTED to a tenant (an injected fault tagged with the tenant, or
#: a real error naming it) counts against the tenant's own breaker in
#: this same ledger instead of against the card. No device is named
#: "tenant:...", so a tenant quarantine never reads as the card's: one
#: tenant's fault storm trips ITS breaker, not the plane.
TENANT_PREFIX = "tenant:"


def is_tenant_label(label: str) -> bool:
    return isinstance(label, str) and label.startswith(TENANT_PREFIX)


def quarantined_tenants() -> tuple:
    """Tenant names (prefix stripped) currently quarantined: the
    service daemon's admission door sheds these with 429s."""
    with _stats_lock:
        return tuple(
            q[len(TENANT_PREFIX):] for q in _QUARANTINED
            if is_tenant_label(q)
        )


#: host pseudo-labels: "host:<i>" rows mark a whole failure domain as
#: dead. A fleet member's death quarantines its host label
#: (service/membership.py). No device is named "host:...", so a host
#: quarantine never reads as the card's.
HOST_PREFIX = "host:"


def is_host_label(label: str) -> bool:
    return isinstance(label, str) and label.startswith(HOST_PREFIX)


def quarantined_hosts() -> tuple:
    """Host ids (prefix stripped) currently quarantined: dead fleet
    members."""
    with _stats_lock:
        return tuple(
            q[len(HOST_PREFIX):] for q in _QUARANTINED
            if is_host_label(q)
        )


def note_degradation(n: int = 1) -> None:
    with _stats_lock:
        RESILIENCE_STATS["degradations"] += n


def note_oracle_fallback(n: int = 1) -> None:
    with _stats_lock:
        RESILIENCE_STATS["oracle_fallbacks"] += n


def note_plane_fault(n: int = 1) -> None:
    with _stats_lock:
        RESILIENCE_STATS["plane_faults"] += n


#: quarantine observers: fn(label) runs the moment a label is
#: quarantined. The list has its own lock so registration never
#: contends with failure accounting.
_QUARANTINE_HOOKS: "list" = []
_hooks_lock = threading.Lock()


def add_quarantine_hook(fn) -> None:
    """Register ``fn(label)`` to run when a label is quarantined. Hooks
    run with no lock held: a hook may re-enter the stats API, and a
    slow hook never stalls other threads' failure accounting."""
    with _hooks_lock:
        _QUARANTINE_HOOKS.append(fn)


def remove_quarantine_hook(fn) -> None:
    with _hooks_lock:
        try:
            _QUARANTINE_HOOKS.remove(fn)
        except ValueError:
            pass


def clear_quarantine_hooks() -> None:
    with _hooks_lock:
        _QUARANTINE_HOOKS.clear()


def _post_quarantine(label: str) -> None:
    """The tail shared by every quarantine entry point: the trace
    instant, then the observer hooks, with no lock held."""
    obs_trace.instant("quarantine", kind="chaos", device=label)
    with _hooks_lock:
        hooks = tuple(_QUARANTINE_HOOKS)
    for fn in hooks:
        try:
            fn(label)
        except Exception:  # noqa: BLE001 - an observer must not
            pass  # break the accounting path it observes


def note_device_failure(label: str, quarantine_after: int = 3) -> bool:
    """Count one attributed failure against a device; returns True the
    moment the count crosses ``quarantine_after`` and the device is
    quarantined (exactly once). Quarantine hooks fire on that trip."""
    with _stats_lock:
        n = _DEVICE_FAILURES.get(label, 0) + 1
        _DEVICE_FAILURES[label] = n
        tripped = n >= quarantine_after and label not in _QUARANTINED
        if tripped:
            _QUARANTINED.append(label)
    if tripped:
        _post_quarantine(label)
    return tripped


def quarantine_label(label: str) -> bool:
    """Quarantine a label at once, skipping the failure-count ladder:
    a dead fleet member cannot produce more failures to count. Fires
    the same instant and hooks as a threshold trip; idempotent
    (returns False when the label is already out)."""
    with _stats_lock:
        tripped = label not in _QUARANTINED
        if tripped:
            _QUARANTINED.append(label)
    if tripped:
        _post_quarantine(label)
    return tripped


def clear_quarantine_label(label: str) -> bool:
    """Re-admit one label: drop its quarantine row and reset its
    failure count. A respawned fleet member carries the ``host:<i>``
    label its dead predecessor was quarantined under; without this the
    replacement would never route. Scoped to one label: re-admission
    never amnesties other breakers the way ``reset_resilience`` does.
    Returns True when a row was cleared."""
    with _stats_lock:
        cleared = label in _QUARANTINED
        if cleared:
            _QUARANTINED.remove(label)
        _DEVICE_FAILURES.pop(label, None)
    if cleared:
        obs_trace.instant(
            "quarantine_cleared", kind="chaos", device=label
        )
    return cleared


def quarantined_devices() -> tuple:
    """Real quarantined device labels (tenant and host pseudo-labels
    excluded: they surface via quarantined_tenants and
    quarantined_hosts)."""
    with _stats_lock:
        return tuple(
            q for q in _QUARANTINED
            if not is_tenant_label(q) and not is_host_label(q)
        )


def mesh_ejection_labels() -> tuple:
    """Every label that should shrink a mesh: quarantined slots PLUS
    quarantined host rows (sharded.mesh_without expands the latter into
    their domain's slot slice). Tenant labels stay excluded: a tenant
    breaker never touches topology."""
    with _stats_lock:
        return tuple(
            q for q in _QUARANTINED if not is_tenant_label(q)
        )


def is_quarantined(label: str) -> bool:
    with _stats_lock:
        return label in _QUARANTINED


def device_failures() -> dict:
    with _stats_lock:
        return dict(_DEVICE_FAILURES)


def resilience_snapshot() -> dict:
    """The ``resilience`` block dispatch_stats() publishes. Tenant and
    host pseudo-labels report separately from the device, so a tenant
    breaker trip or a fleet member's death never reads as the card's
    quarantine."""
    with _stats_lock:
        out = dict(RESILIENCE_STATS)
        out["quarantined_devices"] = [
            q for q in _QUARANTINED
            if not is_tenant_label(q) and not is_host_label(q)
        ]
        out["quarantined_tenants"] = [
            q[len(TENANT_PREFIX):] for q in _QUARANTINED
            if is_tenant_label(q)
        ]
        out["quarantined_hosts"] = [
            q[len(HOST_PREFIX):] for q in _QUARANTINED
            if is_host_label(q)
        ]
        out["device_failures"] = dict(_DEVICE_FAILURES)
    return out


def reset_resilience() -> None:
    with _stats_lock:
        for k in RESILIENCE_STATS:
            RESILIENCE_STATS[k] = 0
        _DEVICE_FAILURES.clear()
        del _QUARANTINED[:]
