"""Host-side history -> event-stream preprocessing for the WGL engine.

A copy of jepsen_tpu.checker.events, with its compiled prep fast path
(csrc/wgl_prep.cc through wgl_native.prep_steps_native) in front of
the numpy one. The frontier search consumes
a flat event stream, not op records. Each event is five int32s:

  kind   0=INVOKE 1=RETURN 2=NOP (padding)
  slot   window slot in [0, W) occupied by the op
  f      model f-code (models.F_READ/WRITE/CAS)
  a, b   interned value codes (NIL=-1 encodes None)

Construction rules (semantics per knossos / the reference runtime,
jepsen/src/jepsen/core.clj:199-232,338-355):

- The history is ``complete()``d first: :ok completion values are copied
  onto invocations, :fail invocations are marked ``fails`` and dropped,
  :info invocations are marked ``crashed``.
- A kept invocation emits INVOKE at its history position; its :ok
  completion emits RETURN. :info completions emit nothing — a crashed op
  may take effect at any moment after its invocation, so it stays open
  (its slot is never freed).
- Crashed *reads* are dropped entirely.
- Slots are assigned from a free list at INVOKE and recycled at RETURN.
  The maximum concurrently-open count is the required window W; masks
  are multi-word int32 bitsets (32 slots per word), up to MAX_WINDOW=128.
"""

from __future__ import annotations

import heapq
import threading
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from jepsen_tpu_torch.checker.models import F_CAS, Model, model as get_model
from jepsen_tpu_torch.history.history import History
from jepsen_tpu_torch.obs import trace as obs_trace

EV_INVOKE, EV_RETURN, EV_NOP = 0, 1, 2

NIL = -1

MAX_WINDOW = 128


def bucket(n: int, lo: int = 64) -> int:
    """Power-of-two shape bucket >= n — the single bucketing policy
    for every checker path (padded shapes keep the reference's
    layouts, so both packages see identical kernel inputs)."""
    size = lo
    while size < n:
        size *= 2
    return size


def n_words(W: int) -> int:
    """Mask words needed for a W-slot window (32 slots per int32)."""
    return max((W + 31) // 32, 1)


def slot_bit_table(W: int) -> np.ndarray:
    """[W, n_words] int32: the mask word pattern for each slot's bit."""
    nw = n_words(W)
    out = np.zeros((W, nw), np.uint32)
    for w in range(W):
        out[w, w // 32] = np.uint32(1) << np.uint32(w % 32)
    return out.view(np.int32)


def intern_key(v):
    """Canonicalize a payload to a hashable interning key: set-workload reads
    are lists, txn payloads can be dicts. Scalars key on (kind, value) so
    True/1 and 0/False intern to distinct codes — int vs float also stay
    distinct, matching the reference's Clojure equality where (= 1 1.0) is
    false — while numpy scalars normalize to their Python kind."""
    if isinstance(v, bool) or isinstance(v, np.bool_):
        return ("bool", bool(v))
    if isinstance(v, (int, np.integer)):
        return ("int", int(v))
    if isinstance(v, (float, np.floating)):
        return ("float", float(v))
    if isinstance(v, (list, tuple)):
        return ("seq", tuple(intern_key(x) for x in v))
    if isinstance(v, (set, frozenset)):
        return ("set", frozenset(intern_key(x) for x in v))
    if isinstance(v, dict):
        return (
            "map",
            tuple(
                sorted(
                    ((intern_key(k), intern_key(x)) for k, x in v.items()),
                    key=repr,
                )
            ),
        )
    return (type(v).__name__, v)


class WindowOverflow(Exception):
    """More than MAX_WINDOW ops were concurrently open."""


@dataclass
class EventStream:
    """Dense event arrays plus the decoding context."""

    kind: np.ndarray  # [n] int32
    slot: np.ndarray  # [n] int32
    f: np.ndarray  # [n] int32
    a: np.ndarray  # [n] int32
    b: np.ndarray  # [n] int32
    window: int  # max slots concurrently open
    init_state: int  # value code of the register's initial value
    n_ops: int  # kept invocations
    value_codes: Dict[Any, Any] = field(default_factory=dict)
    #: op index (in the source history) per event, for error reporting
    op_index: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return int(self.kind.shape[0])

    def as_tuple(self):
        return (self.kind, self.slot, self.f, self.a, self.b)

    def padded(self, n: int) -> "EventStream":
        """Pad with NOP events to length n (shape bucketing)."""
        cur = len(self)
        if n < cur:
            raise ValueError(f"cannot pad {cur} events down to {n}")
        if n == cur:
            return self
        pad = n - cur

        def ext(arr, fill):
            return np.concatenate([arr, np.full(pad, fill, np.int32)])

        return EventStream(
            kind=ext(self.kind, EV_NOP),
            slot=ext(self.slot, 0),
            f=ext(self.f, 0),
            a=ext(self.a, 0),
            b=ext(self.b, 0),
            window=self.window,
            init_state=self.init_state,
            n_ops=self.n_ops,
            value_codes=self.value_codes,
            op_index=ext(self.op_index, -1) if self.op_index is not None else None,
        )


@dataclass
class ReturnSteps:
    """Event stream precompiled into per-RETURN scan steps.

    Only RETURN events mutate the WGL frontier, so the host bakes the
    INVOKE bookkeeping into per-return snapshots of the open-op window:
    the kernel scans [n_steps] rows with a frontier-only carry and zero
    control flow over event kinds.
    """

    occ: np.ndarray  # [n, W] bool — slot occupied at this return
    f: np.ndarray  # [n, W] int32 — open op's model f-code per slot
    a: np.ndarray  # [n, W] int32
    b: np.ndarray  # [n, W] int32
    slot: np.ndarray  # [n] int32 — the returning slot
    live: np.ndarray  # [n] bool — False rows are padding
    #: [n, n_words(W)] int32 — mask of slots whose current occupant never
    #: returns (crashed :info ops). Monotone over steps; drives the
    #: kernel's dominance pruning.
    crashed: np.ndarray
    #: [n] int32 — history op index of the returning completion, for
    #: failure artifacts (-1 on padding rows).
    op_index: np.ndarray
    init_state: int
    W: int
    #: [n, n_words(W)] int32 — mask of slots whose occupant was invoked
    #: since the PREVIOUS return. The frontier stays closed under
    #: already-open ops across a RETURN filter (the filter map commutes
    #: with expansion), so a step's closure only has new work for these
    #: slots — the bitset kernel's first closure round expands just
    #: them and can stop immediately if nothing was added.
    fresh: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return int(self.slot.shape[0])

    @property
    def NW(self) -> int:
        return int(self.crashed.shape[1]) if len(self) else n_words(self.W)

    def padded(self, n: int) -> "ReturnSteps":
        cur = len(self)
        if n < cur:
            raise ValueError(f"cannot pad {cur} steps down to {n}")
        if n == cur:
            return self
        pad = n - cur
        nw = n_words(self.W)
        return ReturnSteps(
            occ=np.concatenate([self.occ, np.zeros((pad, self.W), bool)]),
            f=np.concatenate([self.f, np.zeros((pad, self.W), np.int32)]),
            a=np.concatenate([self.a, np.zeros((pad, self.W), np.int32)]),
            b=np.concatenate([self.b, np.zeros((pad, self.W), np.int32)]),
            slot=np.concatenate([self.slot, np.zeros(pad, np.int32)]),
            live=np.concatenate([self.live, np.zeros(pad, bool)]),
            crashed=np.concatenate(
                [self.crashed, np.zeros((pad, nw), np.int32)]
            ),
            op_index=np.concatenate(
                [self.op_index, np.full(pad, -1, np.int32)]
            ),
            init_state=self.init_state,
            W=self.W,
            fresh=(
                np.concatenate(
                    [self.fresh, np.zeros((pad, nw), np.int32)]
                )
                if self.fresh is not None
                else None
            ),
        )


def crashed_invokes(events: EventStream) -> np.ndarray:
    """[n_events] bool — True at INVOKE events whose op never returns."""
    out = np.zeros(len(events), bool)
    open_inv: Dict[int, int] = {}
    for i in range(len(events)):
        kind = int(events.kind[i])
        s = int(events.slot[i])
        if kind == EV_INVOKE:
            open_inv[s] = i
            out[i] = True  # assume crashed until a RETURN proves otherwise
        elif kind == EV_RETURN:
            out[open_inv.pop(s)] = False
    return out


#: every derived-artifact cache attribute memo_on manages (cleared as
#: a set by clear_memos)
MEMO_ATTRS = (
    "_steps_cache", "_seg_args", "_seg_plan", "_padded_single",
    "_batch_args", "_bitset_args", "_kfrontier_args", "_death_frontier",
)

#: attrs that carry a one-shot in-flight artifact rather than a
#: rebuildable cache: LRU eviction leaves them alone (an eviction
#: landing between a collect writing the death frontier and its
#: resolver reading it would silently drop the failure report, and
#: unlike the caches no later lookup rebuilds it). Explicit
#: clear_memos still drops them.
_EVICT_KEEP = frozenset({"_death_frontier"})

#: prep-memo accounting: every memo_on lookup counts a hit or a miss;
#: evictions counts objects whose memos the LRU bound reclaimed.
MEMO_STATS = {"hits": 0, "misses": 0, "evictions": 0}

#: how many objects (streams/steps) may hold live memo caches at once.
#: Memos pin host arrays AND device tensors (a 100k-op stream's packed
#: segments are tens of MB), so an unbounded registry grows memory for
#: the life of a long run; a dispatch plane keeps many streams alive.
#: Eviction only costs a re-prep, never correctness (memo_on rebuilds
#: on the next miss).
MEMO_MAX_OBJECTS = 512

#: id(obj) -> weakref, insertion order = LRU (oldest first). RLock:
#: eviction calls clear_memos, which recurses back into this registry,
#: and GC-driven weakref callbacks may fire under the lock.
_memo_lock = threading.RLock()
_memo_owners: "OrderedDict[int, weakref.ref]" = OrderedDict()


def set_memo_limit(n: int) -> int:
    """Set MEMO_MAX_OBJECTS (evicting immediately if over the new
    bound); returns the previous limit."""
    global MEMO_MAX_OBJECTS
    with _memo_lock:
        old = MEMO_MAX_OBJECTS
        MEMO_MAX_OBJECTS = n
        _evict_over_limit()
    return old


def memo_stats() -> dict:
    with _memo_lock:
        return dict(MEMO_STATS)


def reset_memo_stats() -> None:
    with _memo_lock:
        for k in MEMO_STATS:
            MEMO_STATS[k] = 0


def _touch_owner(obj) -> None:
    """Register/refresh obj in the LRU registry (most recently used at
    the end) and evict over-limit owners. Caller holds _memo_lock."""
    k = id(obj)
    ref = _memo_owners.get(k)
    if ref is None or ref() is not obj:
        try:
            r = weakref.ref(obj, _make_reaper(k))
        except TypeError:  # un-weakrefable: stays unbounded (none today)
            return
        _memo_owners[k] = r
    _memo_owners.move_to_end(k)
    _evict_over_limit()


def _make_reaper(k: int):
    def reap(ref) -> None:
        with _memo_lock:
            # Guard against id reuse: only drop the entry if it still
            # holds THIS weakref (a new object may own the slot now).
            if _memo_owners.get(k) is ref:
                del _memo_owners[k]

    return reap


def _evict_over_limit() -> None:
    while len(_memo_owners) > MEMO_MAX_OBJECTS:
        _k, ref = _memo_owners.popitem(last=False)
        tgt = ref()
        if tgt is not None:
            MEMO_STATS["evictions"] += 1
            clear_memos(tgt, _evicting=True)


def memo_on(obj, attr: str, key, factory):
    """Memoize factory() on obj under attr[key] — the one idiom for
    every derived-artifact cache in the checker (steps per W, packed
    device args per segment, padded singles). The contract it rests on:
    EventStream/ReturnSteps are immutable once built — every checking
    path constructs them fresh and never mutates in place.

    Retention: memo-owning objects register in a global LRU registry
    bounded by MEMO_MAX_OBJECTS — the oldest owner's memos are cleared
    (clear_memos) when the bound is exceeded. Lookups are thread-safe
    (the dispatch plane's prep worker shares streams with collecting
    threads); the factory runs OUTSIDE the lock, and a concurrent
    duplicate build keeps the first stored value so identity stays
    stable."""
    with _memo_lock:
        cache = getattr(obj, attr, None)
        if cache is None:
            cache = {}
            setattr(obj, attr, cache)
        val = cache.get(key)
        _touch_owner(obj)
        if val is not None:
            MEMO_STATS["hits"] += 1
            return val
        MEMO_STATS["misses"] += 1
    val = factory()
    with _memo_lock:
        cache = getattr(obj, attr, None)
        if cache is None:  # evicted mid-build: reinstall
            cache = {}
            setattr(obj, attr, cache)
        # Re-register: the eviction that cleared the cache mid-build
        # also dropped obj from the LRU registry.
        _touch_owner(obj)
        cur = cache.get(key)
        if cur is not None:
            return cur  # another thread won: keep identity stable
        cache[key] = val
    return val


def clear_memos(obj, _evicting: bool = False) -> None:
    """Drop every derived-artifact memo from a stream/steps object
    (and recursively from memoized steps), releasing the pinned host
    and device memory, and deregister the object from the LRU
    registry.

    _evicting: the LRU-driven variant — in-flight artifacts
    (_EVICT_KEEP) survive, because eviction may land between the
    writer and the reader of a death frontier."""
    for nested in ("_steps_cache", "_padded_single"):
        cache = getattr(obj, nested, None)
        if isinstance(cache, dict):
            for v in cache.values():
                if v is not obj:
                    clear_memos(v, _evicting=_evicting)
    for attr in MEMO_ATTRS:
        if _evicting and attr in _EVICT_KEEP:
            continue
        if hasattr(obj, attr):
            try:
                delattr(obj, attr)
            except AttributeError:
                pass
    with _memo_lock:
        _memo_owners.pop(id(obj), None)


#: compiled (C++) prep fast path toggle: True tries the native helper
#: (wgl_native.prep_steps_native) first and falls back to the numpy
#: path when there is no toolchain. Tests flip it to pin both paths.
PREP_NATIVE = True


def events_to_steps(events: EventStream, W: int) -> ReturnSteps:
    """Precompile an event stream into per-return window snapshots.
    Memoized per (events, W): the precompile is a pure function of the
    immutable stream, so escalations and re-runs share one copy. The
    native pass (csrc/wgl_prep.cc) and the numpy path give
    byte-identical steps."""
    if events.window > W:
        raise ValueError(f"window {events.window} exceeds W={W}")
    with obs_trace.span("events_to_steps", kind="host", W=W) as sp:
        steps = memo_on(
            events, "_steps_cache", W, lambda: _events_to_steps(events, W)
        )
        sp.set(steps=len(steps))
    return steps


def _events_to_steps(events: EventStream, W: int) -> ReturnSteps:
    if len(events) == 0:
        return _empty_steps(events, W)
    if PREP_NATIVE:
        from jepsen_tpu_torch.checker.wgl_native import prep_steps_native

        st = prep_steps_native(events, W)
        if st is not None:
            return st
    return _events_to_steps_numpy(events, W)


def _empty_steps(events: EventStream, W: int) -> ReturnSteps:
    nw = n_words(W)
    return ReturnSteps(
        occ=np.zeros((0, W), bool),
        f=np.zeros((0, W), np.int32),
        a=np.zeros((0, W), np.int32),
        b=np.zeros((0, W), np.int32),
        slot=np.zeros(0, np.int32),
        live=np.zeros(0, bool),
        crashed=np.zeros((0, nw), np.int32),
        op_index=np.zeros(0, np.int32),
        init_state=events.init_state,
        W=W,
    )


def _events_to_steps_numpy(events: EventStream, W: int) -> ReturnSteps:
    """Fused vectorized prep: every pass works on [n_ret, W] STEP rows
    (n_ret = number of returns), never on event-length matrices. Slot
    writes scatter directly into step space — an invoke lands in the
    step of the first return after it, a return frees its slot from the
    next step on — and one masked np.maximum.accumulate forward-fills
    the last writer per (step, slot). Collisions inside a step cell
    resolve by scatter order: the freeing return opens the gap, so a
    re-acquiring invoke (written second) wins, and a slot sees at most
    one invoke per inter-return gap (it must be freed in between)."""
    nw = n_words(W)
    n = len(events)
    if n == 0:
        return _empty_steps(events, W)
    kind = events.kind
    slot = events.slot
    is_inv = kind == EV_INVOKE
    is_ret = kind == EV_RETURN
    ret_pos = np.nonzero(is_ret)[0]
    n_ret = int(ret_pos.shape[0])
    inv_pos = np.nonzero(is_inv)[0]
    # Step of each invoke: first return at-or-after it (invoke
    # positions are never return positions, so 'left' == 'right').
    step_of = np.searchsorted(ret_pos, inv_pos, side="left")
    keep = step_of < n_ret
    r_i = step_of[keep]
    c_i = slot[inv_pos[keep]]

    # Last-writer forward fill over step rows. Scatter clears first,
    # invokes second (see docstring for why invoke wins the cell).
    wrow = np.full((n_ret, W), -1, np.int32)
    rows = np.arange(1, n_ret, dtype=np.int32)
    wrow[rows, slot[ret_pos[:-1]]] = rows  # return j frees at row j+1
    wrow[r_i, c_i] = r_i.astype(np.int32)
    occ_w = np.zeros((n_ret, W), np.int8)
    f_w = np.zeros((n_ret, W), np.int32)
    a_w = np.zeros((n_ret, W), np.int32)
    b_w = np.zeros((n_ret, W), np.int32)
    occ_w[r_i, c_i] = 1
    f_w[r_i, c_i] = events.f[inv_pos[keep]]
    a_w[r_i, c_i] = events.a[inv_pos[keep]]
    b_w[r_i, c_i] = events.b[inv_pos[keep]]
    last = np.maximum.accumulate(wrow, axis=0)
    valid = last >= 0
    g = np.where(valid, last, 0)
    cols = np.arange(W)[None, :]
    out_occ = valid & (occ_w[g, cols] == 1)
    out_f = np.where(out_occ, f_w[g, cols], 0).astype(np.int32)
    out_a = np.where(out_occ, a_w[g, cols], 0).astype(np.int32)
    out_b = np.where(out_occ, b_w[g, cols], 0).astype(np.int32)

    # Crashed slots: more invokes than returns on the slot (crashed
    # slots are never recycled, so the unreturned invoke is its LAST
    # event); the crash bit turns on at that invoke's step.
    n_inv_s = np.bincount(c_full := slot[inv_pos], minlength=W)
    n_ret_s = np.bincount(slot[ret_pos], minlength=W)
    crashed_slots = np.nonzero(n_inv_s > n_ret_s)[0]
    out_crash = np.zeros((n_ret, nw), np.int32)
    if len(crashed_slots):
        # last invoke position per slot: in-order fancy assignment,
        # later (larger) positions overwrite earlier ones
        last_inv = np.full(W, -1, np.int64)
        last_inv[c_full] = inv_pos
        bits = slot_bit_table(W)
        for s in crashed_slots:
            r = int(np.searchsorted(ret_pos, last_inv[s], side="left"))
            if r < n_ret:
                out_crash[r] |= bits[s]
        np.bitwise_or.accumulate(out_crash, axis=0, out=out_crash)

    out_slot = slot[ret_pos].astype(np.int32)
    if events.op_index is not None:
        out_opidx = events.op_index[ret_pos].astype(np.int32)
    else:
        out_opidx = np.full(n_ret, -1, np.int32)

    # Fresh mask per step: one bincount per mask word with power-of-two
    # weights. Exact because each slot contributes at most one invoke
    # per step (distinct powers of two sum without carries, and the
    # per-word total < 2^32 is exactly representable in float64).
    out_fresh = np.zeros((n_ret, nw), np.int32)
    if len(r_i):
        word_of = c_i >> 5
        bit_of = np.ldexp(1.0, (c_i & 31).astype(np.int32))
        for w in range(nw):
            wts = np.where(word_of == w, bit_of, 0.0)
            out_fresh[:, w] = (
                np.bincount(r_i, weights=wts, minlength=n_ret)
                .astype(np.uint32)
                .view(np.int32)
            )
    return ReturnSteps(
        occ=out_occ,
        f=out_f,
        a=out_a,
        b=out_b,
        slot=out_slot,
        live=np.ones(n_ret, bool),
        crashed=out_crash,
        op_index=out_opidx,
        init_state=events.init_state,
        W=W,
        fresh=out_fresh,
    )


@obs_trace.traced("history_to_events")
def history_to_events(
    history: History,
    model: Any = "cas-register",
    init_value: Any = None,
    max_window: int = MAX_WINDOW,
    value_codes: Optional[Dict[Any, int]] = None,
    min_window: int = 0,
) -> EventStream:
    """Encode a record history into an EventStream for the given model.

    Raises WindowOverflow if concurrency (open ops incl. crashed ones)
    exceeds max_window.

    value_codes / min_window seed the encoder so a stream SUFFIX sealed
    at a clean boundary (no open invokes crossing it) re-encodes to the
    exact rows the full history would produce there: the interning
    table is append-only (prefix codes are frozen), and the returned
    window never shrinks below the sealed prefix's high-water (so the
    W-bucket choice — and with it the kernel shape — is stable). Slot
    assignment needs no seed: the min-heap recycler hands a cold
    encoder slots 0,1,2,... exactly as the warm one's fully-returned
    free heap would (streaming.py's windowed frontier GC relies on all
    three properties).
    """
    m: Model = get_model(model)
    h = history.complete()

    # Value interning local to this check: None -> NIL, else dense codes.
    # Keyed through intern_key so True/1 and 0/False stay distinct.
    codes: Dict[Any, int] = dict(value_codes) if value_codes else {}

    def code(v) -> int:
        if v is None:
            return NIL
        k = intern_key(v)
        c = codes.get(k)
        if c is None:
            c = len(codes)
            codes[k] = c
        return c

    # Kernel-capable models need an int initial state (e.g. mutex
    # starts unlocked=0 regardless of the interned init code); initial()
    # is idempotent for every model, so the oracle may apply it again.
    init_state = (
        int(m.initial(code(init_value)))
        if m.jax_capable
        else code(init_value)
    )

    kind: List[int] = []
    slot: List[int] = []
    fcol: List[int] = []
    acol: List[int] = []
    bcol: List[int] = []
    op_index: List[int] = []

    # Min-heap of recycled slots plus a high-water counter: always reuse
    # the smallest index so slots stay dense in [0, max-concurrency) —
    # the kernel's W (mask width) must cover max slot index + 1, not
    # just the concurrency count.
    free: List[int] = []
    next_fresh = 0
    open_slot: Dict[int, int] = {}  # invocation index -> slot
    window = max(int(min_window), 0)
    n_ops = 0

    pairs = h.pairs()

    def encode_fab(op) -> Optional[tuple]:
        fc = m.f_code(op.f)
        if fc < 0:
            return None
        v = op.value
        # Only cas payloads spread [old, new] across (a, b); any other
        # value — including a 2-element list written to the register —
        # interns whole (same gating as columnar.Encoder.encode_payload).
        if fc == F_CAS and m.f_names.get("cas") == F_CAS:
            # A cas payload must be [old, new]; anything else is outside
            # the model (encoding b=0 would alias a legitimate value
            # code and let the kernel "succeed" a garbage cas).
            if not (isinstance(v, (list, tuple)) and len(v) == 2):
                raise ValueError(
                    f"cas payload must be a 2-element [old, new], "
                    f"got {v!r} at history index {op.index}"
                )
            return (fc, code(v[0]), code(v[1]))
        return (fc, code(v), 0)

    for op in h.ops:
        if not op.is_client_op:
            continue
        if op.is_invoke:
            if op.get("fails"):
                continue  # :fail — the op never happened
            fab = encode_fab(op)
            if fab is None:
                continue  # outside the model
            fc, a, b = fab
            if op.get("crashed") and fc in m.crashed_droppable_fs:
                continue  # unconstrained crashed op: no effect
            if free:
                s = heapq.heappop(free)
            elif next_fresh < max_window:
                s = next_fresh
                next_fresh += 1
            else:
                raise WindowOverflow(
                    f"more than {max_window} concurrently-open ops "
                    f"at history index {op.index}"
                )
            open_slot[op.index] = s
            window = max(window, s + 1)
            n_ops += 1
            kind.append(EV_INVOKE)
            slot.append(s)
            fcol.append(fc)
            acol.append(a)
            bcol.append(b)
            op_index.append(op.index)
        elif op.is_ok:
            inv = pairs.get(op.index)
            if inv is None or inv not in open_slot:
                continue
            s = open_slot.pop(inv)
            heapq.heappush(free, s)
            kind.append(EV_RETURN)
            slot.append(s)
            fcol.append(0)
            acol.append(0)
            bcol.append(0)
            op_index.append(op.index)
        # :fail completions: invocation already dropped via `fails` mark.
        # :info completions: op stays open forever; emit nothing.

    return EventStream(
        kind=np.asarray(kind, np.int32),
        slot=np.asarray(slot, np.int32),
        f=np.asarray(fcol, np.int32),
        a=np.asarray(acol, np.int32),
        b=np.asarray(bcol, np.int32),
        window=window,
        init_state=init_state,
        n_ops=n_ops,
        value_codes=dict(codes),
        op_index=np.asarray(op_index, np.int32),
    )
