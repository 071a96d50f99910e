"""Exact bitset-automaton WGL scan: host checks, the CUDA kernel's
wrapper and its plain PyTorch version.

The counterpart of jepsen_tpu.checker.wgl_bitset. For the windows real
register workloads produce, the whole config space is small enough to
hold exactly:

    config = (state row, linearized-slot mask)
    space  = S rows x 2^W masks,   S = interned value codes + 1

so the frontier is an [S, 2^W] bit tensor, packed 32 masks per int32
word ([S, M] int32, M = max(2^W/32, 128)). A closure round linearizes
each open window slot w against every config at once (source row or
union of rows -> relabel m -> m | bit(w) -> OR into the destination
row); the RETURN filter keeps masks holding the returning slot's bit
and clears it. The representation is exact: no capacity, no overflow.

Two tiers share the soundness invariant (every set bit is a config
reached by a legal linearization chain): the FAST tier runs
FAST_ROUNDS closure rounds per step, so alive=True is definite and
alive=False provisional; the EXACT tier loops to a verified fixpoint
(bound W+2; hitting it is taint). A fast-tier death re-runs the exact
tier from segment 0.

bitset_scan() is the kernel: on a CUDA tensor it launches
csrc/bitset_scan.cu, on a CPU tensor it runs bitset_scan_plain(), the
same function in plain PyTorch with the same layout. The host helpers
(plan, pack_steps, plan_segments, decode_frontier, ...) are copies of
the reference's, so both packages feed the kernels byte-identical
inputs. The W ladder and the rows quantum resolve through the perf knob
registry at plan time (_w_buckets, _rows_bucket), as the reference's
do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from jepsen_tpu_torch.checker import _build
from jepsen_tpu_torch.checker.events import ReturnSteps, bucket, memo_on
from jepsen_tpu_torch.checker.models import model as get_model
from jepsen_tpu_torch.device import (
    _bump_launch,
    _host_get,
    host_value,
    record_use,
    resolve_device,
    upload,
)
from jepsen_tpu_torch.obs import trace as obs_trace
from jepsen_tpu_torch.perf import knobs as _perf_knobs

#: out columns: alive, taint, died op index, rounds total, rounds max
OUT_COLS = 8

#: per-step meta columns: slot, live, op_index, fresh mask
META_COLS = 4

#: step padding quantum of pack_steps (the reference's grid block; the
#: CUDA kernel loops over steps and needs no block, but padding the same
#: way keeps the packed inputs identical to the reference's)
STEP_BLOCK = 16

#: mask-word floor: smaller windows still use 128 words
MIN_WORDS = 128

#: window buckets; every width is its own bucket and the segment
#: planner moves between them as the live window fluctuates. Windows
#: past 19 route to the K-frontier ladder, as in the reference.
#: Documented default; the live ladder resolves through the perf knob
#: registry ("wgl_bitset.w_buckets", _w_buckets).
W_BUCKETS = (12, 13, 14, 15, 16, 17, 18, 19)

#: state-row (S) padding quantum (documented default; the live value
#: resolves through the perf knob registry,
#: "wgl_bitset.rows_bucket_growth")
ROWS_BUCKET_GROWTH = 8


def _w_buckets() -> tuple:
    """The active W rung ladder ("wgl_bitset.w_buckets"): the loaded
    profile's choice when there is one, the live W_BUCKETS module
    constant otherwise (so tests that prepend narrow rungs keep
    working). Every ladder the registry admits tops out at 19, so the
    envelope gate never moves: only which rungs the planner uses."""
    return tuple(_perf_knobs.resolve("wgl_bitset.w_buckets", W_BUCKETS))


#: state-row cap
MAX_ROWS = 32

#: the reference's gate on the two [S, M] frontier scratches (its VMEM
#: budget), kept so both packages route the same histories to this
#: tier; an envelope derived for H100 memory is later work
_FRONTIER_BYTES = 4 * 1024 * 1024

#: in-word mask-bit patterns: _C1[k] has bit beta set iff beta & (1<<k)
_C1 = tuple(
    int(np.uint32(sum(1 << b for b in range(32) if b & (1 << k))).view(np.int32))
    for k in range(5)
)

#: fast-tier fixed closure rounds (round 0 counts)
FAST_ROUNDS = 3

def w_bucket(window: int) -> Optional[int]:
    for w in _w_buckets():
        if window <= w:
            return w
    return None


def _rows_bucket(rows: int) -> int:
    g = max(int(_perf_knobs.resolve("wgl_bitset.rows_bucket_growth",
                                    ROWS_BUCKET_GROWTH)), 1)
    return max(g, bucket(rows, g))


def bitset_words(W: int) -> int:
    return max((1 << W) // 32, MIN_WORDS)


def plan(m, window: int, n_value_codes: int) -> Optional[Tuple[int, int]]:
    """(W, S) kernel shape for a model + history envelope, or None when
    the stream is outside the bitset kernel's envelope (window too wide,
    too many state rows, or a model without slot transitions). Same
    gates as the reference."""
    if m.bitset_slot is None:
        return None
    W = w_bucket(max(window, 1))
    if W is None:
        return None
    S = _rows_bucket(m.bitset_rows(n_value_codes))
    if S > MAX_ROWS:
        return None
    if 2 * 4 * S * bitset_words(W) > _FRONTIER_BYTES:
        return None
    return W, S


def init_frontier(init_state, S: int, W: int) -> np.ndarray:
    """[S, M] fresh-scan frontier: the init-state row, empty mask."""
    M = bitset_words(W)
    fr = np.zeros((S, M), np.int32)
    fr[int(init_state) + 1, 0] = 1
    return fr


def pack_steps(steps: ReturnSteps):
    """Host-side packing: FLAT [n*4*W] int8 window scalars (occ/f/a/b;
    codes are < MAX_ROWS) + flat [n*META_COLS] int32 per-step meta,
    padded to a STEP_BLOCK multiple."""
    B = STEP_BLOCK
    if len(steps) % B or not len(steps):
        steps = steps.padded(max(((len(steps) + B - 1) // B) * B, B))
    n = len(steps)
    meta = np.zeros((n, META_COLS), np.int32)
    meta[:, 0] = steps.slot
    meta[:, 1] = steps.live.astype(np.int32)
    meta[:, 2] = steps.op_index
    if steps.fresh is not None:
        meta[:, 3] = steps.fresh[:, 0]
    else:
        # No fresh tracking: treat every occupied slot as fresh.
        bits = (1 << np.arange(steps.W, dtype=np.int64))[None, :]
        meta[:, 3] = (steps.occ * bits).sum(axis=1).astype(np.int32)
    win = np.stack(
        [steps.occ, steps.f, steps.a, steps.b], axis=1
    ).astype(np.int8)
    return win.reshape(-1), meta.reshape(-1)


def _out_to_verdicts(out: np.ndarray) -> List[Tuple[bool, bool, int]]:
    return [
        (bool(o[0]), bool(o[1]), int(o[2])) for o in out[:, 0, :]
    ]


# -- the kernel: CUDA launch or plain version --------------------------------

#: the CUDA kernel's frontier stores (Store in csrc/bitset_scan.cu)
STORES = ("registers", "shared", "global")

#: the geometries csrc/bitset_scan.cu instantiates (its BITSET_INSTANCES):
#: (store index, rows, columns a thread); rows 0 means any S
INSTANCES = (
    (0, 8, 1), (0, 8, 2), (0, 8, 4), (0, 16, 1), (0, 16, 2),
    (1, 0, 1), (1, 0, 2), (1, 0, 4), (1, 0, 8),
    (2, 0, 4), (2, 0, 8), (2, 0, 16),
)

#: steps the kernel stages per chunk, and its decoded per-step ints
CHUNK = 32
_SMETA = 5

#: the card's limits: shared memory a block can use, registers a thread
SMEM_LIMIT = 232_448
REG_LIMIT = 255

#: registers a thread needs beside its frontier words (an estimate the
#: nvcc -Xptxas -v report of the build checks)
_REG_OVERHEAD = 48


def max_warps(store: str, S: int, cols: int) -> int:
    """Warps a block of this instance may have: max_threads in the .cu
    (its __launch_bounds__). The register store keeps (2S+1) cols words
    a thread (rows, union, snapshot): (S+1) cols <= 20 gets 512 threads
    (128 registers), wider gets 256 (255 registers)."""
    if store != "registers":
        return 32
    return 16 if (S + 1) * cols <= 20 else 8


def register_cap(store: str, S: int, cols: int) -> int:
    """Registers a thread may use under that launch bound."""
    return min(REG_LIMIT, 65536 // (32 * max_warps(store, S, cols)))


@dataclass(frozen=True)
class Geometry:
    """How the kernel lays one key's [S, M] frontier over a block:
    `warps` warps, each lane owning `cols` mask-word columns of every
    row (word j = lane | col << 5 | warp << (5 + log2 cols)), kept in
    `store`."""

    store: str
    warps: int
    cols: int
    W: int
    S: int

    @property
    def M(self) -> int:
        return bitset_words(self.W)

    @property
    def cbits(self) -> int:
        return self.cols.bit_length() - 1

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of one block (make_layout in the .cu)."""
        return 4 * smem_words(self.W, self.S, self.M, self.store, self.warps)

    @property
    def registers(self) -> int:
        """Estimated registers a thread: the register store holds its
        (S + 1) * cols words and a snapshot of the S * cols row words."""
        held = (2 * self.S + 1) * self.cols if self.store == "registers" else 0
        return held + _REG_OVERHEAD

    def owner(self, j: int) -> Tuple[int, int, int]:
        """(warp, lane, col) of the thread owning mask word j."""
        return j >> (5 + self.cbits), j & 31, (j >> 5) & (self.cols - 1)

    def word(self, warp: int, lane: int, col: int) -> int:
        return lane | (col << 5) | (warp << (5 + self.cbits))

    def slot_class(self, w: int) -> str:
        """What closure slot w (or a RETURN of slot w) exchanges: within
        the word, with another lane, between a thread's columns, or with
        another warp."""
        if w < 5:
            return "word"
        b = w - 5
        if b < 5:
            return "lane"
        if b < 5 + self.cbits:
            return "column"
        if (1 << b) < self.M:
            return "warp"
        return "beyond"


def smem_words(W: int, S: int, M: int, store: str, warps: int) -> int:
    """32-bit words of dynamic shared memory: make_layout in the .cu."""
    o = 2 * (CHUNK * W + CHUNK * META_COLS) + CHUNK * W + CHUNK * _SMETA
    if store != "registers":
        o += M  # union row
    if warps > 1:
        o += M  # two parities of the M/2-word closure exchange
        if store == "registers":
            o += (S + 1) * (M // 2)  # filter exchange
    if store == "shared":
        o += S * M
    return o


def _instantiated(store: str, S: int, cols: int) -> bool:
    i = STORES.index(store)
    return any(st == i and r in (0, S) and c == cols
               for st, r, c in INSTANCES)


def _fits(geo: Geometry) -> bool:
    return (
        geo.smem_bytes <= SMEM_LIMIT
        and geo.warps <= max_warps(geo.store, geo.S, geo.cols)
        and geo.registers <= register_cap(geo.store, geo.S, geo.cols)
    )


def geometry(W: int, S: int, placement: Optional[str] = None) -> Geometry:
    """The kernel's geometry for a (W, S) scan: in a store, the fewest
    columns a thread at a warp count the instance allows (a thread's
    work per slot grows with its columns, and a slot is a dependent
    chain, so more threads with fewer words are faster; only slots
    above the thread's columns cross warps).

    placement None takes the register store when one column a thread
    fits in at most _REG_AUTO_WARPS warps (W <= 12) and S <= 8, else
    shared memory, else global memory: on an H100 the register store
    beats shared memory only there (tools/kernel_times.py --sweep,
    PERF.md).
    "registers", "shared" or "global" asks for that store at any size
    it fits and raises if it does not."""
    M = bitset_words(W)

    def pick(store, cap):
        for cols in (1, 2, 4, 8, 16):
            warps = M // (32 * cols)
            if warps < 1 or 32 * warps * cols != M:
                continue
            g = Geometry(store, warps, cols, W, S)
            if _instantiated(store, S, cols) and warps <= cap and _fits(g):
                return g
        return None

    if placement is None:
        g = (pick("registers", _REG_AUTO_WARPS)
             if M // 32 <= _REG_AUTO_WARPS and S <= 8 else None)
        g = g or pick("shared", _WARP_CAP["shared"])
        g = g or pick("global", _WARP_CAP["global"])
        if g is None:
            raise ValueError(f"no bitset_scan geometry for W={W} S={S}")
        return g
    if placement not in STORES:
        raise ValueError(f"unknown placement {placement!r}")
    g = pick(placement, _WARP_CAP[placement])
    if g is None:
        raise ValueError(
            f"a frontier of W={W} S={S} does not fit the {placement} store"
        )
    return g


#: most warps geometry() gives each store (a cross-warp slot's barrier
#: waits for every warp)
_WARP_CAP = {"registers": 16, "shared": 16, "global": 32}

#: the register store is the default only up to this many warps of one
#: column each
_REG_AUTO_WARPS = 4


def bitset_scan(win, meta, fr_in, model: str, S: int, W: int,
                exact: bool = False, placement: Optional[str] = None):
    """Batched scan: win int8 [keys, n*4*W], meta int32 [keys, n*4],
    fr_in int32 [keys, S, M] -> (out int32 [keys, 1, 8], fr_out int32
    [keys, S, M]). CUDA tensors launch csrc/bitset_scan.cu on the
    current stream (no sync); CPU tensors run bitset_scan_plain.

    placement: where the kernel keeps the working frontier —
    "registers", "shared" (dynamic shared memory) or "global" (in place
    in fr_out); None picks the first that fits (geometry())."""
    if win.device.type == "cpu":
        return bitset_scan_plain(win, meta, fr_in, model, S, W, exact)
    return _launch(win, meta, fr_in, model, S, W, exact,
                   geometry(W, S, placement))


def _launch(win, meta, fr_in, model: str, S: int, W: int, exact: bool,
            geo: Geometry):
    """Check the CUDA inputs and launch the kernel in geometry geo."""
    n_keys = win.shape[0]
    M = bitset_words(W)
    n = win.shape[1] // (4 * W)
    if win.dtype != torch.int8 or meta.dtype != torch.int32 or (
        fr_in.dtype != torch.int32
    ):
        raise TypeError("bitset_scan takes int8 win, int32 meta and fr_in")
    if (
        win.shape != (n_keys, n * 4 * W)
        or meta.shape != (n_keys, n * META_COLS)
        or fr_in.shape != (n_keys, S, M)
    ):
        raise ValueError(
            f"bitset_scan shapes {tuple(win.shape)} {tuple(meta.shape)} "
            f"{tuple(fr_in.shape)} do not match W={W} S={S}"
        )
    if not (win.is_contiguous() and meta.is_contiguous()
            and fr_in.is_contiguous()):
        raise ValueError("bitset_scan takes contiguous tensors")
    if not (win.device == meta.device == fr_in.device):
        raise ValueError("bitset_scan inputs lie on different devices")
    if win.data_ptr() % 4 or meta.data_ptr() % 4:
        raise ValueError("bitset_scan stages win and meta in 4-byte words")
    if not 1 <= W <= 32 or S > MAX_ROWS:
        raise ValueError(f"bitset_scan supports W <= 32, S <= {MAX_ROWS}")
    if (geo.W, geo.S) != (W, S) or not _instantiated(geo.store, S, geo.cols):
        raise ValueError(f"geometry {geo} is not built for W={W} S={S}")
    kid = get_model(model).kernel_id
    if kid < 0 or get_model(model).bitset_slot is None:
        raise ValueError(f"model {model} has no bitset kernel transition")
    out = torch.empty((n_keys, 1, OUT_COLS), dtype=torch.int32,
                      device=win.device)
    fr_out = torch.empty_like(fr_in)
    stream = torch.cuda.current_stream(win.device).cuda_stream
    # the launch runs under the inputs' card (a mesh slot on another
    # card than the current one)
    with torch.cuda.device(win.device):
        err = _build.load("bitset_scan")(
            win.data_ptr(), meta.data_ptr(), fr_in.data_ptr(),
            out.data_ptr(), fr_out.data_ptr(), n_keys, n, W, S, M, kid,
            int(bool(exact)), STORES.index(geo.store), geo.warps,
            geo.cols, stream,
        )
    _build.check(err, "bitset_scan")
    bitset_scan.launches += 1
    return out, fr_out


#: kernel launches (CUDA only; the plain version is not counted)
bitset_scan.launches = 0


def _add_bit(src, w: int):
    """Relabel masks m -> m | bit(w) of one [M] row: sources are masks
    WITHOUT the bit; everything else contributes zero."""
    if w < 5:
        return (src & ~_C1[w]) << (1 << w)
    s = 1 << (w - 5)
    v = src.view(-1, 2, s)
    out = torch.zeros_like(v)
    out[:, 1] = v[:, 0]
    return out.view(-1)


def _remove_bit(fr, r: int):
    """Relabel masks m -> m & ~bit(r) keeping only masks WITH bit r
    (the RETURN filter) over an [S, M] frontier."""
    S, M = fr.shape
    if r < 5:
        # logical, not arithmetic: word bit 31 is a real mask bit. The
        # bits an arithmetic >> smears in all carry bit r of their
        # position, so masking with ~_C1[r] removes exactly them.
        return ((fr & _C1[r]) >> (1 << r)) & ~_C1[r]
    s = 1 << (r - 5)
    if s >= M:
        return torch.zeros_like(fr)
    v = fr.view(S, -1, 2, s)
    out = torch.zeros_like(v)
    out[:, :, 0] = v[:, :, 1]
    return out.view(S, M)


def bitset_scan_plain(win, meta, fr_in, model: str, S: int, W: int,
                      exact: bool = False):
    """The kernel's function in plain PyTorch, on the inputs' device.
    The per-step control values (slot, live, fresh, window) are read to
    the host once; frontier work stays on the device."""
    m = get_model(model)
    n_keys = win.shape[0]
    n = win.shape[1] // (4 * W)
    M = fr_in.shape[-1]
    win_h = host_value(win).reshape(n_keys, n, 4, W).astype(np.int64)
    meta_h = host_value(meta).reshape(n_keys, n, META_COLS)
    outs = torch.zeros((n_keys, 1, OUT_COLS), dtype=torch.int32)
    fr_out = torch.empty_like(fr_in)
    for k in range(n_keys):
        wt = torch.from_numpy(win_h[k])
        isu, src, dst, valid = (
            t.tolist() if isinstance(t, torch.Tensor) else t
            for t in m.bitset_slot(wt[:, 1], wt[:, 2], wt[:, 3])
        )
        occ = win_h[k, :, 0].tolist()
        f = fr_in[k].clone()  # working frontier, updated in place
        alive, taint, died, rtot, rmax = 1, 0, -1, 0, 0
        final = None
        for i in range(n):
            slot, live, opidx, fresh = (int(x) for x in meta_h[k, i])
            if live != 1:
                continue
            slots = (isu[i], src[i], dst[i], valid[i], occ[i], fresh)
            if fresh != 0:
                if not exact:
                    for r in range(FAST_ROUNDS):
                        _round_plain(f, slots, r, W, S)
                else:
                    changed, nr = True, 0
                    while changed and nr <= W + 2:
                        snap = f.clone()
                        _round_plain(f, slots, nr, W, S)
                        changed = bool(host_value((f != snap).any()))
                        nr += 1
                    rtot += nr
                    rmax = max(rmax, nr)
                    if changed:
                        taint = 1
            fr = _remove_bit(f, slot)
            if not bool(host_value((fr != 0).any())):
                alive, died, final = 0, opidx, f
                break
            f = fr
        outs[k, 0, :5] = torch.tensor([alive, taint, died, rtot, rmax])
        fr_out[k] = f if final is None else final
    return outs.to(fr_in.device), fr_out


def _round_plain(f, slots, r: int, W: int, S: int) -> None:
    """One closure round over all W slots, chained in slot order;
    updates the [S, M] frontier f in place."""
    isu, src, dst, valid, occ, fresh = slots
    for w in range(W):
        gate = (fresh >> w) & 1 if r == 0 else occ[w]
        if gate != 1 or not valid[w] or not 0 <= dst[w] < S:
            continue
        if isu[w]:
            row = f[0].clone()
            for s in range(1, S):
                row |= f[s]
        elif 0 <= src[w] < S:
            row = f[src[w]]
        else:
            continue
        f[dst[w]] |= _add_bit(row, w)


# -- single-key and segmented checks ------------------------------------------


def _dev_args(steps: ReturnSteps, dev: torch.device):
    """Packed (win, meta) tensors of a steps object on dev, memoized on
    the steps object (ReturnSteps are immutable once checked)."""
    def pack():
        win, meta = pack_steps(steps)
        return upload(win[None], dev), upload(meta[None], dev)

    args = memo_on(steps, "_bitset_args", str(dev), pack)
    record_use(args)
    return args


def _fr0(init_state, S: int, W: int, dev: torch.device):
    return upload(init_frontier(init_state, S, W)[None], dev)


def check_steps_bitset(
    steps: ReturnSteps,
    model: str = "cas-register",
    S: int = 8,
    exact: bool = False,
    device=None,
) -> Tuple[bool, bool, int]:
    """Single-key check: (alive, taint, died_op_index). The fast tier
    decides alive verdicts; a fast-tier death re-runs on the exact
    tier, whose verdicts are definite both ways. exact=True skips the
    fast tier. On a death, steps._death_frontier holds the pre-filter
    frontier (decode_frontier)."""
    dev = resolve_device(device)
    name = model if isinstance(model, str) else model.name
    win, meta = _dev_args(steps, dev)
    fr0 = _fr0(steps.init_state, S, steps.W, dev)

    def scan(exact_flag):
        _bump_launch("launches")
        return bitset_scan(win, meta, fr0, name, S, steps.W,
                           exact=exact_flag)

    out, fr = scan(exact)
    verdict = _out_to_verdicts(_host_get(out))[0]
    if not verdict[0] and not exact:
        # fast-tier death is provisional (under-closure): exact decides
        _bump_launch("escalations")
        out, fr = scan(True)
        verdict = _out_to_verdicts(_host_get(out))[0]
    if not verdict[0]:
        steps._death_frontier = _host_get(fr, follow_up=True)[0]
    return verdict


def _slice_steps(
    steps: ReturnSteps, start: int, end: int, W: int
) -> ReturnSteps:
    """Steps [start, end) with the window narrowed to W slots — valid
    only when none of them touches a slot >= W (split_point
    guarantees)."""
    return ReturnSteps(
        occ=steps.occ[start:end, :W],
        f=steps.f[start:end, :W],
        a=steps.a[start:end, :W],
        b=steps.b[start:end, :W],
        slot=steps.slot[start:end],
        live=steps.live[start:end],
        crashed=steps.crashed[start:end],
        op_index=steps.op_index[start:end],
        init_state=steps.init_state,
        W=W,
        fresh=(
            steps.fresh[start:end]
            if steps.fresh is not None
            else None
        ),
    )


def split_point(steps: ReturnSteps, W_low: int) -> int:
    """Number of leading steps whose windows fit W_low slots (the
    first step occupying or returning a slot >= W_low ends the run)."""
    if not len(steps):
        return 0
    touches = (
        np.any(steps.occ[:, W_low:], axis=1) | (steps.slot >= W_low)
    )
    hi = np.nonzero(touches)[0]
    return int(hi[0]) if len(hi) else len(steps)


def _reshape_frontier(fr, M_to: int):
    """Move a [1, S, M] device frontier between mask spaces. Widening
    is a lane pad (the low mask space IS the first M words of the high
    one); NARROWING is a lane slice, legal exactly when every mask bit
    >= W_to is zero — guaranteed by the planner: a segment runs at W_to
    only when no slot >= W_to is occupied anywhere in it, and an
    unoccupied slot's mask bit is provably zero."""
    M_from = fr.shape[-1]
    if M_to > M_from:
        return F.pad(fr, (0, M_to - M_from))
    if M_to < M_from:
        return fr[:, :, :M_to].contiguous()
    return fr


def required_buckets(steps: ReturnSteps) -> np.ndarray:
    """Per-step minimum W bucket: the smallest W_BUCKETS entry
    covering every occupied slot and the returning slot at that step
    (slots are 0-based, so slot k needs W >= k+1)."""
    n = len(steps)
    Wf = steps.occ.shape[1]
    occ = steps.occ.astype(bool)
    maxslot = np.where(
        occ.any(axis=1), Wf - 1 - np.argmax(occ[:, ::-1], axis=1), -1
    )
    need = np.maximum(maxslot, steps.slot) + 1
    wb = _w_buckets()
    wreq = np.full(n, wb[-1], np.int64)
    for b in reversed(wb):
        wreq[need <= b] = b
    return wreq


def _seg_cost(w: int) -> float:
    """Relative per-step cost of a segment at bucket W (the reference's
    planner model: fixed machinery plus work in the mask words)."""
    return 2.0 + 0.2 * (bitset_words(w) / MIN_WORDS)


def plan_segments(
    steps: ReturnSteps, min_len: Optional[int] = None
) -> List[Tuple[int, int, int]]:
    """[(start, end, W)] segments over the WHOLE stream: each step
    runs at the narrowest bucket its window fits, with short runs
    absorbed into a neighbor so every segment is worth its launch.
    Byte-identical to the reference's planner."""
    n = len(steps)
    wb = _w_buckets()
    if n == 0 or steps.W <= wb[0]:
        return [(0, n, steps.W)]
    if min_len is None:
        min_len = max(512, n // 48)
    wreq = np.minimum(required_buckets(steps), steps.W)
    # Chunk-max planning: fixed chunks take the max requirement inside
    # them, then equal neighbors coalesce.
    chunk = max(min_len // 2, STEP_BLOCK)
    n_chunks = (n + chunk - 1) // chunk
    padded = np.full(n_chunks * chunk, wb[0], wreq.dtype)
    padded[:n] = wreq
    cmax = padded.reshape(n_chunks, chunk).max(axis=1)
    runs: List[List[int]] = []
    for ci, v in enumerate(cmax):
        ln = min(chunk, n - ci * chunk)
        if runs and runs[-1][0] == int(v):
            runs[-1][1] += ln
        else:
            runs.append([int(v), ln])
    # absorb any still-short runs into their cheaper neighbor
    i = 0
    while len(runs) > 1 and i < len(runs):
        if runs[i][1] >= min_len:
            i += 1
            continue
        cands = []
        for j in (i - 1, i + 1):
            if 0 <= j < len(runs):
                vi, li = runs[i]
                vj, lj = runs[j]
                vm = max(vi, vj)
                added = li * (_seg_cost(vm) - _seg_cost(vi)) + lj * (
                    _seg_cost(vm) - _seg_cost(vj)
                )
                cands.append((added, j))
        _, j = min(cands)
        lo, hi = min(i, j), max(i, j)
        runs[lo] = [
            max(runs[lo][0], runs[hi][0]), runs[lo][1] + runs[hi][1]
        ]
        del runs[hi]
        i = max(lo - 1, 0)
    segs: List[Tuple[int, int, int]] = []
    start = 0
    for v, ln in runs:
        segs.append((start, start + ln, v))
        start += ln
    return segs


def _segment_args(steps: ReturnSteps, segs, dev: torch.device) -> list:
    """Per-segment packed (win, meta) device tensors for a plan, each
    memoized on the steps object."""

    def packed(start, end, W):
        sub = _slice_steps(steps, start, end, W)
        sub = sub.padded(bucket(max(len(sub), 1), 64))
        win, meta = pack_steps(sub)
        return upload(win[None], dev), upload(meta[None], dev)

    args = [
        memo_on(
            steps, "_seg_args", (start, end, W, str(dev)),
            lambda s=start, e=end, w=W: packed(s, e, w),
        )
        for start, end, W in segs
    ]
    record_use([t for pair in args for t in pair])
    return args


def _plan_for(steps: ReturnSteps, min_len: Optional[int]):
    return memo_on(
        steps, "_seg_plan", min_len, lambda: plan_segments(steps, min_len)
    )


def _run_chain(args, steps, segs, name: str, S: int, exact: bool, dev,
               fr0=None):
    """Enqueue the whole plan back to back on the current stream: each
    segment's scan starts from the previous one's frontier, moved
    between mask spaces on the device. fr0: the first segment's input
    frontier, a [1, S, M] tensor on dev in any segment's mask space (a
    checkpoint's or a stream's boundary frontier); None starts from the
    init frontier. Returns every segment's verdict row and final (or
    death) frontier; nothing waits on the device."""
    if fr0 is None:
        fr = _fr0(steps.init_state, S, segs[0][2], dev)
    else:
        record_use([fr0])
        fr = fr0
    outs, frs = [], []
    for (win, meta), (_, _, W) in zip(args, segs):
        fr = _reshape_frontier(fr, bitset_words(W))
        # planelint: disable=JT103 reason=the chain is ONE dispatch, counted by every caller before it calls _run_chain (outside the chaos guard that may retry it); counting here would count retries and segments
        out, fr = bitset_scan(win, meta, fr, name, S, W, exact=exact)
        outs.append(out)
        frs.append(fr)
    return outs, frs


def launch_steps_bitset_segmented(
    steps: ReturnSteps,
    model: str = "cas-register",
    S: int = 8,
    min_len: Optional[int] = None,
    device=None,
):
    """Dispatch the multi-segment scan on the fast tier WITHOUT the host
    fetch: one dispatch per plan (counted once in
    LAUNCH_STATS["launches"]), every segment chained through the
    frontier on the device. The collect escalates a death. On the card
    the handle carries an event recorded after the chain, so a racer
    can ask whether the scan is done without waiting (handle_ready)."""
    with obs_trace.span("launch_prep", kind="host") as sp:
        dev = resolve_device(device)
        segs = _plan_for(steps, min_len)
        name = model if isinstance(model, str) else model.name
        args = _segment_args(steps, segs, dev)
        _bump_launch("launches")
        outs, _ = _run_chain(args, steps, segs, name, S, False, dev)
        ready = None
        if dev.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        if obs_trace.TRACER.enabled:
            sp.set(segments=len(segs), padded_steps=sum(
                bucket(max(b - a, 1), 64) for a, b, _ in segs))
    return outs, (segs, name, S, dev, ready)


def handle_ready(handle) -> bool:
    """Non-blocking: has a launch_steps_bitset_segmented dispatch
    finished on the device? (Always True on the CPU, where the plain
    versions ran synchronously.)"""
    ready = handle[1][-1]
    return ready is None or bool(ready.query())


def collect_steps_bitset_segmented(
    steps: ReturnSteps, handle, outs_host=None
) -> Tuple[bool, bool, int]:
    """Block on a launch_steps_bitset_segmented handle: ONE host fetch
    for every segment's verdict; the first death wins. A fast-tier
    death is provisional, so the plan re-runs on the exact tier from
    SEGMENT 0 with a fresh init frontier (not from the dying segment's
    input frontier: closure is skipped at steps with no fresh invokes,
    so under-closure before a boundary is never repaired downstream).

    outs_host: the already-fetched host copies of the handle's out
    tensors — the dispatch plane waits once for a whole launch train
    and hands each launch its arrays, skipping the fetch here. The
    exact re-run runs through its own chaos seam (transient faults
    retry; an exhausted budget raises chaos.PlaneFault)."""
    from jepsen_tpu_torch.checker import chaos

    outs, (segs, name, S, dev, _) = handle
    fetched = _host_get(tuple(outs)) if outs_host is None else outs_host
    taint = False
    for o in fetched:
        alive, t, _ = _out_to_verdicts(np.asarray(o))[0]
        taint = taint or t
        if alive:
            continue
        _bump_launch("launches")
        _bump_launch("escalations")
        args = _segment_args(steps, segs, dev)  # memo hit
        outs2, frs2 = chaos.resilient_call(
            lambda: _run_chain(args, steps, segs, name, S, True, dev),
            site="launch",
        )
        # planelint: disable=JT101 reason=the exact escalation re-run syncs ONCE (batched tuple fetch); the enclosing loop always exits via return after it
        for o2, f2 in zip(_host_get(tuple(outs2)), frs2):
            alive2, t2, died2 = _out_to_verdicts(o2)[0]
            taint = taint or t2
            if not alive2:
                steps._death_frontier = _host_get(f2, follow_up=True)[0]
                return False, taint, died2
        return True, taint, -1
    return True, taint, -1


def check_steps_bitset_segmented_checkpointed(
    steps: ReturnSteps,
    sink,
    model: str = "cas-register",
    S: int = 8,
    min_len: Optional[int] = None,
    device=None,
) -> Tuple[bool, bool, int]:
    """Durable segmented scan: every `sink.every` segments form ONE
    group, one _run_chain from the group's boundary frontier, and the
    frontier visits the host only at the persistence boundary that ends
    the group, where it checkpoints atomically before the next group
    starts. Each group pays one launch (LAUNCH_STATS) and ONE host sync
    for its verdict rows and its last frontier together; with every >=
    len(plan) the whole check pays one, as the plain segmented path
    does. A killed process re-enters at the last durable frontier and
    re-runs only unverified groups; a finished checkpoint replays its
    verdict with ZERO launches.

    Soundness (checkpoint.py): a fast-tier boundary frontier equals the
    uninterrupted chain's, so fast boundaries are safe resume points. A
    fast-tier DEATH is provisional: the sink invalidates back to segment
    0 and the exact pass checkpoints its own, fully closed frontiers.
    Stale or tampered checkpoints are rejected in sink.begin() and the
    check runs cold. Each group runs through the chaos seam (transient
    faults retry; an exhausted budget raises chaos.PlaneFault)."""
    from jepsen_tpu_torch.checker import chaos
    from jepsen_tpu_torch.checker import checkpoint as _cp

    dev = resolve_device(device)
    min_len = min_len if min_len is not None else sink.seg_min_len
    segs = _plan_for(steps, min_len)
    name = model if isinstance(model, str) else model.name
    chash = _cp.steps_content_hash(steps, name, S, segs)
    state = sink.begin(chash, segs, name, S)
    v = state.get("verdict")
    if v is not None:
        # finished checkpoint: replay, zero launches
        fr = sink.death_frontier_array()
        if fr is not None:
            steps._death_frontier = fr
        return bool(v["alive"]), bool(v["taint"]), int(v["died"])
    exact = bool(state.get("exact", False))
    start = int(state.get("segments_done", 0))
    fr_host = sink.frontier_array()
    taint = False
    group_n = max(int(getattr(sink, "every", 1)), 1)
    while True:  # one iteration per tier; escalation restarts the loop
        if start == 0 or fr_host is None:
            start, fr_host = 0, None  # None: _run_chain's init frontier
        k = start
        escalated = False
        while k < len(segs):
            g = min(k + group_n, len(segs))
            group = segs[k:g]
            args = _segment_args(steps, group, dev)
            _bump_launch("launches")

            def one_group(a=args, grp=group, f=fr_host, ex=exact):
                fr0 = None if f is None else upload(f, dev)
                outs, frs = _run_chain(a, steps, grp, name, S, ex, dev,
                                       fr0=fr0)
                # ONE host sync per durable boundary: every verdict row
                # of the group and its last frontier in one fetch
                got = _host_get(tuple(outs) + (frs[-1],))
                return got[:-1], got[-1], frs

            o_host, fr_last, frs = chaos.resilient_call(one_group,
                                                        site="launch")
            died_seg, died = -1, -1
            for gi, o in enumerate(o_host):
                alive, t, d = _out_to_verdicts(o)[0]
                taint = taint or t
                if not alive:
                    died_seg, died = gi, d
                    break  # first death wins; downstream is garbage
            if died_seg >= 0:
                if not exact:
                    # provisional fast death: every fast checkpoint is
                    # void; durably escalate, restart from segment 0
                    _bump_launch("escalations")
                    exact = True
                    sink.invalidate(reason="exact-escalation")
                    fr_host = None
                    escalated = True
                    break
                death_fr = _host_get(frs[died_seg], follow_up=True)[0]
                steps._death_frontier = death_fr
                sink.finish(alive=False, taint=taint, died=died,
                            death_frontier=death_fr)
                return False, taint, died
            fr_host = fr_last
            k = g
            sink.record(segments_done=k, frontier=fr_host, exact=exact)
        if escalated:
            start = 0
            continue
        sink.finish(alive=True, taint=taint, died=-1)
        return True, taint, -1


def check_steps_bitset_segmented(
    steps: ReturnSteps,
    model: str = "cas-register",
    S: int = 8,
    min_len: Optional[int] = None,
    device=None,
    checkpoint=None,
) -> Tuple[bool, bool, int]:
    """Segmented scan: the stream runs on the narrowest bucket each
    stretch fits, all segments chained on the device with no host sync
    in between; one host fetch for every segment's verdict. A
    one-segment plan pads to bucket(n, 64) and runs check_steps_bitset,
    as the reference does.

    checkpoint: a checkpoint.CheckpointSink switches to the durable
    group scan (check_steps_bitset_segmented_checkpointed)."""
    if checkpoint is not None:
        return check_steps_bitset_segmented_checkpointed(
            steps, checkpoint, model=model, S=S, min_len=min_len,
            device=device,
        )
    segs = _plan_for(steps, min_len)
    if len(segs) == 1:
        padded = memo_on(
            steps, "_padded_single", None,
            lambda: steps.padded(bucket(max(len(steps), 1), 64)),
        )
        verdict = check_steps_bitset(padded, model=model, S=S, device=device)
        fr = getattr(padded, "_death_frontier", None)
        if fr is not None:
            steps._death_frontier = fr
        return verdict
    return collect_steps_bitset_segmented(
        steps,
        launch_steps_bitset_segmented(
            steps, model=model, S=S, min_len=min_len, device=device,
        ),
    )


# -- multi-key batch -----------------------------------------------------------


def _pad_rows(a: np.ndarray, pad: int, fill=None) -> np.ndarray:
    """a with ``pad`` blank rows appended (zeros, or copies of fill)."""
    if not pad:
        return a
    blank = (np.zeros((pad,) + a.shape[1:], a.dtype) if fill is None
             else np.repeat(fill[None], pad, axis=0))
    return np.concatenate([a, blank])


def launch_keys_bitset(
    steps_list,
    model: str = "cas-register",
    S: int = 8,
    exact: bool = False,
    device=None,
    mesh=None,
):
    """Dispatch the batched per-key scan WITHOUT a host fetch, on the
    fast tier (exact=True: the exact tier, whose deaths are definite):
    every key is one block of ONE bitset_scan launch (counted
    once in LAUNCH_STATS["launches"]), each from its own init frontier. All
    steps share W (the caller packs every key at the batch's largest
    window bucket, with S the batch's largest row bucket); lengths pad
    with non-live steps to bucket(longest, 64). Per-key packing is
    memoized on the steps, keyed by that pad length. Returns (out,
    handle) for collect_keys_bitset.

    mesh (a sharded.Mesh of more than one slot): the key axis pads to a
    multiple of the mesh size with blank rows (zero win and meta, the
    init frontier of state 0: trivially alive, sliced off at collect)
    and kernel A runs once per slot on its block, on the slot's stream
    (sharded.make_sharded_bitset), still counted as ONE launch and one
    sharded launch; ``out`` is every slot's verdict rows gathered
    (slicing.global_view). None, or a one-slot mesh, is the
    single-device launch, unchanged. One departure from "without a host
    fetch": in a pod whose mesh gathers on gloo, global_view stages this
    process's rows through the host for the all_gather, so the launch
    itself waits for the kernel (an uncounted wait; the counted sync
    stays the collect's one _host_get, ROADMAP queue 3)."""
    dev = resolve_device(device)
    n = bucket(max(max(len(st) for st in steps_list), 1), 64)
    name = model if isinstance(model, str) else model.name
    W = steps_list[0].W
    n_real = len(steps_list)
    packed = [
        memo_on(st, "_batch_args", n, lambda s=st: pack_steps(s.padded(n)))
        for st in steps_list
    ]
    win_h = np.stack([w for w, _ in packed])
    meta_h = np.stack([m for _, m in packed])
    fr0_h = np.stack([
        init_frontier(st.init_state, S, W) for st in steps_list
    ])
    n_dev = mesh.size if mesh is not None else 0
    if n_dev > 1:
        from jepsen_tpu_torch.checker.sharded import (
            make_sharded_bitset,
            note_sharded_launch,
        )
        from jepsen_tpu_torch.pod.slicing import global_view, host_shard_put

        pad = -n_real % n_dev
        blocks = host_shard_put((
            _pad_rows(win_h, pad), _pad_rows(meta_h, pad),
            _pad_rows(fr0_h, pad, init_frontier(0, S, W)),
        ), mesh)
        fn = make_sharded_bitset(mesh, name, S, W, exact)
        _bump_launch("launches")
        note_sharded_launch(n_dev)
        out = global_view([(o,) for o, _ in fn(blocks)], mesh)[0]
        return out, (blocks, name, S, W, exact, mesh, n_real)
    args = (upload(win_h, dev), upload(meta_h, dev), upload(fr0_h, dev))
    _bump_launch("launches")
    out, _ = bitset_scan(*args, name, S, W, exact=exact)
    return out, (args, name, S, W, exact, None, n_real)


def collect_keys_bitset(handle, out_host=None) -> List[Tuple[bool, bool, int]]:
    """Block on a launch_keys_bitset handle: ONE host fetch for every
    key's verdict. A fast-tier death is provisional, so if any key died
    the whole batch re-runs on the exact tier in one more launch (its
    inputs are already on the device, or on the slots: a sharded launch
    escalates sharded; deaths are the rare path), counted in
    LAUNCH_STATS["launches"] and ["escalations"]. Pad rows are sliced
    off before the verdicts return.

    out_host: the already-fetched host copy of the handle's out (the
    dispatch plane's one wait per train); the exact re-run, when
    needed, still fetches on its own, through its own chaos seam."""
    from jepsen_tpu_torch.checker import chaos

    out, (args, name, S, W, exact, mesh, n_real) = handle
    verdicts = _out_to_verdicts(
        np.asarray(_host_get(out) if out_host is None else out_host)
    )[:n_real]
    if exact or all(v[0] for v in verdicts):
        return verdicts
    _bump_launch("launches")
    _bump_launch("escalations")
    if mesh is not None:
        from jepsen_tpu_torch.checker.sharded import (
            make_sharded_bitset,
            mesh_size,
            note_sharded_launch,
        )
        from jepsen_tpu_torch.pod.slicing import global_view

        fn = make_sharded_bitset(mesh, name, S, W, True)
        note_sharded_launch(mesh_size(mesh))
        out2 = chaos.resilient_call(
            lambda: global_view([(o,) for o, _ in fn(args)], mesh)[0],
            site="launch", devices=[str(d) for d in mesh.devices.flat],
        )
    else:
        out2, _ = chaos.resilient_call(
            lambda: bitset_scan(*args, name, S, W, exact=True),
            site="launch",
        )
    return _out_to_verdicts(_host_get(out2))[:n_real]


def launch_tails_bitset(
    steps_list,
    frontiers,
    model: str = "cas-register",
    S: int = 8,
    exact: bool = False,
    device=None,
    mesh=None,
):
    """Dispatch a stack of stream TAILS in ONE bitset_scan launch: like
    launch_keys_bitset, but row i starts from stream i's own boundary
    frontier, frontiers[i]: None (a fresh stream: the init frontier), a
    host [S, M] or [1, S, M] array, or a device row an earlier stacked
    launch left. Every row is moved into this launch's mask space
    (_reshape_frontier). The handle KEEPS the stacked fr_out, so each
    stream's next frontier is the device row fr_out[i], never a host
    copy. All tails share (model, S, W); lengths pad to one bucket.
    Returns (out, (fr_out, name, S, W, exact, n_real)).

    mesh (more than one slot): rows pad to a mesh multiple with blank
    init rows and kernel A runs once per slot on its block of rows, as
    in launch_keys_bitset; out and fr_out are the slots' rows gathered,
    so fr_out[i] is again one device row. In a pod whose mesh gathers on
    gloo the launch waits for the kernel, as launch_keys_bitset's
    does."""
    dev = resolve_device(device)
    n = bucket(max(max(len(st) for st in steps_list), 1), 64)
    name = model if isinstance(model, str) else model.name
    W = steps_list[0].W
    M = bitset_words(W)
    n_real = len(steps_list)
    n_dev = mesh.size if mesh is not None else 0
    pad = -n_real % n_dev if n_dev > 1 else 0
    packed = [
        memo_on(st, "_batch_args", n, lambda s=st: pack_steps(s.padded(n)))
        for st in steps_list
    ]
    win_h = _pad_rows(np.stack([w for w, _ in packed]), pad)
    meta_h = _pad_rows(np.stack([m for _, m in packed]), pad)
    # host rows (and fresh streams) upload together; device rows are
    # gathered into the stack on the device
    host = np.zeros((n_real + pad, S, M), np.int32)
    host[n_real:] = init_frontier(0, S, W)
    on_dev = []
    for i, (st, fr) in enumerate(zip(steps_list, frontiers)):
        if fr is None:
            host[i] = init_frontier(st.init_state, S, W)
        elif isinstance(fr, torch.Tensor) and fr.device.type != "cpu":
            on_dev.append((i, fr))
        else:
            t = torch.as_tensor(np.asarray(fr, np.int32)).reshape(1, S, -1)
            host[i] = _reshape_frontier(t, M)[0].numpy()
    fr0 = upload(host, dev)
    if on_dev:
        rows = [fr.reshape(1, S, -1) for _, fr in on_dev]
        record_use(rows)
        fr0[[i for i, _ in on_dev]] = torch.cat(
            [_reshape_frontier(r.to(dev), M) for r in rows])
    if n_dev > 1:
        from jepsen_tpu_torch.checker.sharded import (
            key_block,
            local_positions,
            make_sharded_bitset,
            mesh_local_slots,
            note_sharded_launch,
        )
        from jepsen_tpu_torch.pod.slicing import global_view, host_shard_put

        rows = n_real + pad
        blocks = [
            (w, m, fr0[key_block(mesh, rows, p)].to(slot.device))
            for (w, m), slot, p in zip(
                host_shard_put((win_h, meta_h), mesh),
                mesh_local_slots(mesh), local_positions(mesh))
        ]
        fn = make_sharded_bitset(mesh, name, S, W, exact)
        _bump_launch("launches")
        note_sharded_launch(n_dev)
        out, fr_out = global_view(fn(blocks), mesh)
        return out, (fr_out, name, S, W, exact, n_real)
    win, meta = upload(win_h, dev), upload(meta_h, dev)
    _bump_launch("launches")
    out, fr_out = bitset_scan(win, meta, fr0, name, S, W, exact=exact)
    return out, (fr_out, name, S, W, exact, n_real)


def check_keys_bitset(
    steps_list,
    model: str = "cas-register",
    S: int = 8,
    exact: bool = False,
    device=None,
    mesh=None,
) -> List[Tuple[bool, bool, int]]:
    """A batch of per-key checks in ONE kernel launch and one host sync
    (two of each when a fast-tier death re-runs the batch exactly):
    [(alive, taint, died_op_index)] in key order. Routed through the
    process-wide dispatch plane of the device (dispatch.default_plane),
    as the reference routes it: still one launch, but it joins the
    plane's launch train and stats.

    mesh: None lets the plane decide (its own mesh), False forces the
    single-device dispatch, a Mesh shards the batch explicitly."""
    from jepsen_tpu_torch.checker.dispatch import default_plane

    return default_plane(device=device).run_keys(
        steps_list, model=model, S=S, exact=exact, mesh=mesh,
    )


def decode_frontier(
    fr: np.ndarray,
    steps: ReturnSteps,
    died_op_index: int,
    model,
    decode_value=None,
    max_configs: int = 10,
) -> dict:
    """Decode a death's pre-filter frontier into the reference-style
    failure report (checker.clj:146-158, truncated to 10 configs):
    the returning op that could not linearize, and each surviving
    config's state + which open ops it had/hadn't linearized."""
    m = get_model(model)
    f_names: dict = {}
    for name, code in m.f_names.items():
        f_names.setdefault(code, str(name))
    dec = decode_value or (lambda c: c)

    rows = np.nonzero(steps.op_index == died_op_index)[0]
    if not len(rows):
        return {"configs": [], "note": "death step not found"}
    i = int(rows[0])
    W = steps.W

    def op_desc(slot: int) -> dict:
        d = {
            "slot": slot,
            "f": f_names.get(int(steps.f[i, slot]), "?"),
            "value": dec(int(steps.a[i, slot])),
        }
        if d["f"] in ("cas", "compare-and-set"):
            d["value"] = [
                dec(int(steps.a[i, slot])), dec(int(steps.b[i, slot]))
            ]
        return d

    configs = []
    S, M = fr.shape
    for s in range(S):
        if len(configs) >= max_configs:
            break
        words = np.nonzero(fr[s])[0]
        for w in words:
            word = int(fr[s, w])
            for b in range(32):
                if not (word >> b) & 1:
                    continue
                mask = int(w) * 32 + b
                linearized = [
                    op_desc(j) for j in range(W)
                    if (mask >> j) & 1 and steps.occ[i, j]
                ]
                pending = [
                    op_desc(j) for j in range(W)
                    if not (mask >> j) & 1 and steps.occ[i, j]
                ]
                configs.append({
                    "state": dec(s - 1) if s > 0 else None,
                    "linearized": linearized,
                    "pending": pending,
                })
                if len(configs) >= max_configs:
                    break
            if len(configs) >= max_configs:
                break
    return {
        "failed_op": op_desc(int(steps.slot[i])),
        "configs": configs,
    }
