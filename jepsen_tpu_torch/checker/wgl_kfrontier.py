"""K-frontier WGL scan (single mask word): the check, the CUDA kernel's
wrapper and its plain PyTorch version.

The counterpart of jepsen_tpu.checker.wgl_pallas (its
check_steps_pallas and check_keys_pallas are check_steps_kfrontier and
check_keys_kfrontier here). Same algorithm and
semantics as the multi-word scan in wgl_torch.py, restricted to one
mask word (W <= 32) and a table of K configs: per return step, closure
rounds (bounded by 2W+8) expand every open op against every config,
drop candidates the table holds or dominates, insert the rest into free
slots by exclusive rank, and prune duplicates and dominated configs;
a round that drops candidates and changes nothing taints the verdict
(capacity overflow). alive=True is a witness; alive=False is definite
only without overflow, and the ladder in linearizable.py escalates K.

kfrontier_scan() is the kernel: on CUDA tensors it launches
csrc/kfrontier_scan.cu, on CPU tensors it runs kfrontier_scan_plain().
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from jepsen_tpu_torch.checker import _build
from jepsen_tpu_torch.checker.events import (
    ReturnSteps,
    bucket,
    memo_on,
    slot_bit_table,
)
from jepsen_tpu_torch.checker.models import model as get_model
from jepsen_tpu_torch.device import (
    _host_get,
    host_value,
    record_use,
    resolve_device,
)

#: meta columns: slotbit, live, crashed, op_index, init_state
META_COLS = 8

#: step padding quantum of pack_steps (the reference's grid block)
STEP_BLOCK = 8

#: threads per block of the CUDA kernel
THREADS = 256

#: shared memory one block may use on sm_90 (227 KB)
_SMEM_LIMIT = 232_448

#: the kernel's per-warp totals and step buffers (make_layout in the
#: .cu): two [32] ballot-total buffers, two [4, 32] occupied-slot
#: windows, two slot counts and two meta rows
_SMEM_FIXED_WORDS = 2 * 32 + 2 * 4 * 32 + 2 + 2 * META_COLS


def pack_steps(steps: ReturnSteps):
    """Host-side (numpy) packing: one [n, 4, W] window array
    (occ/f/a/b) + [n, 1, META_COLS] scalars, padded up to a multiple of
    STEP_BLOCK. Same layout as the reference's."""
    if steps.NW != 1:
        raise ValueError("the K-frontier kernel supports one mask word (W<=32)")
    B = STEP_BLOCK
    if len(steps) % B:
        steps = steps.padded(((len(steps) + B - 1) // B) * B)
    n = len(steps)
    W = steps.W
    bits = slot_bit_table(W)[:, 0]  # [W] int32
    meta = np.zeros((n, 1, META_COLS), np.int32)
    meta[:, 0, 0] = bits[steps.slot]
    meta[:, 0, 1] = steps.live.astype(np.int32)
    meta[:, 0, 2] = steps.crashed[:, 0]
    meta[:, 0, 3] = steps.op_index
    meta[:, 0, 4] = steps.init_state
    win = np.stack(
        [steps.occ.astype(np.int32), steps.f, steps.a, steps.b], axis=1
    )
    return win, meta


def smem_bytes(W: int, K: int) -> int:
    """Dynamic shared memory of one block (make_layout in the .cu): the
    [K] table, the [K] live and free lists, and the fixed buffers. The
    candidates live in registers, so W does not enter."""
    return (7 * K + _SMEM_FIXED_WORDS) * 4


def live_and_free(fv, threads: int = THREADS):
    """The kernel's compaction of a [K] valid column: (live slots, free
    slots), each in slot order. A tile of `threads` slots ranks its
    valid ones by the warp-ballot scan (ballot_ranks); a free slot t's
    rank is t minus the valid slots before it."""
    fv = [int(v) == 1 for v in fv]
    K = len(fv)
    live, free = [None] * sum(fv), [None] * (K - sum(fv))
    nl = 0
    for base in range(0, K, threads):
        flags = [t < K and fv[t] for t in range(base, base + threads)]
        ranks, total = ballot_ranks(flags)
        for i, t in enumerate(range(base, min(base + threads, K))):
            p = nl + ranks[i]
            if fv[t]:
                live[p] = t
            else:
                free[t - p] = t
        nl += total
    return live, free


def ballot_ranks(flags):
    """Exclusive ranks of the set flags of one pass of a block, as
    pass_rank in the .cu computes them: each warp's __ballot_sync, the
    lane's __popc of the ballot below it, plus the totals of the warps
    before. Returns (ranks, total)."""
    n_warps = (len(flags) + 31) // 32
    ballots = []
    for g in range(n_warps):
        bits = 0
        for lane in range(32):
            t = 32 * g + lane
            if t < len(flags) and flags[t]:
                bits |= 1 << lane
        ballots.append(bits)
    wsum = [bin(b).count("1") for b in ballots]
    ranks = [
        sum(wsum[: t // 32])
        + bin(ballots[t // 32] & ((1 << (t % 32)) - 1)).count("1")
        for t in range(len(flags))
    ]
    return ranks, sum(wsum)


def candidate_ranks(fv, occ, new, threads: int = THREADS):
    """The kernel's enumeration of one round's candidates: (occupied
    slot, live entry) pairs, slot-major, ranked in tiles of `threads`
    by ballot_ranks. new(w, k) says whether candidate (w, k) survives
    the table filter. Returns {(w, k): rank} for the surviving ones;
    the reference ranks them by the exclusive cumsum of the w-major,
    then k, flattening of [W, K] (wgl_pallas.py:192-195)."""
    live, _ = live_and_free(fv, threads)
    slots = [w for w, o in enumerate(occ) if int(o) == 1]
    nl = len(live)
    pairs = [(slots[c // nl], live[c % nl]) for c in range(len(slots) * nl)]
    ranks, done = {}, 0
    for base in range(0, len(pairs), threads):
        tile = pairs[base:base + threads]
        flags = [bool(new(w, k)) for w, k in tile]
        flags += [False] * (threads - len(tile))
        r, total = ballot_ranks(flags)
        for i, (w, k) in enumerate(tile):
            if flags[i]:
                ranks[(w, k)] = done + r[i]
        done += total
    return ranks


def kfrontier_scan(win, meta, model: str, K: int, W: int):
    """Batched scan: win int32 [keys, n, 4, W], meta int32
    [keys, n, 1, 8] -> out int32 [keys, 1, 8]. CUDA tensors launch
    csrc/kfrontier_scan.cu on the current stream (no sync); CPU
    tensors run kfrontier_scan_plain."""
    if win.device.type == "cpu":
        return kfrontier_scan_plain(win, meta, model, K, W)
    return _launch(win, meta, model, K, W)


def _launch(win, meta, model: str, K: int, W: int):
    """Check the CUDA inputs and launch the kernel."""
    n_keys, n = win.shape[0], win.shape[1]
    if win.dtype != torch.int32 or meta.dtype != torch.int32:
        raise TypeError("kfrontier_scan takes int32 win and meta")
    if win.shape != (n_keys, n, 4, W) or meta.shape != (
        n_keys, n, 1, META_COLS
    ):
        raise ValueError(
            f"kfrontier_scan shapes {tuple(win.shape)} {tuple(meta.shape)} "
            f"do not match W={W}"
        )
    if not (win.is_contiguous() and meta.is_contiguous()):
        raise ValueError("kfrontier_scan takes contiguous tensors")
    if win.device != meta.device:
        raise ValueError("kfrontier_scan inputs lie on different devices")
    if not 1 <= W <= 32 or K < 1:
        raise ValueError("kfrontier_scan supports 1 <= W <= 32, K >= 1")
    if smem_bytes(W, K) > _SMEM_LIMIT:
        raise ValueError(f"K={K}, W={W} exceeds one block's shared memory")
    kid = get_model(model).kernel_id
    if kid < 0:
        raise ValueError(f"model {model} has no kernel transition")
    out = torch.empty((n_keys, 1, META_COLS), dtype=torch.int32,
                      device=win.device)
    stream = torch.cuda.current_stream(win.device).cuda_stream
    err = _build.load("kfrontier_scan")(
        win.data_ptr(), meta.data_ptr(), out.data_ptr(), n_keys, n, W, K,
        kid, THREADS, stream,
    )
    _build.check(err, "kfrontier_scan")
    kfrontier_scan.launches += 1
    return out


#: kernel launches (CUDA only; the plain version is not counted)
kfrontier_scan.launches = 0


def _prune(fs, fm, fv, crashed, ii, jj):
    """Frontier self-canonicalize over [K, K]: kill exact duplicates
    (lowest slot wins) and dominated configs."""
    fs_c, fm_c, fv_c = fs[:, None], fm[:, None], fv[:, None]
    eq_s = fs_c == fs[None, :]
    m_eq = fm_c == fm[None, :]
    live_eq = (fm_c & ~crashed) == (fm[None, :] & ~crashed)
    cra_i = fm_c & crashed
    cra_sub = (cra_i & (fm[None, :] & crashed)) == cra_i
    dup = eq_s & m_eq & (ii < jj)
    dom = eq_s & live_eq & cra_sub & ~m_eq
    both = (fv_c == 1) & (fv[None, :] == 1)
    kill = (both & (dup | dom)).any(dim=0)
    return fv * (~kill).to(fv.dtype)


def kfrontier_scan_plain(win, meta, model: str, K: int, W: int):
    """The kernel's function in plain PyTorch, on the inputs' device:
    the table as [K] tensors, candidates as [W, K], the table filter as
    [K, W, K] and the assignment as a [W*K, K] one-hot match."""
    step = get_model(model).step_torch
    dev = win.device
    n_keys, n = win.shape[0], win.shape[1]
    meta_h = host_value(meta)
    out = torch.zeros((n_keys, 1, META_COLS), dtype=torch.int32)
    bit_w = torch.from_numpy(slot_bit_table(W)[:, 0].copy()).to(dev)[:, None]
    lane = torch.arange(K, device=dev)
    ii, jj = lane[:, None], lane[None, :]
    for key in range(n_keys):
        init_state = int(meta_h[key, 0, 0, 4])
        fs = torch.where(lane == 0, init_state, 0).to(torch.int32)
        fm = torch.zeros(K, dtype=torch.int32, device=dev)
        fv = (lane == 0).to(torch.int32)
        alive, ovf_any, died, rtot, rmax, first = 1, 0, -1, 0, 0, -1
        for i in range(n):
            slotbit, live, crashed, opidx = (int(x) for x in meta_h[key, i, 0, :4])
            if not (alive == 1 and live == 1):
                continue
            occ, sf, sa, sb = (win[key, i, c][:, None] for c in range(4))
            go, ovf, r = True, False, 0
            while go and r <= 2 * W + 8:
                lin = (fm[None, :] & bit_w) != 0
                ok, s2 = step(fs[None, :], sf, sa, sb)
                cv = (fv[None, :] == 1) & (occ == 1) & ~lin & ok
                cm = fm[None, :] | bit_w
                cs = s2.expand(W, K)
                # dedup + dominance vs the table: [K_t, W, K_c]
                ft = fm[:, None, None]
                same_s = (fs[:, None, None] == cs[None]) & (
                    fv[:, None, None] == 1
                )
                eq3 = same_s & (ft == cm[None])
                cra_t = ft & crashed
                dom3 = (
                    same_s
                    & ((ft & ~crashed) == (cm[None] & ~crashed))
                    & ((cra_t & cm[None]) == cra_t)
                    & (ft != cm[None])
                )
                new = (cv & ~(eq3 | dom3).any(dim=0)).to(torch.int32)
                # flattened (w-major, then k) exclusive rank
                flat = new.reshape(-1)
                rank = torch.cumsum(flat, 0) - flat
                free = 1 - fv
                frank = torch.cumsum(free, 0) - free
                A = (
                    (flat[:, None] == 1)
                    & (free[None, :] == 1)
                    & (rank[:, None] == frank[None, :])
                )
                ins = A.any(dim=0)
                pick = A.to(torch.int64).argmax(dim=0)
                fs2 = torch.where(ins, cs.reshape(-1)[pick], fs)
                fm2 = torch.where(ins, cm.reshape(-1)[pick], fm)
                fv2 = torch.maximum(fv, ins.to(torch.int32))
                fv3 = _prune(fs2, fm2, fv2, crashed, ii, jj)
                changed_t = (
                    (fs2 != fs).any() | (fm2 != fm).any() | (fv3 != fv).any()
                )
                leftover_t = flat.sum() > ins.sum()
                changed, leftover = (
                    bool(x) for x in host_value(
                        torch.stack([changed_t, leftover_t])
                    )
                )
                ovf = ovf or (leftover and not changed)
                fs, fm, fv = fs2, fm2, fv3
                go = changed
                r += 1
            rtot += r
            rmax = max(rmax, r)
            ovf = ovf or go
            has = ((fm & slotbit) != 0).to(torch.int32)
            fv = fv * has
            fm = fm & ~slotbit
            if not bool(host_value(fv.sum() > 0)):
                alive, died = 0, opidx
            if ovf and not ovf_any:
                first = i
            if ovf:
                ovf_any = 1
        out[key, 0] = torch.tensor(
            [alive, ovf_any, died, 0, 0, rtot, rmax, first]
        )
    return out.to(dev)


def _dev_args(steps: ReturnSteps, dev: torch.device):
    def pack():
        win, meta = pack_steps(steps)
        return (
            torch.from_numpy(win[None]).to(dev),
            torch.from_numpy(meta[None]).to(dev),
        )

    args = memo_on(steps, "_kfrontier_args", str(dev), pack)
    record_use(args)
    return args


def check_steps_kfrontier(
    steps: ReturnSteps,
    model: str = "cas-register",
    K: int = 128,
    device=None,
) -> Tuple[bool, bool, int]:
    """Run the K-frontier scan over precompiled return steps:
    (alive, overflow, died_op_index). The packed device arguments are
    memoized on the steps object, so ladder rungs that change only K
    re-pack nothing."""
    dev = resolve_device(device)
    win, meta = _dev_args(steps, dev)
    out = kfrontier_scan(
        win, meta, model if isinstance(model, str) else model.name, K,
        steps.W,
    )
    o = _host_get(out)[0, 0]
    return bool(o[0]), bool(o[1]), int(o[2])


def check_keys_kfrontier(
    steps_list,
    model: str = "cas-register",
    K: int = 128,
    device=None,
):
    """Check many per-key ReturnSteps in ONE kfrontier_scan launch (one
    block per key) and one host fetch. All steps share W (the caller
    buckets it); lengths pad with non-live steps to bucket(longest, 64).
    Returns [(alive, overflow, died_op_index)] in key order."""
    dev = resolve_device(device)
    n = bucket(max(max(len(st) for st in steps_list), 1), 64)
    packed = [pack_steps(st.padded(n)) for st in steps_list]
    win = torch.from_numpy(np.stack([w for w, _ in packed])).to(dev)
    meta = torch.from_numpy(np.stack([m for _, m in packed])).to(dev)
    out = _host_get(kfrontier_scan(
        win, meta, model if isinstance(model, str) else model.name, K,
        steps_list[0].W,
    ))
    return [(bool(o[0]), bool(o[1]), int(o[2])) for o in out[:, 0]]
