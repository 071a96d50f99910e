#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (jepsen_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

Phases, in order; each prints one JSON line with its seconds, and any
failure raises (non-zero exit, no result line):

  device     require CUDA; print nvidia-smi's name and power limit
  build      nvcc every kernel from csrc/ (one process per source); g++
             the native oracle and prep (csrc/*.cc)
  kernels    each kernel against its plain PyTorch version on the card,
             bit-exact: small cases over W, S, K, tiers and frontier
             stores, and config1's and the ladder's own inputs as the
             main path builds them
  keys_parity
             the kernels on the key axis against their plain versions,
             bit-exact: kernel A on config 2's batch and on 5 keys of
             different lengths and init states plus 3 blank keys in
             every store; kernel B on the queue's per-value batch
  config1    8 x 1k-op CAS-register histories + 2 corrupted copies
  ladder     a contended-CAS-counter history of window 24 (K-frontier
             ladder) + a corrupted copy
  northstar  the 100k-op CAS-register history, one host sync
  config2    BASELINE config 2: 16 zookeeper-style keys x 625 ops through
             sharded.check_keys, one launch and one host sync, verdicts
             equal to the native oracle's; then keys 3 and 11 corrupted:
             one exact re-run of the batch, oracle-equal indices
  config1_batch
             bench config 1's 7 simulated etcd histories as one batch
  queue      a 32-value unordered-queue history through
             LinearizableChecker("unordered-queue"): the per-value
             batch on kernel B, one launch; and an overdrawn copy
  keys_scale 128 keys x 625 ops in one launch, kernel time beside the
             16-key batch's
  northstar_parity, batch_parity
             every kernel launch of the main path again: its output held
             against the plain version on the same inputs, bit-exact;
             the kernel timed there (CUDA events) with its bound
  compare    only with --parent DIR (an unpacked older commit, e.g.
             `git archive <commit> | tar -x -C build/parent`):
             tools/kernel_times.py for DIR and for this tree in turns
             (parent, change, change, parent), same outputs required

The kernels' launch counters are set to 0 before each path of the main
path and read right after it: the single-key path (config1, ladder and
northstar's end-to-end check, one run of the counts), then config2, its
corrupted batch, config1_batch, queue, its corrupted copy and
keys_scale, each on its own. A kernel that a path runs must have
launched there. Every launch is also recorded with its inputs (the
counted launches, LaunchRecorder); the kernels line's times are means
per launch over those launches, replayed on their own inputs, and
"by_shape" splits them by phase. The line before the last is
{"kernels": [...]}; the last is {"ok": true, "device": {...}}. Exits
non-zero without CUDA, and where the package is missing (a directory
holding only this script).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import re
import subprocess
import sys
import time

import numpy as np
import torch

#: H100 SXM published HBM rate (NVIDIA data sheet, 700 W), bytes/s
HBM_BYTES_S = 3.35e12
#: 32-bit integer and logic operations per SM per clock on Hopper (64
#: INT32 lanes per SM); the peak is this times the SM count times the
#: card's maximum SM clock, set in the device phase
INT32_OPS_PER_SM_CLK = 64
INT32_OPS_S = 0.0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Phase:
    """Times a phase and prints its JSON line on success."""

    def __init__(self, name: str):
        self.name = name
        self.info: dict = {}

    def __enter__(self):
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self.info

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            torch.cuda.synchronize()
            emit({"phase": self.name,
                  "seconds": time.perf_counter() - self.t0, **self.info})
        return False


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps runs, by CUDA events, after
    one warm-up run; reps=0 times the one run itself."""
    if reps == 0:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1)
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def bound(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / INT32_OPS_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes"
    return t_ops, "operations"


def abs_err(a, b) -> int:
    """Largest |a - b| over two int32 tensors, taken in int64."""
    return int((a.long() - b.long()).abs().max())


def ptxas_summary(log: str) -> dict:
    """nvcc -Xptxas -v output by kernel instance: registers, stack frame
    and spill bytes. A bitset_scan instance is keyed "store,rows,cols"
    (its template arguments); a plain kernel by its name."""
    out, key = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            t = re.search(r"ILi(\d+)ELi(\d+)ELi(\d+)E", m.group(1))
            key = ",".join(t.groups()) if t else m.group(1)
            out[key] = {}
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out[key].update(stack_bytes=int(m.group(1)),
                            spill_bytes=int(m.group(2)) + int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[key]["registers"] = int(m.group(1))
    return out


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# -- kernel A: bitset_scan ---------------------------------------------------


def bitset_inputs(steps, S: int, dev):
    from jepsen_tpu_torch.checker import wgl_bitset as bs

    win, meta = bs.pack_steps(steps)
    fr0 = bs.init_frontier(steps.init_state, S, steps.W)[None]
    return (torch.from_numpy(win[None]).to(dev),
            torch.from_numpy(meta[None]).to(dev),
            torch.from_numpy(fr0).to(dev))


def bitset_bound(win, meta, fr_in, out, S: int, W: int, model: str,
                 exact: bool = False):
    """(ms, bound_by) for one scan of these inputs, over every key: each
    input read once and each output written once, against the word
    operations the inputs need (per applied slot: the source words,
    OR-ed over S rows for a write, plus the OR into the destination;
    per live step the RETURN filter's S*M words), counted up to each
    key's death step. A fast-tier step costs its fresh-gated round and
    two occupied-gated rounds; the exact tier's rounds past the first
    are the kernel's own count (out[3]), each at the key's mean
    occupied-gated round."""
    from jepsen_tpu_torch.checker import wgl_bitset as bs
    from jepsen_tpu_torch.checker.models import model as get_model

    M = bs.bitset_words(W)
    keys = win.shape[0]
    w_all = win.cpu().numpy().reshape(keys, -1, 4, W).astype(np.int64)
    m_all = meta.cpu().numpy().reshape(keys, -1, bs.META_COLS)
    o_all = out.cpu().numpy()
    words = np.array([M if s < 5 else M // 2 for s in range(W)])
    ops = 0.0
    for k in range(keys):
        w, m = w_all[k], m_all[k]
        died = int(o_all[k, 0, 2])
        isu, _, _, valid = (
            t.numpy() for t in get_model(model).bitset_slot(
                torch.from_numpy(w[:, 1]), torch.from_numpy(w[:, 2]),
                torch.from_numpy(w[:, 3]))
        )
        per_slot = words * np.where(isu, S + 1, 2)  # [n, W]
        fresh_ops = occ_ops = n_fresh = 0
        for i in range(len(m)):
            slot, live, opidx, fresh = (int(x) for x in m[i])
            if live != 1:
                continue
            if fresh:
                fbits = (fresh >> np.arange(W)) & 1
                fresh_ops += int((per_slot[i] * (fbits & valid[i])).sum())
                occ_ops += int((per_slot[i] * (w[i, 0] & valid[i])).sum())
                n_fresh += 1
            ops += S * M
            if opidx == died:
                break
        if not exact:
            ops += fresh_ops + 2 * occ_ops
        elif n_fresh:
            extra = max(int(o_all[k, 0, 3]) - n_fresh, 0)
            ops += fresh_ops + extra * occ_ops / n_fresh
    nbytes = (win.numel() + 4 * meta.numel() + 2 * 4 * fr_in.numel()
              + 4 * out.numel())
    return bound(nbytes, ops)


def kernel_a_parity(dev, sim, ev_mod, bs) -> dict:
    """bitset_scan against bitset_scan_plain on the card: W in
    {12, 16, 17, 19}, S in {8, 32}, a valid and a dying history, both
    tiers, and every frontier store (registers, shared, global) that
    fits the shape. Exact equality of out and fr_out."""
    cases = 0
    max_err = 0
    placements_run = set()
    for W in (12, 16, 17, 19):
        for S in (8, 32):
            nv = 5 if S == 8 else 24
            h = sim.gen_register_history(
                random.Random(1000 + W * 10 + S), n_ops=64, n_procs=W,
                n_values=nv, p_crash=0.0)
            hc = sim.corrupt_history(h, random.Random(7 + W), n_values=nv)
            for hist in (h, hc):
                ev = ev_mod.history_to_events(hist)
                check(ev.window <= W, f"window {ev.window} > W={W}")
                steps = ev_mod.events_to_steps(ev, W=W)
                steps = steps.padded(ev_mod.bucket(max(len(steps), 1), 64))
                win, meta, fr0 = bitset_inputs(steps, S, dev)
                stores = []
                for placement in bs.STORES:
                    try:
                        bs.geometry(W, S, placement)
                        stores.append(placement)
                    except ValueError:
                        pass
                for exact in (False, True):
                    o_p, f_p = bs.bitset_scan_plain(
                        win, meta, fr0, "cas-register", S, W, exact=exact)
                    for placement in stores:
                        o_k, f_k = bs.bitset_scan(
                            win, meta, fr0, "cas-register", S, W,
                            exact=exact, placement=placement)
                        torch.cuda.synchronize()
                        err = max(abs_err(o_k, o_p), abs_err(f_k, f_p))
                        max_err = max(max_err, err)
                        check(err == 0, f"bitset_scan != plain at W={W} "
                              f"S={S} exact={exact} {placement}: "
                              f"{o_k.tolist()} vs {o_p.tolist()}")
                        placements_run.add(placement)
                        cases += 1
    check(placements_run == set(bs.STORES), "every store ran")
    return {"cases": cases, "max_abs_err": max_err, "tolerance": 0}


# -- kernel B: kfrontier_scan ------------------------------------------------


def kfrontier_inputs(steps, dev):
    from jepsen_tpu_torch.checker import wgl_kfrontier as kf

    win, meta = kf.pack_steps(steps)
    return (torch.from_numpy(win[None]).to(dev),
            torch.from_numpy(meta[None]).to(dev))


def kfrontier_bound(win, meta, out, K: int, W: int):
    """(ms, bound_by): inputs read and the verdicts written once,
    against one operation per candidate and per table entry in every
    closure round the run took (out[5]), over every key."""
    rounds = int(out.cpu().numpy()[:, 0, 5].sum())
    ops = rounds * (W * K + K)
    nbytes = 4 * (win.numel() + meta.numel() + out.numel())
    return bound(nbytes, ops)


def kernel_b_parity(dev, sim, ev_mod, kf) -> dict:
    """kfrontier_scan against kfrontier_scan_plain on the card: K in
    {128, 256} x W in {8, 16, 32} where the reference's _pallas_ok
    admits it, on crash-bearing, dying, wide (slot 31, a negative
    slotbit) and overflowing histories. Exact equality of out."""
    from jepsen_tpu_torch.checker.linearizable import _pallas_ok

    hists = {
        8: [sim.gen_register_history(random.Random(21), n_ops=80,
                                     n_procs=4, p_crash=0.05)],
        16: [sim.gen_register_history(random.Random(22), n_ops=80,
                                      n_procs=5, p_crash=0.1),
             # fourteen concurrent clients: overflows K=128 and K=256
             sim.gen_register_history(random.Random(23), n_ops=80,
                                      n_procs=14, p_crash=0.0)],
        32: [sim.gen_cas_counter_history(random.Random(24), n_rounds=4,
                                         n_procs=32)],
    }
    cases, max_err, overflowed, died = 0, 0, False, False
    for W, hs in hists.items():
        nv = 33 if W == 32 else 3
        for h in list(hs):
            hs.append(sim.corrupt_history(h, random.Random(W), n_values=nv))
        for h in hs:
            ev = ev_mod.history_to_events(h)
            check(ev.window <= W, f"window {ev.window} > W={W}")
            steps = ev_mod.events_to_steps(ev, W=W)
            win, meta = kfrontier_inputs(steps, dev)
            for K in (128, 256):
                if not _pallas_ok(K, W, 1):
                    continue
                o_p = kf.kfrontier_scan_plain(win, meta, "cas-register", K, W)
                o_k = kf.kfrontier_scan(win, meta, "cas-register", K, W)
                torch.cuda.synchronize()
                err = abs_err(o_k, o_p)
                max_err = max(max_err, err)
                check(err == 0, f"kfrontier_scan != plain at K={K} W={W}: "
                      f"{o_k.tolist()} vs {o_p.tolist()}")
                overflowed |= bool(o_k[0, 0, 1])
                died |= not bool(o_k[0, 0, 0])
                cases += 1
    check(overflowed, "an overflow case ran")
    check(died, "a dying case ran")
    return {"cases": cases, "max_abs_err": max_err, "tolerance": 0}


# -- parity at the main path's own inputs ------------------------------------


def bitset_chain(ev, dev, bs):
    """The main path's bitset-tier inputs for an event stream, built as
    check_events_bucketed builds them: (steps, segments, per-segment
    (win, meta) on the card, S)."""
    from jepsen_tpu_torch.checker.events import events_to_steps

    W, S = bs.plan(bs.get_model("cas-register"), ev.window,
                   len(ev.value_codes))
    steps = events_to_steps(ev, W=W)
    segs = bs._plan_for(steps, None)
    return steps, segs, bs._segment_args(steps, segs, dev), S


def bitset_chain_parity(ev, dev, bs, exact: bool):
    """Run the main path's segment chain for ev through bitset_scan and
    hold every segment's out and fr_out against bitset_scan_plain on the
    same inputs (each segment's fr_in is the previous segment's fr_out
    moved into its mask space, as _run_chain does). Exact equality."""
    steps, segs, args, S = bitset_chain(ev, dev, bs)
    fr = bs._fr0(steps.init_state, S, segs[0][2], dev)
    max_err, n_steps = 0, 0
    for (win, meta), (start, end, W) in zip(args, segs):
        fr_in = bs._reshape_frontier(fr, bs.bitset_words(W))
        o_k, f_k = bs.bitset_scan(win, meta, fr_in, "cas-register", S, W,
                                  exact=exact)
        o_p, f_p = bs.bitset_scan_plain(win, meta, fr_in, "cas-register",
                                        S, W, exact=exact)
        err = max(abs_err(o_k, o_p), abs_err(f_k, f_p))
        check(err == 0, f"bitset_scan != plain on the main path's segment "
              f"{start}:{end} W={W} S={S} exact={exact}: "
              f"{o_k.tolist()} vs {o_p.tolist()}")
        max_err = max(max_err, err)
        n_steps += win.shape[1] // (4 * W)
        fr = f_k
    return {"segments": [list(s) for s in segs], "S": S, "exact": exact,
            "steps": n_steps, "max_abs_err": max_err}


def kfrontier_main_inputs(ev, dev, kf):
    """The ladder's kernel-B inputs for ev, built as check_events_bucketed
    builds them: (win, meta, W, return steps before padding)."""
    from jepsen_tpu_torch.checker import linearizable as lin
    from jepsen_tpu_torch.checker.events import bucket, events_to_steps

    W = lin._bucket_window(max(ev.window, 1))
    steps = events_to_steps(ev, W=W)
    ki = lin.get_model("cas-register").kernel_init_code(ev.init_state)
    steps = dataclasses.replace(steps, init_state=ki)
    n_return = len(steps)
    steps = steps.padded(bucket(max(len(steps), 1), 64))
    win, meta = kf._dev_args(steps, dev)
    return win, meta, W, n_return


# -- the key axis -------------------------------------------------------------


def keys_bitset_inputs(steps_list, S: int, dev, n_blank: int = 0):
    """Kernel A's stacked inputs for a key batch, packed as
    launch_keys_bitset packs them (pad to bucket(longest, 64), each key
    from its own init frontier), plus n_blank blank keys (no live steps,
    the init frontier of state 0): (win, meta, fr0, W)."""
    from jepsen_tpu_torch.checker.events import bucket

    from jepsen_tpu_torch.checker import wgl_bitset as bs

    W = steps_list[0].W
    n = bucket(max(max(len(st) for st in steps_list), 1), 64)
    packed = [bs.pack_steps(st.padded(n)) for st in steps_list]
    win = np.stack([w for w, _ in packed])
    meta = np.stack([m for _, m in packed])
    fr0 = np.stack([bs.init_frontier(st.init_state, S, W)
                    for st in steps_list])
    if n_blank:
        win = np.concatenate([win, np.zeros((n_blank,) + win.shape[1:],
                                            win.dtype)])
        meta = np.concatenate([meta, np.zeros((n_blank,) + meta.shape[1:],
                                              meta.dtype)])
        fr0 = np.concatenate([fr0, np.repeat(
            bs.init_frontier(0, S, W)[None], n_blank, axis=0)])
    return (torch.from_numpy(win).to(dev), torch.from_numpy(meta).to(dev),
            torch.from_numpy(fr0).to(dev), W)


def queue_batch_steps(h, ev_mod, lin):
    """The per-value substreams of a queue history as
    check_queue_by_value hands them to kernel B (packed model, init
    state re-encoded, window bucket of the batch): (steps, W)."""
    subs = lin.split_queue_history_by_value(h)
    evs = [ev_mod.history_to_events(sub, model="unordered-queue")
           for sub in subs.values()]
    W = lin._bucket_window(max(ev.window for ev in evs))
    kic = lin.get_model("unordered-queue-packed").kernel_init_code
    steps = [dataclasses.replace(ev_mod.events_to_steps(ev, W=W),
                                 init_state=kic(ev.init_state))
             for ev in evs]
    return steps, W


def keys_kfrontier_inputs(steps_list, dev, kf, n_blank: int = 0):
    """Kernel B's stacked inputs for a key batch, packed as
    check_keys_kfrontier packs them, plus n_blank blank keys."""
    from jepsen_tpu_torch.checker.events import bucket

    n = bucket(max(max(len(st) for st in steps_list), 1), 64)
    packed = [kf.pack_steps(st.padded(n)) for st in steps_list]
    win = np.stack([w for w, _ in packed])
    meta = np.stack([m for _, m in packed])
    if n_blank:
        win = np.concatenate([win, np.zeros((n_blank,) + win.shape[1:],
                                            win.dtype)])
        meta = np.concatenate([meta, np.zeros((n_blank,) + meta.shape[1:],
                                              meta.dtype)])
    return torch.from_numpy(win).to(dev), torch.from_numpy(meta).to(dev)


def keys_parity(dev, sim, ev_mod, bs, kf, lin, config2_steps, S2,
                queue_hist) -> dict:
    """The kernels on the key axis against their plain versions, exact:
    kernel A on config 2's batch, both tiers; kernel A on 5 keys of
    different lengths and init states (two corrupted) plus 3 blank keys,
    both tiers, in every store geometry() can use, at W=12 S=8 and
    W=16 S=16; kernel B on the queue's per-value batch plus 3 blank
    keys."""
    cases, max_err = [], 0

    def hold_a(win, meta, fr0, S, W, what, stores=(None,)):
        nonlocal max_err
        for exact in (False, True):
            o_p, f_p = bs.bitset_scan_plain(win, meta, fr0, "cas-register",
                                            S, W, exact=exact)
            for placement in stores:
                o_k, f_k = bs.bitset_scan(win, meta, fr0, "cas-register", S,
                                          W, exact=exact,
                                          placement=placement)
                torch.cuda.synchronize()
                err = max(abs_err(o_k, o_p), abs_err(f_k, f_p))
                max_err = max(max_err, err)
                check(err == 0, f"bitset_scan != plain on {what} "
                      f"exact={exact} {placement}: {o_k[:, 0].tolist()} vs "
                      f"{o_p[:, 0].tolist()}")
                cases.append(dict(what=what, keys=win.shape[0], W=W, S=S,
                                  exact=exact, placement=placement,
                                  alive=o_k[:, 0, 0].tolist()))

    win, meta, fr0, W = keys_bitset_inputs(config2_steps, S2, dev)
    hold_a(win, meta, fr0, S2, W, "config2's batch")
    for W, S, nv in ((12, 8, 5), (16, 16, 12)):
        steps = []
        for k in range(5):
            h = sim.gen_register_history(
                random.Random(3000 + 10 * W + k), n_ops=40 + 60 * k,
                n_procs=4, n_values=nv, p_crash=0.01 * k)
            if k in (1, 3):
                h = sim.corrupt_history(h, random.Random(3100 + k),
                                        n_values=nv)
            ev = ev_mod.history_to_events(h)
            check(ev.window <= W, f"window {ev.window} > W={W}")
            # init state codes -1 .. 3: a different fr0 row for each key
            steps.append(dataclasses.replace(
                ev_mod.events_to_steps(ev, W=W), init_state=k - 1))
        check(len({st.init_state for st in steps}) == 5, "5 init states")
        win, meta, fr0, _ = keys_bitset_inputs(steps, S, dev, n_blank=3)
        stores = []
        for placement in bs.STORES:
            try:
                bs.geometry(W, S, placement)
                stores.append(placement)
            except ValueError:
                pass
        hold_a(win, meta, fr0, S, W, f"5 keys + 3 blank at W={W} S={S}",
               stores)
        check(cases[-1]["alive"][5:] == [1, 1, 1], "blank keys live")

    steps, W = queue_batch_steps(queue_hist, ev_mod, lin)
    win, meta = keys_kfrontier_inputs(steps, dev, kf, n_blank=3)
    for K in (128,):
        o_p = kf.kfrontier_scan_plain(win, meta, "unordered-queue-packed",
                                      K, W)
        o_k = kf.kfrontier_scan(win, meta, "unordered-queue-packed", K, W)
        torch.cuda.synchronize()
        err = abs_err(o_k, o_p)
        max_err = max(max_err, err)
        check(err == 0, f"kfrontier_scan != plain on the queue batch: "
              f"{o_k[:, 0].tolist()} vs {o_p[:, 0].tolist()}")
        cases.append(dict(what="queue per-value batch + 3 blank",
                          keys=win.shape[0], W=W, K=K,
                          alive=o_k[:, 0, 0].tolist()))
    return {"cases": cases, "max_abs_err": max_err, "tolerance": 0}


class LaunchRecorder:
    """Records every kernel launch made while a phase of the main path
    runs: each kernel's wrapper calls its module's _launch for CUDA
    tensors only, right where it counts the launch, so wrapping
    _launch sees exactly the counted launches, with their inputs and
    outputs."""

    def __init__(self, bs, kf):
        self.phase = None
        self.calls = []
        launch_a, launch_b = bs._launch, kf._launch

        def rec_a(win, meta, fr_in, model, S, W, exact, geo):
            out = launch_a(win, meta, fr_in, model, S, W, exact, geo)
            self._note("bitset_scan", dict(
                win=win, meta=meta, fr_in=fr_in, model=model, S=S, W=W,
                exact=exact, placement=geo.store), out)
            return out

        def rec_b(win, meta, model, K, W):
            out = launch_b(win, meta, model, K, W)
            self._note("kfrontier_scan", dict(
                win=win, meta=meta, model=model, K=K, W=W), out)
            return out

        bs._launch, kf._launch = rec_a, rec_b

    def _note(self, kernel, args, out):
        if self.phase is not None:
            self.calls.append({"phase": self.phase, "kernel": kernel,
                               "args": args, "out": out})

    def count(self, phase: str, kernel: str) -> int:
        return sum(1 for c in self.calls
                   if c["phase"] == phase and c["kernel"] == kernel)


def replay(calls, bs, kf) -> list:
    """Every recorded launch again: its recorded output held against the
    plain version on the same inputs (exact), the kernel timed on those
    inputs (CUDA events) and the plain version once, with the bound.
    One row per launch."""
    rows = []
    for c in calls:
        a = c["args"]
        if c["kernel"] == "bitset_scan":
            def run():
                return bs.bitset_scan(
                    a["win"], a["meta"], a["fr_in"], a["model"], a["S"],
                    a["W"], exact=a["exact"], placement=a["placement"])

            plain = []
            plain_ms = cuda_ms(lambda: plain.append(bs.bitset_scan_plain(
                a["win"], a["meta"], a["fr_in"], a["model"], a["S"],
                a["W"], exact=a["exact"])), reps=0)
            (o_k, f_k), (o_p, f_p) = c["out"], plain[-1]
            err = max(abs_err(o_k, o_p), abs_err(f_k, f_p))
            b_ms, b_by = bitset_bound(a["win"], a["meta"], a["fr_in"], o_k,
                                      a["S"], a["W"], a["model"], a["exact"])
            live = a["meta"].view(a["meta"].shape[0], -1, bs.META_COLS)[
                :, :, 1]
            shape = dict(S=a["S"], exact=a["exact"],
                         geometry=str(bs.geometry(a["W"], a["S"],
                                                  a["placement"])))
        else:
            def run():
                return kf.kfrontier_scan(a["win"], a["meta"], a["model"],
                                         a["K"], a["W"])

            plain = []
            plain_ms = cuda_ms(lambda: plain.append(kf.kfrontier_scan_plain(
                a["win"], a["meta"], a["model"], a["K"], a["W"])), reps=0)
            o_k, o_p = c["out"], plain[-1]
            err = abs_err(o_k, o_p)
            b_ms, b_by = kfrontier_bound(a["win"], a["meta"], o_k, a["K"],
                                         a["W"])
            live = a["meta"][:, :, 0, 1]
            shape = dict(K=a["K"], model=a["model"])
        check(err == 0, f"{c['kernel']} != plain on a {c['phase']} launch: "
              f"{o_k[:, 0].tolist()} vs {o_p[:, 0].tolist()}")
        once = cuda_ms(run, reps=0)
        ms = cuda_ms(run, reps=3 if once > 20 else 20)
        steps = int((live == 1).sum())
        rows.append(dict(
            phase=c["phase"], kernel=c["kernel"], keys=a["win"].shape[0],
            W=a["W"], padded_steps=int(a["meta"].shape[1]) if
            c["kernel"] == "kfrontier_scan" else
            a["win"].shape[1] // (4 * a["W"]),
            return_steps=steps, ms=ms, us_per_step=1e3 * ms / max(steps, 1),
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            max_abs_err=err, **shape))
    return rows


def by_phase(rows, kernel: str) -> list:
    """The replay rows of one kernel, merged per phase: launches, and
    the means per launch of ms, plain ms and bound."""
    out = []
    for phase in dict.fromkeys(r["phase"] for r in rows
                               if r["kernel"] == kernel):
        rs = [r for r in rows if r["kernel"] == kernel
              and r["phase"] == phase]
        n = len(rs)
        out.append(dict(
            what=phase, launches=n,
            keys=sorted({r["keys"] for r in rs}),
            W=sorted({r["W"] for r in rs}),
            return_steps=sum(r["return_steps"] for r in rs),
            ms=sum(r["ms"] for r in rs) / n,
            plain_ms=sum(r["plain_ms"] for r in rs) / n,
            bound_ms=sum(r["bound_ms"] for r in rs) / n,
            bound_by=sorted({r["bound_by"] for r in rs}),
            us_per_step=1e3 * sum(r["ms"] for r in rs)
            / max(sum(r["return_steps"] for r in rs), 1)))
    return out


def compare_with_parent(parent: str) -> dict:
    """tools/kernel_times.py for the parent tree and this one, in turns
    (parent, change, change, parent), each in its own process; every
    shape's outputs must agree. Per shape: both trees' mean ms (the mean
    of their two runs) and the parent/change ratio."""
    here = os.path.dirname(os.path.abspath(__file__))
    tool = os.path.join(here, "tools", "kernel_times.py")
    runs = []
    for root in (parent, here, here, parent):
        proc = subprocess.run(
            [sys.executable, tool, "--root", root], capture_output=True,
            text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"kernel_times.py --root {root} failed:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    rows = {}
    for name, ref in runs[0]["shapes"].items():
        for r in runs[1:]:
            got = r["shapes"][name]
            check(got["out"] == ref["out"]
                  and got.get("fr_out") == ref.get("fr_out"),
                  f"{name}: parent and change disagree: {got} vs {ref}")
        p_ms = [runs[0]["shapes"][name]["ms"], runs[3]["shapes"][name]["ms"]]
        c_ms = [runs[1]["shapes"][name]["ms"], runs[2]["shapes"][name]["ms"]]
        steps = ref["return_steps"]
        rows[name] = dict(
            kernel=ref["kernel"], W=ref["W"], return_steps=steps,
            parent_ms=p_ms, change_ms=c_ms,
            parent_us_per_step=1e3 * sum(p_ms) / 2 / steps,
            change_us_per_step=1e3 * sum(c_ms) / 2 / steps,
            speedup=sum(p_ms) / sum(c_ms))
    return {"parent": parent, "order": "parent, change, change, parent",
            "run_seconds": [r["seconds"] for r in runs], "shapes": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an unpacked older tree to time the "
                    "kernels against (compare phase)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    from jepsen_tpu_torch import launch_stats_snapshot, reset_launch_stats
    from jepsen_tpu_torch import sim
    from jepsen_tpu_torch.checker import _build
    from jepsen_tpu_torch.checker import events as ev_mod
    from jepsen_tpu_torch.checker import wgl_bitset as bs
    from jepsen_tpu_torch.checker import linearizable as lin
    from jepsen_tpu_torch.checker import wgl_kfrontier as kf
    from jepsen_tpu_torch.checker import wgl_native
    from jepsen_tpu_torch.checker.linearizable import (
        LinearizableChecker,
        check_events_bucketed,
    )
    from jepsen_tpu_torch.checker.sharded import check_keys
    from jepsen_tpu_torch.checker.wgl_oracle import (
        check_events,
        check_events_fast,
        check_streams,
    )

    dev = torch.device("cuda")
    smi = "not measured"

    with Phase("device") as info:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        max_sm_mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()[0])
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        global INT32_OPS_S
        INT32_OPS_S = n_sm * INT32_OPS_PER_SM_CLK * max_sm_mhz * 1e6
        info.update(nvidia_smi=smi, torch=torch.__version__,
                    cuda=torch.version.cuda,
                    name=torch.cuda.get_device_name(0),
                    sms=n_sm, max_sm_mhz=max_sm_mhz,
                    int32_ops_s=INT32_OPS_S)

    with Phase("build") as info:
        log = _build.build_all()
        info["kernels"] = {
            name: {"seconds": entry["seconds"],
                   "ptxas": ptxas_summary(entry["ptxas"])}
            for name, entry in log.items()
        }
        # the instances the main path runs must not spill
        main_geos = {bs.geometry(W, 8) for W in range(12, 17)}
        for geo in main_geos:
            key = f"{bs.STORES.index(geo.store)},"
            key += f"{geo.S if geo.store == 'registers' else 0},{geo.cols}"
            got = info["kernels"]["bitset_scan"]["ptxas"].get(key)
            check(got is not None and got["spill_bytes"] == 0,
                  f"bitset_scan instance {key} ({geo}) spills: {got}")
        # the host libraries: the native oracle and prep (g++)
        t0 = time.perf_counter()
        info["native"] = {name: str(_build.native_library(name))
                          for name in ("wgl_native", "wgl_prep")}
        info["native_seconds"] = time.perf_counter() - t0
        check(wgl_native.available() and wgl_native.prep_available(),
              f"native libraries: {info['native']}")

    # -- kernels: parity on small cases and the main path's inputs ---------
    with Phase("kernels") as info:
        parity = {
            "bitset_scan": kernel_a_parity(dev, sim, ev_mod, bs),
            "kfrontier_scan": kernel_b_parity(dev, sim, ev_mod, kf),
        }
        info.update(parity)

        # kernel A on config1's inputs, built as the main path builds
        # them: history 0 and its corrupted copy (which escalates to
        # the exact tier), every segment held against the plain version
        h = sim.gen_register_history(random.Random(100), n_ops=1000,
                                     n_procs=5, p_crash=0.01)
        hc = sim.corrupt_history(h, random.Random(200))
        main_a = [
            bitset_chain_parity(ev_mod.history_to_events(x), dev, bs, exact)
            for x, exact in ((h, False), (hc, False), (hc, True))
        ]
        # kernel B on the ladder's inputs, built as the main path builds
        # them (the contended counter and its corrupted copy, K=128, the
        # rung both take)
        h = sim.gen_cas_counter_history(random.Random(5), n_rounds=40,
                                        n_procs=24)
        hc = sim.corrupt_history(h, random.Random(6), n_values=25)
        main_b = []
        for x in (hc, h):
            win, meta, W, _ = kfrontier_main_inputs(
                ev_mod.history_to_events(x), dev, kf)
            out = kf.kfrontier_scan(win, meta, "cas-register", 128, W)
            err = abs_err(out, kf.kfrontier_scan_plain(
                win, meta, "cas-register", 128, W))
            check(err == 0, f"kfrontier_scan != plain on the ladder's "
                  f"inputs: {out.tolist()}")
            main_b.append({"W": W, "K": 128, "steps": win.shape[1],
                           "max_abs_err": err})
        info.update(main_path_parity={
            "bitset_scan": main_a, "kfrontier_scan": main_b})
        parity["bitset_scan"]["max_abs_err"] = max(
            [parity["bitset_scan"]["max_abs_err"]]
            + [c["max_abs_err"] for c in main_a])
        parity["kfrontier_scan"]["max_abs_err"] = max(
            [parity["kfrontier_scan"]["max_abs_err"]]
            + [c["max_abs_err"] for c in main_b])

    # the inputs of the key-axis phases
    zk_hists = [
        sim.gen_register_history(random.Random(1000 + k), n_ops=625,
                                 n_procs=5, p_crash=0.005)
        for k in range(16)
    ]
    queue_hist = sim.gen_queue_history(random.Random(7), n_ops=800,
                                       n_procs=5, n_values=32, p_crash=0.01)

    with Phase("keys_parity") as info:
        evs = [ev_mod.history_to_events(h) for h in zk_hists]
        W2, S2 = bs.plan(bs.get_model("cas-register"),
                         max(ev.window for ev in evs),
                         max(len(ev.value_codes) for ev in evs))
        kp = keys_parity(dev, sim, ev_mod, bs, kf, lin, [
            ev_mod.events_to_steps(ev, W=W2) for ev in evs], S2, queue_hist)
        info.update(kp)
        for name in parity:
            parity[name]["max_abs_err"] = max(parity[name]["max_abs_err"],
                                              kp["max_abs_err"])

    # -- the main path: each path's counts from 0 -----------------------------
    recorder = LaunchRecorder(bs, kf)
    checker = LinearizableChecker("cas-register")
    launches = {}  # phase -> {kernel: launches in that phase}

    def start(phase):
        bs.bitset_scan.launches = 0
        kf.kfrontier_scan.launches = 0
        recorder.phase = phase
        reset_launch_stats()

    def stop(phase, must_launch):
        recorder.phase = None
        counts = {"bitset_scan": bs.bitset_scan.launches,
                  "kfrontier_scan": kf.kfrontier_scan.launches}
        for name, n in counts.items():
            check(recorder.count(phase, name) == n,
                  f"{phase}: recorded launches of {name} != its count {n}")
        for name in must_launch:
            check(counts[name] > 0, f"{phase}: {name} never launched")
        launches[phase] = counts
        return counts

    # the single-key path (config1, ladder, northstar) is one run of the
    # counts, as it was
    bs.bitset_scan.launches = 0
    kf.kfrontier_scan.launches = 0
    recorder.phase = "config1"
    with Phase("config1") as info:
        hists = [
            sim.gen_register_history(random.Random(100 + i), n_ops=1000,
                                     n_procs=5, p_crash=0.01)
            for i in range(8)
        ]
        hists += [sim.corrupt_history(hists[i], random.Random(200 + i))
                  for i in range(2)]
        reset_launch_stats()
        rows = [checker.check(None, h) for h in hists]
        stats = launch_stats_snapshot()
        for i, r in enumerate(rows[:8]):
            check(r["valid?"] is True, f"config1 history {i}: {r}")
        for h, r in zip(hists[8:], rows[8:]):
            valid, st = check_events(ev_mod.history_to_events(h),
                                     return_stats=True)
            check(r["valid?"] == valid
                  and r.get("failed_op_index") == st["failed_op_index"],
                  f"config1 corrupted: {r} vs oracle {valid} {st}")
        check(all(r["method"] == "gpu-wgl-bitset" for r in rows),
              f"config1 methods {[r['method'] for r in rows]}")
        wall = sum(r["wall_s"] for r in rows)
        info.update(
            methods=sorted({r["method"] for r in rows}),
            windows=[r["window"] for r in rows],
            valid=[r["valid?"] for r in rows],
            check_wall_s=[r["wall_s"] for r in rows],
            invoked_ops=1000 * len(hists), wall_s=wall,
            ops_per_s=1000 * len(hists) / wall, **stats,
        )

    recorder.phase = "ladder"
    with Phase("ladder") as info:
        reset_launch_stats()
        h = sim.gen_cas_counter_history(random.Random(5), n_rounds=40,
                                        n_procs=24)
        hc = sim.corrupt_history(h, random.Random(6), n_values=25)
        t0 = time.perf_counter()
        r = checker.check(None, h)
        rc = checker.check(None, hc)
        wall = time.perf_counter() - t0
        valid, st = check_events(ev_mod.history_to_events(hc),
                                 return_stats=True)
        check(20 <= r["window"] <= 32, f"ladder window {r['window']}")
        check(r["valid?"] is True and r["method"] == "gpu-wgl-kfrontier",
              f"ladder: {r}")
        check(rc["method"] == "gpu-wgl-kfrontier"
              and rc["valid?"] == valid
              and rc.get("failed_op_index") == st["failed_op_index"],
              f"ladder corrupted: {rc} vs oracle {valid} {st}")
        info.update(window=r["window"], method=r["method"],
                    frontier_k=r["frontier_k"],
                    corrupted_failed_op_index=rc["failed_op_index"],
                    op_records=len(h) + len(hc), wall_s=wall,
                    check_wall_s=[r["wall_s"], rc["wall_s"]],
                    **launch_stats_snapshot())

    recorder.phase = "northstar"
    with Phase("northstar") as info:
        h = sim.gen_register_history(random.Random(9), n_ops=100_000,
                                     n_procs=5, p_crash=0.0002)
        # end to end through the checker, cold
        reset_launch_stats()
        t0 = time.perf_counter()
        r = checker.check(None, h)
        e2e = time.perf_counter() - t0
        check(r["valid?"] is True and r["method"] == "gpu-wgl-bitset",
              f"northstar: {r}")
        e2e_stats = launch_stats_snapshot()
        check(e2e_stats["host_syncs"] == 1, f"northstar syncs {e2e_stats}")
        # the single-key path ends here: its launch counts are read now,
        # before the timing re-run below
        recorder.phase = None
        single = {"bitset_scan": bs.bitset_scan.launches,
                  "kfrontier_scan": kf.kfrontier_scan.launches}
        # the same check split: host prep (events, steps, plan, pack and
        # upload), then the device scan alone
        t0 = time.perf_counter()
        ev = ev_mod.history_to_events(h)
        t_events = time.perf_counter() - t0
        steps, segs, _, S = bitset_chain(ev, dev, bs)
        torch.cuda.synchronize()
        prep = time.perf_counter() - t0
        reset_launch_stats()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        r2 = check_events_bucketed(ev, "cas-register")
        e1.record()
        torch.cuda.synchronize()
        dev_wall = time.perf_counter() - t0
        check(r2["valid?"] is True, f"northstar split: {r2}")
        split_stats = launch_stats_snapshot()
        check(split_stats["host_syncs"] == 1, f"northstar {split_stats}")
        info.update(
            invoked_ops=100_000, n_ops=r["n_ops"], window=r["window"],
            segments=[list(s) for s in segs], S=S,
            e2e_wall_s=e2e, e2e_ops_per_s=100_000 / e2e,
            host_prep_s=prep, history_to_events_s=t_events,
            device_wall_s=dev_wall,
            device_event_s=e0.elapsed_time(e1) / 1e3,
            **e2e_stats,
        )
    check(all(n > 0 for n in single.values()),
          f"a kernel of the single-key path never launched: {single}")
    for phase in ("config1", "ladder", "northstar"):
        launches[phase] = {k: recorder.count(phase, k) for k in single}
    check({k: sum(launches[p][k] for p in ("config1", "ladder", "northstar"))
           for k in single} == single,
          f"recorded single-key launches {launches} != counts {single}")
    check(launches["northstar"]["bitset_scan"] == len(segs),
          f"north-star launches {launches['northstar']} vs {len(segs)} "
          "segments")

    with Phase("config2") as info:
        # the oracle's verdicts first, on the host (native C++ over the
        # cores)
        check(wgl_native.available(), "the native oracle builds here")
        want, ometa = check_streams(
            [ev_mod.history_to_events(h) for h in zk_hists])
        check(ometa["oracle"] == "native", f"oracle {ometa}")
        start("config2")
        t0 = time.perf_counter()
        res = check_keys([ev_mod.history_to_events(h) for h in zk_hists])
        wall = time.perf_counter() - t0
        stats = launch_stats_snapshot()
        counts = stop("config2", ["bitset_scan"])
        check(stats["launches"] == 1 and stats["host_syncs"] == 1
              and counts["bitset_scan"] == 1, f"config2 {stats} {counts}")
        check([r["valid?"] for r in res] == want,
              f"config2 verdicts {res} vs oracle {want}")
        check({r["method"] for r in res} == {"gpu-wgl-bitset-batch"},
              f"config2 methods {res}")
        # the same batch split: host prep (events, steps, pack, upload),
        # then kernel A alone (CUDA events)
        t0 = time.perf_counter()
        evs = [ev_mod.history_to_events(h) for h in zk_hists]
        t_events = time.perf_counter() - t0
        W2, S2 = bs.plan(bs.get_model("cas-register"),
                         max(ev.window for ev in evs),
                         max(len(ev.value_codes) for ev in evs))
        win, meta, fr0, _ = keys_bitset_inputs(
            [ev_mod.events_to_steps(ev, W=W2) for ev in evs], S2, dev)
        torch.cuda.synchronize()
        prep = time.perf_counter() - t0
        kernel_16 = cuda_ms(lambda: bs.bitset_scan(
            win, meta, fr0, "cas-register", S2, W2), reps=20)

        # keys 3 and 11 corrupted: one fast-tier death re-runs the whole
        # batch exactly
        bad = list(zk_hists)
        for k in (3, 11):
            bad[k] = sim.corrupt_history(zk_hists[k], random.Random(2000 + k))
        oracle = [check_events_fast(ev_mod.history_to_events(h),
                                    return_stats=True) for h in bad]
        check(not oracle[3][0] and not oracle[11][0],
              "keys 3 and 11 are invalid")
        start("config2_corrupted")
        res_bad = check_keys([ev_mod.history_to_events(h) for h in bad])
        stats_bad = launch_stats_snapshot()
        counts_bad = stop("config2_corrupted", ["bitset_scan"])
        check(stats_bad["launches"] == 2 and stats_bad["escalations"] == 1
              and counts_bad["bitset_scan"] == 2,
              f"config2 corrupted {stats_bad} {counts_bad}")
        for k, (r, (v, st)) in enumerate(zip(res_bad, oracle)):
            check(r["valid?"] == v and r.get("failed_op_index")
                  == (None if v else st["failed_op_index"]),
                  f"config2 corrupted key {k}: {r} vs oracle {v} {st}")
        info.update(
            keys=16, W=W2, S=S2, invoked_ops=625 * 16, wall_s=wall,
            ops_per_s=625 * 16 / wall, host_prep_s=prep,
            history_to_events_s=t_events, kernel_ms=kernel_16,
            oracle=ometa["oracle"], oracle_processes=ometa["processes"],
            **stats,
            corrupted={"failed_op_index": [r.get("failed_op_index")
                                           for r in res_bad],
                       **stats_bad})

    with Phase("config1_batch") as info:
        # bench config 1's 7 simulated etcd histories as one batch (its
        # eighth, recorded stream needs the runtime, not ported)
        hists = [sim.gen_register_history(random.Random(100 + i),
                                          n_ops=1000, n_procs=5,
                                          p_crash=0.01) for i in range(7)]
        start("config1_batch")
        t0 = time.perf_counter()
        res = check_keys([ev_mod.history_to_events(h) for h in hists])
        wall = time.perf_counter() - t0
        stats = launch_stats_snapshot()
        counts = stop("config1_batch", ["bitset_scan"])
        check(stats["launches"] == 1 and stats["host_syncs"] == 1
              and counts["bitset_scan"] == 1, f"config1_batch {stats}")
        check(all(r["valid?"] is True and r["method"]
                  == "gpu-wgl-bitset-batch" for r in res),
              f"config1_batch {res}")
        info.update(keys=7, invoked_ops=7000, wall_s=wall,
                    ops_per_s=7000 / wall, **stats)

    with Phase("queue") as info:
        qchecker = LinearizableChecker("unordered-queue")
        subs = lin.split_queue_history_by_value(queue_hist)
        check(len(subs) == 32, f"{len(subs)} values")
        start("queue")
        t0 = time.perf_counter()
        r = qchecker.check(None, queue_hist)
        wall = time.perf_counter() - t0
        counts = stop("queue", ["kfrontier_scan"])
        check(r["valid?"] is True and r["n_values"] == 32
              and r["method"] == "per-value:gpu-wgl-kfrontier-batchx32",
              f"queue: {r}")
        check(counts == {"bitset_scan": 0, "kfrontier_scan": 1},
              f"queue launches {counts}")
        # one value dequeued more often than it was enqueued
        hc = sim.overdraw_queue_history(queue_hist, 17)
        sub = lin.split_queue_history_by_value(hc)[17]
        v, st = check_events_fast(
            ev_mod.history_to_events(sub, model="unordered-queue"),
            model="unordered-queue-packed", return_stats=True)
        check(not v and st["oracle"] == "native", f"oracle {v} {st}")
        start("queue_corrupted")
        rc = qchecker.check(None, hc)
        counts_c = stop("queue_corrupted", ["kfrontier_scan"])
        check(rc["valid?"] is False and rc["failed_value"] == 17
              and rc["failed_op_index"] == st["failed_op_index"]
              and rc["method"].startswith("per-value:gpu-wgl-kfrontier-"
                                          "batchx"),
              f"queue corrupted: {rc} vs oracle {st}")
        # the batch, then the failing value's own report check
        check(counts_c == {"bitset_scan": 0, "kfrontier_scan": 2},
              f"queue corrupted launches {counts_c}")
        info.update(values=r["n_values"], method=r["method"],
                    op_records=len(queue_hist), wall_s=wall,
                    check_wall_s=[r["wall_s"], rc["wall_s"]],
                    corrupted_failed_value=rc["failed_value"],
                    corrupted_failed_op_index=rc["failed_op_index"])

    with Phase("keys_scale") as info:
        hists = [sim.gen_register_history(random.Random(1000 + k),
                                          n_ops=625, n_procs=5,
                                          p_crash=0.005) for k in range(128)]
        want, _ = check_streams([ev_mod.history_to_events(h)
                                 for h in hists])
        start("keys_scale")
        t0 = time.perf_counter()
        res = check_keys([ev_mod.history_to_events(h) for h in hists])
        wall = time.perf_counter() - t0
        stats = launch_stats_snapshot()
        counts = stop("keys_scale", ["bitset_scan"])
        check(stats["launches"] == 1 and stats["host_syncs"] == 1
              and counts["bitset_scan"] == 1, f"keys_scale {stats}")
        check([r["valid?"] for r in res] == want, "keys_scale verdicts")
        evs = [ev_mod.history_to_events(h) for h in hists]
        W128, S128 = bs.plan(bs.get_model("cas-register"),
                             max(ev.window for ev in evs),
                             max(len(ev.value_codes) for ev in evs))
        win, meta, fr0, _ = keys_bitset_inputs(
            [ev_mod.events_to_steps(ev, W=W128) for ev in evs], S128, dev)
        kernel_128 = cuda_ms(lambda: bs.bitset_scan(
            win, meta, fr0, "cas-register", S128, W128), reps=20)
        info.update(keys=128, W=W128, S=S128, invoked_ops=625 * 128,
                    wall_s=wall, ops_per_s=625 * 128 / wall,
                    kernel_ms=kernel_128, kernel_ms_16_keys=kernel_16,
                    sms=torch.cuda.get_device_properties(0)
                    .multi_processor_count,
                    geometry=str(bs.geometry(W128, S128)), **stats)

    # every launch of the main path again: output held against the
    # plain version on the same inputs, and timed
    single_phases = ("config1", "ladder", "northstar")
    with Phase("northstar_parity") as info:
        rows = replay([c for c in recorder.calls
                       if c["phase"] in single_phases], bs, kf)
        info.update(launches=len(rows), by_launch=rows)
    with Phase("batch_parity") as info:
        batch_rows = replay([c for c in recorder.calls
                             if c["phase"] not in single_phases], bs, kf)
        info.update(launches=len(batch_rows), by_launch=batch_rows)
    rows += batch_rows
    for name in parity:
        parity[name]["max_abs_err"] = max(
            [parity[name]["max_abs_err"]]
            + [r["max_abs_err"] for r in rows if r["kernel"] == name])

    compare = None
    if opts.parent:
        with Phase("compare") as info:
            compare = compare_with_parent(os.path.abspath(opts.parent))
            info.update(compare)

    def kernel_line(name, source, replaces):
        rs = [r for r in rows if r["kernel"] == name]
        n = len(rs)
        check(n == sum(c[name] for c in launches.values()),
              f"{name}: {n} replayed launches vs counts {launches}")
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": n,
            "max_abs_err": parity[name]["max_abs_err"],
            "ms": sum(r["ms"] for r in rs) / n,
            "plain_ms": sum(r["plain_ms"] for r in rs) / n,
            "bound_ms": sum(r["bound_ms"] for r in rs) / n,
            "bound_by": ("operations" if all(
                r["bound_by"] == "operations" for r in rs) else "bytes"),
            "library_ms": None,
            "shape": (f"mean per launch over the main path's {n} launches "
                      "(by_shape: per phase)"),
            "launches_by_phase": {p: c[name] for p, c in launches.items()},
            "by_shape": by_phase(rows, name),
        }

    kernels = [
        kernel_line("bitset_scan", "jepsen_tpu_torch/csrc/bitset_scan.cu",
                    "jepsen_tpu/checker/wgl_bitset.py:251"),
        kernel_line("kfrontier_scan",
                    "jepsen_tpu_torch/csrc/kfrontier_scan.cu",
                    "jepsen_tpu/checker/wgl_pallas.py:88"),
    ]
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
