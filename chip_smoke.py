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
  plane_config1
             config 1's 10 histories through check_async on one
             DispatchPlane, all submitted before any is resolved: one
             shared launch train, one host sync per collected train
  plane_burst
             keys_scale's 128 histories, one check_async each, prepped
             on the plane's worker thread (async_prep)
  plane_northstar
             the north star through plane.submit: a segmented solo
             launch, 1 launch, 1 host sync
  plane_queue
             the queue history and its overdrawn copy through the plane
  race       config 1 with the native oracle racing the card,
             sequentially and through a racing plane; no mismatch
  chaos      injected faults on the plane (transient: retried to
             parity; a sticky device fault and an oom: each rider fails
             with its PlaneFault on the default plane, and degrades to
             the host oracle only on a degrade=True plane; a hung
             collect: cut at its deadline and retried; a Python error in
             the launch wrapper: raised to the caller, not degraded),
             then a real out-of-memory error classified oom
  sentry     a config 1 history with a duplicate index and an inversion
             through the checker: repaired, reported, verdict unchanged
  (chaos also faults the plane's stream bucket: chaos_stream, counted)
  durable_northstar
             the north star through check(checkpoint=CheckpointSink):
             every=1 (a launch and a host sync a segment), every=5 (one),
             a replay of the finished file (none), a run killed at
             boundary 2 and its resume (the 3 segments left), a tampered
             file (a cold run), and a plain check before and after
  durable_plane
             config 1's 10 histories, each with its own sink, and the
             north star through DispatchPlane.submit(checkpoint=):
             durable_coalesced and durable_solo; a second round on the
             finished sinks with no launch
  stream_northstar
             the north star appended to one StreamingCheck in 10 chunks
  streams_1k 1,000 StreamingCheck(plane, hold_s=2) streams, one thread
             each, 4 lockstep rounds (STREAMS_1K): stacked stream tails,
             launches within the reference's bound
  stream_gc  a 200,000-op history through the default plane in 100
             appends with gc_window=4096 (STREAM_GC): retained ops and
             device residency bounded
  stream_deferred
             the ladder's window-24 histories appended in 4 chunks: the
             stream defers and result() runs kernel B
  config3    BASELINE config 3 (bench.py:1597's shape): a 50k-op,
             8-account bank history, checked on the host by default (its
             cells under bank._DEVICE_CELLS) and with force_device=True
             on the card (bank_reduce_torch, one fetch), equal verdicts;
             a copy with one read's balance changed, invalid on both
  config4    BASELINE config 4: a 25,000-key G2 insert history (100k
             ops), host bincounts; a copy with one extra ok insert,
             invalid
  config5    BASELINE config 5: long-fork over 128 groups of 2 keys x
             3,906 ops, valid in one fork launch (fork_pairs_torch) and
             one sync; a copy with a planted fork, invalid with the
             forks of the numpy product on the same presence matrix
  counter    a 200,000-op counter history of float and int deltas: the
             default route on the card (counter_bounds_torch, past the
             100k gate), bounds exactly equal to the numpy path's; one
             read moved out of its bounds, the same errors on both
  (each prints its wall, launches, host syncs and its device program's
  time by CUDA events beside its bound; none may launch a WGL kernel)
  config6    bench config 6 (bench.py:1780's shape, uncut): 200,000
             list-append txns with a planted 3-txn G1c cycle through
             TxnGraphChecker() on the card (the default plane's graph
             bucket): invalid, census G1c = 3, the verdict equal to the
             host fold's; split into encode, extract, the batch
             program's compile, a check of the encoded plane, a warm
             re-check and the verdict; then a clean history of the same
             size, valid
  config6_wide
             components on the other routes: groups of 48 txns (bucket
             48, the widest bucket launch) with a planted G2-item, and
             one 1,500-txn component past the last bucket (a solo
             [1, N, N] launch, no host census)
  plane_graph
             two checkers' histories pinned to one bucket on one
             DispatchPlane: one graph launch, one host sync
  chaos_graph
             a sticky device fault on the graph launches: each checker
             on the default plane raises its PlaneFault (a bucket launch,
             and the guarded oversize solo launch of a history whose one
             component passes buckets=(2,), no bucket launch run); a
             degrade=True plane answers
             from the host census, equal to the fold; a Python error in
             the launch wrapper is raised, not degraded
  g2_txn     BASELINE config 4's G2Checker on a 20,000-txn micro-op
             history with a planted G2-item: the dependency-graph route
             on the card, equal to the CPU's
  (each holds every graph launch's per-graph counts against
  graph_counts_torch on CPU copies of its stacks, exactly, and prints
  the program's time by CUDA events beside its bound; none may launch
  a WGL kernel)
  then the CLI, `jepsen_tpu_torch.cli.main(["analyze", RUN, ...])` on
  run directories the port's Store writes (cli_phases):
  cli_northstar
             the north star as a stored run: exit 0, the in-process
             verdict, 1 launch and 1 host sync in results.json's
             engine_stats; the split into load_history, load_test, the
             sentry (the CLI's gate and the checker's own), the check
             and save_2
  cli_config1
             config 1's 10 histories as runs: exits 0 and 1 as the
             in-process verdicts, linear.svg in each invalid run
  cli_keyed  config 2's 16 keys as one register-keyed run (KV values):
             the oracle's verdicts, one launch a key (IndependentChecker
             checks key by key)
  cli_ladder the window-24 CAS counter and its corrupted copy as runs:
             kernel B, the in-process verdicts
  cli_resume the north star under `--resume` (JEPSEN_TPU_SEG_MIN_LEN
             set): a child process SIGKILLs itself after boundary 2's
             save; the resumed run gives the cold run's verdict with
             strictly fewer launches and resumes 1; a tampered file runs
             cold
  cli_follow `--follow --resume` on a history.jsonl a thread grows in 10
             chunks: the one-shot exit code; a restarted follow resumes
             from stream.json and checks fewer steps
  cli_trace  `--trace` on config 1's runs: each trace passes
             validate_chrome_trace, its launch_stat sums equal
             engine_stats["launch"], trace-summary exits 0
  cli_profile
             `--xla-trace DIR` on the north star: the torch.profiler
             trace names the bitset kernel; the device's busy and idle
             share over the traced window from its CUDA kernel events
  then the checker daemon, an in-process `CheckerDaemon()` on the card
  driven over HTTP by CheckerClient (service_phases):
  service_burst
             config 1's 10 histories from 5 tenants at once, behind a
             barrier, under a 1 s hold: the in-process verdicts, fewer
             kernel launches than requests, every tenant's ledger row
  service_northstar
             the north star in one POST /check: the in-process verdict,
             1 launch and 1 host sync; the split into the client's
             encode, the request decode and sentry, the check (the
             trace's request and check spans) and the response
  service_queue
             the 32-value queue and its overdrawn copy: the per-value
             batch on kernel B, the in-process verdicts
  service_stream
             the north star in 10 POST /check/stream chunks on the
             daemon's plane: 202s, then the one-shot verdict
  service_durable
             a `cli daemon` child SIGKILLs itself after boundary 2 of a
             durable north star; the in-process daemon resumes it at
             segment 2 with the cold verdict and strictly fewer launches
  service_chaos
             a sticky fault aimed at one tenant: that tenant's 500, the
             other tenant's verdict, the card never quarantined
  service_drain
             SIGTERM of a `cli daemon` child with a check in flight: a
             late request refused, the in-flight check answered, exit 0
  then the fleet (fleet_phases):
  fleet_door config 1's 10 histories from 5 tenants at once through a
             proxy FleetFrontDoor in front of 2 in-process members on
             this process's default plane (1 s hold): the in-process
             verdicts, each tenant answered by its ring owner, the
             rollup's 10 completed; then one redirect-mode request
  fleet_handoff
             2 members spawned by `spawn_fleet_member` on the card, the
             tenant's owner under an interpreter that SIGKILLs it after
             boundary 2's save; the durable north star through the
             door: the death declared, the same bytes replayed, the
             successor resumes (handoffs 1, 3 launches against 5, read
             from the door's /stats rollup)
  fleet_gray the supervisor respawns the dead owner at epoch 1; it is
             SIGSTOPped and its tenant's request hedged to the
             successor after the 5 s forward budget, the stopped member
             never in quarantined_hosts; SIGCONT, it answers again
  fleet_drill
             `cli fleet-drill --members 2 --duration 20 --seed 0` as a
             child on the card: exit 0, clean, all 7 fault classes, one
             respawn at epoch 1, the parity pass on the card
  fleet_cli  `cli fleet --members 2` as a child: one POST through its
             door, SIGTERM, exit 0 with "fleet drained"
  then the perf layer (perf_phases):
  perf_trend `cli perf-trend` on bench_runs/trend.jsonl (the JAX
             package's bench rows): its exit and one table line a row
  tune       `cli tune --budget-s 60` on the card into a temporary
             profile directory (removed and restored after): exit 0, a
             profile keyed by the card's name and the torch and CUDA
             versions, parity on every winning rung; the probes'
             kernel-A launches counted and recorded, their graph
             launches held against graph_counts_torch on CPU copies
  tuned      that profile through --profile: `analyze` on the north
             star and on config 1's runs, and one service_burst on a
             default plane built under it; the untuned verdicts, each
             wall beside the same work's untuned wall from this call,
             engine_stats["perf"] tuned with the profile's config_hash
  then the mesh and the pod (mesh_phases), on virtual slots: each
  one of N slots on the one card with its own CUDA stream, kernel A
  once per slot on its block of keys, the slots' rows gathered onto
  the caller's stream before the one counted host sync:
  mesh_config2
             config 2's 16 keys through check_keys on a 2-slot mesh:
             config2's verdicts, 1 launch (2 kernel launches, one a
             slot) and 1 host sync, MESH_STATS sharded_launches 1 over
             2 slots; the corrupted batch: its sharded exact re-run
  mesh_keys_scale
             127 of keys_scale's keys on 2 slots: one blank pad row
  mesh_plane config 1's 10 histories through check_async on a
             DispatchPlane over 2 slots: one block a slot a stacked
             launch, one wait a train; three north-star chains
             round-robin over the slots (2, 1); a persistent fault on
             slot 1 of a 2-slot plane collapses it to one device, of a
             3-slot plane re-shards it onto 2 (resharded_launches 1),
             the verdicts unchanged
  mesh_graph config 6's history with its graph buckets sharded over 2
             slots, and config6_wide's 1,500-txn component row-sharded:
             the unsharded census
  pod_card   launch_pod(2): two processes, one slot each, both on
             cuda:0, joined over gloo (NCCL refuses two ranks on one
             card): config 2 through check_keys(mesh=default_mesh()),
             member 0's verdicts config2's, one launch and one host
             sync, 2 hosts, the clock handshake's skew bound, and the
             spawn-to-result seconds
  pod_trace  the same pod shape through the port's CLI: two `cli
             analyze RUN --trace PATH --pod-*` processes on a stored
             config 1 run (kernel A in each member): both exit with the
             single-process verdict, process 0 writes ONE merged trace
             that validates, with two process_name rows, each member's
             launch_stat instants summing to its LAUNCH_STATS, the
             members' largest skew bound, and trace-summary exiting 0;
             the spawn-to-result seconds and the merged event count
  lint       `cli lint --json` on the tree that runs: exit 0, no
             finding, 27 rules; its wall and the suppression census
  northstar_parity, batch_parity, stream_parity
             every kernel launch of the main path again: its output held
             against the plain version on the same inputs, bit-exact;
             the kernel timed there (CUDA events) with its bound. The
             later phases' plain versions run on CPU copies of the
             inputs in worker processes (PlainPool), each distinct row
             of a launch once
  compare    only with --parent DIR (an unpacked older commit, e.g.
             `git archive <commit> | tar -x -C build/parent`):
             tools/kernel_times.py for DIR and for this tree in turns
             (parent, change, change, parent), same outputs required

The kernels' launch counters are set to 0 before each path of the main
path and read right after it: the single-key path (config1, ladder and
northstar's end-to-end check, one run of the counts), then config2, its
corrupted batch, config1_batch, queue, its corrupted copy, keys_scale,
the plane's four paths, chaos_stream, the durable and streaming
paths, the CLI's, the daemon's, fleet_door, the perf layer's (the
sweep's probes, the tuned runs) and the mesh's (mesh_config2, its
corrupted batch, mesh_keys_scale, mesh_plane and its chains), each on
its own (the daemon children's, the fleet members' and the pod
members' launches run in their own processes: the members' are read
from the door's rollup, a pod member's from its own counts or its
results.json, not replayed).
Those phases run with
race=False, the default (the native oracle must not race the kernels
they count), and every phase but chaos asserts that no verdict went down the
plane's ladder to the host oracle. A kernel that a path runs must have
launched there. Every launch is also recorded with its inputs (the
counted launches, LaunchRecorder); the kernels line's times are means
per launch over those launches, replayed on their own inputs, and
"by_shape" splits them by phase; a launch whose inputs equal an earlier
one's is held against that plain output. The line before the last is
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
import signal
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
#: the chaos phase's per-call deadline on the plane's launches and
#: collects (the hung collect is cut at it)
CHAOS_DEADLINE_S = 0.5


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

    def held_bytes(self, phase: str) -> int:
        """Device bytes the recorded launches of a phase keep alive (their
        inputs and outputs, each storage once)."""
        seen, n = set(), 0
        for c in self.calls:
            if c["phase"] != phase:
                continue
            out = c["out"] if isinstance(c["out"], tuple) else (c["out"],)
            for t in list(c["args"].values()) + list(out):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    st = t.untyped_storage()
                    if st.data_ptr() not in seen:
                        seen.add(st.data_ptr())
                        n += st.nbytes()
        return n


def _same_inputs(a, b, keys) -> bool:
    for k in keys:
        x, y = a[k], b[k]
        if isinstance(x, torch.Tensor):
            if x.shape != y.shape or not torch.equal(x, y):
                return False
        elif x != y:
            return False
    return True


def _cached(cache, kernel, a, keys):
    for kern, args, out, ms in cache:
        if kern == kernel and _same_inputs(a, args, keys):
            return out, ms
    return None


def plain_once(cache, kernel, a, keys, run_plain):
    """The plain version's output and ms on inputs a, run once per
    distinct input: a launch whose inputs equal an earlier replayed
    launch's (the plane's north star and burst repeat the sequential
    phases' work) is held against that plain output, which is the plain
    version on the same inputs."""
    hit = _cached(cache, kernel, a, keys)
    if hit is not None:
        return hit[0], hit[1], True
    plain = []
    ms = cuda_ms(lambda: plain.append(run_plain()), reps=0)
    cache.append((kernel, a, plain[-1], ms))
    return plain[-1], ms, False


def replay(calls, bs, kf, cache) -> list:
    """Every recorded launch again: its recorded output held against the
    plain version on the same inputs (exact), the kernel timed on those
    inputs (CUDA events) and the plain version once per distinct input
    (plain_once), with the bound. One row per launch."""
    rows = []
    for c in calls:
        a = c["args"]
        if c["kernel"] == "bitset_scan":
            def run():
                return bs.bitset_scan(
                    a["win"], a["meta"], a["fr_in"], a["model"], a["S"],
                    a["W"], exact=a["exact"], placement=a["placement"])

            plain, plain_ms, reused = plain_once(
                cache, "bitset_scan", a,
                ("model", "S", "W", "exact", "win", "meta", "fr_in"),
                lambda: bs.bitset_scan_plain(
                    a["win"], a["meta"], a["fr_in"], a["model"], a["S"],
                    a["W"], exact=a["exact"]))
            (o_k, f_k), (o_p, f_p) = c["out"], plain
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

            o_p, plain_ms, reused = plain_once(
                cache, "kfrontier_scan", a, ("model", "K", "W", "win", "meta"),
                lambda: kf.kfrontier_scan_plain(
                    a["win"], a["meta"], a["model"], a["K"], a["W"]))
            o_k = c["out"]
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
            plain_ms=plain_ms, plain_reused=reused, plain_on="cuda",
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err, **shape))
    return rows


# -- the later phases' plain versions, on the host's cores --------------------

#: the inputs each kernel's launches are compared on
_KEYS = {"bitset_scan": ("model", "S", "W", "exact", "win", "meta", "fr_in"),
         "kfrontier_scan": ("model", "K", "W", "win", "meta")}


def _plain_job(kernel, arrays, params):
    """One plain-version run on CPU tensors, in a pool worker: (its
    outputs as arrays, milliseconds)."""
    torch.set_num_threads(1)
    t = [torch.from_numpy(a) for a in arrays]
    t0 = time.perf_counter()
    if kernel == "bitset_scan":
        from jepsen_tpu_torch.checker.wgl_bitset import bitset_scan_plain

        out = bitset_scan_plain(*t, params["model"], params["S"],
                                params["W"], exact=params["exact"])
    elif kernel == "kfrontier_scan":
        from jepsen_tpu_torch.checker.wgl_kfrontier import (
            kfrontier_scan_plain,
        )

        out = (kfrontier_scan_plain(*t, params["model"], params["K"],
                                    params["W"]),)
    else:  # the warm-up: import the plain versions
        import jepsen_tpu_torch.checker.wgl_bitset  # noqa: F401
        import jepsen_tpu_torch.checker.wgl_kfrontier  # noqa: F401

        out = ()
    return [o.numpy() for o in out], 1e3 * (time.perf_counter() - t0)


class PlainPool:
    """The plain versions of the later phases' launches, on CPU copies
    of their inputs in spawned worker processes (one torch thread each)
    while the card runs on. The plain version on CUDA tensors reads the
    host at every step, about a millisecond a step, too slow for the
    streaming phases' hundreds of thousands of return steps. Each
    distinct row of a launch (its win, meta and fr_in) runs once."""

    def __init__(self, workers: int):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        self.workers = workers
        self._ex = ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("spawn"))
        self._rows = {}
        for _ in range(workers):
            self._ex.submit(_plain_job, "warm", [], {})

    def row(self, kernel, arrays, params):
        """The future of the plain version on one row's arrays."""
        import hashlib

        h = hashlib.sha1(repr((kernel, sorted(params.items()))).encode())
        for a in arrays:
            h.update(repr(a.shape).encode())
            h.update(a.tobytes())
        key = h.hexdigest()
        fut = self._rows.get(key)
        if fut is None:
            fut = self._rows[key] = self._ex.submit(
                _plain_job, kernel, arrays, params)
        return fut

    def close(self) -> None:
        self._ex.shutdown(wait=True, cancel_futures=True)


def replay_rows(calls, bs, kf, cache, pool) -> list:
    """replay() for the later phases: every recorded launch's output
    held against the plain version on the same inputs, exactly. A
    launch whose inputs equal an earlier replayed launch's reuses that
    plain output (plain_once's cache); any other runs row by row on the
    pool (PlainPool), each distinct row once (a stacked launch of many
    streams of a few histories has a few distinct rows). The kernel is
    timed on the card meanwhile, as replay() times it."""
    pending = []
    for c in calls:
        a, kernel = c["args"], c["kernel"]
        hit = _cached(cache, kernel, a, _KEYS[kernel])
        futs = None
        if hit is None:
            if kernel == "bitset_scan":
                params = dict(model=a["model"], S=a["S"], W=a["W"],
                              exact=a["exact"])
                names = ("win", "meta", "fr_in")
            else:
                params = dict(model=a["model"], K=a["K"], W=a["W"])
                names = ("win", "meta")
            host = [a[k].cpu().numpy() for k in names]
            futs = [pool.row(kernel, [x[i:i + 1] for x in host], params)
                    for i in range(host[0].shape[0])]
        if kernel == "bitset_scan":
            def run(a=a):
                return bs.bitset_scan(
                    a["win"], a["meta"], a["fr_in"], a["model"], a["S"],
                    a["W"], exact=a["exact"], placement=a["placement"])
        else:
            def run(a=a):
                return kf.kfrontier_scan(a["win"], a["meta"], a["model"],
                                         a["K"], a["W"])
        once = cuda_ms(run, reps=0)
        ms = cuda_ms(run, reps=3 if once > 20 else 20)
        pending.append((c, hit, futs, ms))
    rows = []
    for c, hit, futs, ms in pending:
        a, kernel = c["args"], c["kernel"]
        got = c["out"] if kernel == "bitset_scan" else (c["out"],)
        if hit is not None:
            plain = hit[0] if kernel == "bitset_scan" else (hit[0],)
            plain_ms, n_rows = hit[1], None
        else:
            done = [f.result() for f in futs]
            plain = [torch.from_numpy(np.concatenate([d[0][j] for d in done]))
                     for j in range(len(got))]
            seen = {id(f): d[1] for f, d in zip(futs, done)}
            plain_ms, n_rows = sum(seen.values()), len(seen)
        err = max(abs_err(g.cpu(), p.cpu()) for g, p in zip(got, plain))
        check(err == 0, f"{kernel} != plain on a {c['phase']} launch: "
              f"{got[0][:, 0].tolist()} vs {plain[0][:, 0].tolist()}")
        if kernel == "bitset_scan":
            b_ms, b_by = bitset_bound(a["win"], a["meta"], a["fr_in"],
                                      got[0], a["S"], a["W"], a["model"],
                                      a["exact"])
            live = a["meta"].view(a["meta"].shape[0], -1,
                                  bs.META_COLS)[:, :, 1]
            padded = a["win"].shape[1] // (4 * a["W"])
            shape = dict(S=a["S"], exact=a["exact"],
                         geometry=str(bs.geometry(a["W"], a["S"],
                                                  a["placement"])))
        else:
            b_ms, b_by = kfrontier_bound(a["win"], a["meta"], got[0],
                                         a["K"], a["W"])
            live = a["meta"][:, :, 0, 1]
            padded = int(a["meta"].shape[1])
            shape = dict(K=a["K"], model=a["model"])
        steps = int((live == 1).sum())
        rows.append(dict(
            phase=c["phase"], kernel=kernel, keys=a["win"].shape[0],
            W=a["W"], padded_steps=padded, return_steps=steps, ms=ms,
            us_per_step=1e3 * ms / max(steps, 1), plain_ms=plain_ms,
            plain_reused=hit is not None,
            plain_on="cuda" if hit is not None else "cpu",
            plain_rows=n_rows, bound_ms=b_ms, bound_by=b_by,
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
            plain_on=sorted({r["plain_on"] for r in rs}),
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


# -- the dispatch plane ------------------------------------------------------


def assert_not_degraded(outs, what: str) -> None:
    """No hidden fallback: outside the chaos phase no verdict went down
    the plane's ladder to the host oracle."""
    from jepsen_tpu_torch.checker import chaos

    res = chaos.resilience_snapshot()
    check(res["oracle_fallbacks"] == 0 and res["degradations"] == 0,
          f"{what}: the host oracle stood in for the device: {res}")
    for o in outs:
        check("degraded" not in o, f"{what}: a degraded verdict: {o}")


def same_verdict(got: dict, want: dict, what: str) -> None:
    for k in ("valid?", "failed_op_index"):
        check(got.get(k) == want.get(k), f"{what}: {k} {got} vs {want}")


def plane_summary(dp) -> dict:
    st = dp.dispatch_stats()
    return {k: st[k] for k in (
        "requests", "batches", "batched_requests", "solo_launches",
        "fallbacks", "max_batch", "mean_batch_occupancy",
        "floor_amortization", "coalesce_wait_us", "mean_coalesce_wait_us",
        "train_registers", "double_buffer_occupancy",
        "backpressure_collects", "native_wins")}


def sentry_corrupted(h, History):
    """A copy of h with an inversion (an invoke and its completion, the
    very next op, swapped; the process's previous op has another f, so
    the sentry reads it as an inversion and not a double completion) and
    a duplicate index ten ops away. The hand-cleaned history is h."""
    ops = list(h.ops)
    last_f: dict = {}
    p = None
    for i in range(len(ops) - 1):
        o, nxt = ops[i], ops[i + 1]
        if (o.is_invoke and nxt.process == o.process and not nxt.is_invoke
                and last_f.get(o.process) != o.f and i >= 20):
            p = i
            break
        if not o.is_invoke:
            last_f[o.process] = o.f
    check(p is not None, "an adjacent invoke/completion pair")
    ops[p], ops[p + 1] = ops[p + 1], ops[p]
    q = p + 10
    ops[q] = ops[q].with_(index=ops[q - 1].index)
    return History(ops, indexed=True)


def chaos_stream(c: dict, hists, wants) -> dict:
    """Faults on the plane's stream bucket: 4 streams (one invalid)
    append their histories in two halves on one plane, the second half
    under a fault. A transient launch fault retries to parity; a
    persistent one fails the riders with the PlaneFault (the stream
    bucket has no oracle arm) and each stream re-runs that append on
    its solo chain, kernel A on the card from its device-resident
    frontier, counted in plane_fallbacks, with the same verdict. A
    counted path (chaos_stream): every launch is replayed."""
    from jepsen_tpu_torch.checker import streaming as sm

    dp, chaos = c["dp"], c["chaos"]

    def run(fault):
        sm.reset_stream_stats()
        chaos.reset_resilience()
        with dp.DispatchPlane(device=None, race=False) as plane:
            scs = [sm.StreamingCheck(plane=plane) for _ in hists]
            for k in range(2):
                for sc, h in zip(scs, hists):
                    ops = list(h.ops)
                    chunk = ops[:len(ops) // 2] if k == 0 else \
                        ops[len(ops) // 2:]
                    if k == 1 and fault is not None:
                        with chaos.chaos_plan(fault()):
                            sc.append(chunk)
                    else:
                        sc.append(chunk)
            outs = [sc.result() for sc in scs]
        return outs, sm.stream_stats(), chaos.resilience_snapshot()

    out = {}
    c["start"]("chaos_stream")
    for name, fault in (
        ("clean", None),
        ("transient", lambda: chaos.transient_fault(site="launch",
                                                    times=1)),
        ("persistent", lambda: chaos.persistent_device_fault("cuda:0")),
    ):
        got, sst, res = run(fault)
        for o, want in zip(got, wants):
            same_verdict(o, want, f"chaos stream {name}")
        check(res["oracle_fallbacks"] == 0 and res["degradations"] == 0,
              f"chaos stream {name}: {res}")
        if name == "persistent":
            check(sst["plane_fallbacks"] >= 1
                  and sst["tail_launches"] >= sst["plane_fallbacks"]
                  and res["plane_faults"] == sst["plane_fallbacks"],
                  f"chaos stream persistent: {sst} {res}")
        else:
            check(sst["plane_fallbacks"] == 0,
                  f"chaos stream {name}: {sst}")
        if name == "transient":
            check(res["retries"] >= 1, f"chaos stream {res}")
        out[name] = dict(stream=sst, resilience=res,
                         valid=[o["valid?"] for o in got])
    out["kernel_launches"] = c["stop"]("chaos_stream", ["bitset_scan"])
    chaos.reset_resilience()
    return out


def plane_phases(ctx: dict) -> None:
    """The dispatch plane's phases: plane_config1, plane_burst,
    plane_northstar and plane_queue are main-path paths (counts from 0,
    every launch recorded and replayed in batch_parity); race, chaos and
    sentry check the racer, the fault ladder and the history sentry on
    the card. Each holds its verdicts against the sequential path's on
    the same histories."""
    from jepsen_tpu_torch.checker.linearizable import (
        LinearizableChecker,
        check_queue_by_value,
    )
    from jepsen_tpu_torch.history.history import History

    c = ctx
    dp, lin, chaos, ev_mod = c["dp"], c["lin"], c["chaos"], c["ev_mod"]
    snap = c["launch_stats_snapshot"]
    start, stop = c["start"], c["stop"]

    with Phase("plane_config1") as info:
        # config 1's 10 histories through check_async, all submitted
        # before any is resolved: one plane, one shared launch train
        plane = dp.DispatchPlane(device=None, race=False)
        pchecker = LinearizableChecker("cas-register", plane=plane)
        dp.reset_dispatch_stats()
        start("plane_config1")
        t0 = time.perf_counter()
        resolvers = [pchecker.check_async(None, h)
                     for h in c["config1_hists"]]
        plane.flush()
        outs = [r() for r in resolvers]
        wall = time.perf_counter() - t0
        stats = snap()
        pst = plane_summary(dp)
        counts = stop("plane_config1", ["bitset_scan"])
        plane.close()
        for i, (o, want) in enumerate(zip(outs, c["config1_rows"])):
            same_verdict(o, want, f"plane_config1 history {i}")
        assert_not_degraded(outs, "plane_config1")
        dead = sum(1 for o in outs if o["valid?"] is False)
        # host syncs: one per collected train, one per exact re-run of a
        # batch, and one per dead rider's sequential re-check (whose own
        # exact re-run is an escalation too)
        collects = stats["host_syncs"] - stats["escalations"] - dead
        check(1 <= collects <= pst["train_registers"],
              f"plane_config1 syncs {stats} {pst}")
        info.update(
            wall_s=wall, sequential_wall_s=c["config1_wall"],
            config1_batch_wall_s=c["batch_wall"], invoked_ops=10_000,
            ops_per_s=10_000 / wall, methods=[o["method"] for o in outs],
            trains_collected=collects, launch=stats, dispatch=pst,
            kernel_launches=counts)

    with Phase("plane_burst") as info:
        # 128 keys of the keys_scale generator, each its own check_async
        # request, prepped on the plane's worker thread (async_prep),
        # with the default coalesce hold and batch cap
        plane = dp.DispatchPlane(device=None, race=False, async_prep=True)
        pchecker = LinearizableChecker("cas-register", plane=plane)
        dp.reset_dispatch_stats()
        start("plane_burst")
        t0 = time.perf_counter()
        resolvers = [pchecker.check_async(None, h)
                     for h in c["scale_hists"]]
        outs = [r() for r in resolvers]
        wall = time.perf_counter() - t0
        stats = snap()
        pst = plane_summary(dp)
        counts = stop("plane_burst", ["bitset_scan"])
        plane.close()
        check([o["valid?"] for o in outs]
              == [r["valid?"] for r in c["scale_res"]],
              "plane_burst verdicts != check_keys'")
        check(dp.DISPATCH_STATS["worker_errors"] == 0, "worker errors")
        assert_not_degraded(outs, "plane_burst")
        info.update(keys=len(outs), wall_s=wall, invoked_ops=625 * 128,
                    ops_per_s=625 * 128 / wall, launch=stats,
                    dispatch=pst, kernel_launches=counts,
                    coalesce_hold_s=dp.COALESCE_HOLD_S,
                    max_batch_cap=dp.MAX_BATCH)

    with Phase("plane_northstar") as info:
        plane = dp.DispatchPlane(device=None, race=False)
        dp.reset_dispatch_stats()
        start("plane_northstar")
        t0 = time.perf_counter()
        ev = ev_mod.history_to_events(c["north_h"])
        t_prep = time.perf_counter() - t0
        out = plane.submit(ev).result()
        wall = time.perf_counter() - t0
        stats = snap()
        pst = plane_summary(dp)
        counts = stop("plane_northstar", ["bitset_scan"])
        plane.close()
        check(stats == {"launches": 1, "escalations": 0, "host_syncs": 1,
                        "donated_buffers": 0}, f"plane_northstar {stats}")
        check(pst["solo_launches"] == 1 and out["method"]
              == "gpu-wgl-bitset", f"plane_northstar {out} {pst}")
        same_verdict(out, c["north_r"], "plane_northstar")
        assert_not_degraded([out], "plane_northstar")
        info.update(wall_s=wall, history_to_events_s=t_prep,
                    submit_to_verdict_s=wall - t_prep,
                    sequential_e2e_wall_s=c["north_r"]["wall_s"],
                    invoked_ops=100_000, ops_per_s=100_000 / wall,
                    launch=stats, dispatch=pst, kernel_launches=counts)

    with Phase("plane_queue") as info:
        plane = dp.DispatchPlane(device=None, race=False)
        qchecker = LinearizableChecker("unordered-queue", plane=plane,
                                       race=False)
        dp.reset_dispatch_stats()
        start("plane_queue")
        t0 = time.perf_counter()
        a = check_queue_by_value(c["queue_hist"], "unordered-queue",
                                 plane=plane, race=False)
        b = qchecker.check(None, c["queue_hist"])
        bad = qchecker.check(None, c["queue_hc"])
        wall = time.perf_counter() - t0
        pst = plane_summary(dp)
        counts = stop("plane_queue", ["kfrontier_scan"])
        plane.close()
        for got in (a, b):
            check(got["valid?"] is True and got["n_values"] == 32
                  and got["method"] == "per-value:gpu-wgl-batchx32",
                  f"plane_queue: {got}")
        for k in ("valid?", "failed_value", "failed_op_index", "n_values"):
            check(bad.get(k) == c["queue_rc"].get(k),
                  f"plane_queue overdrawn {k}: {bad} vs {c['queue_rc']}")
        assert_not_degraded([a, b, bad], "plane_queue")
        info.update(values=a["n_values"], method=a["method"],
                    wall_s=wall, check_wall_s=[b["wall_s"], bad["wall_s"]],
                    sequential_check_wall_s=[c["queue_r"]["wall_s"],
                                             c["queue_rc"]["wall_s"]],
                    overdrawn_failed_value=bad["failed_value"],
                    overdrawn_failed_op_index=bad["failed_op_index"],
                    dispatch=pst, kernel_launches=counts)

    with Phase("race") as info:
        # config 1 with the native oracle racing the card, sequentially
        # and through a racing plane (not a counted path: a native win
        # leaves its launch's result unread)
        lin.reset_race_stats()
        rchecker = LinearizableChecker("cas-register", race=True)
        seq = [rchecker.check(None, h) for h in c["config1_hists"]]
        after_seq = dict(lin.RACE_STATS)
        plane = dp.DispatchPlane(device=None, race=True)
        pchecker = LinearizableChecker("cas-register", plane=plane)
        resolvers = [pchecker.check_async(None, h)
                     for h in c["config1_hists"]]
        plane.flush()
        planed = [r() for r in resolvers]
        plane.close()
        for i, (o, p, want) in enumerate(zip(seq, planed,
                                             c["config1_rows"])):
            same_verdict(o, want, f"race sequential {i}")
            same_verdict(p, want, f"race plane {i}")
        st = dict(lin.RACE_STATS)
        check(st["mismatches"] == 0, f"race mismatches {st}")
        check(after_seq["gpu_wins"] + after_seq["native_wins"] == 10,
              f"race: every sequential check raced once {after_seq}")
        check(st["gpu_wins"] + st["native_wins"] == 20,
              f"race: every request raced once {st}")
        assert_not_degraded(seq + planed, "race")
        info.update(race_stats=st, sequential_race_stats=after_seq,
                    winners=[o.get("race_winner", "gpu") for o in seq],
                    plane_winners=[o.get("race_winner", "gpu")
                                   for o in planed])

    with Phase("chaos") as info:
        # injected faults on a plane over 4 of config 1's histories (one
        # corrupted): a transient launch fault retries to parity; a
        # sticky device fault and an oom each fail every rider with its
        # PlaneFault on the card's default plane, and degrade to the
        # host oracle (degraded set) only on a plane built with
        # degrade=True; a hung collect is cut at its deadline and
        # retried; a Python error in the launch wrapper reaches the
        # caller as it is; then a real allocation past the card's memory
        hists = [c["config1_hists"][i] for i in (0, 1, 2, 8)]
        wants = [c["config1_rows"][i] for i in (0, 1, 2, 8)]
        evs = [ev_mod.history_to_events(h) for h in hists]

        def run(**kw):
            """Each rider's verdict, or the exception its result()
            raised."""
            with dp.DispatchPlane(device=None, race=False, **kw) as plane:
                futs = [plane.submit(e) for e in evs]
                plane.flush()
                outs = []
                for f in futs:
                    try:
                        outs.append(f.result())
                    except Exception as e:  # noqa: BLE001 - checked below
                        outs.append(e)
                return outs

        def strip(o):
            return {k: v for k, v in o.items() if k != "method"}

        clean = run()
        for o, want in zip(clean, wants):
            same_verdict(o, want, "chaos clean")

        def broken_launch(*a, **k):
            raise ValueError("a bug in the launch wrapper")

        cases = {}
        for name, fault, kw, expect in (
            ("transient", chaos.transient_fault(site="launch", times=1),
             {}, "parity"),
            ("persistent", chaos.persistent_device_fault("cuda:0"), {},
             "raise fatal"),
            ("persistent_degrade", chaos.persistent_device_fault("cuda:0"),
             {"degrade": True}, "degrade fatal"),
            ("oom", chaos.oom_fault(site="launch", times=None), {},
             "raise oom"),
            ("oom_degrade", chaos.oom_fault(site="launch", times=None),
             {"degrade": True}, "degrade oom"),
            ("hang", chaos.hang_fault(
                site="collect", times=1, delay_s=10 * CHAOS_DEADLINE_S),
             {"launch_deadline_s": CHAOS_DEADLINE_S}, "parity"),
            ("program_error", None, {"degrade": True}, "error"),
        ):
            chaos.reset_resilience()
            real_launch = c["bs"].launch_keys_bitset
            if fault is None:
                c["bs"].launch_keys_bitset = broken_launch
            t0 = time.perf_counter()
            try:
                with chaos.chaos_plan(*([fault] if fault else [])):
                    got = run(**kw)
            finally:
                c["bs"].launch_keys_bitset = real_launch
            secs = time.perf_counter() - t0
            res = chaos.resilience_snapshot()
            how, _, kind = expect.partition(" ")
            for o, want, cl in zip(got, wants, clean):
                if how == "raise":
                    check(isinstance(o, chaos.PlaneFault) and o.kind == kind,
                          f"chaos {name}: {o!r}")
                    continue
                if how == "error":
                    check(isinstance(o, ValueError), f"chaos {name}: {o!r}")
                    continue
                check(isinstance(o, dict), f"chaos {name}: {o!r}")
                same_verdict(o, want, f"chaos {name}")
                if how == "parity":
                    check(strip(o) == strip(cl), f"chaos {name}: {o} vs {cl}")
                else:
                    check(o.get("degraded", {}).get("kind") == kind
                          and o["method"].startswith("cpu-oracle"),
                          f"chaos {name}: {o}")
            if name == "hang":
                check(res["deadline_hits"] >= 1 and res["retries"] >= 1,
                      f"chaos hang: {res}")
            if how == "degrade":
                check(res["oracle_fallbacks"] == len(evs)
                      and res["degradations"] >= 1, f"chaos {name}: {res}")
            else:
                check(res["oracle_fallbacks"] == 0
                      and res["degradations"] == 0, f"chaos {name}: {res}")
            if how == "raise":
                check(res["plane_faults"] == len(evs), f"chaos {name}: {res}")
            if how == "error":
                check(res["retries"] == 0, f"chaos {name}: {res}")
            cases[name] = {"seconds": secs, "resilience": res,
                           "outcomes": [o["method"] if isinstance(o, dict)
                                        else repr(o) for o in got]}
        # a real out-of-memory error, through the same guard
        chaos.reset_resilience()
        total = torch.cuda.get_device_properties(0).total_memory
        try:
            chaos.resilient_call(
                lambda: torch.empty(2 * total, dtype=torch.uint8,
                                    device="cuda"),
                site="launch", devices=["cuda:0"])
            check(False, "an allocation of twice the card's memory worked")
        except chaos.PlaneFault as pf:
            check(pf.kind == "oom"
                  and type(pf.cause).__name__ == "OutOfMemoryError",
                  f"real OOM classified as {pf.kind}: {pf}")
            cases["real_oom"] = pf.describe()
        torch.cuda.empty_cache()
        chaos.reset_resilience()
        cases["stream"] = chaos_stream(c, hists, wants)
        info.update(cases=cases)

    with Phase("sentry") as info:
        # a corrupted copy of config 1's corrupted history 8: the sentry
        # repairs it, names both classes, and the verdict is the
        # hand-cleaned (original) history's
        h = c["config1_hists"][8]
        bad = sentry_corrupted(h, History)
        sc = LinearizableChecker("cas-register", race=False)
        got = sc.check(None, bad)
        want = sc.check(None, h)
        rep = got.get("history_report", {})
        check({"duplicate_index", "inversion"} <= set(rep.get("detected",
                                                          {})),
              f"sentry report {rep}")
        check("history_report" not in want, f"clean history: {want}")
        same_verdict(got, want, "sentry")
        same_verdict(got, c["config1_rows"][8], "sentry vs config1")
        assert_not_degraded([got, want], "sentry")
        info.update(history_report=rep, valid=got["valid?"],
                    failed_op_index=got.get("failed_op_index"))


# -- durable checks and streams ----------------------------------------------


class Die(Exception):
    """The in-process crash: raised from a sink's after_save hook."""


def clean_cuts(ops, n_chunks):
    """Cut points near each 1/n_chunks of ops where no invoke is open:
    appends of whole operations (a cut through an open invoke rewrites
    the checked prefix when its completion arrives, and the stream
    re-checks from step 0 by design)."""
    open_ops, clean = {}, []
    for i, op in enumerate(ops):
        if op.is_invoke:
            open_ops[op.process] = open_ops.get(op.process, 0) + 1
        elif op.process in open_ops:
            open_ops[op.process] -= 1
            if not open_ops[op.process]:
                del open_ops[op.process]
        if not open_ops:
            clean.append(i + 1)
    cuts, j = [0], 0
    for k in range(1, n_chunks):
        want = k * len(ops) // n_chunks
        while j < len(clean) and clean[j] < want:
            j += 1
        if j < len(clean) and clean[j] > cuts[-1]:
            cuts.append(clean[j])
    if cuts[-1] != len(ops):
        cuts.append(len(ops))
    return cuts


def durable_stream_phases(ctx: dict) -> None:
    """The durable checks and the streaming checker on the card, each a
    path of the main path (counts from 0, launches recorded and
    replayed against the plain versions): durable_northstar,
    durable_plane, stream_northstar, streams_1k, stream_gc and
    stream_deferred. Each holds its verdicts against the sequential
    path's on the same histories."""
    import math
    import shutil
    import tempfile
    import threading

    from jepsen_tpu_torch.checker import streaming as sm
    from jepsen_tpu_torch.checker.checkpoint import (
        CheckpointSink,
        checkpoint_stats,
        reset_checkpoint_stats,
    )
    from jepsen_tpu_torch.checker.linearizable import (
        LinearizableChecker,
        check_events_bucketed,
    )

    c = ctx
    dp, ev_mod, sim = c["dp"], c["ev_mod"], c["sim"]
    snap, start, stop = c["launch_stats_snapshot"], c["start"], c["stop"]
    reset = c["reset_launch_stats"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_", dir=c["scratch"])
    north_h, north_r = c["north_h"], c["north_r"]
    checker = LinearizableChecker("cas-register", race=False)

    def sink_dir(name):
        d = os.path.join(tmp, name)
        os.makedirs(d, exist_ok=True)
        return d

    try:
        with Phase("durable_northstar") as info:
            runs = {}
            ev = ev_mod.history_to_events(north_h)
            n_segs = len(c["bs"]._plan_for(ev_mod.events_to_steps(
                ev, W=c["bs"].plan(c["bs"].get_model("cas-register"),
                                   ev.window, len(ev.value_codes))[0]),
                None))

            def run(name, path, want, **kw):
                """One check of the north star, durable when path is
                given (a plain check, the same phase's baseline, when
                it is None)."""
                reset()
                reset_checkpoint_stats()
                t0 = time.perf_counter()
                sink = CheckpointSink(path, **kw) if path else None
                out = checker.check(None, north_h, checkpoint=sink)
                wall = time.perf_counter() - t0
                st = snap()
                check(st == want, f"durable_northstar {name}: {st} vs {want}")
                same_verdict(out, north_r, f"durable_northstar {name}")
                runs[name] = dict(wall_s=wall, launch=st,
                                  checkpoint=out.get("checkpoint"),
                                  checkpoint_stats=checkpoint_stats())
                return out

            def stats(n):
                return {"launches": n, "escalations": 0, "host_syncs": n,
                        "donated_buffers": 0}

            start("durable_northstar")
            one = stats(n_segs)
            run("plain", None, stats(1))
            run("every_1", sink_dir("every1"), one, every=1)
            run("every_5", sink_dir("every5"), stats(-(-n_segs // 5)),
                every=5)
            out = run("replay", sink_dir("every5"), stats(0))
            check(out["checkpoint"]["replayed_verdict"], f"replay {out}")

            def die_at_2(sink, st):
                if st.get("verdict") is None and st["segments_done"] >= 2:
                    raise Die()

            reset()
            t0 = time.perf_counter()
            try:
                checker.check(None, north_h, checkpoint=CheckpointSink(
                    sink_dir("killed"), after_save=die_at_2))
                check(False, "the killed durable run finished")
            except Die:
                pass
            runs["killed"] = dict(wall_s=time.perf_counter() - t0,
                                  launch=snap())
            out = run("resume", sink_dir("killed"), stats(n_segs - 2))
            check(out["checkpoint"]["resumed_from_segment"] == 2,
                  f"resume {out['checkpoint']}")
            # a field edited without its payload hash: a cold run
            path = os.path.join(sink_dir("every1"), "checkpoint.json")
            state = json.load(open(path))
            state["segments_done"] = 3
            json.dump(state, open(path, "w"))
            out = run("tampered", sink_dir("every1"), one)
            check(out["checkpoint"]["rejected_stale"], f"tampered {out}")
            run("plain_again", None, stats(1))
            counts = stop("durable_northstar", ["bitset_scan"])
            check(counts["bitset_scan"] == 6 * n_segs,
                  f"durable_northstar kernel launches {counts}")
            info.update(segments=n_segs, runs=runs,
                        sequential_e2e_wall_s=north_r["wall_s"],
                        kernel_launches=counts)

        with Phase("durable_plane") as info:
            evs = [ev_mod.history_to_events(h) for h in c["config1_hists"]]
            ev_n = ev_mod.history_to_events(north_h)
            rounds = []
            for rnd in ("cold", "replay"):
                phase = "durable_plane" if rnd == "cold" else \
                    "durable_plane_replay"
                plane = dp.DispatchPlane(device=None, race=False)
                dp.reset_dispatch_stats()
                reset_checkpoint_stats()
                start(phase)
                t0 = time.perf_counter()
                futs = [plane.submit(ev, checkpoint=CheckpointSink(
                    sink_dir(f"config1-{i}"))) for i, ev in enumerate(evs)]
                nfut = plane.submit(ev_n, checkpoint=CheckpointSink(
                    sink_dir("plane-northstar")))
                plane.flush()
                outs = [f.result() for f in futs]
                nout = nfut.result()
                wall = time.perf_counter() - t0
                stats = snap()
                pst = plane_summary(dp)
                ds = dp.dispatch_stats()
                counts = stop(phase, ["bitset_scan"] if rnd == "cold"
                              else [])
                plane.close()
                for i, (o, want) in enumerate(zip(outs, c["config1_rows"])):
                    same_verdict(o, want, f"durable_plane {rnd} {i}")
                same_verdict(nout, north_r, f"durable_plane {rnd} north")
                assert_not_degraded(outs + [nout], "durable_plane")
                check(ds["durable_coalesced"] == len(evs)
                      and ds["durable_solo"] == 1, f"durable_plane {ds}")
                if rnd == "replay":
                    check(counts == {"bitset_scan": 0, "kfrontier_scan": 0}
                          and stats["launches"] == 0
                          and all(o["checkpoint"]["replayed_verdict"]
                                  for o in outs + [nout]),
                          f"durable_plane replay {counts} {stats}")
                rounds.append(dict(
                    round=rnd, wall_s=wall, launch=stats, dispatch=pst,
                    durable_coalesced=ds["durable_coalesced"],
                    durable_solo=ds["durable_solo"],
                    checkpoint=ds["checkpoint"], kernel_launches=counts))
            info.update(rounds=rounds)

        with Phase("stream_northstar") as info:
            ops = list(north_h.ops)
            cuts = [len(ops) * k // 10 for k in range(11)]
            sm.reset_stream_stats()
            start("stream_northstar")
            sc = sm.StreamingCheck()
            walls, statuses = [], []
            t0 = time.perf_counter()
            for k in range(10):
                t1 = time.perf_counter()
                st = sc.append(ops[cuts[k]:cuts[k + 1]])
                walls.append(time.perf_counter() - t1)
                statuses.append({x: st[x] for x in ("valid?",
                                                    "checked_steps")})
            out = sc.result()
            wall = time.perf_counter() - t0
            stats = snap()
            sst = sm.stream_stats()
            counts = stop("stream_northstar", ["bitset_scan"])
            same_verdict(out, north_r, "stream_northstar")
            check(out["method"] == "gpu-wgl-bitset-streaming"
                  and sst["deferred"] == 0, f"stream_northstar {out}")
            info.update(append_walls_s=walls, wall_s=wall,
                        oneshot_e2e_wall_s=north_r["wall_s"],
                        invalidations=sst["invalidations"],
                        tail_steps=sst["tail_steps"],
                        tail_launches=sst["tail_launches"],
                        stream=sst, statuses=statuses, launch=stats,
                        kernel_launches=counts)

        with Phase("streams_1k") as info:
            n_streams, rounds, chunk, n_distinct, hold = (
                STREAMS_1K[k] for k in ("streams", "rounds", "chunk",
                                        "distinct", "hold_s"))
            hists = [sim.gen_register_history(
                random.Random(7300 + i), n_ops=rounds * chunk, n_procs=4,
                p_crash=0.0) for i in range(n_distinct)]
            refs = [check_events_bucketed(ev_mod.history_to_events(h),
                                          race=False) for h in hists]
            plane = dp.DispatchPlane(device=None, race=False)
            scs = [sm.StreamingCheck(plane=plane, hold_s=hold)
                   for _ in range(n_streams)]
            finals = [None] * n_streams
            errs = []
            barrier = threading.Barrier(n_streams)
            round_walls = [[] for _ in range(rounds)]

            def drive(i):
                try:
                    ops = list(hists[i % n_distinct].ops)
                    for r in range(rounds):
                        barrier.wait(timeout=600)
                        t1 = time.perf_counter()
                        scs[i].append(ops[r * chunk:] if r == rounds - 1
                                      else ops[r * chunk:(r + 1) * chunk])
                        round_walls[r].append(time.perf_counter() - t1)
                    finals[i] = scs[i].result()
                except Exception as e:  # noqa: BLE001 - raised below
                    errs.append(e)

            dp.reset_dispatch_stats()
            sm.reset_stream_stats()
            start("streams_1k")
            t0 = time.perf_counter()
            threads = [threading.Thread(target=drive, args=(i,))
                       for i in range(n_streams)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=900)
            wall = time.perf_counter() - t0
            stats = snap()
            sst = sm.stream_stats()
            ds = dp.dispatch_stats()
            counts = stop("streams_1k", ["bitset_scan"])
            plane.close()
            check(not errs and not any(th.is_alive() for th in threads),
                  f"streams_1k: {errs[:3]}")
            appends = n_streams * rounds
            limit = 1.25 * math.ceil(appends / dp.MAX_BATCH) + rounds
            check(stats["launches"] <= limit,
                  f"streams_1k: {stats['launches']} launches for {appends} "
                  f"appends, bound {limit}")
            check(sst["plane_fallbacks"] == 0, f"streams_1k {sst}")
            for i, out in enumerate(finals):
                same_verdict(out, refs[i % n_distinct], f"streams_1k {i}")
            info.update(streams=n_streams, rounds=rounds,
                        appends=appends, wall_s=wall,
                        append_walls_s_min_max=[[min(w), max(w)]
                                                for w in round_walls],
                        hold_s=hold,
                        launches=stats["launches"], launch_bound=limit,
                        stream_batches=ds["stream_batches"],
                        stream_requests=ds["stream_requests"],
                        max_batch=ds["max_batch"],
                        mean_batch_occupancy=ds["mean_batch_occupancy"],
                        stream=sst, launch=stats, kernel_launches=counts,
                        valid=sorted({o["valid?"] for o in finals}))
            del scs, finals

        with Phase("stream_gc") as info:
            h = sim.gen_register_history(random.Random(11),
                                         n_ops=STREAM_GC["n_ops"],
                                         n_procs=5, p_crash=0.0)
            ops = list(h.ops)
            cuts = clean_cuts(ops, STREAM_GC["appends"])
            gc_window = STREAM_GC["gc_window"]
            plane = dp.default_plane()
            sm.reset_stream_stats()
            start("stream_gc")
            sc = sm.StreamingCheck(plane=plane, gc_window=gc_window)
            kept, frontier_bytes, mem, walls = [], set(), [], []
            t0 = time.perf_counter()
            for a, b in zip(cuts, cuts[1:]):
                t1 = time.perf_counter()
                st = sc.append(ops[a:b])
                walls.append(time.perf_counter() - t1)
                check(st["valid?"] is True, f"stream_gc append {st}")
                res = sc.device_residency()
                kept.append(res["retained_ops"])
                frontier_bytes.add(res["frontier_bytes"])
                # the card's allocated bytes, and those less what the
                # launch recorder keeps alive for the replay
                raw = torch.cuda.memory_allocated()
                mem.append((raw, raw - c["recorded_bytes"]("stream_gc")))
            out = sc.result()
            wall = time.perf_counter() - t0
            stats = snap()
            sst = sm.stream_stats()
            counts = stop("stream_gc", ["bitset_scan"])
            longest = max(b - a for a, b in zip(cuts, cuts[1:]))
            check(out["valid?"] is True and sst["gc_seals"] > 0,
                  f"stream_gc {out} {sst}")
            check(max(kept) <= gc_window + longest + 5,
                  f"stream_gc retained {max(kept)} ops")
            check(len(frontier_bytes - {0}) == 1,
                  f"stream_gc frontier bytes {frontier_bytes}")
            info.update(op_records=len(ops), appends=len(cuts) - 1,
                        gc_window=gc_window, longest_append=longest,
                        retained_ops_max=max(kept),
                        retained_ops_last=kept[-1],
                        frontier_bytes=sorted(frontier_bytes),
                        memory_allocated_spread=(
                            max(m[0] for m in mem) - min(m[0] for m in mem)),
                        memory_less_recorder_min=min(m[1] for m in mem),
                        memory_less_recorder_max=max(m[1] for m in mem),
                        memory_less_recorder_spread=(
                            max(m[1] for m in mem) - min(m[1] for m in mem)),
                        wall_s=wall, append_wall_s_max=max(walls),
                        append_wall_s_mean=sum(walls) / len(walls),
                        stream=sst, launch=stats, kernel_launches=counts,
                        archived_ops=sc.device_residency()["archived_ops"])

        with Phase("stream_deferred") as info:
            got = {}
            start("stream_deferred")
            for name, h in (("valid", c["ladder_h"]),
                            ("corrupted", c["ladder_hc"])):
                sm.reset_stream_stats()
                ops = list(h.ops)
                sc = sm.StreamingCheck()
                seen = [sc.append(ops[len(ops) * k // 4:
                                      len(ops) * (k + 1) // 4])["deferred"]
                        for k in range(4)]
                got[name] = (seen, sc.result(), sm.stream_stats())
            counts = stop("stream_deferred", ["kfrontier_scan"])
            for name, want in (("valid", c["ladder_r"]),
                               ("corrupted", c["ladder_rc"])):
                seen, out, sst = got[name]
                same_verdict(out, want, f"stream_deferred {name}")
                check(seen[-1] is True and out["method"]
                      == "gpu-wgl-kfrontier", f"stream_deferred {out}")
            info.update(
                kernel_launches=counts,
                cases={k: dict(deferred=v[0], method=v[1]["method"],
                               valid=v[1]["valid?"],
                               failed_op_index=v[1].get("failed_op_index"),
                               stream=v[2]) for k, v in got.items()})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def columnar_phases(ctx: dict) -> None:
    """BASELINE configs 3-5 and the counter: the columnar checkers,
    whose device programs are torch ops (no hand-written kernel), each
    verdict held against the port's numpy path on the same input. None
    of them may launch a WGL kernel."""
    from jepsen_tpu_torch.checker import adya, bank, longfork
    from jepsen_tpu_torch.checker import dispatch as dp
    from jepsen_tpu_torch.checker import reductions as red
    from jepsen_tpu_torch.history.history import History
    from jepsen_tpu_torch.history.ops import invoke_op, ok_op

    dev, sim, bs, kf = ctx["dev"], ctx["sim"], ctx["bs"], ctx["kf"]
    snapshot, reset = ctx["launch_stats_snapshot"], ctx["reset_launch_stats"]
    wgl = (bs.bitset_scan.launches, kf.kfrontier_scan.launches)

    def timed(fn):
        reset()
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0, snapshot()

    with Phase("config3") as info:
        # bench.py:1597's shape: tidb bank, 50k ops, 8 accounts
        test = {"accounts": list(range(8)), "total_amount": 100}
        h = sim.gen_bank_history(random.Random(33), n_ops=50_000,
                                 n_accounts=8, total=100)
        t0 = time.perf_counter()
        plane = bank.BankChecker.encode(test, h)
        encode_s = time.perf_counter() - t0
        check(plane.bal.size < bank._DEVICE_CELLS,
              f"config3 has {plane.bal.size} cells: not a host check")
        r, wall, st = timed(lambda: bank.BankChecker().check(test, plane))
        check(r["valid?"] is True and r["read_count"] > 20_000,
              f"config3: {r['valid?']} {r['read_count']}")
        check(st["host_syncs"] == 0, f"config3 default route {st}")
        rd, wall_dev, st_dev = timed(lambda: bank.BankChecker(
            force_device=True).check(test, plane))
        check(st_dev["host_syncs"] == 1, f"config3 card route {st_dev}")
        check(rd == r, "config3: the card's verdict != the host's")
        # one read's balance changed: a wrong total on both routes
        reads = [i for i, o in enumerate(h.ops)
                 if o.is_ok and o.f == "read"]
        i = random.Random(34).choice(reads)
        ops = list(h.ops)
        v = dict(ops[i].value)
        v[3] += 1
        ops[i] = ops[i].with_(value=v)
        hb = History(ops, indexed=True)
        rb = bank.BankChecker().check(test, hb)
        rb_dev = bank.BankChecker(force_device=True).check(test, hb)
        check(rb["valid?"] is False and rb == rb_dev
              and rb["error_count"] == 1
              and rb["first_error"]["op_index"] == ops[i].index
              and rb["first_error"]["total"] == 101.0,
              f"config3 changed read: {rb['errors']} {rb_dev['errors']}")
        bal = torch.from_numpy(plane.bal).to(dev)
        ms = cuda_ms(lambda: bank.bank_reduce_torch(bal, 100.0), reps=20)
        rows, A = plane.bal.shape
        bms, by = program_bound(plane.bal.nbytes + 4 * rows * 4,
                                4 * rows * A)
        info.update(
            op_records=len(h), reads=r["read_count"], cells=plane.bal.size,
            encode_s=encode_s, host_check_wall_s=wall,
            card_check_wall_s=wall_dev, launches=st_dev["launches"],
            host_syncs=st_dev["host_syncs"], device_program_ms=ms,
            numpy_ms=host_ms(lambda: bank._bank_reduce(
                plane.bal, 100.0, dev, False)),
            bound_ms=bms, bound_by=by,
            changed_read_index=ops[i].index)

    with Phase("config4") as info:
        # bench.py:1648's shape: cockroachdb G2, 25,000 keys (100k ops)
        h = sim.gen_g2_history(random.Random(44), n_keys=25_000)
        t0 = time.perf_counter()
        plane = adya.G2Checker.encode(h)
        encode_s = time.perf_counter() - t0
        r, wall, st = timed(lambda: adya.G2Checker().check({}, plane))
        check(r["valid?"] is True and r["key_count"] == 25_000
              and r["legal_count"] == 25_000, f"config4: {r}")
        check(st == {"launches": 0, "escalations": 0, "host_syncs": 0,
                     "donated_buffers": 0}, f"config4 is a host check: {st}")
        re2e, wall_e2e, _ = timed(lambda: adya.G2Checker().check({}, h))
        check(re2e == r, "config4 from the history != from its plane")
        k = random.Random(45).randrange(25_000)
        extra = (k, (10 ** 6, None))
        hb = History(list(h.ops) + [invoke_op(0, "insert", extra),
                                    ok_op(0, "insert", extra)])
        rb = adya.G2Checker().check({}, hb)
        check(rb["valid?"] is False and rb["illegal"] == {k: 2}
              and rb["illegal_count"] == 1, f"config4 extra insert: {rb}")
        info.update(op_records=len(h), invoked_ops=len(h) // 2,
                    encode_s=encode_s, check_wall_s=wall,
                    e2e_wall_s=wall_e2e, launches=0, host_syncs=0,
                    device_program_ms=None, extra_insert_key=k)

    with Phase("config5") as info:
        # bench.py:1702's shape: hazelcast long-fork, 128 groups of 2
        # keys x 3,906 ops (about 500k ops over 256 keys)
        t0 = time.perf_counter()
        h = sim.gen_long_fork_history(random.Random(55), n_groups=128,
                                      ops_per_group=3906, n=2)
        gen_s = time.perf_counter() - t0
        chk = longfork.LongForkChecker(2)
        solo0 = dp.DISPATCH_STATS["solo_launches"]
        r, wall, st = timed(lambda: chk.check({}, h))
        check(r["valid?"] is True and r["reads_count"] > 300_000,
              f"config5: {r}")
        check(st["launches"] == 1 and st["host_syncs"] == 1
              and dp.DISPATCH_STATS["solo_launches"] == solo0 + 1,
              f"config5: one fork launch and one sync, not {st}")
        _, glist = chk.group_states(h)
        V, live = chk.state_matrix(glist)

        def numpy_pairs(V, live):
            missed = np.einsum("grk,gsk->grs", V, 1 - V) > 0.5
            return (missed & missed.transpose(0, 2, 1)
                    & live[:, :, None] & live[:, None, :])

        check(not numpy_pairs(V, live).any(), "config5: numpy forks")
        Vd, lived = (torch.from_numpy(a).to(dev) for a in (V, live))
        ms = cuda_ms(lambda: longfork.fork_pairs_torch(Vd, lived), reps=20)
        G, S, n = V.shape
        bms, by = program_bound(V.nbytes + live.nbytes + G * S * S,
                                2 * G * S * S * n)
        # a planted fork: two reads of group 0, each seeing the write
        # the other missed
        keys = glist[0][0]
        check(all(any(o.is_ok and o.f == "write" and o.value[0][1] == k
                      for o in h.ops) for k in keys),
              f"config5: group {keys} is not fully written")
        planted = []
        for seen in ((1, None), (None, 1)):
            planted += [
                invoke_op(9, "read", [["r", k, None] for k in keys]),
                ok_op(9, "read", [["r", k, x] for k, x in zip(keys, seen)]),
            ]
        hf = History(list(h.ops) + planted)
        rf, wall_f, st_f = timed(lambda: chk.check({}, hf))
        _, glist_f = chk.group_states(hf)
        want = chk.forks(glist_f, numpy_pairs(*chk.state_matrix(glist_f)))
        check(rf["valid?"] is False and rf["forks"] == want and want,
              f"config5 planted fork: {rf.get('forks')} vs numpy {want}")
        check(st_f["launches"] == 1 and st_f["host_syncs"] == 1,
              f"config5 planted: {st_f}")
        info.update(op_records=len(h), reads=r["reads_count"],
                    groups=G, states_padded=S, gen_s=gen_s,
                    check_wall_s=wall, launches=st["launches"],
                    host_syncs=st["host_syncs"], device_program_ms=ms,
                    numpy_ms=host_ms(lambda: numpy_pairs(V, live)),
                    bound_ms=bms, bound_by=by, planted_wall_s=wall_f,
                    planted_forks=len(rf["forks"]))

    with Phase("counter") as info:
        n_ops = 200_000
        t0 = time.perf_counter()
        h = counter_history(66, n_ops)
        gen_s = time.perf_counter() - t0
        chk = red.CounterChecker()
        r, wall, st = timed(lambda: chk.check({}, h))
        check(r["valid?"] is True and len(r["reads"]) > 90_000,
              f"counter: {r['valid?']} {len(r['reads'])} reads")
        check(st["host_syncs"] == 1, f"counter's default route: {st}")
        r_np, wall_np, st_np = timed(lambda: chk.check({}, h,
                                                       force_device=False))
        check(st_np["host_syncs"] == 0 and r_np == r,
              "counter: the card's bounds != the numpy path's")
        vals, inv_add, ok_add, inv_pos, comp_pos = chk.bounds_inputs(h)
        check(vals.dtype == np.float64 and len(vals) >= 100_000,
              f"counter inputs {vals.dtype} {len(vals)}")
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (vals, inv_add, ok_add, inv_pos, comp_pos)]
        out = red.counter_bounds_torch(*args).cpu().numpy()
        lo_w = np.cumsum(np.where(ok_add, vals, 0))[inv_pos]
        hi_w = np.cumsum(np.where(inv_add, vals, 0))[comp_pos]
        check(np.array_equal(out[0], lo_w) and np.array_equal(out[1], hi_w),
              "counter: bounds not exactly equal in float64")
        ms = cuda_ms(lambda: red.counter_bounds_torch(*args), reps=20)
        n, m = len(vals), len(inv_pos)
        bms, by = program_bound(n * 8 + 2 * n + 2 * m * 8 + 4 * m * 8,
                                2 * n + 3 * m)
        # one read outside its bounds: the same errors on both routes
        reads = [i for i, o in enumerate(h.ops) if o.is_ok and o.f == "read"]
        i = reads[len(reads) // 2]
        ops = list(h.ops)
        ops[i] = ops[i].with_(value=ops[i].value + 1000)
        hb = History(ops, indexed=True)
        rb = chk.check({}, hb)
        rb_np = chk.check({}, hb, force_device=False)
        check(rb["valid?"] is False and len(rb["errors"]) == 1
              and rb["errors"] == rb_np["errors"] and rb == rb_np,
              f"counter bad read: {rb['errors']} vs {rb_np['errors']}")
        info.update(invoked_ops=n_ops, op_records=len(h), reads=m,
                    gen_s=gen_s, check_wall_s=wall, numpy_check_wall_s=wall_np,
                    launches=st["launches"], host_syncs=st["host_syncs"],
                    device_program_ms=ms,
                    numpy_ms=host_ms(lambda: (
                        np.cumsum(np.where(ok_add, vals, 0))[inv_pos],
                        np.cumsum(np.where(inv_add, vals, 0))[comp_pos])),
                    bound_ms=bms, bound_by=by, bad_error=rb["errors"])

    check((bs.bitset_scan.launches, kf.kfrontier_scan.launches) == wgl,
          "a columnar phase launched a WGL kernel")


class GraphRecorder:
    """Records every txn_graph.launch_graph_batch call: the stacks it
    was given and the counts it returned (device tensors both), for the
    per-graph parity against CPU copies after each phase."""

    def __init__(self, tg):
        self.tg, self.real, self.calls = tg, tg.launch_graph_batch, []
        tg.launch_graph_batch = self.launch

    def launch(self, wrww, allm, rw, need1=True, need2=True, mesh=None):
        out = self.real(wrww, allm, rw, need1, need2, mesh)
        self.calls.append(((wrww, allm, rw), need1, need2, out))
        return out

    def take(self) -> list:
        calls, self.calls = self.calls, []
        return calls

    def close(self) -> None:
        self.tg.launch_graph_batch = self.real


def graph_launch_rows(tg, calls) -> list:
    """Each recorded graph launch: its per-graph counts on the card held
    against graph_counts_torch on CPU copies of the same stacks (exact),
    then the program timed on its stacks by CUDA events beside its bound.
    The bound counts the stacks' bytes read and the counts written, and
    a round's 2 B N^3 operations of an exact 0/1 product at the dense
    bfloat16 tensor-core rate (BF16_FLOP_S)."""
    rows = []
    for stacks, need1, need2, out in calls:
        host = [t.cpu() for t in stacks]
        B, N = host[0].shape[0], host[0].shape[-1]
        n_iters = tg._n_iters(N)
        want = tg.graph_counts_torch(*host, n_iters, need1, need2)
        # a sharded launch pads its batch to a slot multiple: its real
        # graphs are the first B
        err = max(abs_err(g.cpu()[:B], w) for g, w in zip(out, want))
        check(err == 0, f"graph counts on the card != CPU at B={B} N={N}")
        ms = cuda_ms(lambda: tg.graph_counts_torch(*stacks, n_iters, need1,
                                                   need2), reps=5)
        rounds = n_iters * (int(need1) + int(need2))
        nbytes = sum(t.numel() * t.element_size() for t in host) + 3 * B * 4
        bms, by = program_bound(nbytes, 2 * B * N ** 3 * rounds,
                                BF16_FLOP_S)
        rows.append({"B": B, "N": N, "rounds": rounds,
                     "max_abs_err": err, "ms": ms,
                     "bound_ms": bms, "bound_by": by})
    return rows


def graph_phases(ctx: dict) -> None:
    """Bench config 6 and the txn-graph paths: the TxnGraphChecker on the
    card through the default plane's graph bucket, each verdict held
    against the port's host fold on the same history and each launch's
    per-graph counts against graph_counts_torch on CPU copies. None of
    them may launch a WGL kernel."""
    from jepsen_tpu_torch.checker import adya, chaos
    from jepsen_tpu_torch.checker import dispatch as dp
    from jepsen_tpu_torch.checker import txn_graph as tg

    sim, bs, kf = ctx["sim"], ctx["bs"], ctx["kf"]
    snapshot, reset = ctx["launch_stats_snapshot"], ctx["reset_launch_stats"]
    wgl = (bs.bitset_scan.launches, kf.kfrontier_scan.launches)
    rec = GraphRecorder(tg)
    device_extras = ("method", "wall_s", "components", "matmul_rounds")

    def timed(fn):
        reset()
        dp.reset_dispatch_stats()
        tg.reset_txn_graph_stats()
        rec.take()
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0, snapshot()

    def as_fold(v):
        return {k: x for k, x in v.items() if k not in device_extras}

    def graph_info(st) -> dict:
        d = dp.dispatch_stats()
        return {"launches": st["launches"], "host_syncs": st["host_syncs"],
                "graph_requests": d["graph_requests"],
                "graph_batches": d["graph_batches"],
                "backpressure_collects": d["backpressure_collects"],
                "txn_graph_stats": tg.txn_graph_stats()}

    try:
        with Phase("config6") as info:
            # bench.py:1780's shape, uncut: 200,000 list-append txns with
            # a planted 3-txn G1c cycle
            t0 = time.perf_counter()
            h = sim.gen_txn_graph_history(random.Random(66),
                                          n_txns=200_000, anomaly="g1c",
                                          cycle_len=3)
            gen_s = time.perf_counter() - t0
            # from the history, cold: encode, extract, compile, the
            # device program and the verdict
            r, wall, st = timed(lambda: tg.TxnGraphChecker().check({}, h))
            gi = graph_info(st)
            rows = graph_launch_rows(tg, rec.take())
            check(r["valid?"] is False and r["census"]["G1c"] == 3
                  and r["method"] == "gpu-txn-graph" and "degraded" not in r,
                  f"config6: {r['valid?']} {r['census']} {r['method']}")
            check(r["anomalies"]["G1c"]["cycle_len"] == 3,
                  f"config6 witness {r['anomalies']}")
            check(st["launches"] == len(rows) == gi["graph_batches"]
                  and gi["graph_batches"] == len(r["components"]["buckets"]),
                  f"config6: {len(rows)} launches, {gi}")
            assert_not_degraded([r], "config6")
            # the mesh phases shard the same history (mesh_graph)
            ctx["config6"] = (h, r, wall)
            t0 = time.perf_counter()
            want = tg.fold_txn_graph(h)
            fold_s = time.perf_counter() - t0
            check(as_fold(r) == as_fold(want),
                  "config6: the card's verdict != the host fold's")
            # the same check split: encode, extract, compile of the batch
            # program, then a check of the plane (its own compile), a
            # warm re-check (the program memoized) and the verdict alone
            t0 = time.perf_counter()
            plane = tg.encode_txn_graph(h)
            encode_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            es = tg.extract_edges(plane)
            extract_s = time.perf_counter() - t0
            chk = tg.TxnGraphChecker()
            t0 = time.perf_counter()
            chk._compile_graph_prog(es, True, True,
                                    dp.default_plane().device)
            torch.cuda.synchronize()
            compile_s = time.perf_counter() - t0
            verdict_s = []
            real_verdict = tg._verdict_from

            def timed_verdict(*a, **kw):
                t0 = time.perf_counter()
                out = real_verdict(*a, **kw)
                verdict_s.append(time.perf_counter() - t0)
                return out

            tg._verdict_from = timed_verdict
            try:
                rp, wall_plane, st_plane = timed(lambda: chk.check({},
                                                                   plane))
                rec.take()
                rw_, wall_warm, st_warm = timed(lambda: chk.check({},
                                                                  plane))
                rec.take()
            finally:
                tg._verdict_from = real_verdict
            check(rp == r and rw_ == r, "config6 from its plane != e2e")
            # a clean history of the same size: valid
            hc = sim.gen_txn_graph_history(random.Random(67),
                                           n_txns=200_000)
            rc, wall_c, st_c = timed(lambda: tg.TxnGraphChecker().check(
                {}, hc))
            rows_c = graph_launch_rows(tg, rec.take())
            check(rc["valid?"] is True and not rc["anomalies"]
                  and "degraded" not in rc, f"config6 clean: {rc}")
            check(as_fold(rc) == as_fold(tg.fold_txn_graph(hc)),
                  "config6 clean: the card's verdict != the host fold's")
            info.update(
                n_txns=r["n_txns"], edges=r["edges"],
                components=r["components"], census=r["census"],
                gen_s=gen_s, e2e_wall_s=wall, **gi,
                encode_s=encode_s, extract_s=extract_s,
                compile_s=compile_s, plane_check_wall_s=wall_plane,
                warm_check_wall_s=wall_warm,
                verdict_s=verdict_s, host_fold_s=fold_s,
                device_program_ms=sum(x["ms"] for x in rows),
                bound_ms=sum(x["bound_ms"] for x in rows),
                by_launch=rows, warm_host_syncs=st_warm["host_syncs"],
                clean={"e2e_wall_s": wall_c,
                       "launches": st_c["launches"],
                       "host_syncs": st_c["host_syncs"],
                       "components": rc["components"],
                       "device_program_ms": sum(x["ms"] for x in rows_c),
                       "by_launch": rows_c})

        with Phase("config6_wide") as info:
            # the widest bucket launch: groups of 48 txns (bucket 48)
            h = sim.gen_txn_graph_history(random.Random(68), n_txns=48_000,
                                          txns_per_group=48,
                                          anomaly="g2-item", cycle_len=3)
            r, wall, st = timed(lambda: tg.TxnGraphChecker().check({}, h))
            gi = graph_info(st)
            rows = graph_launch_rows(tg, rec.take())
            check(48 in r["components"]["buckets"]
                  and any(x["N"] == 48 for x in rows),
                  f"config6_wide: no bucket-48 launch {r['components']}")
            check(r["valid?"] is False and r["census"]["G2-item"] == 2
                  and as_fold(r) == as_fold(tg.fold_txn_graph(h)),
                  f"config6_wide: {r['census']}")
            assert_not_degraded([r], "config6_wide")
            # the solo oversize launch: one component of 1,500 txns past
            # the last bucket (1,024)
            ho = sim.gen_txn_graph_history(random.Random(69), n_txns=1500,
                                           keys_per_group=8,
                                           txns_per_group=1500,
                                           anomaly="g1c", cycle_len=4)
            ro, wall_o, st_o = timed(lambda: tg.TxnGraphChecker().check(
                {}, ho))
            so = tg.txn_graph_stats()
            rows_o = graph_launch_rows(tg, rec.take())
            check(so["oversize_components"] > 0
                  and so["host_fallback_components"] == 0
                  and ro["components"]["max_size"] > tg.GRAPH_BUCKETS[-1]
                  and any(x["N"] > tg.GRAPH_BUCKETS[-1] for x in rows_o),
                  f"config6_wide oversize: {ro['components']} {so}")
            check(ro["valid?"] is False and ro["census"]["G1c"] == 4
                  and as_fold(ro) == as_fold(tg.fold_txn_graph(ho)),
                  f"config6_wide oversize: {ro['census']}")
            ctx["oversize"] = (ho, ro)
            assert_not_degraded([ro], "config6_wide")
            info.update(
                n_txns=r["n_txns"], components=r["components"],
                e2e_wall_s=wall, **gi,
                device_program_ms=sum(x["ms"] for x in rows),
                by_launch=rows,
                oversize={"n_txns": ro["n_txns"],
                          "components": ro["components"],
                          "e2e_wall_s": wall_o,
                          "launches": st_o["launches"],
                          "host_syncs": st_o["host_syncs"],
                          "oversize_components": so["oversize_components"],
                          "by_launch": rows_o})

        with Phase("plane_graph") as info:
            hs = [sim.gen_txn_graph_history(random.Random(s), n_txns=12)
                  for s in (1, 2)]

            def two_checks():
                with dp.DispatchPlane() as plane:
                    c = tg.TxnGraphChecker(plane=plane, buckets=(16,))
                    rs = [c.check_async({}, x) for x in hs]
                    plane.flush()
                    return [f() for f in rs]

            outs, wall, st = timed(two_checks)
            gi = graph_info(st)
            rows = graph_launch_rows(tg, rec.take())
            check(gi["graph_requests"] >= 2 and gi["graph_batches"] == 1
                  and st["launches"] == 1 and st["host_syncs"] == 1,
                  f"plane_graph: {gi}")
            for x, o in zip(hs, outs):
                check(o == tg.TxnGraphChecker(device="cpu", buckets=(16,))
                      .check({}, x), "plane_graph: the card != the CPU")
            assert_not_degraded(outs, "plane_graph")
            info.update(wall_s=wall, **gi, by_launch=rows)

        with Phase("chaos_graph") as info:
            h = sim.gen_txn_graph_history(random.Random(4), n_txns=2000,
                                          anomaly="g-single", cycle_len=3)
            oracle = tg.fold_txn_graph(h)
            out = {}
            chaos.reset_resilience()
            try:
                with chaos.chaos_plan(chaos.persistent_device_fault("cuda")):
                    # the default plane: each checker raises, from a
                    # bucket launch, and from the guarded solo launch of
                    # a history whose one component (the planted 3-txn
                    # cycle) passes the only bucket, 2: no bucket launch
                    solo = sim.gen_txn_graph_history(
                        random.Random(4), n_txns=0, anomaly="g-single",
                        cycle_len=3)
                    for name, hist, kw in (("bucket", h, {}),
                                           ("oversize", solo,
                                            {"buckets": (2,)})):
                        dp.reset_dispatch_stats()
                        tg.reset_txn_graph_stats()
                        try:
                            tg.TxnGraphChecker(**kw).check({}, hist)
                        except chaos.PlaneFault as pf:
                            out[name] = pf.describe()
                        else:
                            check(False, f"chaos_graph {name}: no fault")
                        st = (dp.dispatch_stats()["graph_requests"],
                              tg.txn_graph_stats()["oversize_components"])
                        routed = (st == (0, 1) if name == "oversize"
                                  else st[0] > 0 and st[1] == 0)
                        check(routed, f"chaos_graph {name}: requests, "
                              f"oversize components {st}")
                        out[name].update(graph_requests=st[0],
                                         oversize_components=st[1])
                    check(chaos.resilience_snapshot()["oracle_fallbacks"]
                          == 0, "chaos_graph: the default plane degraded")
                    with dp.DispatchPlane(degrade=True) as plane:
                        got = tg.TxnGraphChecker(plane=plane).check({}, h)
                check(got.get("degraded") is True
                      and got["method"] == "cpu-txn-fold"
                      and {k: v for k, v in got.items()
                           if k != "degraded"} == oracle,
                      f"chaos_graph degraded: {got}")
                out["degrade_true"] = {"method": got["method"],
                                       "valid?": got["valid?"]}
                res = chaos.resilience_snapshot()
                check(res["oracle_fallbacks"] == 1,
                      f"chaos_graph resilience {res}")
                # a Python error in the launch wrapper is raised, not
                # degraded, even on a degrade=True plane
                def boom(*a, **kw):
                    raise RuntimeError("injected graph-launch fault")

                tg.launch_graph_batch = boom
                try:
                    with dp.DispatchPlane(degrade=True) as plane:
                        tg.TxnGraphChecker(plane=plane).check({}, h)
                except RuntimeError as e:
                    check(not isinstance(e, chaos.PlaneFault),
                          f"chaos_graph: the error was wrapped: {e!r}")
                    out["python_error"] = repr(e)
                else:
                    check(False, "chaos_graph: the Python error vanished")
                finally:
                    tg.launch_graph_batch = rec.launch
                check(chaos.resilience_snapshot()["oracle_fallbacks"] == 1,
                      "chaos_graph: the Python error was degraded")
            finally:
                chaos.reset_resilience()
            rec.take()
            info.update(out)

        with Phase("g2_txn") as info:
            # BASELINE config 4's checker on a micro-op txn history with a
            # planted G2-item (two rw anti-dependencies)
            h = sim.gen_txn_graph_history(random.Random(77), n_txns=20_000,
                                          anomaly="g2-item", cycle_len=3)
            r, wall, st = timed(lambda: adya.G2Checker().check({}, h))
            gi = graph_info(st)
            rows = graph_launch_rows(tg, rec.take())
            want = adya.G2Checker(device="cpu").check({}, h)
            tgv = r["txn_graph"]
            methods = (tgv.pop("method"), want["txn_graph"].pop("method"))
            check(methods == ("gpu-txn-graph",) * 2,
                  f"g2_txn methods {methods}")
            check(r == want and r["valid?"] is False
                  and r["illegal_count"] == 2 and len(r["illegal"]) == 2,
                  f"g2_txn: {r} vs the CPU's {want}")
            assert_not_degraded([tgv], "g2_txn")
            info.update(n_txns=tgv["n_txns"], wall_s=wall, **gi,
                        illegal=r["illegal"], by_launch=rows,
                        device_program_ms=sum(x["ms"] for x in rows))
    finally:
        rec.close()

    check((bs.bitset_scan.launches, kf.kfrontier_scan.launches) == wgl,
          "a txn-graph phase launched a WGL kernel")


#: streams_1k: the reference's production shape (bench.py's streams-1k
#: block): 1,000 streams, one thread each, 4 lockstep rounds of
#: 200-record chunks (the last takes the rest) of 8 distinct 800-op
#: histories, each append held 2 s for partners
STREAMS_1K = dict(streams=1000, rounds=4, chunk=200, distinct=8, hold_s=2.0)


# -- the CLI: `analyze` and `trace-summary` through cli.main ------------------

#: the child that runs `analyze --resume` on the card and SIGKILLs itself
#: right after the checkpoint save of boundary K (no cleanup, no exit)
_KILL_CHILD = """
import os, signal, sys
sys.path.insert(0, {root!r})
from jepsen_tpu_torch import cli
from jepsen_tpu_torch.checker import checkpoint as cp

init = cp.CheckpointSink.__init__


def hooked(self, *a, **kw):
    init(self, *a, **kw)

    def after_save(sink, st):
        if st.get("verdict") is None and st["segments_done"] >= {k}:
            os.kill(os.getpid(), signal.SIGKILL)
    self.after_save = after_save


cp.CheckpointSink.__init__ = hooked
sys.exit(cli.main({argv!r}))
"""


class Timed:
    """Wraps obj.name so each call's seconds append to acc[key]; undone
    on exit."""

    def __init__(self, acc, key, obj, name):
        self.acc, self.key, self.obj, self.name = acc, key, obj, name

    def __enter__(self):
        fn = self.orig = getattr(self.obj, self.name)
        acc, key = self.acc, self.key

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc.setdefault(key, []).append(time.perf_counter() - t0)

        setattr(self.obj, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.obj, self.name, self.orig)
        return False


def profile_shares(path: str, kernel: str) -> dict:
    """The device's busy and idle share over a torch.profiler trace: the
    union of the CUDA kernel events' intervals over the traced window
    (first event's start to last event's end, host and device), and the
    kernels by name."""
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    timed = [e for e in evs if e.get("ph") == "X" and "ts" in e
             and isinstance(e.get("dur"), (int, float))]
    kernels = [e for e in timed if e.get("cat") == "kernel"]
    t0 = min(e["ts"] for e in timed)
    t1 = max(e["ts"] + e["dur"] for e in timed)
    busy, end = 0.0, None
    for e in sorted(kernels, key=lambda e: e["ts"]):
        a, b = e["ts"], e["ts"] + e["dur"]
        if end is None or a >= end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    names = {}
    for e in kernels:
        n, d = names.get(e["name"], (0, 0.0))
        names[e["name"]] = (n + 1, d + e["dur"])
    window_us = t1 - t0
    return dict(
        window_ms=window_us / 1e3, kernel_busy_ms=busy / 1e3,
        busy_share=busy / window_us, idle_share=1 - busy / window_us,
        kernel_events=len(kernels),
        named=sorted(n for n in names if kernel in n),
        by_kernel={n: {"count": c, "ms": d / 1e3}
                   for n, (c, d) in sorted(names.items())})


def cli_phases(ctx: dict) -> None:
    """The port's CLI on the card, each phase a path of the main path
    (counts from 0, launches recorded and replayed against the plain
    versions): cli_northstar, cli_config1, cli_keyed, cli_ladder,
    cli_resume, cli_follow, cli_trace and cli_profile. Each run is a run
    directory written by the port's Store and checked by
    `jepsen_tpu_torch.cli.main(["analyze", ...])` in this process (the
    kill in a child process), its verdict held against the in-process
    checks of the same histories."""
    import shutil
    import tempfile
    import threading

    from jepsen_tpu_torch import cli, independent, obs
    from jepsen_tpu_torch.checker import streaming as sm
    from jepsen_tpu_torch.history import sentry
    from jepsen_tpu_torch.history.history import History
    from jepsen_tpu_torch.obs.profiler import PROFILE_FILE
    from jepsen_tpu_torch.store import Store, op_to_json

    c = ctx
    start, stop = c["start"], c["stop"]
    north_h, north_r = c["north_h"], c["north_r"]
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_", dir=c["scratch"])
    st = Store(root)

    def save(name, ops, workload="register"):
        return st.save_1({"name": name, "workload": workload,
                          "history": History(ops, indexed=True)})

    def analyze(d, *extra, workload="register"):
        t0 = time.perf_counter()
        code = cli.main(["analyze", d, "--store", root, "--workload",
                         workload, *extra])
        return code, time.perf_counter() - t0, st.load_results(d)

    def verdict(r):
        return {k: r.get(k) for k in ("valid?", "failed_op_index",
                                      "failure")}

    try:
        with Phase("cli_northstar") as info:
            t0 = time.perf_counter()
            d = save("northstar", north_h.ops)
            save_1_s = time.perf_counter() - t0
            split = {}

            class TimedChecker:
                def __init__(self, inner):
                    self.inner = inner

                def check(self, *a, **kw):
                    t0 = time.perf_counter()
                    try:
                        return self.inner.check(*a, **kw)
                    finally:
                        split.setdefault("check_s", []).append(
                            time.perf_counter() - t0)

            pick = cli._checker_for
            start("cli_northstar")
            cli._checker_for = lambda *a: TimedChecker(pick(*a))
            try:
                with Timed(split, "load_history_s", Store, "load_history"), \
                        Timed(split, "load_test_s", Store, "load_test"), \
                        Timed(split, "sentry_s", sentry, "validate_history"), \
                        Timed(split, "save_2_s", Store, "save_2"):
                    code, wall, res = analyze(d)
            finally:
                cli._checker_for = pick
            counts = stop("cli_northstar", ["bitset_scan"])
            check(code == cli.EXIT_VALID, f"cli_northstar exit {code}")
            check(verdict(res) == verdict(north_r),
                  f"cli_northstar {verdict(res)} vs {verdict(north_r)}")
            launch = res["engine_stats"]["launch"]
            check(launch == {"launches": 1, "escalations": 0,
                             "host_syncs": 1, "donated_buffers": 0},
                  f"cli_northstar {launch}")
            info.update(save_1_s=save_1_s, wall_s=wall, split=split,
                        check_wall_s=res["wall_s"],
                        inprocess_wall_s=north_r["wall_s"], launch=launch,
                        kernel_launches=counts)
            c["walls"]["cli_northstar"] = wall

        with Phase("cli_config1") as info:
            runs = [save(f"config1-{i}", h.ops)
                    for i, h in enumerate(c["config1_hists"])]
            start("cli_config1")
            outs = [analyze(d) for d in runs]
            counts = stop("cli_config1", ["bitset_scan"])
            codes = [o[0] for o in outs]
            for d, (code, _, res), want in zip(runs, outs,
                                               c["config1_rows"]):
                check(code == cli._exit_code(want)
                      and verdict(res) == verdict(want),
                      f"cli_config1 {d}: {code} {verdict(res)} vs "
                      f"{verdict(want)}")
                svg = os.path.join(d, "linear.svg")
                check(os.path.exists(svg) == (want["valid?"] is False)
                      and res.get("failure_svg", svg) == svg,
                      f"cli_config1 {d}: linear.svg {res.get('failure_svg')}")
            check(codes == [0] * 8 + [1, 1], f"cli_config1 codes {codes}")
            c["walls"]["cli_config1"] = [o[1] for o in outs]
            info.update(codes=codes, walls_s=[o[1] for o in outs],
                        check_walls_s=[o[2]["wall_s"] for o in outs],
                        inprocess_wall_s=c["config1_wall"],
                        kernel_launches=counts)

        with Phase("cli_keyed") as info:
            # config 2's 16 keys as one run: key k's ops carry KV(k, v),
            # its processes offset so no two keys share one
            ops = []
            for k, h in enumerate(c["zk_hists"]):
                for o in h.ops:
                    ops.append(o.with_(value=independent.KV(k, o.value),
                                       process=100 * k + o.process))
            d = save("keyed", ops, "register-keyed")
            start("cli_keyed")
            code, wall, res = analyze(d, workload="register-keyed")
            counts = stop("cli_keyed", ["bitset_scan"])
            got = [res["results"][k]["valid?"] for k in range(16)]
            check(code == cli.EXIT_VALID and res["key_count"] == 16
                  and got == c["zk_want"], f"cli_keyed {code} {got}")
            # IndependentChecker checks key by key, as the reference's
            # does: one launch and one sync a key
            launch = res["engine_stats"]["launch"]
            check(launch["launches"] == 16 and counts["bitset_scan"] == 16,
                  f"cli_keyed {launch} {counts}")
            info.update(keys=16, wall_s=wall, launch=launch,
                        batch_wall_s=c["config2_wall"],
                        kernel_launches=counts)

        with Phase("cli_ladder") as info:
            runs = [save("ladder", c["ladder_h"].ops),
                    save("ladder-bad", c["ladder_hc"].ops)]
            start("cli_ladder")
            outs = [analyze(d) for d in runs]
            counts = stop("cli_ladder", ["kfrontier_scan"])
            for (code, _, res), want in zip(outs, (c["ladder_r"],
                                                   c["ladder_rc"])):
                check(code == cli._exit_code(want)
                      and verdict(res) == verdict(want)
                      and res["method"] == "gpu-wgl-kfrontier",
                      f"cli_ladder {code} {res} vs {want}")
            info.update(codes=[o[0] for o in outs],
                        walls_s=[o[1] for o in outs],
                        window=outs[0][2]["window"], kernel_launches=counts)

        with Phase("cli_resume") as info:
            ev = c["ev_mod"].history_to_events(north_h)
            bs = c["bs"]
            steps = c["ev_mod"].events_to_steps(ev, W=bs.plan(
                bs.get_model("cas-register"), ev.window,
                len(ev.value_codes))[0])
            # the planner's own least segment length for this history,
            # set through the CLI's environment: the north star's plan
            # (a rehearsal on a short history passes a shorter one)
            min_len = c.get("seg_min_len") or max(512, len(steps) // 48)
            n_segs = len(bs._plan_for(steps, min_len))
            check(n_segs >= 3, f"cli_resume: {n_segs} segments")
            os.environ["JEPSEN_TPU_SEG_MIN_LEN"] = str(min_len)
            killed = save("resume", north_h.ops)
            cold = killed + ".cold"
            shutil.copytree(killed, cold)
            here = os.path.dirname(os.path.abspath(__file__))
            argv = ["analyze", killed, "--store", root, "--workload",
                    "register", "--resume"]
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-c",
                 _KILL_CHILD.format(root=here, k=2, argv=argv)],
                capture_output=True, text=True, timeout=600)
            kill_s = time.perf_counter() - t0
            check(proc.returncode == -9,
                  f"cli_resume child exit {proc.returncode}: {proc.stderr}")
            ck = json.load(open(os.path.join(killed, "checkpoint.json")))
            check(ck["segments_done"] == 2 and st.load_results(killed)
                  is None, f"cli_resume killed at {ck['segments_done']}")
            start("cli_resume")
            code_k, wall_k, res_k = analyze(killed, "--resume")
            code_c, wall_c, res_c = analyze(cold, "--resume")
            # an edited field without its payload hash: a cold run
            path = os.path.join(cold, "checkpoint.json")
            state = json.load(open(path))
            state["segments_done"] = 1
            json.dump(state, open(path, "w"))
            code_t, wall_t, res_t = analyze(cold, "--resume")
            counts = stop("cli_resume", ["bitset_scan"])
            del os.environ["JEPSEN_TPU_SEG_MIN_LEN"]
            lk = res_k["engine_stats"]["launch"]
            lc = res_c["engine_stats"]["launch"]
            ckk = res_k["engine_stats"]["checkpoint"]
            ckt = res_t["engine_stats"]["checkpoint"]
            check(code_k == code_c == code_t == cli.EXIT_VALID
                  and verdict(res_k) == verdict(res_c) == verdict(north_r)
                  == verdict(res_t), "cli_resume verdicts")
            check(0 < lk["launches"] < lc["launches"] == n_segs
                  and ckk["resumes"] == 1 and ckk["resumed_segments"] == 2,
                  f"cli_resume {lk} {lc} {ckk}")
            check(ckt["rejected"] >= 1 and ckt["resumes"] == 0
                  and res_t["engine_stats"]["launch"]["launches"] == n_segs,
                  f"cli_resume tampered {ckt}")
            check(counts["bitset_scan"] == lk["launches"] + 2 * n_segs,
                  f"cli_resume kernel launches {counts}")
            info.update(segments=n_segs, seg_min_len=min_len,
                        child_s=kill_s, resumed_wall_s=wall_k,
                        cold_wall_s=wall_c, tampered_wall_s=wall_t,
                        resumed_launch=lk, cold_launch=lc,
                        resumed_checkpoint=ckk, tampered_checkpoint=ckt,
                        kernel_launches=counts)

        with Phase("cli_follow") as info:
            ops = list(north_h.ops)
            cuts = [len(ops) * k // 10 for k in range(11)]
            d = save("follow", ops[:cuts[1]])
            hist = os.path.join(d, "history.jsonl")
            errs = []

            def writer():
                # the next chunk once the follow has appended the last
                try:
                    for k in range(1, 10):
                        end = time.perf_counter() + 120
                        while sm.stream_stats()["appends"] < k:
                            if time.perf_counter() > end:
                                raise TimeoutError(f"append {k}")
                            time.sleep(0.01)
                        with open(hist, "a") as f:
                            f.write("".join(
                                json.dumps(op_to_json(o)) + "\n"
                                for o in ops[cuts[k]:cuts[k + 1]]))
                except Exception as e:  # noqa: BLE001 - raised below
                    errs.append(e)

            sm.reset_stream_stats()
            start("cli_follow")
            t = threading.Thread(target=writer)
            t.start()
            try:
                t0 = time.perf_counter()
                code = cli.main(["analyze", d, "--store", root, "--follow",
                                 "--resume", "--follow-idle", "2"])
                wall = time.perf_counter() - t0
            finally:
                t.join()
            check(not errs, f"cli_follow writer: {errs}")
            first = sm.stream_stats()
            # a restarted follow over the whole file skips the prefix
            t0 = time.perf_counter()
            code2 = cli.main(["analyze", d, "--store", root, "--follow",
                              "--resume", "--follow-idle", "0"])
            wall2 = time.perf_counter() - t0
            second = sm.stream_stats()
            counts = stop("cli_follow", ["bitset_scan"])
            check(code == code2 == cli._exit_code(north_r),
                  f"cli_follow exits {code} {code2}")
            check(first["appends"] >= 10 and second["resumes"] == 1
                  and second["tail_steps"] < first["tail_steps"],
                  f"cli_follow {first} {second}")
            info.update(wall_s=wall, idle_s=2, restart_wall_s=wall2,
                        first=first, restart=second,
                        kernel_launches=counts)

        with Phase("cli_trace") as info:
            start("cli_trace")
            rows = []
            runs = [save(f"trace-{i}", h.ops)
                    for i, h in enumerate(c["config1_hists"])]
            for i, d in enumerate(runs):
                path = os.path.join(root, f"trace-{i}.json")
                code, wall, res = analyze(d, "--trace", path)
                with open(path) as f:
                    obj = json.load(f)
                errors = obs.validate_chrome_trace(obj)
                summed = {}
                for e in obj["traceEvents"]:
                    if e.get("cat") == "launch_stat":
                        summed[e["name"]] = (summed.get(e["name"], 0)
                                             + e["args"]["n"])
                launch = res["engine_stats"]["launch"]
                check(not errors and {k: summed.get(k, 0) for k in launch}
                      == launch and code == cli._exit_code(
                          c["config1_rows"][i]),
                      f"cli_trace {d}: {errors[:3]} {summed} vs {launch}")
                check(cli.main(["trace-summary", path]) == cli.EXIT_VALID,
                      f"cli_trace summary {path}")
                rows.append(dict(events=len(obj["traceEvents"]),
                                 wall_s=wall, launch=launch))
            counts = stop("cli_trace", ["bitset_scan"])
            info.update(runs=len(runs), traces=rows,
                        kernel_launches=counts)

        with Phase("cli_profile") as info:
            d = save("profile", north_h.ops)
            prof = os.path.join(root, "profile")
            start("cli_profile")
            code, wall, res = analyze(d, "--xla-trace", prof)
            counts = stop("cli_profile", ["bitset_scan"])
            check(code == cli.EXIT_VALID
                  and verdict(res) == verdict(north_r), "cli_profile")
            shares = profile_shares(os.path.join(prof, PROFILE_FILE),
                                    "bitset_scan")
            check(shares["named"] != [],
                  f"cli_profile: no bitset_scan kernel in the trace: "
                  f"{shares['by_kernel']}")
            info.update(wall_s=wall, check_wall_s=res["wall_s"],
                        launch=res["engine_stats"]["launch"],
                        kernel_launches=counts, **shares)
    finally:
        shutil.rmtree(root, ignore_errors=True)


#: the service phases' hold: long enough that the burst's 10 concurrent
#: requests all park in one bucket before the first resolves
SERVICE_HOLD_S = 1.0



def service_burst(d, hists, wants, start, stop, snap, phase: str) -> dict:
    """Config 1's histories as concurrent POST /check requests from 5
    tenants to the in-process daemon d, all released together: each
    verdict held against the in-process check of the same history, the
    phase's launches counted from 0. The service_burst phase, and the
    tuned phase's run of it under a tuned profile. Returns the phase's
    walls, counts and the plane's batch summary."""
    import threading

    from jepsen_tpu_torch.checker import dispatch as dp
    from jepsen_tpu_torch.service.client import CheckerClient, encode_history

    tenants = [f"tenant-{i % 5}" for i in range(len(hists))]
    bodies = [json.dumps({"history": encode_history(h)}).encode()
              for h in hists]
    outs, errs = [None] * len(hists), []
    walls = [None] * len(hists)
    gate = threading.Barrier(len(hists))

    def go(i):
        try:
            cl = CheckerClient(port=d.port, tenant=tenants[i], retries=0,
                               timeout_s=600)
            gate.wait()
            t1 = time.perf_counter()
            outs[i] = cl._roundtrip("POST", "/check", bodies[i])
            walls[i] = time.perf_counter() - t1
        except Exception as e:  # noqa: BLE001 - checked below
            errs.append(e)

    dp.reset_dispatch_stats()
    start(phase)
    t0 = time.perf_counter()
    ts = [threading.Thread(target=go, args=(i,)) for i in range(len(hists))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    stats = snap()
    pst = plane_summary(dp)
    counts = stop(phase, ["bitset_scan"])
    check(not errs, f"{phase}: {errs}")
    for i, (o, w) in enumerate(zip(outs, wants)):
        same_verdict(o, w, f"{phase} request {i}")
    assert_not_degraded(outs, phase)
    return dict(requests=len(hists), tenants=len(set(tenants)),
                tenant_names=sorted(set(tenants)), wall_s=wall,
                client_walls_s=walls,
                check_walls_s=[o["wall_s"] for o in outs],
                methods=[o["method"] for o in outs], launch=stats,
                dispatch=pst, kernel_launches=counts)


def service_phases(ctx: dict) -> None:
    """The checker daemon on the card (service/server.py): an in-process
    CheckerDaemon() on the default plane of the card, driven over HTTP
    by CheckerClient. service_burst, service_northstar, service_queue,
    service_stream, service_durable's resumed run and service_chaos are
    paths of the main path (counts from 0, launches recorded and
    replayed against the plain versions); service_durable's killed run
    and service_drain run in `cli daemon` children. Each holds its
    verdicts against the in-process checks of the same histories."""
    import shutil
    import socket
    import tempfile
    import threading

    from jepsen_tpu_torch import obs
    from jepsen_tpu_torch.checker import chaos
    from jepsen_tpu_torch.checker import dispatch as dp
    from jepsen_tpu_torch.history.history import History
    from jepsen_tpu_torch.service.client import (
        CheckerClient,
        ServiceError,
        encode_history,
    )
    from jepsen_tpu_torch.service.server import CheckerDaemon, check_id_for
    from jepsen_tpu_torch.store import Store, op_from_json

    c = ctx
    start, stop, snap = c["start"], c["stop"], c["launch_stats_snapshot"]
    ev_mod, bs = c["ev_mod"], c["bs"]
    north_h, north_r = c["north_h"], c["north_r"]
    hists, wants = c["config1_hists"], c["config1_rows"]
    root = tempfile.mkdtemp(prefix="chip_smoke_service_", dir=c["scratch"])
    here = os.path.dirname(os.path.abspath(__file__))

    def client(port, tenant="default"):
        return CheckerClient(port=port, tenant=tenant, retries=0,
                             timeout_s=600)

    def free_port():
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            return sk.getsockname()[1]

    def child(port, store, *extra):
        # a `cli daemon` child that SIGKILLs itself at a durable check's
        # boundary 2 (a check that saves no boundary runs to its end)
        argv = ["daemon", "--store", store, "--port", str(port), *extra]
        return subprocess.Popen(
            [sys.executable, "-c",
             _KILL_CHILD.format(root=here, k=2, argv=argv)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def healthy(port, proc, timeout_s=300):
        cl = client(port)
        end = time.perf_counter() + timeout_s
        while time.perf_counter() < end:
            if proc.poll() is not None:
                check(False, f"daemon child exited {proc.returncode}: "
                      f"{proc.communicate()}")
            try:
                if cl.health().get("ok"):
                    return cl
            except (OSError, ServiceError):
                pass
            time.sleep(0.1)
        raise TimeoutError(f"daemon child on :{port} never healthy")

    def body(h, **req):
        return json.dumps({"history": encode_history(h), **req}).encode()

    d = CheckerDaemon(root=root, port=0, coalesce_hold_s=SERVICE_HOLD_S)
    serving = threading.Thread(target=d.serve_forever, daemon=True)
    serving.start()
    procs = []
    try:
        check(d.plane.device.type == "cuda" and d.plane.degrade is False,
              f"the daemon's plane: {d.plane.device} {d.plane.degrade}")

        with Phase("service_burst") as info:
            got = service_burst(d, hists, wants, start, stop, snap,
                                "service_burst")
            pst, counts = got["dispatch"], got["kernel_launches"]
            # one bucket for all 10 requests: the stacked fast launch,
            # its exact re-run, and a fast launch and an exact re-run
            # for each of the 2 dead riders' own re-checks
            check(pst["max_batch"] == len(hists)
                  and counts["bitset_scan"] == 6 < len(hists),
                  f"service_burst: {counts} launches for {len(hists)} "
                  f"requests, batches {pst}")
            rows = d.ledger.snapshot()
            tenants = got["tenant_names"]
            check(all(rows[t]["completed"] == 2 for t in tenants),
                  f"service_burst ledger {rows}")
            info.update(hold_s=SERVICE_HOLD_S, **got,
                        ledger={t: {k: rows[t][k] for k in (
                            "accepted", "completed", "valid", "invalid")}
                            for t in tenants})
            c["walls"]["service_burst"] = got["wall_s"]

        d.coalesce_hold_s = 0.0
        with Phase("service_northstar") as info:
            t0 = time.perf_counter()
            north = body(north_h)
            encode_s = time.perf_counter() - t0
            # the daemon's request decode alone (json.loads, op_from_json
            # and the History), as handle_check does it
            t0 = time.perf_counter()
            History([op_from_json(x) for x in json.loads(north)["history"]],
                    indexed=True)
            decode_s = time.perf_counter() - t0
            obs.enable()
            obs.reset()
            try:
                start("service_northstar")
                t0 = time.perf_counter()
                out = client(d.port, "north")._roundtrip("POST", "/check",
                                                        north)
                wall = time.perf_counter() - t0
                stats = snap()
                counts = stop("service_northstar", ["bitset_scan"])
                spans = obs.spans()
            finally:
                obs.disable()
                obs.reset()
            span_s = {n: sum(e["dur"] for e in spans if e["name"] == n
                             and e.get("ph") == "X") / 1e9
                      for n in ("request", "check")}
            same_verdict(out, north_r, "service_northstar")
            assert_not_degraded([out], "service_northstar")
            check(stats == {"launches": 1, "escalations": 0,
                            "host_syncs": 1, "donated_buffers": 0},
                  f"service_northstar {stats}")
            info.update(
                body_bytes=len(north), client_encode_s=encode_s,
                decode_alone_s=decode_s, wall_s=wall,
                request_span_s=span_s["request"],
                check_span_s=span_s["check"],
                decode_and_sentry_s=span_s["request"] - span_s["check"],
                response_and_transport_s=wall - span_s["request"],
                check_wall_s=out["wall_s"],
                inprocess_e2e_wall_s=north_r["wall_s"],
                invoked_ops=100_000, ops_per_s=100_000 / wall,
                launch=stats, kernel_launches=counts)

        with Phase("service_queue") as info:
            rows = []
            for name, h, want, n in (
                    ("service_queue", c["queue_hist"], c["queue_r"], 1),
                    ("service_queue_overdrawn", c["queue_hc"],
                     c["queue_rc"], 2)):
                start(name)
                t0 = time.perf_counter()
                o = client(d.port, "queue")._roundtrip(
                    "POST", "/check", body(h, model="unordered-queue"))
                wall = time.perf_counter() - t0
                counts = stop(name, ["kfrontier_scan"])
                for k in ("valid?", "failed_value", "failed_op_index",
                          "n_values", "method"):
                    check(o.get(k) == want.get(k),
                          f"{name} {k}: {o} vs {want}")
                check(counts == {"bitset_scan": 0, "kfrontier_scan": n},
                      f"{name} launches {counts}")
                assert_not_degraded([o], name)
                rows.append(dict(phase=name, wall_s=wall,
                                 check_wall_s=o["wall_s"],
                                 inprocess_wall_s=want["wall_s"],
                                 method=o["method"], valid=o["valid?"],
                                 kernel_launches=counts))
            info.update(values=32, requests=rows)

        with Phase("service_stream") as info:
            ops = encode_history(north_h)
            cuts = [len(ops) * k // 10 for k in range(11)]
            cl = client(d.port, "stream")
            walls, statuses = [], []
            start("service_stream")
            t0 = time.perf_counter()
            for k in range(10):
                t1 = time.perf_counter()
                statuses.append(cl._roundtrip("POST", "/check/stream",
                                              json.dumps({
                                                  "stream_id": "north",
                                                  "ops": ops[cuts[k]:
                                                             cuts[k + 1]],
                                                  "final": k == 9,
                                              }).encode()))
                walls.append(time.perf_counter() - t1)
            wall = time.perf_counter() - t0
            stats = snap()
            counts = stop("service_stream", ["bitset_scan"])
            out = statuses[-1]
            same_verdict(out, north_r, "service_stream")
            check(out["method"] == "gpu-wgl-bitset-streaming"
                  and out["streaming"]["coalesced"] is True,
                  f"service_stream {out}")
            assert_not_degraded([out], "service_stream")
            info.update(chunks=10, wall_s=wall, chunk_walls_s=walls,
                        provisional=[{k: s.get(k) for k in (
                            "valid?", "checked_steps", "deferred")}
                            for s in statuses[:-1]],
                        streaming=out["streaming"],
                        oneshot_wall_s=north_r["wall_s"], launch=stats,
                        kernel_launches=counts)

        with Phase("service_durable") as info:
            ev = ev_mod.history_to_events(north_h)
            steps = ev_mod.events_to_steps(ev, W=bs.plan(
                bs.get_model("cas-register"), ev.window,
                len(ev.value_codes))[0])
            min_len = c.get("seg_min_len") or max(512, len(steps) // 48)
            n_segs = len(bs._plan_for(steps, min_len))
            check(n_segs >= 3, f"service_durable: {n_segs} segments")
            os.environ["JEPSEN_TPU_SEG_MIN_LEN"] = str(min_len)
            try:
                durable = body(north_h, durable=True)
                path = Store(root).service_checkpoint_path(
                    "default", check_id_for("cas-register", durable))
                port = free_port()
                t0 = time.perf_counter()
                proc = child(port, root)
                procs.append(proc)
                cl = healthy(port, proc)
                up_s = time.perf_counter() - t0
                try:
                    cl._roundtrip("POST", "/check", durable)
                    answered = True
                except (OSError, ServiceError):
                    answered = False
                proc.wait(timeout=600)
                child_s = time.perf_counter() - t0
                check(not answered and proc.returncode == -9,
                      f"service_durable child {proc.returncode} "
                      f"answered={answered}: {proc.communicate()[1][-2000:]}")
                ck = json.load(open(path))
                check(ck["segments_done"] == 2 and ck.get("verdict") is None,
                      f"service_durable killed at {ck['segments_done']}")
                start("service_durable")
                t0 = time.perf_counter()
                out = client(d.port)._roundtrip("POST", "/check", durable)
                wall = time.perf_counter() - t0
                stats = snap()
                counts = stop("service_durable", ["bitset_scan"])
            finally:
                del os.environ["JEPSEN_TPU_SEG_MIN_LEN"]
            same_verdict(out, north_r, "service_durable")
            assert_not_degraded([out], "service_durable")
            check(out["checkpoint"]["resumed_from_segment"] == 2
                  and 0 < stats["launches"] < n_segs
                  and counts["bitset_scan"] == n_segs - 2
                  and d.ledger.snapshot()["default"]["durable_resumes"]
                  == 1, f"service_durable {out['checkpoint']} {stats} "
                  f"{counts}")
            info.update(segments=n_segs, seg_min_len=min_len,
                        child_up_s=up_s, child_s=child_s,
                        resumed_wall_s=wall, checkpoint=out["checkpoint"],
                        launch=stats, kernel_launches=counts)

        with Phase("service_chaos") as info:
            chaos.reset_resilience()
            start("service_chaos")
            with chaos.chaos_plan(chaos.persistent_device_fault(
                    chaos.TENANT_PREFIX + "evil")):
                try:
                    client(d.port, "evil")._roundtrip("POST", "/check",
                                                      body(hists[0]))
                    evil = 200, None
                except ServiceError as e:
                    evil = e.status, e.body
                out = client(d.port, "clean")._roundtrip("POST", "/check",
                                                         body(hists[1]))
            counts = stop("service_chaos", ["bitset_scan"])
            res = chaos.resilience_snapshot()
            rows = d.ledger.snapshot()
            check(evil[0] == 500 and evil[1]["error"] == "check-failed",
                  f"service_chaos evil {evil}")
            same_verdict(out, wants[1], "service_chaos clean")
            check("degraded" not in out, f"service_chaos clean {out}")
            check(res["quarantined_devices"] == []
                  and dp.device_label(d.plane.device)
                  not in res["device_failures"]
                  and res["device_failures"].get("tenant:evil", 0) >= 1
                  and res["oracle_fallbacks"] == 0,
                  f"service_chaos resilience {res}")
            check(rows["evil"]["errors"] == 1
                  and rows["evil"]["plane_faults"] == 1
                  and rows["clean"]["errors"] == 0
                  and rows["clean"]["faults"] == 0,
                  f"service_chaos ledger {rows}")
            info.update(evil_status=evil[0], evil_body=evil[1],
                        clean_valid=out["valid?"], resilience=res,
                        ledger={t: rows[t] for t in ("evil", "clean")},
                        kernel_launches=counts)
            chaos.reset_resilience()

        with Phase("service_drain") as info:
            port = free_port()
            proc = child(port, os.path.join(root, "drain"),
                         "--coalesce-hold", "2", "--drain-seconds", "120")
            procs.append(proc)
            cl = healthy(port, proc)
            got = {}

            def inflight():
                try:
                    got["out"] = cl.check(hists[0])
                except Exception as e:  # noqa: BLE001 - checked below
                    got["err"] = e

            t = threading.Thread(target=inflight)
            t.start()
            end = time.perf_counter() + 120
            while cl.stats()["admission"]["inflight"] < 1:
                check(time.perf_counter() < end, "service_drain: never "
                      "in flight")
                time.sleep(0.02)
            t0 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            time.sleep(0.3)
            try:
                client(port, "late").check(hists[1])
                late = 200
            except ServiceError as e:
                late = e.status
            except OSError:
                late = "refused"
            t.join(timeout=300)
            out, err = proc.communicate(timeout=300)
            drain_s = time.perf_counter() - t0
            check(proc.returncode == 0 and "drained. (code 0)" in out,
                  f"service_drain exit {proc.returncode}: {err[-2000:]}")
            check(late in (503, "refused"), f"service_drain late {late}")
            check("out" in got, f"service_drain in flight: {got}")
            same_verdict(got["out"], wants[0], "service_drain")
            info.update(exit=proc.returncode, late=late, drain_s=drain_s)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
        d.admission.start_drain()
        d.httpd.shutdown()
        serving.join(timeout=60)
        d.close()
        dp.reset_default_plane()
        shutil.rmtree(root, ignore_errors=True)


# -- the fleet: N daemons behind one front door ----------------------------

#: fleet_handoff's owner starts under this interpreter: it runs the member
#: (`-m jepsen_tpu_torch.cli daemon ...`) and SIGKILLs itself right after
#: the checkpoint save of boundary K (no cleanup, no exit)
_KILL_MEMBER = """#!{python}
import os, signal, sys
sys.path.insert(0, {root!r})
from jepsen_tpu_torch.checker import checkpoint as cp

init = cp.CheckpointSink.__init__


def hooked(self, *a, **kw):
    init(self, *a, **kw)

    def after_save(sink, st):
        if st.get("verdict") is None and st["segments_done"] >= {k}:
            os.kill(os.getpid(), signal.SIGKILL)
    self.after_save = after_save


cp.CheckpointSink.__init__ = hooked
if sys.argv[1:3] != ["-m", "jepsen_tpu_torch.cli"]:
    sys.exit("usage: kill_member -m jepsen_tpu_torch.cli ARGS")
from jepsen_tpu_torch import cli

sys.exit(cli.main(sys.argv[3:]))
"""

#: fleet_gray's forward budget: a healthy member answers a config 1
#: history well inside it, a stopped one never does
FLEET_GRAY_TIMEOUT_S = 5.0

#: fleet_drill's child: the canonical gauntlet, every fault class
FLEET_DRILL = ("--members", "2", "--duration", "20", "--seed", "0")


def fleet_phases(ctx: dict) -> None:
    """The checker fleet on the card (service/membership.py,
    frontdoor.py, supervisor.py, nemesis.py; the CLI's fleet commands).
    fleet_door runs two in-process daemons on this process's default
    plane (member 0 owns it) and is a path of the main path: counts from
    0, every launch recorded and replayed against the plain version. The
    other phases run their members as processes of their own on the
    card, each with its own CUDA context and plane: their launches and
    host syncs are read from the front door's /stats rollup.
    ``ctx["member_device"]`` is None (the card) except in a rehearsal
    on the CPU."""
    import shutil
    import tempfile
    import threading

    from jepsen_tpu_torch.checker import chaos
    from jepsen_tpu_torch.checker import dispatch as dp
    from jepsen_tpu_torch.pod import launcher
    from jepsen_tpu_torch.service.client import (
        CheckerClient,
        ServiceError,
        encode_history,
    )
    from jepsen_tpu_torch.service.frontdoor import FleetFrontDoor
    from jepsen_tpu_torch.service.membership import (
        FleetRegistry,
        HashRing,
    )
    from jepsen_tpu_torch.service.nemesis import FAULT_KINDS
    from jepsen_tpu_torch.service.server import CheckerDaemon, check_id_for
    from jepsen_tpu_torch.service.supervisor import (
        FleetSupervisor,
        SupervisionPolicy,
    )
    from jepsen_tpu_torch.store import Store

    c = ctx
    start, stop, snap = c["start"], c["stop"], c["launch_stats_snapshot"]
    ev_mod, bs = c["ev_mod"], c["bs"]
    north_h, north_r = c["north_h"], c["north_r"]
    hists, wants = c["config1_hists"], c["config1_rows"]
    device = c.get("member_device")
    backend = ["--backend", "cpu"] if device == "cpu" else []
    root = tempfile.mkdtemp(prefix="chip_smoke_fleet_", dir=c["scratch"])
    here = os.path.dirname(os.path.abspath(__file__))
    ring = HashRing((0, 1))
    procs, servers = [], []

    def client(port, tenant="default"):
        return CheckerClient(port=port, tenant=tenant, retries=0,
                             timeout_s=600)

    def body(h, **req):
        return json.dumps({"history": encode_history(h), **req}).encode()

    def serve(obj):
        t = threading.Thread(target=obj.serve_forever, daemon=True)
        t.start()
        servers.append((obj, t))
        return obj

    def owned_by(member_id, prefix):
        return next(f"{prefix}-{i}" for i in range(10_000)
                    if ring.route(f"{prefix}-{i}") == member_id)

    def log_tail(path):
        try:
            with open(path, errors="replace") as f:
                return f.read()[-2000:]
        except OSError:
            return ""

    def wait_members(fdir, want, t0, logs, timeout_s=300):
        """Seconds from t0 until each (member id, epoch) in ``want`` is
        announced and alive."""
        reg, up = FleetRegistry(fdir), {}
        end = time.perf_counter() + timeout_s
        while len(up) < len(want):
            for m in reg.alive_members():
                if (m.member_id, m.epoch) in want and m.member_id not in up:
                    up[m.member_id] = time.perf_counter() - t0
            for p, lp in logs:
                if p.poll() is not None:
                    check(False, f"fleet member exited {p.returncode}: "
                          f"{log_tail(lp)}")
            check(time.perf_counter() < end,
                  f"fleet members {want} not up after {timeout_s} s: "
                  f"{[log_tail(lp) for _, lp in logs]}")
            time.sleep(0.05)
        return up

    def close_servers():
        for obj, t in servers:
            if isinstance(obj, CheckerDaemon):
                obj.admission.start_drain()
            obj.httpd.shutdown()
            t.join(timeout=60)
            obj.close()
        servers.clear()

    def stop_procs():
        """SIGTERM every member and child still running (a stopped one
        is continued first), then wait; SIGKILL past 60 s."""
        for p in procs:
            if p.poll() is None:
                try:
                    os.kill(p.pid, signal.SIGCONT)
                    p.terminate()
                except ProcessLookupError:
                    pass
        for p in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=60)
        procs.clear()

    def spawn(mid, fdir, store, epoch=0, **kw):
        lp = os.path.join(os.path.dirname(fdir), f"member-{mid}-e{epoch}.log")
        p = launcher.spawn_fleet_member(mid, fdir, store, device=device,
                                        epoch=epoch, log_path=lp, **kw)
        procs.append(p)
        return p, lp

    try:
        # -- fleet_door: two in-process members on this plane -----------
        fdir = os.path.join(root, "door", "fleet")
        store = os.path.join(root, "door", "store")
        members = [serve(CheckerDaemon(
            root=store, port=0, device=device, fleet_dir=fdir,
            member_id=i, own_plane=(i == 0),
            coalesce_hold_s=SERVICE_HOLD_S)) for i in (0, 1)]
        check(device == "cpu" or (members[0].plane.device.type == "cuda"
                                  and members[0].plane.degrade is False
                                  and members[1].plane is members[0].plane),
              f"fleet_door's plane: {members[0].plane.device}")
        door = serve(FleetFrontDoor(fdir, port=0, forward_timeout_s=600))
        rdoor = serve(FleetFrontDoor(fdir, port=0, mode="redirect"))
        with Phase("fleet_door") as info:
            tenants = [f"tenant-{i % 5}" for i in range(len(hists))]
            bodies = [body(h) for h in hists]
            outs, errs = [None] * len(hists), []
            walls = [None] * len(hists)
            gate = threading.Barrier(len(hists))

            def go(i):
                try:
                    cl = client(door.port, tenants[i])
                    gate.wait()
                    t1 = time.perf_counter()
                    outs[i] = cl._roundtrip("POST", "/check", bodies[i])
                    walls[i] = time.perf_counter() - t1
                except Exception as e:  # noqa: BLE001 - checked below
                    errs.append(e)

            dp.reset_dispatch_stats()
            start("fleet_door")
            t0 = time.perf_counter()
            ts = [threading.Thread(target=go, args=(i,))
                  for i in range(len(hists))]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
            stats = snap()
            pst = plane_summary(dp)
            fst = door.fleet_stats()
            # one redirect-mode request: the client follows the 307 to
            # the owner, which answers without the door's relay
            rtenant = "redirect"
            t0 = time.perf_counter()
            rout = client(rdoor.port, rtenant).check(hists[0])
            rwall = time.perf_counter() - t0
            counts = stop("fleet_door", ["bitset_scan"])
            rst = rdoor.fleet_stats()
            check(not errs, f"fleet_door: {errs}")
            for i, (o, w) in enumerate(zip(outs, wants)):
                same_verdict(o, w, f"fleet_door request {i}")
                check(o["fleet_member"] == ring.route(tenants[i]),
                      f"fleet_door request {i}: served by "
                      f"{o['fleet_member']}, owner {ring.route(tenants[i])}")
            same_verdict(rout, wants[0], "fleet_door redirect")
            assert_not_degraded(outs + [rout], "fleet_door")
            rowner = ring.route(rtenant)
            check("fleet_member" not in rout
                  and rst["door"]["redirects"] == 1
                  and members[rowner].ledger.snapshot()[rtenant]
                  ["completed"] == 1, f"fleet_door redirect {rst['door']}")
            check(fst["rollup"]["completed"] == len(hists)
                  and fst["rollup"]["valid"] == sum(
                      1 for w in wants if w["valid?"])
                  and fst["door"]["proxied"] == len(hists)
                  and fst["door"]["steals"] == 0,
                  f"fleet_door rollup {fst['rollup']} {fst['door']}")
            info.update(
                requests=len(hists), tenants=len(set(tenants)),
                members=2, hold_s=SERVICE_HOLD_S, wall_s=wall,
                client_walls_s=walls,
                owners={t: ring.route(t) for t in sorted(set(tenants))},
                served_by=[o["fleet_member"] for o in outs],
                methods=[o["method"] for o in outs], launch=stats,
                dispatch=pst, kernel_launches=counts,
                rollup=fst["rollup"],
                rollup_note="each in-process member's /stats reports "
                            "this process's launch counters, so the "
                            "rollup counts them once per member",
                door=fst["door"],
                redirect=dict(wall_s=rwall, member=rowner,
                              valid=rout["valid?"]))
        close_servers()
        dp.reset_default_plane()
        chaos.reset_resilience()

        # -- fleet_handoff: subprocess members, a SIGKILLed owner -------
        hroot = os.path.join(root, "handoff")
        fdir = os.path.join(hroot, "fleet")
        store = os.path.join(hroot, "store")
        os.makedirs(fdir)
        ev = ev_mod.history_to_events(north_h)
        steps = ev_mod.events_to_steps(ev, W=bs.plan(
            bs.get_model("cas-register"), ev.window,
            len(ev.value_codes))[0])
        min_len = c.get("seg_min_len") or max(512, len(steps) // 48)
        n_segs = len(bs._plan_for(steps, min_len))
        check(n_segs >= 3, f"fleet_handoff: {n_segs} segments")
        tenant = "handoff"
        owner = ring.route(tenant)
        succ = 1 - owner
        kill_py = os.path.join(hroot, "kill_member.py")
        with open(kill_py, "w") as f:
            f.write(_KILL_MEMBER.format(python=sys.executable, root=here,
                                        k=2))
        os.chmod(kill_py, 0o755)
        seg_env = {"JEPSEN_TPU_SEG_MIN_LEN": str(min_len)}
        with Phase("fleet_handoff") as info:
            t0 = time.perf_counter()
            if device != "cpu":  # built by the build phase: a stat each
                launcher.build_member_libraries()
            build_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            spawned = {mid: spawn(mid, fdir, store, extra_env=seg_env,
                                  python=kill_py if mid == owner else None)
                       for mid in (0, 1)}
            up = wait_members(fdir, {(0, 0), (1, 0)}, t0,
                              list(spawned.values()))
            door = serve(FleetFrontDoor(fdir, port=0,
                                        forward_timeout_s=600))
            durable = body(north_h, durable=True)
            path = Store(store).service_checkpoint_path(
                tenant, check_id_for("cas-register", durable))
            t0 = time.perf_counter()
            out = client(door.port, tenant)._roundtrip("POST", "/check",
                                                       durable)
            wall = time.perf_counter() - t0
            oproc = spawned[owner][0]
            oproc.wait(timeout=60)
            fst = door.fleet_stats()
            surl = FleetRegistry(fdir).member_by_id(succ).url
            sst = client(int(surl.rsplit(":", 1)[1])).stats()
            ck = out.get("checkpoint") or {}
            same_verdict(out, north_r, "fleet_handoff")
            assert_not_degraded([out], "fleet_handoff")
            check(oproc.returncode == -9,
                  f"fleet_handoff owner exit {oproc.returncode}: "
                  f"{log_tail(spawned[owner][1])}")
            check(out["fleet_member"] == succ
                  and ck.get("resumed_from_segment") == 2
                  and ck.get("resumed_from_owner") == f"member-{owner}"
                  and ck.get("owner") == f"member-{succ}",
                  f"fleet_handoff checkpoint {out.get('fleet_member')} {ck}")
            srow = fst["members"][str(succ)]
            check(sst["checkpoint"]["handoffs"] == 1
                  and srow["launches"] == n_segs - 2
                  and fst["door"]["member_deaths"] == 1
                  and fst["door"]["handoffs"] == 1,
                  f"fleet_handoff: successor {sst['checkpoint']} {srow}, "
                  f"door {fst['door']}")
            check(chaos.quarantined_hosts() == (str(owner),)
                  and chaos.quarantined_devices() == ()
                  and os.listdir(door.intent_dir) == [],
                  f"fleet_handoff: {chaos.resilience_snapshot()}")
            check(json.load(open(path))["verdict"] is not None,
                  "fleet_handoff: the checkpoint holds no verdict")
            info.update(
                owner=owner, successor=succ, segments=n_segs,
                seg_min_len=min_len, build_s=build_s,
                spawn_to_announce_s=up, wall_s=wall,
                check_wall_s=out["wall_s"], checkpoint=ck,
                successor_launches=srow["launches"],
                successor_host_syncs=srow["host_syncs"],
                cold_launches=n_segs,
                successor_checkpoint=sst["checkpoint"],
                door=fst["door"], rollup=fst["rollup"],
                quarantined_hosts=list(chaos.quarantined_hosts()))

        # -- fleet_gray: SIGSTOP a member; its tenant is hedged --------
        with Phase("fleet_gray") as info:
            # the supervisor respawns the dead owner at epoch 1
            sup = FleetSupervisor(
                fdir, (0, 1), store_root=store,
                policy=SupervisionPolicy(confirm_s=0.0),
                spawn_kwargs=dict(device=device, log_path=os.path.join(
                    hroot, f"member-{owner}-e1.log")))
            t0 = time.perf_counter()
            check(sup.poll_once() == [owner], "fleet_gray: no respawn")
            rproc = sup.procs[owner]
            procs.append(rproc)
            respawn = wait_members(fdir, {(owner, 1)}, t0, [(
                rproc, os.path.join(hroot, f"member-{owner}-e1.log"))])
            check(not chaos.is_quarantined(f"host:{owner}"),
                  "fleet_gray: the respawned member is quarantined")
            gdoor = serve(FleetFrontDoor(
                fdir, port=0, forward_timeout_s=FLEET_GRAY_TIMEOUT_S))
            gtenant = owned_by(owner, "gray")
            os.kill(rproc.pid, signal.SIGSTOP)
            try:
                t0 = time.perf_counter()
                gout = client(gdoor.port, gtenant)._roundtrip(
                    "POST", "/check", body(hists[1]))
                gwall = time.perf_counter() - t0
                hosts = chaos.quarantined_hosts()
                with gdoor._stats_lock:
                    gcount = dict(gdoor._counters)
            finally:
                os.kill(rproc.pid, signal.SIGCONT)
            same_verdict(gout, wants[1], "fleet_gray")
            assert_not_degraded([gout], "fleet_gray")
            check(gout["fleet_member"] == succ
                  and str(owner) not in hosts
                  and gcount["suspects"] == 1 and gcount["hedges"] == 1
                  and gcount["member_deaths"] == 0,
                  f"fleet_gray: {gout['fleet_member']} {hosts} {gcount}")
            rurl = FleetRegistry(fdir).member_by_id(owner).url
            t0 = time.perf_counter()
            after = client(int(rurl.rsplit(":", 1)[1]), gtenant).check(
                hists[1])
            same_verdict(after, wants[1], "fleet_gray after SIGCONT")
            info.update(
                stopped=owner, hedged_to=succ, respawn_epoch=1,
                respawn_to_announce_s=respawn[owner],
                forward_timeout_s=FLEET_GRAY_TIMEOUT_S, wall_s=gwall,
                door=gcount, quarantined_hosts=list(hosts),
                health=gdoor.health_snapshot(),
                after_sigcont_wall_s=time.perf_counter() - t0,
                supervisor=sup.snapshot())
        stop_procs()
        close_servers()
        chaos.reset_resilience()

        # -- fleet_drill: `cli fleet-drill` as a child ------------------
        with Phase("fleet_drill") as info:
            dstore = os.path.join(root, "drill")
            report = os.path.join(root, "drill-report.json")
            t0 = time.perf_counter()
            proc = subprocess.Popen(
                [sys.executable, "-m", "jepsen_tpu_torch.cli",
                 "fleet-drill", *FLEET_DRILL, "--store", dstore,
                 "--report", report, *backend],
                cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)
            procs.append(proc)
            out, err = proc.communicate(timeout=600)
            wall = time.perf_counter() - t0
            check(proc.returncode == 0 and "fleet drill clean" in out,
                  f"fleet_drill exit {proc.returncode}: {err[-3000:]}")
            r = json.load(open(report))
            fired = [f for f in r["nemesis"]["fired"]
                     if f["kind"] != "release"]
            missed = [f for f in fired if "missed" in f]
            victim = next(f["member_id"] for f in fired
                          if f["kind"] == "kill")
            sup = r["supervisor"]
            check(r["clean"] and {f["kind"] for f in fired}
                  == set(FAULT_KINDS),
                  f"fleet_drill: {r['violations']} {fired}")
            check(sup["respawns"] == {str(victim): 1,
                                      str(1 - victim): 0}
                  and sup["epochs"] == {str(victim): 1}
                  and not sup["exhausted"],
                  f"fleet_drill supervisor {sup}")
            check(r["oracle"]["device"] == ("cpu" if device == "cpu"
                                            else "cuda:0")
                  and r["parity"]["compared"] == r["checks"]["unique"] > 0
                  and r["parity"]["mismatches"] == [],
                  f"fleet_drill parity {r['parity']} {r['oracle']}")
            info.update(
                wall_s=wall, params=r["params"], checks=r["checks"],
                faults=[f["kind"] for f in fired], missed=missed,
                supervisor=sup, door=r["door"], oracle=r["oracle"],
                parity_compared=r["parity"]["compared"],
                final_sample=r["final_sample"], samples=r["samples"])

        # -- fleet_cli: `cli fleet` as a child -------------------------
        with Phase("fleet_cli") as info:
            port = launcher.free_port()
            t0 = time.perf_counter()
            proc = subprocess.Popen(
                [sys.executable, "-m", "jepsen_tpu_torch.cli", "fleet",
                 "--members", "2", "--store", os.path.join(root, "cli"),
                 "--port", str(port), *backend],
                cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)
            procs.append(proc)
            cl = client(port, "cli")
            end = time.perf_counter() + 300
            while True:
                if proc.poll() is not None:
                    check(False, f"fleet_cli exited {proc.returncode}: "
                          f"{proc.communicate()[1][-2000:]}")
                try:
                    if cl.health().get("members_alive") == 2:
                        break
                except (OSError, ServiceError):
                    pass
                check(time.perf_counter() < end, "fleet_cli never up")
                time.sleep(0.1)
            up_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            fout = cl.check(hists[0])
            post_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            out, err = proc.communicate(timeout=300)
            drain_s = time.perf_counter() - t0
            same_verdict(fout, wants[0], "fleet_cli")
            check(fout["fleet_member"] == ring.route("cli"),
                  f"fleet_cli served by {fout['fleet_member']}")
            check(proc.returncode == 0 and "fleet drained. (code 0)" in out,
                  f"fleet_cli exit {proc.returncode}: {err[-2000:]}")
            info.update(up_s=up_s, post_wall_s=post_s, drain_s=drain_s,
                        member=fout["fleet_member"], exit=proc.returncode)
    finally:
        stop_procs()
        close_servers()
        dp.reset_default_plane()
        chaos.reset_resilience()
        shutil.rmtree(root, ignore_errors=True)


# -- the perf layer: knob sweep, tuned profile, trend ledger ------------------

#: the tune phase's sweep budget, seconds (the command's default)
TUNE_BUDGET_S = 60.0


def _same_rung(a, b) -> bool:
    """Knob values as the profile JSON carries them (ladders as lists)."""
    norm = (lambda v: list(v) if isinstance(v, (list, tuple)) else v)
    return norm(a) == norm(b)


def perf_phases(ctx: dict) -> None:
    """The perf layer on the card (perf/, obs/trend.py and the CLI's
    perf-trend, tune and --profile): perf_trend renders the trend
    ledger; tune sweeps the knob registry on the card into a temporary
    profile directory, the probes' kernel-A launches counted from 0 and
    recorded like every other launch, the txn probe's graph launches
    held against graph_counts_torch on CPU copies; tuned runs that
    profile through --profile (analyze on the north star and on config
    1's runs, and one service_burst on a default plane built under it),
    each verdict held to the untuned one and each wall printed beside
    the untuned wall of the same work earlier in this call. The
    profile directory and the active profile are restored afterwards,
    so nothing later in this call, or any later run, reads them."""
    import contextlib
    import io
    import shutil
    import tempfile
    import threading

    from jepsen_tpu_torch import cli
    from jepsen_tpu_torch.checker import dispatch as dp
    from jepsen_tpu_torch.checker import txn_graph as tg
    from jepsen_tpu_torch.history.history import History
    from jepsen_tpu_torch.obs import trend
    from jepsen_tpu_torch.perf import autotune, knobs
    from jepsen_tpu_torch.service.server import CheckerDaemon
    from jepsen_tpu_torch.store import Store

    c = ctx
    start, stop, snap = c["start"], c["stop"], c["launch_stats_snapshot"]
    walls = c["walls"]
    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="chip_smoke_perf_", dir=c["scratch"])

    def run_cli(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            code = cli.main(argv)
        return code, buf.getvalue()

    def verdict(r):
        return {k: r.get(k) for k in ("valid?", "failed_op_index",
                                      "failure")}

    try:
        with Phase("perf_trend") as info:
            ledger = os.path.join(here, "bench_runs", "trend.jsonl")
            rows = trend.load_trend_rows(ledger)
            code, out = run_cli(["perf-trend", "--ledger", ledger])
            ok, msgs = trend.gate_trend(rows, 0.10)
            table = [ln for ln in out.splitlines()
                     if not ln.startswith("perf-trend:")]
            check(len(rows) > 0 and code == (
                cli.EXIT_VALID if ok else cli.EXIT_INVALID),
                f"perf_trend exit {code} on {len(rows)} rows: {out}")
            check(len(table) == len(rows) + 1,
                  f"perf_trend rendered {len(table)} lines for "
                  f"{len(rows)} rows")
            info.update(exit=code, rows=len(rows), gate=msgs,
                        trajectories=sorted({trend.trend_key(r)
                                             for r in rows}),
                        rows_are=("the JAX package's bench rows, rendered "
                                  "as they are; no row is the card's"))

        pdir = os.path.join(root, "profiles")
        prev_dir = os.environ.get(autotune.PROFILE_DIR_ENV)
        os.environ[autotune.PROFILE_DIR_ENV] = pdir
        tuned_path = os.path.join(root, "tuned_profile.json")
        graphs = GraphRecorder(tg)
        try:
            with Phase("tune") as info:
                start("tune")
                t0 = time.perf_counter()
                code, out = run_cli(["tune", "--budget-s",
                                     str(TUNE_BUDGET_S)])
                wall = time.perf_counter() - t0
                counts = stop("tune", ["bitset_scan"])
                graph_rows = graph_launch_rows(tg, graphs.take())
                check(code == cli.EXIT_VALID, f"tune exit {code}: {out}")
                key = autotune.current_key()
                path = autotune.profile_path(key)
                with open(path) as f:
                    doc = json.load(f)
                with open(path[:-len(".json")] + ".evidence.json") as f:
                    ev = json.load(f)
                check(doc["key"] == key and key["backend"] == "cuda"
                      and key["device_name"] == torch.cuda.get_device_name(0)
                      and key["torch_version"] == torch.__version__
                      and key["cuda_version"] == str(torch.version.cuda),
                      f"tune profile key {doc['key']}")
                check(autotune.load_profile(path) is not None,
                      "tune's profile does not load for the card's key")
                winners = doc["knobs"]
                for name, val in winners.items():
                    check(any(r.get("parity") and _same_rung(r["rung"], val)
                              for r in ev["evidence"][name]),
                          f"tune: winner {name}={val} holds no parity")
                check(sorted(winners) == sorted(
                    n for n, rs in ev["evidence"].items()
                    if any(r.get("parity") for r in rs)),
                    f"tune: winners {sorted(winners)}")
                if "txn_graph.graph_buckets" in ev["evidence"]:
                    check(len(graph_rows) > 0,
                          "tune: the txn probe launched no graph program")
                check(counts["kfrontier_scan"] == 0,
                      f"tune: the probes left the bitset envelope {counts}")
                shutil.copyfile(path, tuned_path)
                off = {n: v for n, v in winners.items()
                       if not _same_rung(v, knobs.KNOBS[n].default)}
                info.update(
                    exit=code, wall_s=wall, sweep_elapsed_s=ev["elapsed_s"],
                    budget_s=ev["budget_s"], swept=sorted(ev["evidence"]),
                    skipped=ev["skipped"], winners=winners,
                    off_default=off, config_hash=doc["config_hash"],
                    key=key, kernel_launches=counts,
                    rejected_rungs={n: [r["rung"] for r in rs
                                        if "rung" in r and not r["parity"]]
                                    for n, rs in ev["evidence"].items()},
                    rung_costs_s={n: [r.get("cost_s") for r in rs
                                      if "rung" in r]
                                  for n, rs in ev["evidence"].items()},
                    graph_launches=len(graph_rows),
                    graph_max_abs_err=max(
                        [r["max_abs_err"] for r in graph_rows], default=0),
                    output=out.splitlines())
        finally:
            graphs.close()
            if prev_dir is None:
                os.environ.pop(autotune.PROFILE_DIR_ENV, None)
            else:
                os.environ[autotune.PROFILE_DIR_ENV] = prev_dir
            shutil.rmtree(pdir, ignore_errors=True)

        st = Store(os.path.join(root, "store"))

        def save(name, ops):
            return st.save_1({"name": name, "workload": "register",
                              "history": History(ops, indexed=True)})

        d = serving = None
        try:
            with Phase("tuned") as info:
                north_run = save("northstar", c["north_h"].ops)
                runs = [save(f"config1-{i}", h.ops)
                        for i, h in enumerate(c["config1_hists"])]
                start("tuned_northstar")
                t0 = time.perf_counter()
                code, _ = run_cli(["analyze", north_run, "--store", st.root,
                                   "--profile", tuned_path])
                wall_n = time.perf_counter() - t0
                counts_n = stop("tuned_northstar", ["bitset_scan"])
                res = st.load_results(north_run)
                check(code == cli.EXIT_VALID
                      and verdict(res) == verdict(c["north_r"]),
                      f"tuned north star: {code} {verdict(res)}")
                perf = res["engine_stats"]["perf"]
                check(perf["tuned"] is True and perf["profile"] == tuned_path
                      and perf["config_hash"] == doc["config_hash"],
                      f"tuned north star perf {perf}")
                start("tuned_config1")
                outs = []
                for run_dir in runs:
                    t0 = time.perf_counter()
                    code, _ = run_cli(["analyze", run_dir, "--store",
                                       st.root, "--profile", tuned_path])
                    outs.append((code, time.perf_counter() - t0,
                                 st.load_results(run_dir)))
                counts_c = stop("tuned_config1", ["bitset_scan"])
                for i, ((code, _, r), want) in enumerate(
                        zip(outs, c["config1_rows"])):
                    check(code == cli._exit_code(want)
                          and verdict(r) == verdict(want)
                          and r["engine_stats"]["perf"]["tuned"] is True,
                          f"tuned config1 run {i}: {code} {verdict(r)}")
                # one burst on a default plane built under the profile
                dp.reset_default_plane()
                d = CheckerDaemon(root=os.path.join(root, "service"),
                                  port=0, coalesce_hold_s=SERVICE_HOLD_S)
                serving = threading.Thread(target=d.serve_forever,
                                           daemon=True)
                serving.start()
                plane_knobs = {
                    "max_batch": d.plane.max_batch,
                    "coalesce_wait_s": d.plane.coalesce_wait_s,
                    "max_inflight_trains": d.plane.max_inflight_trains,
                    "tail_bucket": d.plane._tail_bucket}
                check(plane_knobs["max_batch"] == knobs.resolve(
                    "dispatch.max_batch") and knobs.tuned(),
                    f"tuned burst plane {plane_knobs}")
                got = service_burst(d, c["config1_hists"], c["config1_rows"],
                                    start, stop, snap, "tuned_burst")
                info.update(
                    profile=tuned_path, perf=perf, plane_knobs=plane_knobs,
                    northstar=dict(
                        wall_s=wall_n, untuned_wall_s=walls["cli_northstar"],
                        check_wall_s=res["wall_s"],
                        launch=res["engine_stats"]["launch"],
                        kernel_launches=counts_n),
                    config1=dict(
                        walls_s=[o[1] for o in outs],
                        untuned_walls_s=walls["cli_config1"],
                        wall_s=sum(o[1] for o in outs),
                        untuned_wall_s=sum(walls["cli_config1"]),
                        kernel_launches=counts_c),
                    service_burst=dict(
                        wall_s=got["wall_s"],
                        untuned_wall_s=walls["service_burst"],
                        kernel_launches=got["kernel_launches"],
                        dispatch=got["dispatch"]),
                    walls_are=("one run each after the sweep, beside the "
                               "same work's untuned wall earlier in this "
                               "call: records, not a claim"))
        finally:
            if d is not None:
                d.admission.start_drain()
                d.httpd.shutdown()
                serving.join(timeout=60)
                d.close()
            knobs.set_active({}, source=None)
            os.environ.pop(autotune.PROFILE_ENV, None)
            dp.reset_default_plane()
    finally:
        shutil.rmtree(root, ignore_errors=True)


#: stream_gc: one stream of a 200,000-op history in 100 appends, GC'd
#: past 4,096 retained ops
STREAM_GC = dict(n_ops=200_000, appends=100, gc_window=4096)

#: NVIDIA's published float32 rate of one H100 SXM outside the tensor
#: cores (data sheet, 700 W), for the columnar phases' device programs
FP32_FLOP_S = 67e12

#: NVIDIA's published dense bfloat16 tensor-core rate of one H100 SXM
#: (data sheet, 700 W), for the txn graph's exact 0/1 products
BF16_FLOP_S = 989e12


def program_bound(nbytes: float, flops: float,
                  flop_s: float = FP32_FLOP_S) -> tuple:
    """(ms, "bytes" | "operations"): the least time of a torch-ops
    device program, its bytes over the HBM rate or its operations over
    flop_s (float32 outside the tensor cores by default), whichever is
    larger."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / flop_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def host_ms(fn, reps: int = 5) -> float:
    """Mean host-clock milliseconds of fn() over reps runs (numpy)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def counter_history(seed: int, n_ops: int):
    """A seeded counter history of n_ops invocations over 10 processes,
    each with at most one open op: adds of whole and quarter deltas
    (every partial sum exact in float64, in any summation order), 5 %
    of them failed; an add takes effect at its completion and a read
    returns the counter at its own, so every read lies in its bounds."""
    from jepsen_tpu_torch.history.history import History
    from jepsen_tpu_torch.history.ops import fail_op, invoke_op, ok_op

    rng = random.Random(seed)
    ops, val, open_op, invoked = [], 0.0, {}, 0
    while invoked < n_ops or open_op:
        p = rng.randrange(10)
        if p in open_op:
            d = open_op.pop(p)
            if d is None:
                ops.append(ok_op(p, "read",
                                 int(val) if val.is_integer() else val))
            elif rng.random() < 0.05:
                ops.append(fail_op(p, "add", d))
            else:
                val += d
                ops.append(ok_op(p, "add", d))
        elif invoked < n_ops:
            invoked += 1
            if rng.random() < 0.5:
                d = (rng.randrange(1, 40) / 4 if rng.random() < 0.3
                     else rng.randrange(0, 9))
                open_op[p] = d
                ops.append(invoke_op(p, "add", d))
            else:
                open_op[p] = None
                ops.append(invoke_op(p, "read"))
    return History(ops)


#: the key-axis and plane phases, replayed by replay() (batch_parity)
#: config 2's 16 keys in a pod member (pod_card): the generator's seeds
#: are the config2 phase's, so the member checks the same histories
_POD_BODY = """
import json, random, time
from jepsen_tpu_torch import sim
from jepsen_tpu_torch.checker import wgl_bitset as bs
from jepsen_tpu_torch.checker.events import history_to_events
from jepsen_tpu_torch.checker.sharded import check_keys, default_mesh
from jepsen_tpu_torch.checker.sharded import mesh_size
from jepsen_tpu_torch.device import launch_stats_snapshot
from jepsen_tpu_torch.pod import topology

evs = [history_to_events(sim.gen_register_history(
    random.Random(1000 + k), n_ops=625, n_procs=5, p_crash=0.005))
    for k in range(16)]
mesh = default_mesh()
assert mesh is not None and mesh_size(mesh) == 2, mesh
t0 = time.perf_counter()
res = check_keys(evs, mesh=mesh)
wall = time.perf_counter() - t0
snap = topology.topology_snapshot()
if snap["process_index"] == 0:
    print(json.dumps({"res": res, "wall_s": wall, "mesh": repr(mesh),
                      "launch": launch_stats_snapshot(),
                      "kernel_launches": bs.bitset_scan.launches,
                      "topology": snap, "clock": topology.pod_clock(),
                      "collective": topology.collective_backend()}),
          flush=True)
"""


def mesh_phases(ctx: dict) -> None:
    """The mesh and the pod on the card: virtual slots (each its own
    CUDA stream on the one card) under check_keys, the dispatch plane
    and the txn graph, each path's counts from 0 and every kernel-A
    launch recorded (one per slot) and replayed; then a 2-process gloo
    pod sharing the card. Each holds its verdicts against the unsharded
    phase's on the same histories."""
    from jepsen_tpu_torch.checker import chaos, sharded
    from jepsen_tpu_torch.checker import dispatch as dp
    from jepsen_tpu_torch.checker import txn_graph as tg
    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
    from jepsen_tpu_torch.pod import launcher

    c = ctx
    ev_mod, bs = c["ev_mod"], c["bs"]
    snap, start, stop = c["launch_stats_snapshot"], c["start"], c["stop"]
    dev = torch.device("cuda")
    mesh2 = sharded.virtual_mesh(dev, 2)

    def mesh_info():
        st = sharded.mesh_stats_snapshot()
        return {k: st[k] for k in ("sharded_launches", "last_n_devices",
                                   "resilience")}

    def keys_phase(phase, hists, want, launches, syncs):
        sharded.reset_mesh_stats()
        evs = [ev_mod.history_to_events(h) for h in hists]
        start(phase)
        t0 = time.perf_counter()
        res = sharded.check_keys(evs, mesh=mesh2)
        wall = time.perf_counter() - t0
        stats = snap()
        counts = stop(phase, ["bitset_scan"])
        check(stats["launches"] == launches and stats["host_syncs"] == syncs
              and counts["bitset_scan"] == 2 * launches,
              f"{phase}: {stats} {counts}")
        ms = mesh_info()
        check(ms["sharded_launches"] == launches
              and ms["last_n_devices"] == 2, f"{phase}: {ms}")
        for k, (r, w) in enumerate(zip(res, want)):
            same_verdict(r, w, f"{phase} key {k}")
        check(len(res) == len(want), f"{phase}: {len(res)} verdicts")
        assert_not_degraded(res, phase)
        return dict(keys=len(res), slots=2, wall_s=wall, launch=stats,
                    kernel_launches=counts, mesh=ms)

    with Phase("mesh_config2") as info:
        info.update(keys_phase("mesh_config2", c["zk_hists"],
                               c["config2_res"], 1, 1),
                    unsharded_wall_s=c["config2_wall"])
        info["corrupted"] = keys_phase(
            "mesh_config2_corrupted", c["config2_bad"],
            c["config2_bad_res"], 2, 2)

    with Phase("mesh_keys_scale") as info:
        # 127 keys on 2 slots: one blank pad row, the uneven split
        info.update(keys_phase("mesh_keys_scale", c["scale_hists"][:127],
                               c["scale_res"][:127], 1, 1))

    with Phase("mesh_plane") as info:
        plane = dp.DispatchPlane(mesh=mesh2, race=False)
        pchecker = LinearizableChecker("cas-register", plane=plane)
        dp.reset_dispatch_stats()
        sharded.reset_mesh_stats()
        start("mesh_plane")
        t0 = time.perf_counter()
        resolvers = [pchecker.check_async(None, h)
                     for h in c["config1_hists"]]
        plane.flush()
        outs = [r() for r in resolvers]
        wall = time.perf_counter() - t0
        stats = snap()
        pst = plane_summary(dp)
        per_slot = dp.dispatch_stats()["per_device"]
        counts = stop("mesh_plane", ["bitset_scan"])
        for i, (o, want) in enumerate(zip(outs, c["config1_rows"])):
            same_verdict(o, want, f"mesh_plane history {i}")
        assert_not_degraded(outs, "mesh_plane")
        dead = sum(1 for o in outs if o["valid?"] is False)
        collects = stats["host_syncs"] - stats["escalations"] - dead
        check(1 <= collects <= pst["train_registers"],
              f"mesh_plane {stats} {pst}")
        # every stacked launch runs one block on each slot
        check(list(per_slot) == ["cuda:0[0]", "cuda:0[1]"]
              and all(b["launches"] == pst["batches"]
                      for b in per_slot.values()),
              f"mesh_plane per slot {per_slot} {pst}")
        check(mesh_info()["sharded_launches"] >= 1, "mesh_plane unsharded")
        info.update(wall_s=wall, sequential_wall_s=c["config1_wall"],
                    trains_collected=collects, launch=stats, dispatch=pst,
                    per_slot=per_slot, kernel_launches=counts,
                    mesh=mesh_info())

        # three north-star-shaped segmented solo chains round-robin over
        # the 2 slots: slot 0, slot 1, slot 0
        dp.reset_dispatch_stats()
        start("mesh_plane_chains")
        t0 = time.perf_counter()
        ev = ev_mod.history_to_events(c["north_h"])
        futs = [plane.submit(ev) for _ in range(3)]
        chains = [f.result() for f in futs]
        wall = time.perf_counter() - t0
        stats = snap()
        per_slot = dp.dispatch_stats()["per_device"]
        counts = stop("mesh_plane_chains", ["bitset_scan"])
        for o in chains:
            same_verdict(o, c["north_r"], "mesh_plane chain")
        check([per_slot[s]["launches"] for s in ("cuda:0[0]", "cuda:0[1]")]
              == [2, 1] and dp.DISPATCH_STATS["solo_launches"] == 3,
              f"mesh_plane chains per slot {per_slot}")
        check(stats["launches"] == 3, f"mesh_plane chains {stats}")
        assert_not_degraded(chains, "mesh_plane chains")
        plane.close()
        info["chains"] = dict(wall_s=wall, launch=stats, per_slot=per_slot,
                              kernel_launches=counts)

        # a persistent fault on slot 1: on 2 slots the ladder collapses
        # to one device (the reference's rule: fewer than 2 survivors),
        # on 3 it re-shards onto the 2 survivors
        faults = {}
        for n in (2, 3):
            chaos.reset_resilience()
            sharded.reset_mesh_stats()
            # two earlier attributed failures: the plane's first on the
            # slot reaches chaos.note_device_failure's threshold of 3
            for _ in range(2):
                chaos.note_device_failure("cuda:0[1]")
            plane = dp.DispatchPlane(mesh=sharded.virtual_mesh(dev, n),
                                     race=False)
            pchecker = LinearizableChecker("cas-register", plane=plane)
            with chaos.chaos_plan(
                    chaos.persistent_device_fault("cuda:0[1]")):
                resolvers = [pchecker.check_async(None, h)
                             for h in c["config1_hists"]]
                plane.flush()
                outs = [r() for r in resolvers]
            for i, (o, want) in enumerate(zip(outs, c["config1_rows"])):
                same_verdict(o, want, f"mesh_plane fault {n} history {i}")
            res = chaos.resilience_snapshot()
            ms = mesh_info()
            check(res["quarantined_devices"] == ["cuda:0[1]"]
                  and res["oracle_fallbacks"] == 0
                  and not any("degraded" in o for o in outs),
                  f"mesh_plane fault on {n} slots: {res}")
            if n == 2:
                check(plane.mesh is None and res["degradations"] == 1
                      and ms["resilience"]["resharded_launches"] == 0,
                      f"mesh_plane fault on 2 slots: {plane.mesh} {ms}")
            else:
                check(plane.mesh is not None
                      and sharded.mesh_size(plane.mesh) == 2
                      and ms["resilience"]["resharded_launches"] == 1,
                      f"mesh_plane fault on 3 slots: {plane.mesh} {ms}")
            faults[f"{n}_slots"] = dict(
                mesh_after=repr(plane.mesh), resilience=res, mesh=ms)
            plane.close()
        chaos.reset_resilience()
        info["slot_fault"] = faults

    with Phase("mesh_graph") as info:
        # config 6's graph buckets sharded over the 2 slots of a plane's
        # mesh, and config6_wide's 1,500-txn component row-sharded
        h, want, want_wall = c["config6"]
        plane = dp.DispatchPlane(mesh=mesh2)
        tg.reset_txn_graph_stats()
        sharded.reset_mesh_stats()
        c["reset_launch_stats"]()
        t0 = time.perf_counter()
        r = tg.TxnGraphChecker(plane=plane).check({}, h)
        wall = time.perf_counter() - t0
        stats, ms = snap(), mesh_info()
        keys = ("valid?", "census", "anomalies", "edges", "n_txns",
                "components")
        check({k: r.get(k) for k in keys} == {k: want.get(k) for k in keys},
              f"mesh_graph: {r.get('census')} vs {want.get('census')}")
        check(ms["sharded_launches"] > 0 and ms["last_n_devices"] == 2,
              f"mesh_graph {stats} {ms}")
        ho, wo = c["oversize"]
        tg.reset_txn_graph_stats()
        c["reset_launch_stats"]()
        t0 = time.perf_counter()
        ro = tg.TxnGraphChecker(plane=plane, mesh=mesh2).check({}, ho)
        wall_o = time.perf_counter() - t0
        so, stats_o = tg.txn_graph_stats(), snap()
        check({k: ro.get(k) for k in keys} == {k: wo.get(k) for k in keys}
              and so["row_sharded_launches"] == 1
              and so["host_fallback_components"] == 0,
              f"mesh_graph oversize: {ro.get('census')} {so}")
        plane.close()
        assert_not_degraded([r, ro], "mesh_graph")
        info.update(wall_s=wall, unsharded_wall_s=want_wall,
                    launch=stats, mesh=ms, census=r["census"],
                    oversize=dict(wall_s=wall_o, launch=stats_o,
                                  census=ro["census"],
                                  row_sharded_launches=so[
                                      "row_sharded_launches"]))

    with Phase("pod_card") as info:
        # 2 processes, one virtual slot each, both on cuda:0: the pod
        # gathers over gloo (NCCL refuses two ranks on one card)
        t0 = time.perf_counter()
        procs = launcher.launch_pod(2, _POD_BODY, n_local_devices=1,
                                    timeout_s=240)
        spawn_to_result = time.perf_counter() - t0
        for p in procs:
            check(p.ok, f"pod member {p.process_id} exit {p.returncode}: "
                  f"{p.stderr[-3000:]}")
        rec = json.loads([ln for ln in procs[0].stdout.splitlines()
                          if ln.startswith("{")][-1])
        for k, (r, w) in enumerate(zip(rec["res"], c["config2_res"])):
            same_verdict(r, w, f"pod_card key {k}")
        topo, clock = rec["topology"], rec["clock"]
        check(topo["n_hosts"] == 2 and clock is not None
              and "skew_bound_ns" in clock and rec["collective"] == "gloo",
              f"pod_card: {topo} {clock} {rec['collective']}")
        check(rec["launch"]["launches"] == rec["launch"]["host_syncs"] == 1
              and rec["kernel_launches"] == 1,
              f"pod_card member 0: {rec['launch']} "
              f"{rec['kernel_launches']}")
        info.update(spawn_to_result_s=spawn_to_result,
                    member_check_wall_s=rec["wall_s"], mesh=rec["mesh"],
                    launch=rec["launch"],
                    member_kernel_launches=rec["kernel_launches"],
                    topology=topo, clock=clock,
                    collective=rec["collective"])


def trace_lint_phases(ctx: dict) -> None:
    """The pod trace merge and planelint on the card's host.

    pod_trace: a stored config 1 run (the port's Store), one copy per
    member, analyzed by two `python -m jepsen_tpu_torch.cli analyze
    --trace` processes joined by the --pod-* flags (one slot each, both
    on cuda:0, gloo). lint: the port's `lint --json` on this tree.
    Every process started here is waited for or killed."""
    import shutil
    import tempfile
    from collections import Counter

    from jepsen_tpu_torch import cli, obs
    from jepsen_tpu_torch.checker import sharded
    from jepsen_tpu_torch.history.history import History
    from jepsen_tpu_torch.obs import podtrace
    from jepsen_tpu_torch.pod import launcher
    from jepsen_tpu_torch.store import Store

    c = ctx
    here = c["here"]
    root = tempfile.mkdtemp(prefix="chip_smoke_pod_trace_",
                            dir=c["scratch"])
    try:
        with Phase("pod_trace") as info:
            st = Store(root)
            want = c["config1_rows"][0]
            run = st.save_1({"name": "pod-trace", "workload": "register",
                             "history": History(c["config1_hists"][0].ops,
                                                indexed=True)})
            runs = []
            for i in range(2):
                runs.append(f"{run}.m{i}")
                shutil.copytree(run, runs[-1])
            trace = os.path.join(root, "trace", "pod.json")
            port = launcher.free_port()
            procs = []
            t0 = time.perf_counter()
            try:
                for i, d in enumerate(runs):
                    env = launcher.member_env()
                    env[sharded.ENV_LOCAL_DEVICES] = "1"
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "jepsen_tpu_torch.cli",
                         "analyze", d, "--store", root, "--trace", trace,
                         "--pod-coordinator", f"127.0.0.1:{port}",
                         "--pod-processes", "2", "--pod-index", str(i)],
                        env=env, cwd=here, stdout=subprocess.PIPE,
                        stderr=subprocess.PIPE, text=True))
                outs = [p.communicate(timeout=240) for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            spawn_to_result = time.perf_counter() - t0
            codes = [p.returncode for p in procs]
            for i, (code, (_, err)) in enumerate(zip(codes, outs)):
                check(code == cli._exit_code(want),
                      f"pod_trace member {i} exit {code} vs "
                      f"{cli._exit_code(want)}: {err[-3000:]}")
            launch = []
            for d in runs:
                res = st.load_results(d)
                check(all(res.get(k) == want.get(k) for k in
                          ("valid?", "failed_op_index", "failure")),
                      f"pod_trace {d}: {res.get('valid?')} vs "
                      f"{want.get('valid?')}")
                launch.append(res["engine_stats"]["launch"])
            trace_dir = os.path.dirname(trace)
            check(sorted(os.listdir(trace_dir)) == [
                "member-000.trace.json", "member-001.trace.json",
                "pod.json"], f"pod_trace files {os.listdir(trace_dir)}")
            with open(trace) as f:
                merged = json.load(f)
            errors = obs.validate_chrome_trace(merged)
            check(errors == [], f"pod_trace schema: {errors[:5]}")
            evs = merged["traceEvents"]
            rows = {e["pid"]: e["args"]["name"] for e in evs
                    if e["ph"] == "M" and e["name"] == "process_name"}
            check(rows == {1: "pod-member-0", 2: "pod-member-1"},
                  f"pod_trace process rows {rows}")
            for i, lc in enumerate(launch):
                got = Counter()
                for e in evs:
                    if e["pid"] == i + 1 and e.get("cat") == "launch_stat":
                        got[e["name"]] += e["args"].get("n", 1)
                check(all(got[k] == lc[k] for k in lc)
                      and set(got) <= set(lc) and lc["launches"] >= 1,
                      f"pod_trace member {i}: launch_stat {dict(got)} vs "
                      f"LAUNCH_STATS {lc}")
            skews = [podtrace.load_member_trace(
                podtrace.member_trace_path(trace_dir, i))["clock"][
                "skew_bound_ns"] for i in range(2)]
            skew = merged["metadata"]["clock_skew_bound_ns"]
            check(skew == max(skews) > 0,
                  f"pod_trace skew bound {skew} vs members {skews}")
            summary = cli.main(["trace-summary", trace, "--by-process"])
            check(summary == cli.EXIT_VALID,
                  f"pod_trace trace-summary exit {summary}")
            info.update(spawn_to_result_s=spawn_to_result, codes=codes,
                        merged_events=len(evs),
                        member_events=[m["events"] for m in
                                       merged["metadata"]["members"]],
                        clock_skew_bound_ns=skew, member_skews_ns=skews,
                        launch=launch)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    with Phase("lint") as info:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "jepsen_tpu_torch.cli", "lint",
             "--json"], cwd=here, capture_output=True, text=True,
            timeout=300)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"lint exit {proc.returncode}: {proc.stdout[-3000:]} "
              f"{proc.stderr[-2000:]}")
        rec = json.loads(proc.stdout)
        check(rec["findings"] == [] and rec["clean"] is True
              and rec["rules_total"] == 27,
              f"lint: {rec['findings'][:5]} rules {rec['rules_total']}")
        census = {rid: ent["count"]
                  for rid, ent in rec["suppressions"].items()}
        emit({"lint_wall_s": wall, "suppression_census": census})
        info.update(wall_s=wall, findings=len(rec["findings"]),
                    rules_total=rec["rules_total"],
                    suppressions=sum(census.values()))


BATCH_PHASES = ("config2", "config2_corrupted", "config1_batch", "queue",
                "queue_corrupted", "keys_scale", "plane_config1",
                "plane_burst", "plane_northstar", "plane_queue")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an unpacked older tree to time the "
                    "kernels against (compare phase)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    # the later phases' plain versions run on the host's cores, in
    # processes started now so they are warm by then
    pool = PlainPool(max(1, min(8, (os.cpu_count() or 2) - 1)))
    try:
        return run(opts, pool)
    finally:
        pool.close()


def run(opts, pool) -> int:
    from jepsen_tpu_torch import launch_stats_snapshot, reset_launch_stats
    from jepsen_tpu_torch import sim
    from jepsen_tpu_torch.checker import _build, chaos
    from jepsen_tpu_torch.checker import dispatch as dp
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
    from jepsen_tpu_torch.history.sentry import validate_history

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
    # race=False: these phases time and count the kernels, so the
    # native oracle must not race them (the race phase races)
    checker = LinearizableChecker("cas-register", race=False)
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
        assert_not_degraded(rows, "config1")
        wall = sum(r["wall_s"] for r in rows)
        config1_hists, config1_rows, config1_wall = hists, rows, wall
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
        assert_not_degraded([r, rc], "ladder")
        ladder = dict(ladder_h=h, ladder_hc=hc, ladder_r=r, ladder_rc=rc)
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
        assert_not_degraded([r], "northstar")
        north_h, north_r = h, r
        e2e_stats = launch_stats_snapshot()
        check(e2e_stats["host_syncs"] == 1, f"northstar syncs {e2e_stats}")
        # the single-key path ends here: its launch counts are read now,
        # before the timing re-run below
        recorder.phase = None
        single = {"bitset_scan": bs.bitset_scan.launches,
                  "kfrontier_scan": kf.kfrontier_scan.launches}
        # the history sentry's scan alone (the checker runs it first)
        t0 = time.perf_counter()
        validate_history(h)
        sentry_s = time.perf_counter() - t0
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
        r2 = check_events_bucketed(ev, "cas-register", race=False)
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
            sentry_s=sentry_s, host_prep_s=prep,
            history_to_events_s=t_events, device_wall_s=dev_wall,
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
        # the process-wide plane check_keys runs through, built before
        # the timed window: a one-time cost, like the kernels' build
        # (tools/kernel_times.py --walls times it)
        dp.default_plane()
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
        assert_not_degraded(res, "config2")
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
        config2_want, config2_wall = want, wall
        config2_res, config2_bad, config2_bad_res = res, bad, res_bad
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
        assert_not_degraded(res, "config1_batch")
        batch_wall = wall
        info.update(keys=7, invoked_ops=7000, wall_s=wall,
                    ops_per_s=7000 / wall, **stats)

    with Phase("queue") as info:
        qchecker = LinearizableChecker("unordered-queue", race=False)
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
        assert_not_degraded([r, rc], "queue")
        queue_r, queue_rc, queue_hc = r, rc, hc
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
        assert_not_degraded(res, "keys_scale")
        scale_hists, scale_res = hists, res
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

    # -- the dispatch plane: each of its paths counted from 0 ------------------
    plane_phases(dict(
        start=start, stop=stop, dp=dp, lin=lin, ev_mod=ev_mod, sim=sim,
        chaos=chaos, bs=bs, launch_stats_snapshot=launch_stats_snapshot,
        config1_hists=config1_hists, config1_rows=config1_rows,
        config1_wall=config1_wall, batch_wall=batch_wall,
        north_h=north_h, north_r=north_r, scale_hists=scale_hists,
        scale_res=scale_res, queue_hist=queue_hist, queue_r=queue_r,
        queue_rc=queue_rc, queue_hc=queue_hc,
    ))

    # -- durable checks and streams: each path counted from 0 ---------------
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    durable_stream_phases(dict(
        start=start, stop=stop, dp=dp, ev_mod=ev_mod, sim=sim, bs=bs,
        launch_stats_snapshot=launch_stats_snapshot,
        reset_launch_stats=reset_launch_stats,
        scratch=os.path.join(here, "build"),
        recorded_bytes=recorder.held_bytes,
        config1_hists=config1_hists, config1_rows=config1_rows,
        north_h=north_h, north_r=north_r, **ladder,
    ))

    # -- BASELINE configs 3-5 and the counter: torch-ops device programs --
    columnar_phases(dict(
        dev=dev, sim=sim, bs=bs, kf=kf,
        launch_stats_snapshot=launch_stats_snapshot,
        reset_launch_stats=reset_launch_stats,
    ))

    # -- bench config 6 and the txn-graph paths: torch-ops device program --
    graph_ctx = dict(
        sim=sim, bs=bs, kf=kf,
        launch_stats_snapshot=launch_stats_snapshot,
        reset_launch_stats=reset_launch_stats,
    )
    graph_phases(graph_ctx)

    # -- the CLI: analyze on stored runs, each path counted from 0 -------
    walls = {}  # the untuned walls the tuned phase prints its own beside
    cli_phases(dict(
        start=start, stop=stop, ev_mod=ev_mod, bs=bs, walls=walls,
        scratch=os.path.join(here, "build"),
        north_h=north_h, north_r=north_r, config1_hists=config1_hists,
        config1_rows=config1_rows, config1_wall=config1_wall,
        zk_hists=zk_hists, zk_want=config2_want, config2_wall=config2_wall,
        **ladder,
    ))

    # -- the checker daemon on the card, each path counted from 0 -------
    service_phases(dict(
        start=start, stop=stop, ev_mod=ev_mod, bs=bs, walls=walls,
        launch_stats_snapshot=launch_stats_snapshot,
        scratch=os.path.join(here, "build"),
        north_h=north_h, north_r=north_r, config1_hists=config1_hists,
        config1_rows=config1_rows, queue_hist=queue_hist, queue_r=queue_r,
        queue_rc=queue_rc, queue_hc=queue_hc,
    ))

    # -- the fleet: fleet_door counted from 0, the members' processes
    # through the door's rollup ---------------------------------------
    fleet_phases(dict(
        start=start, stop=stop, ev_mod=ev_mod, bs=bs,
        launch_stats_snapshot=launch_stats_snapshot,
        scratch=os.path.join(here, "build"),
        north_h=north_h, north_r=north_r, config1_hists=config1_hists,
        config1_rows=config1_rows,
    ))

    # -- the perf layer: the trend ledger, a knob sweep on the card and
    # the tuned profile's walls, each path counted from 0 -------------
    perf_phases(dict(
        start=start, stop=stop, launch_stats_snapshot=launch_stats_snapshot,
        scratch=os.path.join(here, "build"), walls=walls,
        north_h=north_h, north_r=north_r, config1_hists=config1_hists,
        config1_rows=config1_rows,
    ))

    # -- the mesh and the pod: virtual slots on the card and a 2-process
    # pod sharing it, each path counted from 0 -----------------------
    mesh_phases(dict(
        start=start, stop=stop, ev_mod=ev_mod, bs=bs,
        launch_stats_snapshot=launch_stats_snapshot,
        reset_launch_stats=reset_launch_stats,
        zk_hists=zk_hists, config2_res=config2_res,
        config2_bad=config2_bad, config2_bad_res=config2_bad_res,
        config2_wall=config2_wall, scale_hists=scale_hists,
        scale_res=scale_res, config1_hists=config1_hists,
        config1_rows=config1_rows, config1_wall=config1_wall,
        north_h=north_h, north_r=north_r, config6=graph_ctx["config6"],
        oversize=graph_ctx["oversize"],
    ))

    # -- the pod trace merge and planelint --------------------------
    trace_lint_phases(dict(
        here=here, scratch=os.path.join(here, "build"),
        config1_hists=config1_hists, config1_rows=config1_rows,
    ))

    # every launch of the main path again: output held against the
    # plain version on the same inputs, and timed
    single_phases = ("config1", "ladder", "northstar")
    with Phase("northstar_parity") as info:
        plain_cache = []
        rows = replay([c for c in recorder.calls
                       if c["phase"] in single_phases], bs, kf, plain_cache)
        info.update(launches=len(rows), by_launch=rows)
    with Phase("batch_parity") as info:
        batch_rows = replay([c for c in recorder.calls
                             if c["phase"] in BATCH_PHASES], bs, kf,
                            plain_cache)
        info.update(launches=len(batch_rows), by_launch=batch_rows)
    rows += batch_rows
    with Phase("stream_parity") as info:
        later = [c for c in recorder.calls
                 if c["phase"] not in single_phases + BATCH_PHASES]
        stream_rows = replay_rows(later, bs, kf, plain_cache, pool)
        info.update(launches=len(stream_rows), plain_workers=pool.workers,
                    by_launch=[r for r in stream_rows
                               if r["phase"] != "stream_gc"],
                    stream_gc=by_phase([r for r in stream_rows
                                        if r["phase"] == "stream_gc"],
                                       "bitset_scan"))
    rows += stream_rows
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
        on_card = [r for r in rs if r["plain_on"] == "cuda"]
        on_cpu = [r for r in rs if r["plain_on"] == "cpu"]
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": n,
            "max_abs_err": parity[name]["max_abs_err"],
            "ms": sum(r["ms"] for r in rs) / n,
            "plain_ms": sum(r["plain_ms"] for r in on_card) / len(on_card),
            "plain_on": (f"the card, over the {len(on_card)} launches whose "
                         "plain version ran there (plain_cpu_ms: the rest, "
                         "on the host's cores)"),
            "plain_cpu_ms": (sum(r["plain_ms"] for r in on_cpu) / len(on_cpu)
                             if on_cpu else None),
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
