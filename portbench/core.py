"""The harness: set-up, the measured window, the reference's judgement
and the result line of one run of one cell.

A run: read the cell's data (spec.py), make the pool of inputs from the
seed (gen/), build and warm the program through the mix's entry
(entries/), measure for `--seconds` (and, with `--trace 1`, profile the
device and record the program's spans), read the device's peak memory,
free the program, judge every answer the window produced against the
plain reference of the configuration's model (reference/), check that
no JAX module was loaded, and print the result as the last line of
standard output.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import os
import random
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from portbench import spec

#: top-level module names the run may never load (compared whole: the
#: port's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "jepsen_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def set_env(root: str) -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths, and the program on its knob defaults. The program builds its
    own kernels into build/jepsen_tpu_torch/ under the checkout."""
    base = os.path.join(root, "build", "portbench")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)
    os.environ["JEPSEN_TPU_NO_PROFILE"] = "1"
    # one process, few threads: no math library's thread pool on the
    # host's shared cores
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


@dataclass
class Record:
    """One check of the window."""

    item: int  # index into Run.items
    t0: float
    t1: float = 0.0
    verdict: Optional[dict] = None  # normalized by the entry
    error: Optional[str] = None


@dataclass
class Run:
    """What a run knows; the metric readers read it."""

    cell: "spec.Cell"
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    items: List[dict] = field(default_factory=list)
    records: List[Record] = field(default_factory=list)
    t_window0: float = 0.0
    t_window1: float = 0.0
    setup_s: float = 0.0
    #: the part of setup_s spent building the program's kernels and host
    #: libraries (nvcc and g++; about 0 once the checkout has them)
    build_s: float = 0.0
    #: item index -> the reference's normalized verdict
    reference: Dict[int, dict] = field(default_factory=dict)
    #: program counters over the window (entries fill these)
    counters: Dict[str, float] = field(default_factory=dict)
    #: the program's spans over the window (--trace 1)
    spans: List[dict] = field(default_factory=list)
    #: the device trace's reduction (devtrace.reduce), --trace 1 on a card
    devtrace: Optional[dict] = None
    #: the card's properties (peaks.card)
    card: Optional[dict] = None


class Schedule:
    """Which pool item each check takes: every `corrupt_every`-th check
    a corrupted one, in turn, the others the valid ones in turn."""

    def __init__(self, n_valid: int, n_corrupt: int, corrupt_every: int):
        self.n_valid = n_valid
        self.n_corrupt = n_corrupt
        self.every = corrupt_every
        self._i = 0

    def next(self) -> int:
        i = self._i
        self._i += 1
        if self.n_corrupt and self.every and i % self.every == self.every - 1:
            return self.n_valid + (i // self.every) % self.n_corrupt
        k = i - (i // self.every if self.every and self.n_corrupt else 0)
        return k % self.n_valid


def closed_loop(seconds: float, schedule: Schedule,
                call: Callable[[int], dict]) -> List[Record]:
    """One caller sending its next check when the last answers,
    starting none after `seconds`. call(item) gives the normalized
    verdict or raises."""
    records: List[Record] = []
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        rec = Record(item=schedule.next(), t0=time.perf_counter())
        try:
            rec.verdict = call(rec.item)
        except Exception as e:  # noqa: BLE001 - counted as failed
            rec.error = f"{type(e).__name__}: {e}"
        rec.t1 = time.perf_counter()
        records.append(rec)
    return records


#: (pkg, model) -> its reference module, loaded once a process
_REFERENCES: Dict[tuple, object] = {}


def reference(pkg: str, model: str):
    """The plain reference of the configurations of `model`:
    `<pkg>/reference/<model, each '-' read '_'>.py`, loaded from its
    path as every other kind is (spec.load_module), once a process."""
    key = (pkg, model)
    if key not in _REFERENCES:
        _REFERENCES[key] = spec.load_module(
            pkg, "reference", model.replace("-", "_"))
    return _REFERENCES[key]


def _verdict(pkg: str, model: str, item: dict) -> dict:
    return reference(pkg, model).verdict(item)


def judge(pkg: str, model: str, items: List[dict], used: List[int],
          processes: int) -> Dict[int, dict]:
    """The normalized verdict of every item used by the reference of
    `model` under `pkg`, computed in `processes` fresh interpreters
    (spawn), each loading that reference from its path."""
    used = sorted(set(used))
    jobs = [items[i] for i in used]
    verdict = functools.partial(_verdict, pkg, model)
    if processes <= 1 or len(jobs) <= 1:
        out = [verdict(it) for it in jobs]
    else:
        import multiprocessing as mp

        pool = mp.get_context("spawn").Pool(min(processes, len(jobs)))
        try:
            out = pool.map(verdict, jobs, chunksize=1)
        finally:
            pool.close()
            pool.join()
    return dict(zip(used, out))


def compare(run: Run) -> Dict[str, dict]:
    """The numbers that decide `correct`, each with its limit: answers
    that differ from the reference (verdict, or the failing op of an
    invalid one; for a keyed history, of each key), checks with no
    answer, and whether the window checked anything at all."""
    wrong_verdict = wrong_index = unanswered = 0
    for r in run.records:
        if r.verdict is None:
            unanswered += 1
            continue
        want = run.reference[r.item]
        if r.verdict["valid"] != want["valid"]:
            wrong_verdict += 1
        if r.verdict.get("failed") != want.get("failed"):
            wrong_index += 1
    return {
        "wrong_verdicts": {"value": wrong_verdict, "limit": 0},
        "wrong_failed_ops": {"value": wrong_index, "limit": 0},
        "unanswered": {"value": unanswered, "limit": 0},
        "checks_judged": {"value": len(run.records), "min": 1},
    }


def passes(checks: Dict[str, dict]) -> bool:
    for c in checks.values():
        if "limit" in c and c["value"] > c["limit"]:
            return False
        if "min" in c and c["value"] < c["min"]:
            return False
    return True


def read_metrics(run: Run, entries: List[dict], kind: str) -> dict:
    """{name: {"value", "unit"}} of every metric whose reader finds
    something to read."""
    out = {}
    for m in entries:
        value = spec.load_module(run.cell.pkg, kind, m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda",
             t_start: Optional[float] = None, pkg: str = spec.PKG,
             judge_processes: Optional[int] = None,
             entry=None) -> dict:
    """One run; returns the result object. device="cpu" runs the
    program's plain kernels (the CPU tests); "cuda" is the card.
    `entry`, a module-like object, takes the place of the mix's entry
    (the control)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec.load_cell(root, workload, pkg)
    model = cell.config["model"]
    reference(pkg, model)  # a configuration without one fails here
    run = Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
              device=device, t_start=t_start)
    gen = spec.load_module(pkg, "gen", cell.traffic["generator"])
    if entry is None:
        entry = spec.load_module(pkg, "entries", cell.traffic["entry"])
    valid, corrupted = gen.build_pool(cell.config, cell.traffic, seed)
    run.items = valid + corrupted
    schedule = Schedule(len(valid), len(corrupted),
                        int(cell.traffic.get("corrupt_every", 0)))

    import torch

    from portbench import devtrace, peaks, program

    on_card = device != "cpu"
    if on_card:
        run.card = peaks.card()
        t_build = time.perf_counter()
        program.build()
        run.build_s = time.perf_counter() - t_build
    state = entry.prepare(run)  # builds and warms the program
    # the pool and the warm program live for the whole run: keep them
    # out of the collector's full passes in the window
    gc.collect()
    gc.freeze()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.perf_counter() - t_start
    capture = devtrace.Capture(on_card) if trace else None
    counters = program.Window()
    counters.begin(run)
    if capture is not None:
        capture.start()
    run.t_window0 = time.perf_counter()
    run.records = entry.window(run, state, schedule)
    if on_card:
        torch.cuda.synchronize()
    run.t_window1 = time.perf_counter()
    if capture is not None:
        run.devtrace = capture.stop(run.t_window1 - run.t_window0)
    counters.end(run)
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    if hasattr(entry, "close"):
        entry.close(run, state)
    del state
    gc.unfreeze()
    if on_card:
        torch.cuda.empty_cache()

    procs = judge_processes
    if procs is None:
        procs = max(min((os.cpu_count() or 2) - 1, 8), 1)
    t_judge = time.perf_counter()
    run.reference = judge(pkg, model, run.items,
                          [r.item for r in run.records], procs)
    times = sorted(r.t1 - r.t0 for r in run.records)
    half = (run.t_window0 + run.t_window1) / 2
    rates = [sum(run.items[r.item]["invoked"] for r in run.records
                 if (r.t1 < half) == first) for first in (True, False)]
    print(f"portbench: set-up {run.setup_s:.3f} s (build "
          f"{run.build_s:.3f} s), window "
          f"{run.t_window1 - run.t_window0:.3f} s, {len(times)} checks "
          f"(min {times[0] if times else 0:.4f}, median "
          f"{times[len(times) // 2] if times else 0:.4f}, max "
          f"{times[-1] if times else 0:.4f} s), reference "
          f"{time.perf_counter() - t_judge:.3f} s over "
          f"{len(run.reference)} histories; ops answered in the window's "
          f"halves {rates}", file=sys.stderr)
    checks = compare(run)
    kind = "metrics" if trace else "e2e"
    metrics = read_metrics(
        run, cell.per_layer if trace else cell.end_to_end, kind)
    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": (torch.cuda.get_device_name(0) if on_card else "cpu"),
        "count": cell.chips if on_card else 0,
        "memory_peak_bytes": peak,
    }
    if trace and run.devtrace is not None:
        device_info["busy_s"] = run.devtrace["busy_s"]
        device_info["window_s"] = run.devtrace["window_s"]
    result = {
        "correct": passes(checks),
        "attempted": len(run.records),
        "failed": sum(1 for r in run.records if r.error is not None),
        "metrics": metrics,
        "device": device_info,
    }
    if trace and run.devtrace is not None:
        result["breakdown"] = run.devtrace["breakdown"]
    if run.card is not None:
        result["card"] = run.card
    errors = [r.error for r in run.records if r.error is not None]
    if errors:
        result["errors"] = sorted(set(errors))[:5]
    result["build_s"] = run.build_s
    result["checks"] = checks
    return result


def parse(argv):
    p = argparse.ArgumentParser(
        prog="portbench/run.py",
        description="Run one cell of the port's benchmark and print its "
                    "result as the last line of standard output.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, root: str, t_start: float) -> int:
    args = parse(argv)
    set_env(root)
    try:
        cell = spec.load_cell(root, args.workload)
    except (OSError, LookupError, KeyError, ValueError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    random.seed(args.seed)
    result = run_cell(root, args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad[:10]}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        bound = (f"limit {c['limit']}" if "limit" in c
                 else f"at least {c['min']}")
        print(f"check {name}: {c['value']} ({bound})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
