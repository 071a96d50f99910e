"""Job-schedule completeness checker (the chronos suite's verdict).

Reference: chronos/src/jepsen/chronos/checker.clj — a job {name, start,
interval, count, epsilon, duration} defines *targets*: invocation
windows [t, t + epsilon + forgiveness] for t = start + k*interval. The
checker matches actual *runs* (start times of completed executions)
against the targets that must have begun before the final read, and
the job is valid iff every such target got a run.

The reference solves the matching as a constraint problem (loco,
checker.clj:116-170) with an O(n) fast path for disjoint targets
(disjoint-job-solution, :78-114). Targets ARE disjoint whenever
epsilon + forgiveness < interval — the configuration the suite always
uses — so here the matching is the vectorized riffle: bucket each
run's start into the target grid with floor division, validate the
within-window offset, and reduce per-target counts. No solver, no
per-target Python.

The port's copy of jepsen_tpu.checker.schedule;
tests/test_torch_perf_graphs.py holds the two against each other.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from jepsen_tpu_torch.checker.core import UNKNOWN, merge_valid

#: seconds of slack past epsilon before a run counts as missed
#: (checker.clj epsilon-forgiveness)
EPSILON_FORGIVENESS = 5


def job_targets(job: Dict[str, Any], read_time: float) -> np.ndarray:
    """[T] target start times that must have begun by read_time
    (job->targets, checker.clj:30-47): cut off epsilon + duration
    before the read."""
    finish = read_time - job["epsilon"] - job["duration"]
    n = int(job["count"])
    starts = job["start"] + np.arange(n) * job["interval"]
    return starts[starts < finish]


def job_solution(
    job: Dict[str, Any],
    read_time: float,
    runs: List[Dict[str, Any]],
) -> dict:
    """Match runs to targets (job-solution, checker.clj:116-170).
    Runs are {start, end?}; only completed runs (with an end) satisfy
    targets."""
    window = job["epsilon"] + EPSILON_FORGIVENESS
    if window >= job["interval"]:
        # Overlapping targets need the reference's constraint solver
        # (loco, checker.clj:116-170); rather than crash the whole
        # analysis on one odd job config, degrade that job to unknown.
        return {
            "valid?": UNKNOWN,
            "job": job,
            "error": (
                "targets overlap (epsilon + forgiveness "
                f"{window} >= interval {job['interval']}); "
                "disjoint-target fast path cannot decide this job"
            ),
        }
    targets = job_targets(job, read_time)
    complete = np.asarray(
        sorted(r["start"] for r in runs if r.get("end") is not None),
        np.float64,
    )
    incomplete = sorted(
        r["start"] for r in runs if r.get("end") is None
    )
    if len(targets) == 0:
        return {
            "valid?": True,
            "job": job,
            "solution": {},
            "extra": complete.tolist(),
            "complete": complete.tolist(),
            "incomplete": incomplete,
        }
    # Bucket each run into the target grid; valid iff the offset lands
    # inside [0, window] and the bucket is a live target.
    rel = (complete - job["start"]) / job["interval"]
    bucket = np.floor(rel).astype(np.int64)
    offset = complete - (job["start"] + bucket * job["interval"])
    in_window = (
        (bucket >= 0)
        & (bucket < len(targets))
        & (offset <= window)
    )
    hit_counts = np.bincount(
        bucket[in_window], minlength=len(targets)
    )
    satisfied = hit_counts > 0
    # First satisfying run per target (for the solution artifact).
    solution: Dict[float, Optional[float]] = {}
    sat_runs = complete[in_window]
    sat_buckets = bucket[in_window]
    first = {}
    for b, s in zip(sat_buckets.tolist(), sat_runs.tolist()):
        first.setdefault(b, s)
    for i, t in enumerate(targets.tolist()):
        solution[t] = first.get(i)
    extra = complete[~in_window].tolist() + [
        s for b, s in zip(sat_buckets.tolist(), sat_runs.tolist())
        if first.get(b) != s
    ]
    return {
        "valid?": bool(satisfied.all()),
        "job": job,
        "solution": solution,
        "extra": sorted(extra),
        "complete": complete.tolist(),
        "incomplete": incomplete,
    }


class ScheduleChecker:
    """checker (chronos checker.clj:172-203): the history carries
    {f: "add-job", value: job} invocations and a final
    {f: "read", value: [runs]} whose run maps name their job. Valid
    iff every job's solution is valid; jobs without a read are
    unknown."""

    def check(self, test, history, opts=None) -> dict:
        from jepsen_tpu_torch.history.history import History

        if not isinstance(history, History):
            history = History(list(history))
        jobs: Dict[Any, Dict[str, Any]] = {}
        final_read = None
        read_time = None
        for o in history.ops:
            if o.f == "add-job" and o.is_ok and o.value is not None:
                jobs[o.value["name"]] = o.value
            elif o.f == "read" and o.is_ok and o.value is not None:
                final_read = o.value
                read_time = (
                    o.value.get("time")
                    if isinstance(o.value, dict)
                    else None
                )
        if final_read is None:
            return {"valid?": UNKNOWN, "error": "jobs were never read"}
        runs = (
            final_read.get("runs")
            if isinstance(final_read, dict)
            else final_read
        )
        if read_time is None:
            read_time = max(
                (r["start"] for r in runs), default=0
            ) + 1
        by_job: Dict[Any, List[dict]] = {}
        for r in runs:
            by_job.setdefault(r["name"], []).append(r)
        solutions = {
            name: job_solution(job, read_time, by_job.get(name, []))
            for name, job in jobs.items()
        }
        return {
            "valid?": merge_valid(
                s["valid?"] for s in solutions.values()
            ),
            "job_count": len(jobs),
            "run_count": len(runs),
            "jobs": solutions,
        }


def schedule_checker() -> ScheduleChecker:
    return ScheduleChecker()
