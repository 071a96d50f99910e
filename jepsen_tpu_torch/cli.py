"""Command-line interface of the port: analyze a stored run, summarize
a trace, serve checks as a daemon, run a fleet of daemons behind one
front door, tune the perf knobs, and render the bench trend ledger.

The analysis and service commands of jepsen_tpu.cli (itself after
jepsen's cli.clj: subcommand dispatch with exit codes 0 valid, 1
invalid, 2 unknown, 254 crash, 255 usage, and the `analyze` command of
single-test-cmd, cli.clj:366-397): re-check a stored history, durably
(--resume) or while it grows (--follow), with the flight recorder
(--trace) and a torch.profiler capture (--xla-trace) around it; or run
the multi-tenant checker daemon (service/server.py) until a SIGTERM
drains it; or run N daemons as a fleet behind one front door
(service/frontdoor.py), or drill that fleet under the seeded fault
schedule (service/nemesis.py, exit 8 on a violated invariant); or
sweep the perf knob registry on the card and persist the verdict-parity
checked winners as a profile (`tune`, perf/autotune.py) that `analyze`
and `daemon` load by name (--profile) or find by their device's key;
or render and gate the bench trend ledger (`perf-trend`, obs/trend.py);
or lint the port's own tree (`lint`, analysis/).

    python3 -m jepsen_tpu_torch.cli analyze store/register/latest
    python3 -m jepsen_tpu_torch.cli analyze RUN --backend cpu --resume
    python3 -m jepsen_tpu_torch.cli trace-summary trace.json
    python3 -m jepsen_tpu_torch.cli daemon --store store --port 8008
    python3 -m jepsen_tpu_torch.cli fleet --members 2 --store store
    python3 -m jepsen_tpu_torch.cli fleet-drill --members 2 --duration 20
    python3 -m jepsen_tpu_torch.cli tune --budget-s 60
    python3 -m jepsen_tpu_torch.cli analyze RUN --profile PROFILE.json
    python3 -m jepsen_tpu_torch.cli perf-trend --ledger bench_runs/trend.jsonl
    python3 -m jepsen_tpu_torch.cli lint --json

Checks run on the CUDA card unless ``--backend cpu`` asks for the CPU;
without a card the command fails (exit 254, "CUDA is not available"),
it never quietly runs on the CPU. A fleet's members are processes of
their own, each with its own plane on the one card; ``--backend`` takes
the place of the reference's ``--member-devices`` (virtual CPU devices
per member), which is a usage error here.

`analyze` and `daemon` take the mesh and pod seam of the reference:
``--devices N`` caps the ambient mesh at N slots (1 forces one device)
and ``--pod-coordinator HOST:PORT --pod-processes N --pod-index I``
join a multi-process pod (torch.distributed over gloo; the
JEPSEN_TPU_POD_* env seam otherwise) before the mesh policy is pinned.

`analyze --trace` inside a pod writes ONE merged trace: every member
persists its ring into the trace dir (obs/podtrace.py) and process 0
merges them onto its clock. `lint` runs planelint
(jepsen_tpu_torch/analysis/) over the port's tree and exits 5
(EXIT_LINT_DIRTY) when a finding is neither suppressed nor baselined.

Not ported yet: the `test` and `serve` commands (the harness and
dashboard layers). Each is a usage error here.
"""

from __future__ import annotations

import argparse
import sys
import traceback
from typing import List, Optional

EXIT_VALID = 0
EXIT_INVALID = 1
EXIT_UNKNOWN = 2
#: the stored history itself failed strict sentry validation: a
#: distinct failure from an invalid VERDICT (the history was readable
#: and the checker found a consistency violation) and from unknown
#: (the checker could not decide). See history/sentry.py.
EXIT_HOSTILE_HISTORY = 3
#: `lint` found planelint findings that are not baselined (distinct
#: from every verdict code, so CI can tell "dirty tree" from "invalid
#: history")
EXIT_LINT_DIRTY = 5
#: `fleet-drill`'s invariant gate failed: the fleet broke a contract
#: under fire (a lost accepted check, divergent verdicts, a gray member
#: never evicted, the fleet not restored within budget)
EXIT_DRILL = 8
EXIT_CRASH = 254
EXIT_USAGE = 255

WORKLOADS = (
    "register", "register-keyed", "bank", "long-fork", "g2",
    "txn-graph", "set", "counter", "monotonic", "dirty-reads",
)


def _device(args):
    """The device the check runs on: "cpu" for --backend cpu, else None
    (the CUDA card)."""
    return "cpu" if getattr(args, "backend", None) == "cpu" else None


def _checker_for(workload: str, device=None):
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.bank import BankChecker
    from jepsen_tpu_torch.checker.divergence import DirtyReadsChecker
    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
    from jepsen_tpu_torch.checker.longfork import LongForkChecker
    from jepsen_tpu_torch.checker.monotonic import MonotonicChecker
    from jepsen_tpu_torch.checker.reductions import (
        CounterChecker,
        SetFullChecker,
    )
    from jepsen_tpu_torch.checker.txn_graph import TxnGraphChecker
    from jepsen_tpu_torch.workloads.adya import _KVG2Checker

    return {
        "set": lambda: SetFullChecker(),
        "register": lambda: LinearizableChecker(device=device),
        "register-keyed": lambda: independent.independent_checker(
            LinearizableChecker(device=device)
        ),
        "bank": lambda: BankChecker(device=device),
        "long-fork": lambda: LongForkChecker(2, device=device),
        "g2": lambda: _KVG2Checker(device=device),
        "txn-graph": lambda: TxnGraphChecker(device=device),
        "counter": lambda: CounterChecker(device=device),
        "monotonic": lambda: MonotonicChecker(),
        "dirty-reads": lambda: DirtyReadsChecker(),
    }[workload]()


def _exit_code(results: Optional[dict]) -> int:
    if results is None:
        return EXIT_UNKNOWN
    v = results.get("valid?")
    if v is True:
        return EXIT_VALID
    if v is False:
        return EXIT_INVALID
    return EXIT_UNKNOWN  # "unknown" verdicts (cli.clj:272-283)


def _reset_engine_state() -> None:
    """Clean slate at command entry: a quarantine ledger or a default
    plane left by an earlier in-process command must not shadow THIS
    run, and the engine stats this command reports are its own. The
    default planes are drained first, so a train an earlier command
    left uncollected is waited for (never dropped) and its host sync
    counts there, not here; then every counter surface the snapshot
    reads (and the flight recorder's rings) resets, then the planes."""
    from jepsen_tpu_torch.checker import dispatch
    from jepsen_tpu_torch.obs.snapshot import reset_engine_stats

    dispatch.drain_default_plane()
    reset_engine_stats()
    dispatch.reset_default_plane()


def _resolve_run_dir(path: str, store_root: str) -> str:
    import os

    if os.path.isdir(path) and os.path.exists(
        os.path.join(path, "history.jsonl")
    ):
        return path
    # maybe a test name: use its latest run
    from jepsen_tpu_torch.store import Store

    latest = Store(store_root).latest(path if path else None)
    if latest is None:
        raise FileNotFoundError(f"no stored run at {path!r}")
    return latest


def _apply_mesh_args(args) -> None:
    """Thread the --devices/--backend/--pod-* seam into the engine: pod
    flags (or the JEPSEN_TPU_POD_* env they override) join the pod
    FIRST, then the mesh policy pins what sharded.resolve_mesh's
    ambient default_mesh may span. A configured pod that cannot be
    joined raises (exit 254): it never runs as one process."""
    from jepsen_tpu_torch.checker import sharded
    from jepsen_tpu_torch.pod import topology

    cfg = None
    coord = getattr(args, "pod_coordinator", None)
    if coord:
        cfg = topology.PodConfig(
            coordinator=coord,
            num_processes=int(getattr(args, "pod_processes", None) or 1),
            process_id=int(getattr(args, "pod_index", None) or 0),
        )
    topology.init_pod(cfg)
    sharded.set_mesh_policy(devices=getattr(args, "devices", None),
                            backend=getattr(args, "backend", None))


def _perf_setup(args) -> None:
    """Perf-plane setup of the single-process entry points
    (analyze, daemon): honor an explicit ``--profile PATH``, checked
    against the key of the command's device. A profile the user NAMED
    that fails to load gets a warning and the run goes on with the
    defaults (silent fallback is only for the ambient auto-discovered
    store). The reference's persistent compile cache has no
    counterpart: the kernels build into build/jepsen_tpu_torch/."""
    import os

    from jepsen_tpu_torch.perf import autotune

    prof = getattr(args, "profile", None)
    if prof:
        os.environ[autotune.PROFILE_ENV] = prof
        if autotune.load_active_profile(_device(args)) is None:
            print(
                f"perf: profile {prof} is invalid, foreign, or stale; "
                "using defaults",
                file=sys.stderr,
            )


def cmd_analyze(args) -> int:
    """`analyze`, with the flight recorder wrapped around it when
    --trace PATH is given: the tracer enables before any launch,
    records every plane crossing the re-check makes, and exports a
    Perfetto-loadable Chrome-trace JSON to PATH on the way out
    (whatever the verdict: a crashed analysis still leaves its trace).
    --xla-trace DIR also wraps the run in a torch.profiler capture of
    the host and the card (obs/profiler.py), so the recorder's spans
    and the device timeline share a run. Feed the trace to
    ui.perfetto.dev or `trace-summary`."""
    from jepsen_tpu_torch.device import resolve_device

    resolve_device(_device(args))  # no card: fail before any work
    _perf_setup(args)
    _apply_mesh_args(args)
    trace_path = getattr(args, "trace", None)
    xla_dir = getattr(args, "xla_trace", None)
    if not trace_path and not xla_dir:
        return _cmd_analyze(args)
    from contextlib import ExitStack

    from jepsen_tpu_torch import obs

    with ExitStack() as stack:
        if xla_dir:
            from jepsen_tpu_torch.obs.profiler import xla_trace

            stack.enter_context(xla_trace(xla_dir, _device(args)))
            print(f"xla-trace: capturing to {xla_dir}")
        if trace_path:
            obs.enable()
        try:
            return _cmd_analyze(args)
        finally:
            if trace_path:
                try:
                    _export_trace(trace_path)
                finally:
                    obs.disable()


def _export_trace(trace_path: str) -> None:
    """Export the live ring to ``trace_path``, pod-aware.

    One process: one chrome trace straight from the ring. Inside an
    initialized pod: every member persists its raw ring (with the
    init_pod clock record) into the shared trace dir (the
    JEPSEN_TPU_TRACE_DIR seam, else trace_path's directory, which all
    members must share), every member meets a barrier on the pod's
    gloo group, so no file an earlier run left there is read in place
    of this run's, and process 0 merges members 0 .. world_size-1 into
    ONE clock-aligned Perfetto trace at trace_path. A member that never
    reaches the barrier, or whose file never appears, makes the command
    raise (it exits 254): no partial merge is written."""
    import os
    from datetime import timedelta

    from jepsen_tpu_torch import obs
    from jepsen_tpu_torch.obs import podtrace
    from jepsen_tpu_torch.pod import topology

    if not topology.is_multiprocess():
        events = obs.spans()
        obs.write_chrome_trace(trace_path, events)
        print(f"trace: {len(events)} events -> {trace_path}")
        return
    import torch.distributed as dist

    pidx = topology.process_index()
    n_procs = int(dist.get_world_size())
    trace_dir = (
        os.environ.get(podtrace.ENV_TRACE_DIR)
        or os.path.dirname(os.path.abspath(trace_path))
    )
    member_path = podtrace.persist_member_trace(trace_dir)
    dist.monitored_barrier(timeout=timedelta(seconds=30))
    if pidx != 0:
        print(f"trace: member {pidx} ring -> {member_path}")
        return
    merged = podtrace.merge_pod_trace(
        trace_dir, trace_path, expect_members=n_procs, timeout_s=30.0
    )
    print(
        f"trace: {len(merged['traceEvents'])} events from "
        f"{n_procs} members -> {trace_path}"
    )


def _cmd_analyze(args) -> int:
    """Re-check a stored history (cli.clj:366-397).

    --strict-history: refuse (exit code 3, distinct message) instead
    of repairing when the stored history fails sentry validation.

    --resume: run the check durably: verified segment boundaries
    persist atomically into <run_dir>/checkpoint.json, and a re-run
    after a crash re-enters at the last durable frontier (stale or
    tampered checkpoints are rejected and the check runs cold).
    engine_stats in results.json carries the launch and checkpoint
    accounting, so a resumed run's strictly fewer launches are
    auditable. $JEPSEN_TPU_SEG_MIN_LEN sets the segment plan's least
    segment length.

    --follow: tail a GROWING history.jsonl with the streaming checker
    instead of loading it once: each poll appends the newly written
    ops and launches only that tail (checker/streaming.py). With
    --resume the stream frontier persists into <run_dir>/stream.json,
    so a restarted --follow skips the already-checked prefix."""
    import inspect
    import os

    from jepsen_tpu_torch.history.sentry import (
        HistorySentryError,
        validate_history,
    )
    from jepsen_tpu_torch.store import Store

    _reset_engine_state()
    run_dir = _resolve_run_dir(args.path, args.store)
    if args.follow:
        return _analyze_follow(args, run_dir)
    st = Store(args.store)
    history = st.load_history(run_dir)
    test = st.load_test(run_dir)
    # Resolve BEFORE checking: test.json may carry a stale absolute
    # run_dir (a relocated run), and artifact-writing checkers
    # (linear.svg) target test["run_dir"].
    test["run_dir"] = run_dir
    # Sentry gate ahead of EVERY checker (linearizable runs its own
    # pass too, but bank/set/etc. get validated history only here).
    try:
        history, hreport = validate_history(
            history, strict=args.strict_history
        )
    except HistorySentryError as e:
        print(f"analyzed {run_dir}: hostile history — {e}")
        print(_epitaph(EXIT_HOSTILE_HISTORY))
        return EXIT_HOSTILE_HISTORY
    checker = _checker_for(args.workload, _device(args))
    checkpoint = None
    if args.resume:
        from jepsen_tpu_torch.checker.checkpoint import CheckpointSink

        seg_env = os.environ.get("JEPSEN_TPU_SEG_MIN_LEN")
        checkpoint = CheckpointSink(
            run_dir,
            seg_min_len=int(seg_env) if seg_env else None,
        )
    kw = {}
    if (
        checkpoint is not None
        and "checkpoint" in inspect.signature(checker.check).parameters
    ):
        kw["checkpoint"] = checkpoint
    results = checker.check(test, history, {}, **kw)
    if hreport is not None and not hreport.get("clean"):
        results.setdefault("history_report", hreport)
    results["engine_stats"] = _engine_stats()
    test["results"] = results
    st.save_2(test)
    if args.stats_json:
        _dump_stats_json(args.stats_json)
    print(f"analyzed {run_dir}: valid?={results.get('valid?')}")
    print(_epitaph(_exit_code(results)))
    return _exit_code(results)


def _analyze_follow(args, run_dir: str) -> int:
    """`analyze --follow`: tail <run_dir>/history.jsonl with a
    StreamingCheck. Each poll reads the complete lines written since
    the last one, appends them, and checks only that tail; the follow
    ends after --follow-idle seconds without growth, or at once on an
    invalid verdict (terminal: linearizability is prefix-closed). The
    sentry gate is skipped while following (a live history always has
    unpaired tails); run a plain `analyze` afterwards for the sentry
    report. Register (linearizable) workloads only."""
    import json as _json
    import os
    import time as _time

    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
    from jepsen_tpu_torch.store import op_from_json

    if args.workload not in (None, "register"):
        print(f"--follow supports only the register (linearizable) "
              f"workload, not {args.workload!r}")
        return EXIT_USAGE
    checker = LinearizableChecker(device=_device(args))
    sc = checker.check_streaming(
        path=os.path.join(run_dir, "stream.json") if args.resume else None
    )
    hist = os.path.join(run_dir, "history.jsonl")
    pos = 0
    idle_s = max(float(args.follow_idle), 0.0)
    last_growth = _time.monotonic()
    while True:
        batch = []
        try:
            with open(hist, "rb") as f:
                f.seek(pos)
                for raw in f:
                    if not raw.endswith(b"\n"):
                        break  # torn tail write: retry next poll
                    pos += len(raw)
                    line = raw.decode().strip()
                    if line:
                        batch.append(op_from_json(_json.loads(line)))
        except FileNotFoundError:
            pass  # appears on the writer's first atomic rename
        if batch:
            status = sc.append(batch)
            last_growth = _time.monotonic()
            print(f"followed +{len(batch)} ops "
                  f"(checked_steps={status.get('checked_steps')}, "
                  f"valid?={status.get('valid?')})")
            if status.get("valid?") is False:
                break
        elif _time.monotonic() - last_growth >= idle_s:
            break
        else:
            _time.sleep(min(0.2, idle_s) if idle_s else 0.2)
    results = sc.result()
    results["engine_stats"] = _engine_stats()
    if args.stats_json:
        _dump_stats_json(args.stats_json)
    print(f"analyzed {run_dir} (followed): "
          f"valid?={results.get('valid?')}")
    print(_epitaph(_exit_code(results)))
    return _exit_code(results)


def _dump_stats_json(path: str) -> None:
    """Write the full engine-stats bundle to `path` ("-" = stdout):
    scripts that scrape launches and resumes get one machine-readable
    file instead of parsing results.json out of the run dir."""
    import json

    bundle = _engine_stats()
    if path == "-":
        print(json.dumps(bundle, indent=2, default=str))
    else:
        from jepsen_tpu_torch.store import atomic_write_text

        atomic_write_text(
            path, json.dumps(bundle, indent=2, default=str)
        )


def _engine_stats() -> dict:
    """The consolidated engine snapshot for results.json, the audit
    trail a kill-restart differential reads (a resumed run shows
    strictly fewer launches than the cold one). Drains the default
    planes first: a native-racer win can leave the launch train
    uncollected (its host sync unpaid and uncounted), and this
    snapshot is the run's final ledger."""
    from jepsen_tpu_torch.checker.dispatch import drain_default_plane
    from jepsen_tpu_torch.obs.snapshot import engine_snapshot

    drain_default_plane()
    return engine_snapshot()


def cmd_daemon(args) -> int:
    """Run the checker-as-a-service daemon (service/server.py): one
    warm plane serving history checks for many tenants, with admission
    control at the door and a SIGTERM-triggered graceful drain.
    In-flight durable checks that outlive --drain-seconds are safe:
    their verified frontier is already checkpointed, and a restarted
    daemon resumes them on resubmission."""
    from jepsen_tpu_torch.device import resolve_device
    from jepsen_tpu_torch.service.drain import install_signal_drain
    from jepsen_tpu_torch.service.server import CheckerDaemon

    resolve_device(_device(args))  # no card: fail before any work
    _perf_setup(args)
    _reset_engine_state()
    _apply_mesh_args(args)
    if args.trace:
        from jepsen_tpu_torch import obs

        obs.enable()
    daemon = CheckerDaemon(
        root=args.store,
        host=args.host,
        port=args.port,
        device=_device(args),
        max_inflight=args.max_inflight,
        per_tenant_inflight=args.tenant_inflight,
        max_payload_bytes=args.max_payload_mb << 20,
        strict_default=args.strict_history,
        coalesce_hold_s=args.coalesce_hold,
        launch_deadline_s=args.launch_deadline,
        drain_s=args.drain_seconds,
        audit_path=args.audit_path,
        audit_max_bytes=args.audit_max_mb << 20,
        fleet_dir=args.fleet_dir,
        member_id=args.member_id,
        member_epoch=args.member_epoch,
    )
    handle = install_signal_drain(daemon.drain)
    member = f" member={daemon.member_id}" if args.fleet_dir else ""
    print(f"checker daemon serving on {daemon.url} "
          f"(store={args.store}){member}", flush=True)
    try:
        daemon.serve_forever()
    except KeyboardInterrupt:
        daemon.drain()
    finally:
        handle.restore()
        daemon.close()
    print("checker daemon drained. (code 0)")
    return EXIT_VALID


def cmd_fleet(args) -> int:
    """Run an N-member checker fleet behind one front door.

    Spawns N `daemon` subprocesses on ephemeral ports (each announces
    its bound URL into the shared fleet dir and heartbeats; on the card
    the kernels are built here first), waits for the full fleet to come
    alive, then serves the front door (service/frontdoor.py) in the
    foreground: consistent-hash tenant routing, admission-shed
    stealing, and durable hand-off of a dead member's in-flight checks
    to survivors. Orphaned intents of an earlier door replay first.
    SIGTERM drains the fleet: members get SIGTERM first (each drains
    its own in-flight checks and retires its membership), then the door
    stops."""
    import os
    import time

    from jepsen_tpu_torch.device import resolve_device
    from jepsen_tpu_torch.pod import launcher
    from jepsen_tpu_torch.service.drain import install_signal_drain
    from jepsen_tpu_torch.service.frontdoor import FleetFrontDoor

    resolve_device(_device(args))  # no card: fail before any spawn
    fleet_dir = args.fleet_dir or os.path.join(args.store, ".fleet")
    os.makedirs(fleet_dir, exist_ok=True)
    extra = [
        "--max-inflight", str(args.max_inflight),
        "--tenant-inflight", str(args.tenant_inflight),
        "--coalesce-hold", str(args.coalesce_hold),
        "--drain-seconds", str(args.drain_seconds),
    ]
    procs = [
        launcher.spawn_fleet_member(
            i, fleet_dir, args.store,
            device=_device(args),
            extra_args=extra,
            log_path=os.path.join(fleet_dir, f"member-{i:03d}.log"),
        )
        for i in range(args.members)
    ]
    try:
        launcher.wait_fleet(
            fleet_dir, args.members, timeout_s=args.spawn_timeout
        )
    except TimeoutError as e:
        print(f"fleet: {e}", file=sys.stderr)
        for p in procs:
            p.kill()
            p.wait()
        return EXIT_CRASH
    door = FleetFrontDoor(
        fleet_dir, host=args.host, port=args.port, mode=args.mode
    )
    recovered = door.recover_intents()
    if recovered:
        print(f"fleet: recovered {len(recovered)} orphaned "
              f"intent(s) from a previous door")

    def _drain(signum=None):
        for p in procs:
            if p.poll() is None:
                p.terminate()  # the member drains and retires itself
        deadline = time.time() + args.drain_seconds + 5.0
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.time(), 0.1))
            except Exception:  # noqa: BLE001 - escalate past drain
                p.kill()
                p.wait()
        door.shutdown()

    handle = install_signal_drain(_drain)
    print(f"fleet front door ({args.mode}) on {door.url} — "
          f"{args.members} members over {fleet_dir}", flush=True)
    try:
        door.serve_forever()
    except KeyboardInterrupt:
        _drain()
    finally:
        handle.restore()
        door.close()
    print("fleet drained. (code 0)")
    return EXIT_VALID


def cmd_fleet_drill(args) -> int:
    """Run the fleet chaos gauntlet (service/nemesis.run_fleet_drill):
    spawn a real subprocess fleet, inject the seeded fault schedule
    (SIGKILL, SIGSTOP gray periods, torn registry writes, clock skew,
    checkpoint corruption) while live multi-tenant traffic flows, and
    gate on the invariant monitor: zero accepted-check loss,
    at-most-once verdicts per check_id, verdict parity against a solo
    oracle on the drill's device, gray-member eviction within budget,
    and supervised fleet restoration. Exit 8 on any violation."""
    import json
    import os

    from jepsen_tpu_torch.device import resolve_device
    from jepsen_tpu_torch.service.nemesis import run_fleet_drill

    resolve_device(_device(args))  # no card: fail before any spawn
    fleet_dir = args.fleet_dir or os.path.join(
        args.store, ".fleet-drill"
    )
    classes = (
        [c.strip() for c in args.classes.split(",") if c.strip()]
        if args.classes else None
    )
    report = run_fleet_drill(
        args.store, fleet_dir,
        members=args.members,
        duration_s=args.duration,
        seed=args.seed,
        gray_s=args.gray_seconds,
        restart_budget=args.restart_budget,
        device=_device(args),
        spawn_timeout_s=args.spawn_timeout,
        classes=classes,
        log_dir=fleet_dir,
        parity=not args.no_parity,
    )
    out = json.dumps(report, indent=2, sort_keys=True, default=str)
    if args.report:
        with open(args.report, "w") as f:
            f.write(out + "\n")
    print(out)
    if report.get("clean"):
        print(f"fleet drill clean: {report['checks']['unique']} "
              f"unique checks under fire, 0 lost. (code 0)")
        return EXIT_VALID
    kinds = sorted({v["invariant"] for v in report["violations"]})
    print(f"fleet drill FAILED: {len(report['violations'])} "
          f"violation(s) ({', '.join(kinds)}). (code {EXIT_DRILL})",
          file=sys.stderr)
    return EXIT_DRILL


def cmd_trace_summary(args) -> int:
    """Attribution table from a Chrome-trace file (`analyze --trace`
    output): where the wall went, by span kind and name (launch vs.
    host-sync floor vs. coalesce holds), plus the two derived ratios
    the dispatch plane reports (floor amortization from dispatch_batch/
    dispatch_solo instants, double-buffer occupancy from train_register
    instants), recomputed purely from the trace."""
    import json

    from jepsen_tpu_torch.obs.export import validate_chrome_trace

    with open(args.path) as f:
        obj = json.load(f)
    errors = validate_chrome_trace(obj)
    if errors:
        for e in errors[:10]:
            print(f"trace-summary: schema: {e}")
        return EXIT_UNKNOWN
    evs = [e for e in obj["traceEvents"] if e["ph"] in ("X", "i")]
    wall_ms = 0.0
    if evs:
        wall_ms = (max(e["ts"] + e.get("dur", 0) for e in evs)
                   - min(e["ts"] for e in evs)) / 1e3
    if getattr(args, "by_process", False):
        return _trace_summary_by_process(obj, evs, wall_ms)
    rows = {}
    for e in evs:
        key = (e.get("cat", "?"), e["name"])
        cnt, tot = rows.get(key, (0, 0.0))
        rows[key] = (cnt + 1, tot + e.get("dur", 0) / 1e3)
    print(f"{'kind':<12} {'name':<24} {'count':>8} {'total_ms':>10} "
          f"{'mean_ms':>9} {'%wall':>6}")
    for (kind, name), (cnt, tot) in sorted(
            rows.items(), key=lambda kv: -kv[1][1]):
        pct = 100.0 * tot / wall_ms if wall_ms else 0.0
        print(f"{kind:<12} {name:<24} {cnt:>8} {tot:>10.3f} "
              f"{tot / cnt:>9.3f} {pct:>6.1f}")
    batches = sum(1 for e in evs if e["name"] == "dispatch_batch")
    solos = sum(1 for e in evs if e["name"] == "dispatch_solo")
    riders = sum(e["args"].get("riders", 0) for e in evs
                 if e["name"] == "dispatch_batch")
    regs = [e["args"].get("inflight", 0) for e in evs
            if e["name"] == "train_register"]
    launches = batches + solos
    if launches:
        print(f"floor_amortization    "
              f"{(riders + solos) / launches:.3f}  "
              f"({riders + solos} requests / {launches} launches)")
    if regs:
        print(f"double_buffer_occupancy {sum(regs) / len(regs):.3f}  "
              f"(over {len(regs)} trains)")
    print(f"wall {wall_ms:.3f} ms, {len(evs)} events")
    return EXIT_VALID


def _trace_summary_by_process(obj, evs, wall_ms: float) -> int:
    """Per-process attribution: wall and span totals by Perfetto pid,
    named from the trace's own process_name metadata rows (everything
    comes from the file), with the recorded clock skew bound where a
    merged trace carries one."""
    names = {}
    for e in obj["traceEvents"]:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            names[e.get("pid", 1)] = str(
                (e.get("args") or {}).get("name", "?")
            )
    rows = {}
    for e in evs:
        pid = e.get("pid", 1)
        cnt, tot = rows.get(pid, (0, 0.0))
        rows[pid] = (cnt + 1, tot + e.get("dur", 0) / 1e3)
    print(f"{'process':<20} {'pid':>4} {'events':>8} {'total_ms':>10} "
          f"{'%wall':>6}")
    for pid in sorted(rows):
        cnt, tot = rows[pid]
        pct = 100.0 * tot / wall_ms if wall_ms else 0.0
        print(f"{names.get(pid, '?'):<20} {pid:>4} {cnt:>8} "
              f"{tot:>10.3f} {pct:>6.1f}")
    meta = obj.get("metadata") or {}
    skew = meta.get("clock_skew_bound_ns")
    if skew is not None:
        print(f"clock_skew_bound {int(skew) / 1e3:.1f} us "
              f"({len(meta.get('members', []))} members)")
    print(f"wall {wall_ms:.3f} ms, {len(evs)} events, "
          f"{len(rows)} process(es)")
    return EXIT_VALID


def cmd_perf_trend(args) -> int:
    """Render the bench trend ledger (bench_runs/trend.jsonl, one compact
    row per bench run) and gate on regressions PER TRAJECTORY, as the
    reference's `perf-trend` does: smoke rows (CPU flow validations),
    hardware rows and each "mode/fleetN" fleet trajectory are gated
    against their own predecessors only. The rows are the reference's
    bench rows (TPU hardware and CPU smoke); the port has no bench yet,
    and the table renders them as they are. Exit 1 when any
    trajectory's vs_baseline geomean dropped more than
    --max-regression (fractional) below its previous row's, exit 2
    when there is no ledger to judge."""
    import os

    from jepsen_tpu_torch.obs.trend import (
        gate_trend,
        load_trend_rows,
        trend_fleet,
        trend_mode,
    )

    path = args.ledger
    if not os.path.exists(path):
        print(f"perf-trend: no trend ledger at {path}")
        return EXIT_UNKNOWN
    rows = load_trend_rows(path)
    if not rows:
        print(f"perf-trend: empty trend ledger at {path}")
        return EXIT_UNKNOWN

    def _num(row, key):
        v = row.get(key)
        return f"{v:.3f}" if isinstance(v, (int, float)) else "-"

    def _cfg(row):
        """Short knob-config identity: rows before the schema gained
        config_hash render '-'; a '*' marks a persisted tuned profile
        (vs. registry defaults)."""
        h = row.get("config_hash")
        if not isinstance(h, str) or not h:
            return "-"
        return h[:8] + ("*" if row.get("tuned") else "")

    print(f"{'ts':<20} {'mode':<8} {'fleet':>5} {'cfg':<9} "
          f"{'vs_base':>8} "
          f"{'vs_py':>10} {'syncs':>6} {'floor_ms':>9} {'occup':>6} "
          f"{'trace_ov%':>9} {'ops/s':>10}")
    for r in rows:
        ts = str(r.get("ts", "?"))[:19]
        print(f"{ts:<20} {trend_mode(r):<8} "
              f"{trend_fleet(r):>5} "
              f"{_cfg(r):<9} "
              f"{_num(r, 'vs_baseline'):>8} "
              f"{_num(r, 'vs_python_oracle'):>10} "
              f"{_num(r, 'syncs_per_check'):>6} "
              f"{_num(r, 'sync_floor_ms'):>9} "
              f"{_num(r, 'double_buffer_occupancy'):>6} "
              f"{_num(r, 'trace_overhead_pct'):>9} "
              f"{_num(r, 'ops_per_sec'):>10}")
    ok, msgs = gate_trend(rows, args.max_regression)
    for m in msgs:
        print(f"perf-trend: {m}")
    return EXIT_VALID if ok else EXIT_INVALID


def cmd_tune(args) -> int:
    """`tune`: sweep the perf-knob registry on the command's device (the
    card; --backend cpu for the CPU) and persist the winning overrides
    as a profile keyed by the backend, the device count, the card's
    name and the torch and CUDA versions. Every candidate rung must
    reproduce the baseline probe verdict (verdict parity) or it is
    rejected regardless of speed; sweep evidence lands in a sibling
    .evidence.json. Exit 0 when a profile was written (or --dry-run
    completed), 1 when nothing persistable came out of the budget, 255
    on an unknown --knobs name, 254 without a card (and without
    --backend cpu)."""
    from jepsen_tpu_torch.device import resolve_device
    from jepsen_tpu_torch.perf import autotune

    resolve_device(_device(args))  # no card: fail before any work
    only = None
    if args.knobs:
        only = [k.strip() for k in args.knobs.split(",") if k.strip()]
    try:
        return autotune.run_tune(
            budget_s=args.budget_s, only=only, dry_run=args.dry_run,
            device=_device(args),
        )
    except ValueError as e:
        print(f"tune: {e}", file=sys.stderr)
        return EXIT_USAGE


def cmd_lint(args) -> int:
    """Run planelint (jepsen_tpu_torch/analysis) over the port's tree.

    Exit 0 when every finding is inline-suppressed or baselined, 5
    when non-baselined findings remain. --update-baseline rewrites
    planelint_torch_baseline.json with the current findings
    (grandfathering them, and pruning entries whose file::symbol no
    longer exists); --changed-only scopes findings to the files git
    considers changed (the call graph still spans the whole package);
    --sarif writes the new findings as SARIF 2.1.0 for CI annotation;
    --json emits the machine-readable report (findings, per-rule
    descriptions, suppression census). Stdlib-ast only: no torch
    import, so it runs anywhere."""
    import json

    from jepsen_tpu_torch import analysis

    root = args.root or analysis.package_root()
    baseline_path = args.baseline or analysis.default_baseline_path()
    only = None
    if args.changed_only:
        only = analysis.changed_files(root)
        if not args.json:
            print(
                f"planelint: --changed-only scope: "
                f"{len(only)} file(s)"
            )
    findings = analysis.run_lint(root, only=only)
    baseline = analysis.load_baseline(baseline_path)
    stale = analysis.stale_baseline_entries(baseline, root)
    for key in stale:
        print(
            f"planelint: warning: stale baseline entry {key} "
            "(file or symbol no longer exists)",
            file=sys.stderr,
        )
    if args.update_baseline:
        analysis.save_baseline(baseline_path, findings)
        print(
            f"planelint: baselined {len(findings)} finding(s) into "
            f"{baseline_path}"
            + (f" (pruned {len(stale)} stale entries)" if stale else "")
        )
        return EXIT_VALID
    new, matched = analysis.apply_baseline(findings, baseline)
    if args.sarif:
        doc = analysis.to_sarif(new, analysis.RULES)
        errors = analysis.validate_sarif(doc)
        if errors:  # never ship a SARIF a CI ingester would drop
            for e in errors:
                print(f"planelint: sarif: {e}", file=sys.stderr)
            return EXIT_CRASH
        with open(args.sarif, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
        if not args.json:
            print(
                f"planelint: wrote {len(new)} finding(s) to "
                f"{args.sarif}"
            )
    if args.json:
        print(json.dumps({
            "findings": [f.to_dict() for f in new],
            "baselined": sum(matched.values()),
            "total": len(findings),
            "clean": not new,
            "rules_total": analysis.rules_total(),
            "rules": {
                rid: {"title": title, "invariant": invariant}
                for rid, (title, invariant) in sorted(
                    analysis.RULES.items()
                )
            },
            "suppressions": analysis.suppression_census(
                root, only=only
            ),
            "stale_baseline": stale,
        }, indent=2))
    else:
        for f in new:
            print(f.render())
        print(
            f"planelint: {len(new)} finding(s) "
            f"({sum(matched.values())} baselined, "
            f"{len(findings)} total, "
            f"{analysis.rules_total()} rules)"
        )
    return EXIT_LINT_DIRTY if new else EXIT_VALID


def _epitaph(code: int) -> str:
    """Results one-liner (core.clj:453-465's celebratory/despair)."""
    if code == EXIT_VALID:
        return "Everything looks good! (code 0)"
    if code == EXIT_INVALID:
        return "Analysis invalid! (code 1)"
    if code == EXIT_HOSTILE_HISTORY:
        return (
            "Stored history failed validation; no verdict issued. "
            "(code 3)"
        )
    return "Errors occurred during analysis; verdict unknown. (code 2)"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="jepsen_tpu_torch",
        description="distributed-systems history checking on a CUDA GPU",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    def mesh_args(sp):
        """The explicit mesh and pod seam (analyze, daemon): mesh shape
        by flag, not only by the local-slot env seam."""
        sp.add_argument("--devices", type=int, default=None,
                        help="cap the ambient mesh at N slots (1 forces "
                             "the single-device path)")
        sp.add_argument("--pod-coordinator", default=None,
                        metavar="HOST:PORT",
                        help="join a multi-process pod via this "
                             "coordinator (torch.distributed over gloo; "
                             "overrides JEPSEN_TPU_POD_COORDINATOR); "
                             "--trace inside a pod merges every "
                             "member's ring into one trace")
        sp.add_argument("--pod-processes", type=int, default=None,
                        help="total pod process count")
        sp.add_argument("--pod-index", type=int, default=None,
                        help="this process's pod index (0-based)")

    a = sub.add_parser(
        "analyze", help="re-check a stored history (no cluster needed)"
    )
    a.add_argument("--store", default="store",
                   help="store root directory")
    a.add_argument("--workload", choices=WORKLOADS, default="register")
    a.add_argument("--backend", choices=("cpu", "cuda"), default=None,
                   help="device the check runs on (default: the CUDA "
                        "card; cpu runs the plain PyTorch versions)")
    a.add_argument("path", nargs="?", default="",
                   help="run directory or test name (default: latest)")
    a.add_argument("--resume", action="store_true",
                   help="durable check: persist segment checkpoints "
                        "into the run dir and resume a killed "
                        "analysis at its last verified frontier")
    a.add_argument("--follow", action="store_true",
                   help="tail a growing history.jsonl and check "
                        "incrementally (streaming checker; register "
                        "workload only; combine with --resume to "
                        "persist the stream frontier)")
    a.add_argument("--follow-idle", type=float, default=2.0,
                   metavar="SECONDS",
                   help="stop following after this long with no new "
                        "ops (default 2.0)")
    a.add_argument("--strict-history", action="store_true",
                   help="refuse (exit 3) instead of repairing when "
                        "the stored history fails sentry validation")
    a.add_argument("--stats-json", default=None, metavar="PATH",
                   help="also write the engine-stats bundle (launch/"
                        "resilience/checkpoint) as JSON to PATH "
                        "('-' = stdout)")
    a.add_argument("--trace", default=None, metavar="PATH",
                   help="record every plane crossing with the flight "
                        "recorder and export a Perfetto-loadable "
                        "Chrome-trace JSON to PATH")
    a.add_argument("--xla-trace", default=None, metavar="DIR",
                   help="also capture a torch.profiler trace of the "
                        "host and the card into DIR")
    a.add_argument("--profile", default=None, metavar="PATH",
                   help="load this tuned perf profile instead of the "
                        "auto-discovered one of the device's key "
                        "(invalid/foreign/stale profiles warn and fall "
                        "back to registry defaults)")
    mesh_args(a)
    a.set_defaults(fn=cmd_analyze)

    ts = sub.add_parser(
        "trace-summary",
        help="attribution table (floor/occupancy, %%wall by span) "
             "from an `analyze --trace` Chrome-trace file",
    )
    ts.add_argument("path", help="Chrome-trace JSON file")
    ts.add_argument("--by-process", action="store_true",
                    help="attribute wall per process (reads "
                         "process_name metadata rows and a recorded "
                         "clock skew bound)")
    ts.set_defaults(fn=cmd_trace_summary)

    pt = sub.add_parser(
        "perf-trend",
        help="render the bench trend ledger and gate on geomean "
             "regressions vs the previous run",
    )
    pt.add_argument("--ledger", default="bench_runs/trend.jsonl",
                    metavar="PATH",
                    help="trend ledger written by the reference's "
                         "bench.py (default: bench_runs/trend.jsonl)")
    pt.add_argument("--max-regression", type=float, default=0.10,
                    metavar="FRACTION",
                    help="fail (exit 1) when vs_baseline drops more "
                         "than this fraction below the previous row "
                         "(default 0.10)")
    pt.set_defaults(fn=cmd_perf_trend)

    tu = sub.add_parser(
        "tune",
        help="sweep the perf-knob registry on this device and persist "
             "the verdict-parity-checked winners as a profile",
    )
    tu.add_argument("--backend", choices=("cpu", "cuda"), default=None,
                    help="device the probes run on (default: the CUDA "
                         "card; cpu runs the plain PyTorch versions)")
    tu.add_argument("--budget-s", type=float, default=60.0,
                    metavar="SECONDS",
                    help="wall-clock sweep budget; rungs past it are "
                         "skipped and recorded as such (default 60)")
    tu.add_argument("--knobs", default=None, metavar="NAMES",
                    help="comma-separated knob subset to sweep "
                         "(default: every registered knob)")
    tu.add_argument("--dry-run", action="store_true",
                    help="print the sweep plan without running it or "
                         "writing the profile")
    tu.set_defaults(fn=cmd_tune)

    li = sub.add_parser(
        "lint",
        help="planelint: static analysis of the port's own plane "
             "invariants (exit 5 on non-baselined findings)",
    )
    li.add_argument("--root", default=None,
                    help="package tree to lint (default: the "
                         "jepsen_tpu_torch package)")
    li.add_argument("--baseline", default=None, metavar="PATH",
                    help="baseline file (default: "
                         "planelint_torch_baseline.json at the repo "
                         "root)")
    li.add_argument("--update-baseline", action="store_true",
                    help="grandfather the current findings into the "
                         "baseline (and prune stale entries)")
    li.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    li.add_argument("--sarif", default=None, metavar="PATH",
                    help="also write the new findings as SARIF 2.1.0")
    li.add_argument("--changed-only", action="store_true",
                    help="only report findings in files git considers "
                         "changed (the call graph still spans the "
                         "whole package)")
    li.set_defaults(fn=cmd_lint)

    d = sub.add_parser(
        "daemon",
        help="checker-as-a-service: a long-lived multi-tenant "
             "analysis daemon over one warm dispatch plane",
    )
    d.add_argument("--store", default="store",
                   help="store root directory")
    d.add_argument("--backend", choices=("cpu", "cuda"), default=None,
                   help="device the checks run on (default: the CUDA "
                        "card; cpu runs the plain PyTorch versions)")
    d.add_argument("--host", default="127.0.0.1")
    d.add_argument("--port", type=int, default=8008)
    d.add_argument("--max-inflight", type=int, default=64,
                   help="global in-flight check bound (429 past it)")
    d.add_argument("--tenant-inflight", type=int, default=16,
                   help="per-tenant in-flight cap (fairness floor)")
    d.add_argument("--max-payload-mb", type=int, default=32,
                   help="413 payloads above this many MiB")
    d.add_argument("--strict-history", action="store_true",
                   help="default tenant policy: refuse hostile "
                        "histories (422) instead of repairing")
    d.add_argument("--coalesce-hold", type=float, default=0.005,
                   metavar="S",
                   help="hold window between submit and resolve so "
                        "concurrent tenants coalesce into one launch")
    d.add_argument("--launch-deadline", type=float, default=None,
                   metavar="S",
                   help="per-launch deadline inherited by the plane")
    d.add_argument("--drain-seconds", type=float, default=10.0,
                   help="SIGTERM drain budget for in-flight checks")
    d.add_argument("--audit-path", default=None, metavar="PATH",
                   help="request audit log (JSONL; default "
                        "<store>/.service/audit.jsonl)")
    d.add_argument("--audit-max-mb", type=int, default=4,
                   help="rotate the audit log past this many MiB")
    d.add_argument("--trace", action="store_true",
                   help="enable the flight recorder for the daemon's "
                        "life; GET /trace drains the ring")
    d.add_argument("--profile", default=None, metavar="PATH",
                   help="load this tuned perf profile instead of the "
                        "auto-discovered one of the device's key "
                        "(invalid/foreign/stale profiles warn and fall "
                        "back to registry defaults)")
    d.add_argument("--fleet-dir", default=None, metavar="DIR",
                   help="join a checker fleet: announce + heartbeat "
                        "this daemon's URL into DIR (the front "
                        "door's membership registry)")
    d.add_argument("--member-id", type=int, default=None,
                   help="this daemon's fleet member id (with "
                        "--fleet-dir; default 0)")
    d.add_argument("--member-epoch", type=int, default=None,
                   help="this member's supervision epoch (set by the "
                        "fleet supervisor on respawn; an older "
                        "incarnation of the same member id fences "
                        "itself instead of double-owning checks)")
    mesh_args(d)
    d.set_defaults(fn=cmd_daemon)

    fl = sub.add_parser(
        "fleet",
        help="N-member checker fleet behind one front door: "
             "consistent-hash tenant routing, work-stealing, "
             "zero-loss member hand-off",
    )
    fl.add_argument("--store", default="store",
                    help="store root directory (shared by the members)")
    fl.add_argument("--backend", choices=("cpu", "cuda"), default=None,
                    help="device the members check on (default: the "
                         "CUDA card; cpu runs the plain PyTorch "
                         "versions)")
    fl.add_argument("--members", type=int, default=2,
                    help="checker-daemon member count (default 2)")
    fl.add_argument("--host", default="127.0.0.1")
    fl.add_argument("--port", type=int, default=8010,
                    help="front-door port (members use ephemeral "
                         "ports; default 8010)")
    fl.add_argument("--mode", choices=("proxy", "redirect"),
                    default="proxy",
                    help="proxy = relay + journal + steal/hand-off; "
                         "redirect = 307 to the owning member")
    fl.add_argument("--fleet-dir", default=None, metavar="DIR",
                    help="membership registry dir (default "
                         "<store>/.fleet)")
    fl.add_argument("--max-inflight", type=int, default=64,
                    help="per-member global in-flight bound")
    fl.add_argument("--tenant-inflight", type=int, default=16,
                    help="per-member per-tenant in-flight cap")
    fl.add_argument("--coalesce-hold", type=float, default=0.005,
                    metavar="S",
                    help="per-member coalescing hold window")
    fl.add_argument("--drain-seconds", type=float, default=10.0,
                    help="per-member SIGTERM drain budget")
    fl.add_argument("--spawn-timeout", type=float, default=120.0,
                    metavar="S",
                    help="budget for all members to come alive "
                         "(each pays import torch and its CUDA "
                         "context)")
    fl.set_defaults(fn=cmd_fleet)

    fd = sub.add_parser(
        "fleet-drill",
        help="continuously-verified chaos drill: a live fleet under "
             "the seeded fault gauntlet, gated on the invariant "
             "monitor (exit 8 on violation)",
    )
    fd.add_argument("--store", default="store",
                    help="store root directory (shared by the members)")
    fd.add_argument("--backend", choices=("cpu", "cuda"), default=None,
                    help="device the members and the parity oracle "
                         "check on (default: the CUDA card; cpu runs "
                         "the plain PyTorch versions)")
    fd.add_argument("--members", type=int, default=2,
                    help="fleet size under drill (min 2; default 2)")
    fd.add_argument("--duration", type=float, default=30.0,
                    metavar="S",
                    help="traffic-under-fire window (default 30s; "
                         "settle/restore time is extra)")
    fd.add_argument("--seed", type=int, default=0,
                    help="fault-schedule seed (same seed = same "
                         "drill, byte for byte)")
    fd.add_argument("--classes", default=None, metavar="K1,K2,...",
                    help="restrict the gauntlet to these fault "
                         "classes (kill,stall,delay,drop,torn_write,"
                         "clock_skew,checkpoint_corrupt); default all")
    fd.add_argument("--gray-seconds", type=float, default=12.0,
                    metavar="S",
                    help="SIGSTOP gray-failure period length")
    fd.add_argument("--restart-budget", type=int, default=3,
                    help="supervisor respawns per member")
    fd.add_argument("--fleet-dir", default=None, metavar="DIR",
                    help="registry dir (default <store>/.fleet-drill)")
    fd.add_argument("--spawn-timeout", type=float, default=180.0,
                    metavar="S",
                    help="budget for the initial fleet to come alive")
    fd.add_argument("--report", default=None, metavar="PATH",
                    help="also write the invariant report JSON here")
    fd.add_argument("--no-parity", action="store_true",
                    help="skip the solo-oracle verdict-parity pass "
                         "(faster; weakens the gate)")
    fd.set_defaults(fn=cmd_fleet_drill)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    try:
        args = parser.parse_args(argv)
    except SystemExit as e:
        return EXIT_USAGE if e.code not in (0, None) else 0
    try:
        return args.fn(args)
    except Exception:
        traceback.print_exc()
        return EXIT_CRASH


if __name__ == "__main__":
    sys.exit(main())
