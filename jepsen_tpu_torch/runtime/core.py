"""Core runtime: the test orchestrator and worker loops.

The accelerator-era analog of the reference's core runtime
(jepsen/src/jepsen/core.clj): `run()` takes a declarative test spec,
spawns one OS thread per logical worker plus a nemesis worker, drives
them from a SHARED pure generator (the v2 design the reference was
migrating toward — generator/pure.clj — which this framework adopts
outright), records a concurrent history, and hands it to the checker.

This is the port's copy of jepsen_tpu.runtime.core. The worker threads
are plain Python and never touch CUDA: the check, after every worker
has joined, is the one step that reaches the card (kernel A for the
linearizable workloads, the torch-ops programs for the rest). The run
log goes to the jepsen_tpu_torch logger.

Faithfully reproduced semantics:
- Worker loop (core.clj:299-358): poll generator -> stamp
  process/relative-time -> (re)open client if needed -> journal invoke
  -> client.invoke -> journal completion.
- Exception conversion (core.clj:199-232): client exceptions become
  :info completions (indeterminate) with the error recorded;
  ClientFailed becomes :fail (definitely didn't happen).
- Crash cycling (core.clj:338-355): an :info completion retires the
  logical process — the thread closes its client and adopts process
  `p + (count of numeric processes)`, keeping per-process history
  single-threaded, which the linearizability checker's soundness
  depends on.
- Failed client open (core.clj:313-328): journals a synthetic
  :fail invoke/completion pair with the error, then retries on the
  next op.
- Generator failure recovery (test/jepsen/core_test.clj:130-152): a
  generator exception poisons the scheduler, unblocks every worker,
  closes all clients, and rethrows from run().
- Nemesis worker (core.clj:370-401): same loop on the "nemesis"
  thread/process, but ops route to the test's nemesis and errors are
  journaled, never retried.

The scheduler is the real-time interpreter of the pure-generator
contract proven by generator/simulate.py: identical context/update
semantics, with actual clocks and threads.
"""

from __future__ import annotations

import threading
import time as _time
from typing import Any, Dict, List, Optional

from jepsen_tpu_torch.generator import pure as gen
from jepsen_tpu_torch.history.history import History
from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.runtime.client import Client, ClientFailed

NEMESIS = gen.NEMESIS

#: how long a worker sleeps when the generator is PENDING
_PENDING_SLEEP = 0.0005
#: max single sleep while waiting for a scheduled op time (keeps
#: workers responsive to poisoning)
_MAX_SLEEP = 0.05


class Scheduler:
    """Shared pure-generator state: one lock, one generator value, one
    evolving context. Workers poll ops and report events; the scheduler
    maintains free-thread bookkeeping and process retirement exactly as
    generator/simulate.py does deterministically."""

    def __init__(self, generator, test, threads: List[Any], t0_ns: int):
        self._lock = threading.Lock()
        self._gen = gen.validate(generator)
        self._test = test
        self._t0 = t0_ns
        self._ctx = gen.context(
            time=0,
            free_threads=tuple(threads),
            workers={t: t for t in threads},
        )
        self._poison: Optional[BaseException] = None

    def now(self) -> int:
        return _time.monotonic_ns() - self._t0

    def poison(self, err: BaseException) -> None:
        with self._lock:
            if self._poison is None:
                self._poison = err

    @property
    def poisoned(self) -> Optional[BaseException]:
        return self._poison

    def next_op(self, thread) -> Optional[dict]:
        """Block until the generator yields an op for some free thread
        that this thread can take, the generator is exhausted (None), or
        the scheduler is poisoned (None). Returns the invocation as a
        plain dict (type/f/value/process/time)."""
        while True:
            committed = None
            with self._lock:
                if self._poison is not None:
                    return None
                self._ctx["time"] = self.now()
                try:
                    pair = gen.op(self._gen, self._test, self._ctx)
                except BaseException as e:  # generator bug: poison all
                    self._poison = e
                    return None
                if pair is None:
                    return None
                o, g2 = pair
                if o is gen.PENDING:
                    # Commit the successor even for PENDING: Sleep-style
                    # generators anchor their deadline in it.
                    self._gen = g2
                else:
                    # Is this op for us? Ops carry a process; map it to
                    # its thread. Workers only execute their own ops —
                    # another thread's op stays uncommitted for its
                    # owner to pick up.
                    t = gen.process_to_thread(self._ctx, o["process"])
                    if t == thread:
                        # Commit NOW, even when the op is scheduled in
                        # the future, then sleep until its time outside
                        # the lock. Re-polling later instead would
                        # livelock on time-randomizing generators like
                        # stagger, which produce a fresh future delay on
                        # every poll (the deterministic interpreter in
                        # generator/simulate.py commits the same way).
                        self._gen = g2
                        committed = dict(o)
            if committed is not None:
                while self._poison is None:
                    wait = committed["time"] - self.now()
                    if wait <= 0:
                        return committed
                    _time.sleep(min(wait / 1e9, _MAX_SLEEP))
                return None
            _time.sleep(_PENDING_SLEEP)

    def on_invoke(self, invocation: dict) -> None:
        """Journal an invoke event: thread leaves the free set."""
        with self._lock:
            thread = gen.process_to_thread(self._ctx, invocation["process"])
            self._ctx["free_threads"] = tuple(
                t for t in self._ctx["free_threads"] if t != thread
            )
            self._ctx["time"] = max(self._ctx["time"], invocation["time"])
            self._gen = gen.update(
                self._gen, self._test, self._ctx, invocation
            )

    def on_complete(self, completion: dict) -> None:
        """Journal a completion: thread rejoins the free set; an :info
        completion retires the process (crash cycling)."""
        with self._lock:
            thread = gen.process_to_thread(self._ctx, completion["process"])
            self._ctx["time"] = max(self._ctx["time"], completion["time"])
            self._gen = gen.update(
                self._gen, self._test, self._ctx, completion
            )
            if thread is None:
                return
            if completion.get("type") == "info" and thread != NEMESIS:
                self._ctx["workers"][thread] = gen.next_process(
                    self._ctx, thread
                )
            self._ctx["free_threads"] = gen._sorted_threads(
                set(self._ctx["free_threads"]) | {thread}
            )


class _HistoryRecorder:
    """Thread-safe append-only op journal with relative-nanos stamping
    (core.clj:55-59's conj-op! on an atom)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ops: List[Op] = []

    def append(self, op: Op) -> Op:
        with self._lock:
            self._ops.append(op)
            return op

    def snapshot(self) -> List[Op]:
        with self._lock:
            return list(self._ops)


def _invoke_client(client, test, op: Op) -> Op:
    """client.invoke with the reference's exception conversion
    (core.clj:199-232)."""
    try:
        completion = client.invoke(test, op)
        if not isinstance(completion, Op) or completion.type not in (
            "ok",
            "fail",
            "info",
        ):
            return op.with_(
                type="info", error=f"bad completion: {completion!r}"
            )
        return completion
    except ClientFailed as e:
        return op.with_(type="fail", error=str(e) or "client failed")
    except Exception as e:
        return op.with_(type="info", error=f"{type(e).__name__}: {e}")


class ClientWorker(threading.Thread):
    """Per-thread op loop with crash cycling (core.clj:280-368)."""

    def __init__(self, thread_id, node, test, sched: Scheduler,
                 recorder: _HistoryRecorder):
        super().__init__(name=f"jepsen-worker-{thread_id}", daemon=True)
        self.thread_id = thread_id
        self.node = node
        self.test = test
        self.sched = sched
        self.recorder = recorder
        self.client: Optional[Client] = None
        self._setup_done = False
        self.error: Optional[BaseException] = None

    def _open_client(self) -> Optional[str]:
        """Open (and on the worker's FIRST open, setup) a client.
        Crash-cycle reopens skip setup — data setup is one-time, like
        the reference's setup!/open! split (client.clj:8-27)."""
        try:
            self.client = self.test["client"].open(self.test, self.node)
        except Exception as e:
            self.client = None
            return f"{type(e).__name__}: {e}"
        if not self._setup_done:
            try:
                self.client.setup(self.test)
                self._setup_done = True
            except Exception as e:
                self._close_client()
                return f"{type(e).__name__}: {e}"
        return None

    def _close_client(self, teardown: bool = False) -> None:
        if self.client is not None:
            if teardown and self._setup_done:
                try:
                    self.client.teardown(self.test)
                except Exception:
                    pass
            try:
                self.client.close(self.test)
            except Exception:
                pass
            self.client = None

    def run(self) -> None:
        test, sched, rec = self.test, self.sched, self.recorder
        try:
            while True:
                o = sched.next_op(self.thread_id)
                if o is None:
                    break
                op = Op(
                    type="invoke",
                    f=o.get("f"),
                    value=o.get("value"),
                    process=o["process"],
                    time=sched.now(),
                )
                if self.client is None:
                    err = self._open_client()
                    if err is not None:
                        # Synthetic fail pair; retry open on next op
                        # (core.clj:313-328).
                        inv = rec.append(op.with_(error=err))
                        sched.on_invoke(_as_dict(inv))
                        comp = rec.append(
                            op.with_(
                                type="fail", time=sched.now(), error=err
                            )
                        )
                        sched.on_complete(_as_dict(comp))
                        continue
                inv = rec.append(op)
                _log_op(test, inv)
                sched.on_invoke(_as_dict(inv))
                completion = _invoke_client(self.client, test, inv)
                completion = completion.with_(time=sched.now())
                rec.append(completion)
                _log_op(test, completion)
                sched.on_complete(_as_dict(completion))
                if completion.type == "info":
                    # Crash: retire process, cycle the client
                    # (core.clj:338-355).
                    self._close_client()
        except BaseException as e:  # runtime bug: abort the whole run
            self.error = e
            sched.poison(e)
        finally:
            self._close_client(teardown=True)


class NemesisWorker(threading.Thread):
    """Nemesis op loop (core.clj:370-401): ops route to the test's
    nemesis; exceptions become :info completions and are never
    retried."""

    def __init__(self, test, sched: Scheduler, recorder: _HistoryRecorder):
        super().__init__(name="jepsen-nemesis", daemon=True)
        self.test = test
        self.sched = sched
        self.recorder = recorder
        self.error: Optional[BaseException] = None

    def run(self) -> None:
        test, sched, rec = self.test, self.sched, self.recorder
        nemesis = test.get("nemesis")
        try:
            while True:
                o = sched.next_op(NEMESIS)
                if o is None:
                    break
                inv = rec.append(
                    Op(
                        type="invoke",
                        f=o.get("f"),
                        value=o.get("value"),
                        process=NEMESIS,
                        time=sched.now(),
                    )
                )
                sched.on_invoke(_as_dict(inv))
                if nemesis is None:
                    comp = inv.with_(type="info", time=sched.now())
                else:
                    try:
                        comp = nemesis.invoke(test, inv)
                        if not isinstance(comp, Op):
                            comp = inv.with_(type="info")
                    except Exception as e:
                        comp = inv.with_(
                            type="info", error=f"{type(e).__name__}: {e}"
                        )
                    comp = comp.with_(time=sched.now())
                rec.append(comp)
                sched.on_complete(_as_dict(comp))
        except BaseException as e:
            self.error = e
            sched.poison(e)


def synchronize(test, timeout_s: float = 60.0) -> None:
    """Block until every node's setup thread arrives (core.clj:40-53).
    No-op for single-node tests."""
    barrier = test.get("barrier")
    if barrier is not None:
        barrier.wait(timeout=timeout_s)


_op_log = None


def _log_op(test, op: Op) -> None:
    """Structured per-op logging (util.clj:208-212, core.clj:311,337):
    enabled by test["log_ops"]; lines go to the jepsen_tpu_torch.runtime
    logger (and thus the run-dir jepsen.log when a store is set)."""
    if not test.get("log_ops"):
        return
    import logging

    global _op_log
    if _op_log is None:
        _op_log = logging.getLogger("jepsen_tpu_torch.runtime.ops")
    _op_log.info(
        "%-8s %-6s %-10s %r", op.process, op.type, op.f, op.value
    )


def _as_dict(op: Op) -> dict:
    return {
        "type": op.type,
        "f": op.f,
        "value": op.value,
        "process": op.process,
        "time": op.time,
    }


def _attach_run_log(run_dir) -> None:
    """Mirror jepsen_tpu_torch.* logging into <run_dir>/jepsen.log
    (store.clj:394-422's unilog appender)."""
    if not run_dir:
        return
    import logging
    import os

    logger = logging.getLogger("jepsen_tpu_torch")
    path = os.path.join(run_dir, "jepsen.log")
    for h in logger.handlers:
        if getattr(h, "_jepsen_run_log", None) == path:
            return
    for h in list(logger.handlers):
        if getattr(h, "_jepsen_run_log", None):
            logger.removeHandler(h)
            h.close()
    h = logging.FileHandler(path)
    h._jepsen_run_log = path
    h.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)-5s [%(name)s] %(message)s"
    ))
    logger.addHandler(h)
    if logger.level == logging.NOTSET:
        # Default to INFO but respect an operator-set level (DEBUG
        # enables the control-command audit trace).
        logger.setLevel(logging.INFO)


#: default bound on the post-generator worker join (overridable per
#: test via test["worker_join_timeout_s"]): generous enough for any
#: legitimate drain, but finite — a wedged client must surface as a
#: named failure, never block run() forever.
_JOIN_TIMEOUT_S = 3600.0

#: after poisoning, how long hung workers get to notice and exit
_JOIN_GRACE_S = 5.0


def _join_workers(all_workers, test, sched: Scheduler) -> None:
    """Bounded worker joins (the unbounded w.join()/nw.join() let one
    wedged client block the whole run forever). Blowing the budget
    poisons the scheduler — unblocking every generator-waiting worker —
    grants a short grace, then records WHICH workers hung in
    test["hung_workers"] and lets the poison surface from run()."""
    timeout = float(
        test.get("worker_join_timeout_s") or _JOIN_TIMEOUT_S
    )
    deadline = _time.monotonic() + timeout
    hung = [w for w in all_workers if not _deadline_join(w, deadline)]
    if not hung:
        return
    names = [w.name for w in hung]
    sched.poison(RuntimeError(
        f"worker(s) did not join within {timeout:g}s: "
        + ", ".join(names)
    ))
    grace = _time.monotonic() + float(
        test.get("worker_join_grace_s") or _JOIN_GRACE_S
    )
    still = [w.name for w in hung if not _deadline_join(w, grace)]
    test["hung_workers"] = still or names
    import logging

    logging.getLogger(__name__).error(
        "worker join timed out after %gs; hung: %s%s",
        timeout, ", ".join(names),
        " (exited after poison)" if not still else "",
    )


def _deadline_join(w, deadline: float) -> bool:
    """Join a worker against an absolute monotonic deadline; True if
    it exited."""
    w.join(timeout=max(0.0, deadline - _time.monotonic()))
    return not w.is_alive()


def run(test: Dict[str, Any]) -> Dict[str, Any]:
    """Run a test spec end-to-end in-process and analyze the history.

    The spec is a plain dict of protocol slots, the same data-first
    shape as the reference's test map (core.clj:467-515):

      client       Client prototype (opened per worker)
      nemesis      optional Nemesis
      generator    pure generator of client ops
      checker      optional checker with .check(test, history, opts)
      concurrency  worker count (default 5)
      nodes        list of node names (workers round-robin over them;
                   default ["n1".."n5"])
      name         test name (default "noname")

    Returns the test dict extended with "history" (History) and
    "results" (checker output; {"valid?": True} when no checker).
    """
    test = dict(test)
    test.setdefault("name", "noname")
    test.setdefault("concurrency", 5)
    test.setdefault("nodes", [f"n{i}" for i in range(1, 6)])
    test.setdefault("start_time", _time.time())
    n = test["concurrency"]
    nodes = test["nodes"]
    # Cross-node rendezvous for multi-phase DB bring-up, sized to the
    # node count with the reference's 60s default (core.clj:40-53);
    # DB.setup implementations call synchronize(test).
    test.setdefault(
        "barrier",
        threading.Barrier(len(nodes)) if len(nodes) > 1 else None,
    )

    # Run-dir + logging start BEFORE anything executes (store.clj's
    # start-logging! happens first thing in run!, core.clj:513), so op
    # and control-command lines land in <run_dir>/jepsen.log.
    store = None
    if test.get("store") is not None:
        from jepsen_tpu_torch.store import Store

        store = (
            test["store"] if isinstance(test["store"], Store)
            else Store(str(test["store"]))
        )
        store.make_run_dir(test)
        _attach_run_log(test.get("run_dir"))

    threads = list(range(n)) + [NEMESIS]
    t0 = _time.monotonic_ns()
    # A workload's final phase (queue drain, final set/monotonic read)
    # composes AFTER the main generator — so a time_limit applied to
    # "generator" can never truncate it (the reference's
    # :final-generator convention, e.g. hazelcast.clj:309-317).
    generator = test.get("generator")
    if test.get("final_generator") is not None:
        generator = gen.phases(generator, test["final_generator"])
    sched = Scheduler(generator, test, threads, t0)
    rec = _HistoryRecorder()

    # Environment lifecycle (core.clj:538-552): OS setup on every node,
    # then the DB teardown/setup cycle (with retries), before any
    # worker runs. Only engaged when the spec carries the slots.
    from jepsen_tpu_torch.control.core import on_nodes as _on_nodes

    os_ = test.get("os")
    if os_ is not None:
        _on_nodes(test, lambda nd, s: os_.setup(test, nd, s))
    if test.get("db") is not None:
        from jepsen_tpu_torch import db as _dblib

        _dblib.cycle(test)

    # Nemesis lifecycle (nemesis.clj:9-14): setup before workers spawn,
    # teardown after they drain.
    nem = test.get("nemesis")
    if nem is not None and hasattr(nem, "setup"):
        test["nemesis"] = nem = nem.setup(test)

    workers = [
        ClientWorker(i, nodes[i % len(nodes)], test, sched, rec)
        for i in range(n)
    ]
    nw = NemesisWorker(test, sched, rec)
    try:
        for w in workers:
            w.start()
        nw.start()
        _join_workers(workers + [nw], test, sched)
    finally:
        if nem is not None and hasattr(nem, "teardown"):
            try:
                nem.teardown(test)
            except Exception as e:
                # An un-torn-down nemesis leaves faults in place
                # (partitions, stopped processes): surface it.
                import logging

                logging.getLogger(__name__).warning(
                    "nemesis teardown failed; injected faults may "
                    "persist: %s", e
                )
                test["nemesis_teardown_error"] = f"{type(e).__name__}: {e}"
        db = test.get("db")
        if db is not None:
            def _td(nd, s):
                try:
                    db.teardown(test, nd, s)
                except Exception:
                    pass

            _on_nodes(test, _td)
        # Log snarfing (core.clj:98-149 with-log-snarfing): download
        # every node's DB logs into <run_dir>/<node>/ after teardown.
        # Living in this finally, it also runs when the test dies —
        # a poisoned generator, a worker crash, or a Ctrl-C
        # (KeyboardInterrupt propagating through the joins) — the
        # reference's JVM-shutdown-hook role.
        if db is not None and test.get("run_dir"):
            from jepsen_tpu_torch.db import snarf_logs as _snarf_logs

            try:
                _snarf_logs(test, test["run_dir"])
            except Exception:
                pass  # best-effort, like the shutdown hook

    if sched.poisoned is not None:
        for w in workers + [nw]:
            if w.error is not None and w.error is sched.poisoned:
                raise w.error
        raise sched.poisoned

    history = History(rec.snapshot())
    test["history"] = history

    # Two-phase persistence around analysis (store.clj:367-392): the
    # history saves BEFORE checking (so artifact-writing checkers like
    # the timeline have a home, and a checker crash still leaves the
    # history on disk), results after.
    if store is not None:
        store.save_1(test)

    checker = test.get("checker")
    if checker is not None:
        test["results"] = checker.check(test, history, {})
    else:
        test["results"] = {"valid?": True}
    if store is not None:
        store.save_2(test)
    return test
