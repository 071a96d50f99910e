"""planelint Family C: flight-recorder emission discipline.

JT3xx rules over the instrumented tree (checker modules, the service
daemon, the CLI, and ``obs`` itself). The recorder is deliberately
safe to leave in hot paths — but only under three disciplines the
runtime cannot enforce:

- JT301 ``span(...)`` must be entered via ``with`` — a span records
  itself at ``__exit__``, so a span held in a variable and never
  (or conditionally) closed silently drops its event, and an
  exception between ``__enter__`` and ``__exit__`` loses the timing.
- JT302 no ``span``/``instant`` emission while holding a plane lock:
  emission appends to a ring and (first emission per thread) takes
  the ring-registry lock — doing that under ``_stats_lock`` couples
  the recorder's locking to the plane's, and a slow trim stalls
  every thread contending for the plane lock.
- JT303 no ``span``/``instant`` call reachable from compile-traced
  code (``torch.compile``/``torch.jit``): a traced emission fires at
  TRACE time, records compile-side wall, and its clock read bakes into
  the compiled graph — the timeline would show phantom events that
  never happen on re-execution.
- JT304 no ``span``/``instant`` emission inside a per-device or
  per-member loop: ring churn that scales with mesh size turns the
  recorder from O(1) per plane crossing into O(devices) per crossing
  — on a pod that is O(hosts x chips) events for ONE logical step,
  and the ring's drop-on-overflow then evicts the events that
  mattered. Emit once after the loop with the aggregate
  (``n=len(devices)``) instead.
- JT305 no direct launch/collect call inside a loop over stream
  appends: a per-append device launch pays the one-sync floor once
  PER APPEND, where routing the tail through the dispatch plane's
  stream bucket (``plane.submit_stream_tail(...)`` + ``fut.result()``)
  coalesces same-shape tails into one stacked launch — k appends cost
  ~k/bucket_size launches instead of k. The rule keys on the loop's
  shape (iterable/target named for appends, chunks, or tails) and the
  callee's (known dispatch/collect entry points); plane submits are
  the sanctioned spelling and never match.

Lock-scope inference matches Family B (``with <...lock...>:``), and
traced-closure inference reuses Family A's ``ModuleInfo`` fixpoint.
"""

from __future__ import annotations

import ast
from typing import List, Set

from jepsen_tpu_torch.analysis.findings import Finding
from jepsen_tpu_torch.analysis.hotpath import ModuleInfo, _last_seg

#: emission entry points, by final name segment (``span``,
#: ``obs_trace.span``, ``obs.instant``...)
_SPAN_TAILS = {"span"}
_EMIT_TAILS = {"span", "instant"}


def _is_emit_call(node: ast.Call, tails: Set[str]) -> bool:
    seg = _last_seg(node.func)
    return bool(seg) and seg in tails


#: iterables whose loops are per-device / per-member by construction
#: (``for d in devices:``, ``for m in members:`` ...)
_MESH_ITER_TAILS = {
    "devices", "local_devices", "mesh_devices", "members",
    "member_recs", "procs", "processes", "hosts", "shards",
}
#: range()/count bounds that make a loop mesh-sized
#: (``for i in range(n_devices):`` ...)
_MESH_BOUND_TAILS = {
    "n_devices", "n_hosts", "n_members", "n_procs", "n_local_devices",
    "process_count", "device_count", "local_device_count", "mesh_size",
}
#: loop targets that name the per-device / per-member element
_MESH_TARGET_NAMES = {"device", "dev", "member", "shard"}

#: iterables whose loops walk stream appends by construction
#: (``for chunk in stream_appends:``, ``for a in appends:`` ...)
_STREAM_ITER_TAILS = {
    "appends", "stream_appends", "chunks", "stream_chunks",
    "tails", "stream_tails", "pending_appends",
}
#: loop targets that name the per-append element
_STREAM_TARGET_NAMES = {"chunk", "append_ops", "tail_ops"}
#: direct launch / collect entry points whose per-append use defeats
#: stream-tail coalescing (the plane's submit_stream_tail does NOT
#: appear here — routing through the plane IS the sanctioned fix)
_STREAM_LAUNCH_TAILS = {
    "check_steps_bitset", "check_steps_bitset_segmented",
    "check_keys_bitset", "launch_tails_bitset", "_run_chain",
    "bitset_scan", "_host_get", "wait_train", "synchronize",
}


def _target_names(t: ast.AST) -> Set[str]:
    if isinstance(t, ast.Name):
        return {t.id}
    if isinstance(t, (ast.Tuple, ast.List)):
        out: Set[str] = set()
        for e in t.elts:
            out |= _target_names(e)
        return out
    return set()


def _mesh_iterable(node: ast.AST) -> bool:
    """Does this loop iterable enumerate mesh members?"""
    seg = _last_seg(node)
    if seg in _MESH_ITER_TAILS:
        return True
    if isinstance(node, ast.Call):
        fseg = _last_seg(node.func)
        if fseg in _MESH_ITER_TAILS:  # mesh.devices(), ...
            return True
        if fseg in ("enumerate", "sorted", "reversed", "zip", "list"):
            return any(_mesh_iterable(a) for a in node.args)
        if fseg == "range":
            for a in node.args:
                if _last_seg(a) in _MESH_BOUND_TAILS:
                    return True
                if (isinstance(a, ast.Call)
                        and _last_seg(a.func) in _MESH_BOUND_TAILS):
                    return True
    return False


def _per_mesh_loop(node: ast.For) -> bool:
    return _mesh_iterable(node.iter) or bool(
        _target_names(node.target) & _MESH_TARGET_NAMES
    )


def _stream_iterable(node: ast.AST) -> bool:
    """Does this loop iterable walk stream appends?"""
    seg = _last_seg(node)
    if seg in _STREAM_ITER_TAILS:
        return True
    if isinstance(node, ast.Call):
        fseg = _last_seg(node.func)
        if fseg in _STREAM_ITER_TAILS:
            return True
        if fseg in ("enumerate", "sorted", "reversed", "zip", "list"):
            return any(_stream_iterable(a) for a in node.args)
    return False


def _per_append_loop(node: ast.For) -> bool:
    return _stream_iterable(node.iter) or bool(
        _target_names(node.target) & _STREAM_TARGET_NAMES
    )


class ObsChecker(ast.NodeVisitor):
    def __init__(self, tree: ast.Module, rel: str):
        self.tree = tree
        self.rel = rel
        self.findings: List[Finding] = []
        self.locks: List[str] = []
        self.symbols: List[str] = []
        self.info = ModuleInfo(tree)
        #: span(...) calls that ARE a with-item context expression
        #: (the sanctioned spelling) — collected up front so JT301
        #: can flag every other span call
        self.with_spans: Set[int] = set()
        for n in ast.walk(tree):
            if isinstance(n, ast.With):
                for item in n.items:
                    if isinstance(item.context_expr, ast.Call):
                        self.with_spans.add(id(item.context_expr))
        #: are we inside a function that only runs under compile
        #: tracing?
        self.traced_depth = 0
        #: depth of enclosing per-device / per-member loops (JT304)
        self.mesh_loop_depth = 0
        #: depth of enclosing stream-append loops (JT305)
        self.stream_loop_depth = 0

    @property
    def symbol(self) -> str:
        return ".".join(self.symbols) if self.symbols else "<module>"

    def add(self, rule: str, node: ast.AST, message: str) -> None:
        self.findings.append(
            Finding(
                rule=rule,
                file=self.rel,
                line=getattr(node, "lineno", 0),
                col=getattr(node, "col_offset", 0),
                severity="error",
                message=message,
                symbol=self.symbol,
            )
        )

    def run(self) -> List[Finding]:
        self.visit(self.tree)
        return self.findings

    # -- scope tracking (Family B's lock discipline) -------------------

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.symbols.append(node.name)
        held, self.locks = self.locks, []
        # a nested def's body runs when CALLED, not per loop
        # iteration — its mesh-loop context starts fresh
        in_loop, self.mesh_loop_depth = self.mesh_loop_depth, 0
        in_stream, self.stream_loop_depth = self.stream_loop_depth, 0
        traced = (
            node.name in self.info.traced
            or node.name in self.info.jit_impls
            or node.name in self.info.jitted
        )
        self.traced_depth += 1 if traced else 0
        self.generic_visit(node)
        self.traced_depth -= 1 if traced else 0
        self.mesh_loop_depth = in_loop
        self.stream_loop_depth = in_stream
        self.locks = held
        self.symbols.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.symbols.append(node.name)
        self.generic_visit(node)
        self.symbols.pop()

    def visit_Lambda(self, node: ast.Lambda) -> None:
        held, self.locks = self.locks, []
        self.generic_visit(node)
        self.locks = held

    def visit_With(self, node: ast.With) -> None:
        acquired = []
        for item in node.items:
            if (
                _last_seg(item.context_expr) is not None
                and "lock" in (_last_seg(item.context_expr) or "").lower()
            ):
                acquired.append(_last_seg(item.context_expr) or "<lock>")
            else:
                self.visit(item.context_expr)
        self.locks.extend(acquired)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self.locks.pop()

    def visit_For(self, node: ast.For) -> None:
        mesh = _per_mesh_loop(node)
        stream = _per_append_loop(node)
        self.visit(node.iter)
        self.visit(node.target)
        self.mesh_loop_depth += 1 if mesh else 0
        self.stream_loop_depth += 1 if stream else 0
        for stmt in node.body:
            self.visit(stmt)
        self.mesh_loop_depth -= 1 if mesh else 0
        self.stream_loop_depth -= 1 if stream else 0
        for stmt in node.orelse:
            self.visit(stmt)

    visit_AsyncFor = visit_For

    # -- the rules -----------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        if _is_emit_call(node, _SPAN_TAILS) and (
            id(node) not in self.with_spans
        ):
            self.add(
                "JT301", node,
                "span(...) not entered via a with block — the span "
                "records itself at __exit__, so a held or "
                "conditionally-closed span silently drops its event",
            )
        if _is_emit_call(node, _EMIT_TAILS):
            if self.locks:
                held = ", ".join(self.locks)
                self.add(
                    "JT302", node,
                    f"trace emission while holding {held} — emit "
                    "after the lock is released (emission may take "
                    "the recorder's ring-registry lock and trim)",
                )
            if self.traced_depth > 0:
                self.add(
                    "JT303", node,
                    "obs emission reachable from compile-traced code "
                    "— it fires at trace time and its clock read "
                    "bakes into the compiled graph; emit from the "
                    "host-side caller instead",
                )
            if self.mesh_loop_depth > 0:
                self.add(
                    "JT304", node,
                    "trace emission inside a per-device/per-member "
                    "loop — ring churn scales with mesh size and "
                    "drop-on-overflow evicts the events that matter; "
                    "emit once after the loop with the aggregate "
                    "(n=len(devices))",
                )
        if self.stream_loop_depth > 0:
            seg = _last_seg(node.func)
            if seg in _STREAM_LAUNCH_TAILS:
                self.add(
                    "JT305", node,
                    f"{seg}(...) launched per append inside a stream "
                    "loop — each iteration pays the one-sync launch "
                    "floor; route the tail through the dispatch "
                    "plane's stream bucket (plane.submit_stream_tail "
                    "+ fut.result()) so same-shape tails coalesce "
                    "into one stacked launch",
                )
        self.generic_visit(node)


def check_obs(tree: ast.Module, rel: str) -> List[Finding]:
    return ObsChecker(tree, rel).run()
