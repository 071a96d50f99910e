"""planelint Family B: plane lock discipline.

JT2xx rules over the threaded layers (dispatch plane, the kernel
build, the service daemon, chaos). Lock-guard scopes are inferred syntactically
from ``with <LOCK>:`` blocks — any context-manager expression whose
final name segment contains "lock" counts as a plane lock.

Rules:

- JT201 mutation of a module-level ``*_STATS`` structure (or the
  chaos quarantine ledger) outside a lock scope.
- JT202 blocking call (``.join()``, ``.result()``, socket ops,
  ``.communicate()``, ``time.sleep``) while holding a plane lock.
  ``Condition.wait`` is deliberately NOT in the set: it releases the
  lock it rides, and neither is a string's ``"sep".join(...)``.
- JT203 ``Thread(...)`` creation in a module with no bounded-join
  seam (no ``join(timeout=...)`` anywhere) — an unjoinable thread.
- JT204 user-hook invocation (observer/callback/on_fault/after_save
  spellings) while holding a lock: a hook that re-enters the stats
  API deadlocks on the non-reentrant lock, and a slow hook stalls
  every thread contending for it.
- JT205 aggregate read (``dict(X_STATS)``, ``.items()``, iteration)
  of a stats structure outside a lock — a torn snapshot. Single
  scalar subscript reads stay allowed (atomic under the GIL); the
  sanctioned path is a locked ``snapshot()`` helper.
- JT206 cross-member membership/routing state (``self._members``,
  ``self._ring``, ``routing``/``route_table`` attributes) mutated
  outside the membership lock. The fleet's routing tier caches a
  consistent-hash ring derived from the live member set; an unlocked
  rebind or in-place edit lets a concurrent router read a
  half-updated ring and route a tenant to two owners at once —
  admission ledgers and stream state then split across members.
  ``__init__`` bodies are exempt (single-threaded construction), and
  locals are out of scope: only attribute state can be shared.
- JT207 process control — a signal send (``os.kill``,
  ``proc.terminate()``/``.send_signal()``) or subprocess spawn
  (``subprocess.Popen``/``run``, ``spawn_*`` helpers) — while holding
  a lock. A fork pays page-table copy + exec latency and a signal
  delivery can block on an uninterruptible target; either one stalls
  every router/supervisor thread contending for the registry or plane
  lock it rides. The sanctioned shape is the supervisor's: decide
  WHICH members to respawn under the lock, release it, then spawn.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional

from jepsen_tpu_torch.analysis.callgraph import (
    BLOCKING_ATTRS as _BLOCKING_ATTRS,
    BLOCKING_DOTTED_TAILS as _BLOCKING_DOTTED_TAILS,
    _dotted,
    _last_seg,
    is_str_join,
)
from jepsen_tpu_torch.analysis.findings import Finding

#: guarded shared structures: module-level stats dicts + the chaos
#: quarantine ledger
_STATS_RE = re.compile(
    r"(^|_)([A-Z][A-Z0-9]*_)*(STATS|FAILURES|QUARANTINED)$"
)

#: attribute calls that mutate a dict/list in place
_MUTATORS = {
    "update", "clear", "setdefault", "pop", "popitem", "append",
    "extend", "insert", "remove", "__setitem__",
}

# the blocking-call sets now live in callgraph.py (imported above):
# JT202 (this family, lexical) and JT403 (Family D, interprocedural)
# must agree on what "blocking" means or they partition the hazard
# incorrectly.

#: hook-shaped callee names (JT204)
_HOOK_RE = re.compile(
    r"(observer|hook|callback|on_fault|on_drain|after_save)",
    re.IGNORECASE,
)

#: aggregate readers (JT205)
_AGG_READERS = {"dict", "list", "tuple", "sorted"}
_AGG_METHODS = {"items", "values", "keys", "copy"}

#: cross-member membership/routing attributes (JT206): the shared
#: control-plane state a fleet router derives tenant ownership from
_MEMBERSHIP_RE = re.compile(
    r"^_?(members|ring|routing|route_table)$"
)

#: JT207 process control under a held lock: signal-send spellings
#: (dotted module calls and process-handle methods) and spawn
#: spellings. ``.wait()``/``.join()`` are JT202's beat, not ours.
_SIGNAL_DOTTED = {"os.kill", "os.killpg"}
_SIGNAL_METHODS = {"terminate", "send_signal"}
_SPAWN_DOTTED = {
    "subprocess.Popen", "subprocess.run", "subprocess.call",
    "subprocess.check_call", "subprocess.check_output", "Popen",
}
_SPAWN_NAME_RE = re.compile(r"^spawn_")


def _is_membership_attr(node: ast.expr) -> bool:
    """ATTRIBUTE whose final segment names membership/routing state.
    Bare Names stay out of scope: a local ``ring = reg.ring()`` is
    thread-private — only attribute state can be shared."""
    return isinstance(node, ast.Attribute) and bool(
        _MEMBERSHIP_RE.match(node.attr)
    )


def _membership_base(node: ast.expr) -> Optional[str]:
    """The membership attribute a subscript chain bottoms out in:
    ``self._members[mid]`` -> '_members'."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if _is_membership_attr(node):
        return node.attr
    return None


def _is_stats_expr(node: ast.expr) -> bool:
    """Name/Attribute whose final segment matches the stats pattern
    (``LAUNCH_STATS``, ``bs.LAUNCH_STATS``, ``_QUARANTINED``...)."""
    seg = _last_seg(node)
    return bool(seg) and bool(_STATS_RE.search(seg))


def _stats_base(node: ast.expr) -> Optional[str]:
    """The stats structure a subscript/attribute chain bottoms out in:
    ``X_STATS[...]["..."]`` -> 'X_STATS'."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, (ast.Name, ast.Attribute)) and _is_stats_expr(
        node
    ):
        return _last_seg(node)
    return None


def _is_lock_expr(node: ast.expr) -> bool:
    seg = _last_seg(node)
    return bool(seg) and "lock" in seg.lower()


class ConcurrencyChecker(ast.NodeVisitor):
    def __init__(self, tree: ast.Module, rel: str):
        self.tree = tree
        self.rel = rel
        self.findings: List[Finding] = []
        self.locks: List[str] = []  # currently-held lock names
        self.symbols: List[str] = []
        #: does this module have a bounded-join seam at all?
        self.has_bounded_join = any(
            isinstance(n, ast.Call)
            and _last_seg(n.func) == "join"
            and (
                n.args
                or any(kw.arg == "timeout" for kw in n.keywords)
            )
            for n in ast.walk(tree)
        )

    # -- plumbing ------------------------------------------------------

    @property
    def symbol(self) -> str:
        return ".".join(self.symbols) if self.symbols else "<module>"

    def add(self, rule: str, node: ast.AST, message: str,
            severity: str = "error") -> None:
        self.findings.append(
            Finding(
                rule=rule,
                file=self.rel,
                line=getattr(node, "lineno", 0),
                col=getattr(node, "col_offset", 0),
                severity=severity,
                message=message,
                symbol=self.symbol,
            )
        )

    def run(self) -> List[Finding]:
        self.visit(self.tree)
        return self.findings

    # -- scope tracking ------------------------------------------------

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.symbols.append(node.name)
        # lock state does not cross a def boundary: the nested def
        # runs later, on some other thread's schedule
        held, self.locks = self.locks, []
        self.generic_visit(node)
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
            if _is_lock_expr(item.context_expr):
                acquired.append(
                    _last_seg(item.context_expr) or "<lock>"
                )
            else:
                self.visit(item.context_expr)
        self.locks.extend(acquired)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self.locks.pop()

    # -- JT201: stats mutation outside the lock ------------------------

    def _flag_mutation(self, node: ast.AST, base: str) -> None:
        if self.locks:
            return
        self.add(
            "JT201", node,
            f"mutation of shared stats structure '{base}' outside "
            "its lock — concurrent bumps interleave and drop counts",
        )

    # -- JT206: membership/routing mutation outside the lock -----------

    @property
    def _in_ctor(self) -> bool:
        """Inside __init__ (any nesting level): construction is
        single-threaded — nobody routes over a half-built registry."""
        return "__init__" in self.symbols

    def _flag_membership(self, node: ast.AST, name: str) -> None:
        if self.locks or self._in_ctor:
            return
        self.add(
            "JT206", node,
            f"mutation of cross-member routing state '{name}' "
            "outside the membership lock — a concurrent router reads "
            "a half-updated member set/ring and routes one tenant to "
            "two owners; mutate under the membership lock (rebuild "
            "rings immutably, swap the reference inside the lock)",
        )

    def _membership_targets(self, tgt: ast.expr, node: ast.AST):
        """Flag one assignment/delete target when it rebinds or
        edits membership state."""
        if _is_membership_attr(tgt):
            self._flag_membership(node, tgt.attr)
        elif isinstance(tgt, ast.Subscript):
            name = _membership_base(tgt)
            if name:
                self._flag_membership(node, name)

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            base = (
                _stats_base(tgt)
                if isinstance(tgt, ast.Subscript)
                else None
            )
            if base:
                self._flag_mutation(node, base)
            self._membership_targets(tgt, node)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._membership_targets(node.target, node)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        base = (
            _stats_base(node.target)
            if isinstance(node.target, ast.Subscript)
            else None
        )
        if base:
            self._flag_mutation(node, base)
        self._membership_targets(node.target, node)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for tgt in node.targets:
            if isinstance(tgt, ast.Subscript):
                base = _stats_base(tgt)
                if base:
                    self._flag_mutation(node, base)
            self._membership_targets(tgt, node)
        self.generic_visit(node)

    # -- calls: JT201 mutators, JT202/204 under-lock, JT203, JT205 -----

    def visit_For(self, node: ast.For) -> None:
        base = _stats_base(node.iter)
        if base is None and isinstance(node.iter, ast.Call):
            # for k in X_STATS.items()/keys()/values()
            f = node.iter.func
            if isinstance(f, ast.Attribute) and f.attr in _AGG_METHODS:
                base = _stats_base(f.value)
        if base and not self.locks:
            self.add(
                "JT205", node.iter,
                f"unlocked iteration over '{base}' — a concurrent "
                "bump tears the snapshot; read through the locked "
                "snapshot() helper",
            )
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        fd = _dotted(node.func)
        seg = _last_seg(node.func)

        # JT201: in-place mutator methods on a stats structure
        if isinstance(node.func, ast.Attribute) and (
            node.func.attr in _MUTATORS
        ):
            base = _stats_base(node.func.value)
            if base:
                self._flag_mutation(node, base)
            # JT206: in-place mutators on membership/routing state
            mname = _membership_base(node.func.value)
            if mname:
                self._flag_membership(node, mname)

        # JT205: aggregate reads outside the lock
        if not self.locks:
            if fd in _AGG_READERS and node.args:
                base = _stats_base(node.args[0])
                if base:
                    self.add(
                        "JT205", node,
                        f"unlocked aggregate read {fd}({base}) — a "
                        "concurrent bump tears the snapshot; read "
                        "through the locked snapshot() helper",
                    )
            if isinstance(node.func, ast.Attribute) and (
                node.func.attr in _AGG_METHODS
            ):
                base = _stats_base(node.func.value)
                if base:
                    self.add(
                        "JT205", node,
                        f"unlocked aggregate read {base}."
                        f"{node.func.attr}() — a concurrent bump "
                        "tears the snapshot; read through the locked "
                        "snapshot() helper",
                    )

        if self.locks:
            held = ", ".join(self.locks)
            # JT202: blocking calls under a plane lock
            blocking = None
            if isinstance(node.func, ast.Attribute) and (
                node.func.attr in _BLOCKING_ATTRS
            ) and not is_str_join(node):
                blocking = f".{node.func.attr}()"
            elif fd is not None and "." in fd and (
                fd.rsplit(".", 1)[-1] in _BLOCKING_DOTTED_TAILS
            ):
                blocking = f"{fd}()"
            if blocking:
                self.add(
                    "JT202", node,
                    f"blocking call {blocking} while holding "
                    f"{held} — every thread contending for the lock "
                    "stalls behind this wait",
                )
            # JT204: user hooks invoked under a lock
            if seg and _HOOK_RE.search(seg) and not (
                seg.startswith(("add_", "remove_", "clear_", "set_",
                                "install_"))
            ):
                self.add(
                    "JT204", node,
                    f"user hook '{seg}' invoked while holding "
                    f"{held} — a hook that re-enters the stats API "
                    "deadlocks; snapshot under the lock, call hooks "
                    "after release",
                )
            # JT207: process control (signal send / subprocess
            # spawn) under a held lock
            proc_ctl = None
            if fd in _SIGNAL_DOTTED:
                proc_ctl = f"signal send {fd}()"
            elif isinstance(node.func, ast.Attribute) and (
                node.func.attr in _SIGNAL_METHODS
            ):
                proc_ctl = f"signal send .{node.func.attr}()"
            elif fd in _SPAWN_DOTTED:
                proc_ctl = f"subprocess spawn {fd}()"
            elif seg and _SPAWN_NAME_RE.match(seg):
                proc_ctl = f"subprocess spawn {seg}()"
            if proc_ctl:
                self.add(
                    "JT207", node,
                    f"{proc_ctl} while holding {held} — a fork/exec "
                    "or signal delivery stalls every thread "
                    "contending for the lock; decide under the lock, "
                    "release it, then spawn/signal",
                )

        # JT203: thread creation without a bounded-join seam
        if fd in ("threading.Thread", "Thread") and (
            not self.has_bounded_join
        ):
            self.add(
                "JT203", node,
                "Thread(...) created in a module with no bounded "
                "join (join(timeout=...)) anywhere — an unjoinable "
                "thread outlives every drain path",
                severity="warning",
            )

        self.generic_visit(node)


def check_concurrency(tree: ast.Module, rel: str) -> List[Finding]:
    return ConcurrencyChecker(tree, rel).run()
