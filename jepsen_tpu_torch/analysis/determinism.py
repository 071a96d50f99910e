"""planelint Family E, part 2 (JT503): durable-hash determinism.

The durable machinery keys everything on content hashes:
``checkpoint.steps_content_hash`` names checkpoints, ``streaming``'s
``_prefix_sha`` rows let a restarted checker trust its tail resume,
and ``service.check_id_for`` coalesces identical submissions across
tenants. Every one of those guarantees is exactly as strong as the
determinism of the hash inputs: one ``time.time()``, ``id()``,
``os.getpid()`` or unsorted-``set`` iteration in the funnel and
"same work" hashes differently per run/process — resume re-checks
from scratch, coalescing silently stops, and pod members disagree
about identity.

JT503 fires when a nondeterministic value reaches a hash funnel:

- value sources: ``time.time``/``monotonic``/``perf_counter`` (and
  ``_ns`` variants), ``os.getpid``, ``id()``, ``hash()`` (PYTHONHASHSEED),
  ``uuid1/uuid4``, ``os.urandom``/``secrets.*``, module-level
  ``random.*`` — including helpers that *return* one of these,
  through the call graph;
- order sources: iterating (or stringifying) a ``set``-typed value —
  ``sorted(...)`` launders this, which is the sanctioned spelling;
- funnels: ``steps_content_hash`` / ``_prefix_sha`` / ``_payload_sha``
  / ``check_id_for`` arguments, and ``.update()`` on a
  ``hashlib``-derived object (including updates issued inside a loop
  over a set, whose *order* is the nondeterminism).

Seeded ``random.Random(seed)`` instances are deliberately not
flagged: their streams are deterministic per seed, and the tree uses
them everywhere for reproducible histories.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set

from jepsen_tpu_torch.analysis.callgraph import (
    CallGraph,
    FunctionNode,
    _dotted,
    _last_seg,
)
from jepsen_tpu_torch.analysis.findings import Finding

RULE_NONDET_HASH_INPUT = "JT503"

#: content-hash funnels by final name segment
FUNNEL_TAILS = {
    "steps_content_hash", "_prefix_sha", "_payload_sha", "check_id_for",
}

_HASHLIB_CTORS = {
    "sha256", "sha1", "sha512", "md5", "blake2b", "blake2s", "new",
}
_TIME_TAILS = {
    "time", "time_ns", "monotonic", "monotonic_ns",
    "perf_counter", "perf_counter_ns",
}
_MISC_NONDET_TAILS = {
    "getpid", "uuid1", "uuid4", "urandom", "token_hex", "token_bytes",
}
#: builtins whose value depends on the process, not the content
_NONDET_BUILTINS = {"id", "hash"}
#: calls that pin iteration order (launder order-nondeterminism)
_ORDER_LAUNDER = {"sorted", "min", "max", "sum", "len"}


def nondet_call_desc(call: ast.Call) -> Optional[str]:
    """Description when this call produces a process/run-dependent
    value, else None."""
    fd = _dotted(call.func)
    seg = fd.rsplit(".", 1)[-1] if fd else _last_seg(call.func)
    if seg in _TIME_TAILS or seg in _MISC_NONDET_TAILS:
        return f"{fd or seg}()"
    if isinstance(call.func, ast.Name) and (
        call.func.id in _NONDET_BUILTINS
    ):
        return f"{call.func.id}()"
    if fd and fd.startswith("random."):
        return f"{fd}()"
    return None


def _nondet_returners(graph: CallGraph) -> Dict[str, str]:
    """node key -> source description, for every function that
    returns a nondeterministic value (directly or through a resolved
    callee) — the interprocedural half of JT503."""
    out: Dict[str, str] = {}
    changed = True
    while changed:
        changed = False
        for key in sorted(graph.nodes):
            if key in out:
                continue
            node = graph.nodes[key]
            if node.fn_ast is None or node.symbol == "<module>":
                continue
            desc = _returns_nondet(node, out)
            if desc is not None:
                out[key] = desc
                changed = True
    return out


def _returns_nondet(
    node: FunctionNode, returners: Dict[str, str]
) -> Optional[str]:
    for sub in ast.walk(node.fn_ast):
        if not isinstance(sub, ast.Return) or sub.value is None:
            continue
        for call in ast.walk(sub.value):
            if not isinstance(call, ast.Call):
                continue
            d = nondet_call_desc(call)
            if d is not None:
                return d
            r = node.call_resolutions.get(
                (call.lineno, call.col_offset)
            )
            if r in returners:
                return returners[r]
    return None


def check_determinism(
    graph: CallGraph, targets: Set[str]
) -> List[Finding]:
    findings: List[Finding] = []
    returners = _nondet_returners(graph)
    for nkey in sorted(graph.nodes):
        node = graph.nodes[nkey]
        if node.rel not in targets or node.fn_ast is None:
            continue
        if node.symbol == "<module>":
            continue
        scan = _FunctionScan(graph, node, returners)
        scan.run()
        findings.extend(scan.findings)
    findings.sort(key=lambda f: (f.file, f.line, f.col, f.rule))
    return findings


class _FunctionScan:
    """Statement-ordered taint walk of one function: nondet values,
    set-typed names, hashlib objects, and the funnel checks."""

    def __init__(self, graph: CallGraph, node: FunctionNode,
                 returners: Dict[str, str]):
        self.graph = graph
        self.node = node
        self.returners = returners
        self.findings: List[Finding] = []
        self.tainted: Dict[str, str] = {}  # name -> source desc
        self.unordered: Set[str] = set()  # set-typed names
        self.hash_objs: Set[str] = set()  # hashlib-derived names
        self.order_loops: List[str] = []  # active set-iteration loops

    def run(self) -> None:
        self._walk(self.node.fn_ast.body)

    # -- taint queries -------------------------------------------------

    def _taint(self, e: ast.expr, order_ok: bool = True
               ) -> Optional[str]:
        """Why the value of ``e`` is nondeterministic, or None."""
        if isinstance(e, ast.Call):
            d = nondet_call_desc(e)
            if d is not None:
                return d
            r = self.node.call_resolutions.get(
                (e.lineno, e.col_offset)
            )
            if r in self.returners:
                callee = _dotted(e.func) or "<call>"
                return f"{callee}() -> {self.returners[r]}"
            seg = _last_seg(e.func)
            launder = seg in _ORDER_LAUNDER
            children = list(e.args) + [k.value for k in e.keywords]
            if isinstance(e.func, ast.Attribute):
                # a method call's result derives from its receiver:
                # str(time.time()).encode() is as tainted as time.time()
                children.append(e.func.value)
            for child in children:
                d = self._taint(child, order_ok and not launder)
                if d is not None:
                    return d
            return None
        if isinstance(e, ast.Name):
            if e.id in self.tainted:
                return self.tainted[e.id]
            if order_ok and e.id in self.unordered:
                return f"iteration order of set {e.id!r}"
            return None
        if isinstance(e, (ast.FunctionDef, ast.Lambda)):
            return None
        for child in ast.iter_child_nodes(e):
            if isinstance(child, ast.expr):
                d = self._taint(child, order_ok)
                if d is not None:
                    return d
        return None

    def _is_set_expr(self, e: ast.expr) -> bool:
        if isinstance(e, (ast.Set, ast.SetComp)):
            return True
        if isinstance(e, ast.Call):
            return _last_seg(e.func) in ("set", "frozenset")
        return False

    def _is_hashlib_ctor(self, e: ast.expr) -> bool:
        if not isinstance(e, ast.Call):
            return False
        fd = _dotted(e.func)
        if not fd:
            return False
        head, _, tail = fd.rpartition(".")
        return tail in _HASHLIB_CTORS and (
            head == "hashlib" or head.endswith(".hashlib") or not head
        )

    # -- statement walk ------------------------------------------------

    def _walk(self, stmts: Sequence[ast.stmt]) -> None:
        for stmt in stmts:
            self._stmt(stmt)

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # separate node / separate scan
        if isinstance(stmt, ast.Assign):
            self._scan_calls(stmt.value)
            desc = self._taint(stmt.value)
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    self._bind(t.id, stmt.value, desc)
            return
        if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            self._scan_calls(stmt.value)
            desc = self._taint(stmt.value)
            if isinstance(stmt.target, ast.Name):
                self._bind(stmt.target.id, stmt.value, desc)
            return
        if isinstance(stmt, ast.AugAssign):
            self._scan_calls(stmt.value)
            desc = self._taint(stmt.value)
            if isinstance(stmt.target, ast.Name) and desc:
                self.tainted[stmt.target.id] = desc
            return
        if isinstance(stmt, ast.For):
            self._scan_calls(stmt.iter)
            iter_order = self._iter_order_desc(stmt.iter)
            iter_value = self._taint(stmt.iter, order_ok=False)
            if isinstance(stmt.target, ast.Name):
                if iter_value:
                    self.tainted[stmt.target.id] = iter_value
                else:
                    self.tainted.pop(stmt.target.id, None)
            if iter_order:
                self.order_loops.append(iter_order)
            self._walk(stmt.body)
            if iter_order:
                self.order_loops.pop()
            self._walk(stmt.orelse)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self._scan_calls(stmt.test)
            self._walk(stmt.body)
            self._walk(stmt.orelse)
            return
        if isinstance(stmt, ast.With):
            for item in stmt.items:
                self._scan_calls(item.context_expr)
            self._walk(stmt.body)
            return
        if isinstance(stmt, ast.Try):
            self._walk(stmt.body)
            for h in stmt.handlers:
                self._walk(h.body)
            self._walk(stmt.orelse)
            self._walk(stmt.finalbody)
            return
        for sub in ast.iter_child_nodes(stmt):
            if isinstance(sub, ast.expr):
                self._scan_calls(sub)

    def _bind(self, name: str, value: ast.expr,
              desc: Optional[str]) -> None:
        if desc:
            self.tainted[name] = desc
        else:
            self.tainted.pop(name, None)
        if self._is_set_expr(value):
            self.unordered.add(name)
        else:
            self.unordered.discard(name)
        if self._is_hashlib_ctor(value):
            self.hash_objs.add(name)
        else:
            self.hash_objs.discard(name)

    def _iter_order_desc(self, it: ast.expr) -> Optional[str]:
        """Set when iterating ``it`` visits elements in a
        process-dependent order (sorted() launders)."""
        if isinstance(it, ast.Name) and it.id in self.unordered:
            return f"iteration order of set {it.id!r}"
        if self._is_set_expr(it):
            return "iteration order of a set literal"
        return None

    # -- funnel checks -------------------------------------------------

    def _scan_calls(self, e: ast.expr) -> None:
        stack: List[ast.AST] = [e]
        while stack:
            n = stack.pop()
            if isinstance(n, ast.Lambda):
                continue
            if isinstance(n, ast.Call):
                self._check_funnel(n)
            stack.extend(ast.iter_child_nodes(n))

    def _check_funnel(self, call: ast.Call) -> None:
        fd = _dotted(call.func)
        seg = fd.rsplit(".", 1)[-1] if fd else _last_seg(call.func)
        is_update = (
            isinstance(call.func, ast.Attribute)
            and call.func.attr == "update"
            and isinstance(call.func.value, ast.Name)
            and call.func.value.id in self.hash_objs
        )
        if seg not in FUNNEL_TAILS and not is_update:
            return
        funnel = (
            f"{call.func.value.id}.update()" if is_update else f"{seg}()"
        )
        for arg in list(call.args) + [k.value for k in call.keywords]:
            desc = self._taint(arg)
            if desc is not None:
                self._report(call, funnel, desc)
                return
        if is_update and self.order_loops:
            self._report(call, funnel, self.order_loops[-1])

    def _report(self, call: ast.Call, funnel: str, desc: str) -> None:
        self.findings.append(
            Finding(
                rule=RULE_NONDET_HASH_INPUT,
                file=self.node.rel,
                line=call.lineno,
                col=call.col_offset,
                severity="error",
                message=(
                    f"nondeterministic value ({desc}) flows into "
                    f"content-hash funnel {funnel} — the durable "
                    "identity this hash anchors (resume, coalescing) "
                    "changes per run/process"
                ),
                symbol=self.node.symbol,
            )
        )
