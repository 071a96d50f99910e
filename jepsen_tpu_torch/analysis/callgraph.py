"""planelint interprocedural core: the package-wide call graph (a copy
of jepsen_tpu.analysis.callgraph, its tables grown to torch.distributed).

Families A-C are intra-procedural; the hazards the pod plane and the
durable machinery introduce are not. A collective that is
safe where it is written becomes a whole-pod deadlock when a caller
two frames up still holds a plane lock, and a content hash that looks
deterministic locally breaks resume when one of its inputs is computed
by a helper that reads the clock. Both are *reachability* properties —
this module is the shared core that makes them checkable at review
time.

``CallGraph.from_trees`` parses nothing itself: it takes the
``{package-relative path: ast.Module}`` map the engine already built
and produces one ``FunctionNode`` per function/method/nested def (plus
a ``<module>`` node per file) carrying a statement-ordered event list:

- ``acquire``  — a ``with <...lock...>:`` entry, with the lock ids
  already held (lock identity is module-qualified, so
  ``dispatch.py::_stats_lock`` and ``chaos.py::_stats_lock`` never
  alias);
- ``call``     — any call, with the callee resolved through the
  module's imports (``from X import f`` / ``import X as x`` /
  ``self.method`` / same-module defs — unresolvable callees stay
  opaque, which under-approximates: a linter must not invent edges);
- ``collective`` — a pod/mesh collective entry point (``global_view``,
  ``init_pod``, ``launch_pod``, and the ``torch.distributed``
  collectives and group constructors: ``all_gather``,
  ``all_gather_object``, ``all_reduce``, ``broadcast``, ``barrier``,
  ``new_group``, ``init_process_group``);
- ``blocking`` — the Family B blocking set (``.join()``/``.result()``/
  socket ops/``time.sleep``).

Each event also records whether it sits under process-divergent
control flow (``process_index()``/``dist.get_rank()``/``process_id``/
``os.getpid`` tests — ``is_multiprocess()``, ``dist.is_initialized()``
and ``dist.get_world_size()`` are deliberately NOT divergent: every
pod member agrees on them) and whether it sits inside a per-device
loop.

On top of the events the graph computes fixpoint summaries —
``transitive_locks``, ``collective_witness``, ``blocking_witness``,
``ordered_collectives`` — that lockorder.py (Family D) and
podrules.py/determinism.py (Family E) consume, and exposes
``reachable_closure``, the generalization of hotpath.py's traced-code
fixpoint (which now rides this function).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

PACKAGE_NAME = "jepsen_tpu_torch"

#: pod/mesh collective entry points, by final name segment. Any of
#: these reachable under a held plane lock (JT402) or under process-
#: divergent control flow (JT501) can wedge the whole pod: collectives
#: are barriers, and a member that never arrives strands the rest.
COLLECTIVE_TAILS = {
    "global_view", "init_pod", "launch_pod",
    "psum", "pmean", "pmax", "pmin",
    "all_gather", "all_to_all", "ppermute",
    # torch.distributed: collectives, and the constructors every rank
    # must enter together (init_process_group's rendezvous, new_group)
    "all_reduce", "all_gather_object", "broadcast", "barrier",
    "monitored_barrier", "new_group", "init_process_group",
}

#: attribute calls that block (or can block) the calling thread —
#: THE Family B set (concurrency.py imports these back, one source of
#: truth for JT202 and the interprocedural JT403). ``wait`` is
#: excluded on purpose: Condition.wait RELEASES the lock it rides.
#: ``communicate`` waits for a child process (the kernel build's nvcc).
BLOCKING_ATTRS = {
    "join", "result", "recv", "recv_into", "send", "sendall",
    "accept", "connect", "communicate",
}
#: dotted calls that block
BLOCKING_DOTTED_TAILS = {"sleep"}  # time.sleep / _time.sleep

#: markers of process-divergent values: expressions over these differ
#: between pod members, so a branch tested on them splits the pod's
#: control flow (JT501). ``is_multiprocess``/``process_count`` and
#: torch.distributed's ``is_initialized``/``get_world_size`` are NOT
#: here — every member agrees on them, so gating a collective on them
#: is the sanctioned spelling.
DIVERGENT_TAILS = {
    "process_index", "process_id", "getpid", "gethostname", "host_of",
    "get_rank",
}
DIVERGENT_NAMES = {"process_index", "process_id", "rank"}

#: per-device loop iterables (a collective issued once per device is
#: n_devices barriers where the program needs one)
DEVICE_ITER_TAILS = {"devices", "local_devices"}


def _dotted(node: ast.AST) -> Optional[str]:
    """'torch.cuda.synchronize'-style dotted path for Name/Attribute
    chains."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _last_seg(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def reachable_closure(
    defs_by_name: Dict[str, List[ast.FunctionDef]],
    seeds: Set[str],
    exempt: frozenset = frozenset(),
) -> Set[str]:
    """Fixpoint closure of function names reachable (by bare callee
    name) from ``seeds`` through the given defs. This is the
    generalization of hotpath.ModuleInfo's traced-code walk — Family
    A's compile-reachability and Family C's traced-emission checks both
    ride it now, and the whole-program graph applies the same idea
    with import-aware resolution."""
    reached = set(seeds)
    frontier = list(seeds)
    while frontier:
        name = frontier.pop()
        for fn in defs_by_name.get(name, []):
            for sub in ast.walk(fn):
                if not isinstance(sub, ast.Call):
                    continue
                callee = _last_seg(sub.func)
                if (
                    callee
                    and callee in defs_by_name
                    and callee not in reached
                    and callee not in exempt
                ):
                    reached.add(callee)
                    frontier.append(callee)
    return reached


def collective_tail(call: ast.Call) -> Optional[str]:
    """The collective's display name when this call IS a collective
    entry point, else None."""
    fd = _dotted(call.func)
    seg = fd.rsplit(".", 1)[-1] if fd else _last_seg(call.func)
    if seg in COLLECTIVE_TAILS:
        return seg
    return None


def is_str_join(call: ast.Call) -> bool:
    """``"sep".join(...)``: a string join, never a thread's."""
    f = call.func
    return (
        isinstance(f, ast.Attribute) and f.attr == "join"
        and isinstance(f.value, ast.Constant)
        and isinstance(f.value.value, str)
    )


def blocking_desc(call: ast.Call) -> Optional[str]:
    """A display string when this call is in the blocking set."""
    if isinstance(call.func, ast.Attribute) and (
        call.func.attr in BLOCKING_ATTRS
    ) and not is_str_join(call):
        return f".{call.func.attr}()"
    fd = _dotted(call.func)
    if fd is not None and "." in fd and (
        fd.rsplit(".", 1)[-1] in BLOCKING_DOTTED_TAILS
    ):
        return f"{fd}()"
    return None


def is_divergent_expr(node: ast.expr) -> bool:
    """Does this (test) expression read a process-divergent value?"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            fd = _dotted(sub.func)
            seg = fd.rsplit(".", 1)[-1] if fd else _last_seg(sub.func)
            if seg in DIVERGENT_TAILS:
                return True
        elif isinstance(sub, ast.Attribute):
            if sub.attr in DIVERGENT_TAILS or sub.attr in DIVERGENT_NAMES:
                return True
        elif isinstance(sub, ast.Name):
            if sub.id in DIVERGENT_NAMES:
                return True
    return False


def is_device_iter(node: ast.expr) -> bool:
    """Does this For-iterable range over devices?"""
    if isinstance(node, ast.Call):
        seg = _last_seg(node.func)
        if seg in DEVICE_ITER_TAILS:
            return True
        node = node.func
    seg = _last_seg(node)
    return bool(seg) and seg.rstrip("s") in (
        t.rstrip("s") for t in DEVICE_ITER_TAILS
    )


def _is_lock_expr(node: ast.expr) -> bool:
    seg = _last_seg(node)
    return bool(seg) and "lock" in seg.lower()


def rel_to_module(rel: str) -> str:
    """'checker/dispatch.py' -> 'jepsen_tpu_torch.checker.dispatch'."""
    mod = rel[:-3] if rel.endswith(".py") else rel
    mod = mod.replace("/", ".")
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    return f"{PACKAGE_NAME}.{mod}" if mod else PACKAGE_NAME


@dataclasses.dataclass(frozen=True)
class Event:
    """One interesting site inside a function body, in statement
    order, with its full context."""

    kind: str  # "acquire" | "call" | "collective" | "blocking"
    name: str  # lock id / callee dotted / collective tail / blocking
    line: int
    col: int
    held: Tuple[str, ...]  # lock ids held at this point
    divergent: bool  # under process-divergent control flow
    device_loop: bool  # inside a per-device loop
    resolved: Optional[str] = None  # node key for resolved calls


class FunctionNode:
    """One function/method/nested def (or module body) in the graph."""

    def __init__(self, rel: str, symbol: str,
                 fn_ast: Optional[ast.AST] = None):
        self.rel = rel
        self.symbol = symbol
        self.key = f"{rel}::{symbol}"
        self.fn_ast = fn_ast
        self.events: List[Event] = []
        #: (line, col) -> resolved key / collective tail, for walkers
        #: (podrules' branch-order scan) that re-visit the AST
        self.call_resolutions: Dict[Tuple[int, int], Optional[str]] = {}
        self.collective_sites: Dict[Tuple[int, int], str] = {}


class _ModuleIndex:
    """Per-module symbol/import tables the resolver consults."""

    def __init__(self, rel: str, tree: ast.Module,
                 known_rels: Set[str]):
        self.rel = rel
        #: top-level function name -> symbol
        self.toplevel: Dict[str, str] = {}
        #: (class, method) -> symbol
        self.methods: Dict[Tuple[str, str], str] = {}
        #: import alias -> target module rel
        self.mod_aliases: Dict[str, str] = {}
        #: from-imported name -> (target module rel, name there)
        self.from_names: Dict[str, Tuple[str, str]] = {}
        #: module-level names assigned from threading.RLock()
        self.rlocks: Set[str] = set()

        mod_by_dotted = {rel_to_module(r): r for r in known_rels}
        for node in tree.body:
            if isinstance(node, ast.FunctionDef):
                self.toplevel[node.name] = node.name
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, ast.FunctionDef):
                        self.methods[(node.name, sub.name)] = (
                            f"{node.name}.{sub.name}"
                        )
            elif isinstance(node, ast.Import):
                for a in node.names:
                    tgt = mod_by_dotted.get(a.name)
                    if tgt:
                        self.mod_aliases[a.asname or a.name] = tgt
            elif isinstance(node, ast.ImportFrom):
                if not node.module or node.level:
                    continue
                for a in node.names:
                    sub_mod = mod_by_dotted.get(
                        f"{node.module}.{a.name}"
                    )
                    if sub_mod:
                        self.mod_aliases[a.asname or a.name] = sub_mod
                    else:
                        base = mod_by_dotted.get(node.module)
                        if base:
                            self.from_names[a.asname or a.name] = (
                                base, a.name
                            )
            elif isinstance(node, ast.Assign):
                if isinstance(node.value, ast.Call) and (
                    _last_seg(node.value.func) == "RLock"
                ):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            self.rlocks.add(t.id)


class CallGraph:
    """The whole-program graph Families D/E run on."""

    def __init__(self) -> None:
        self.nodes: Dict[str, FunctionNode] = {}
        self.trees: Dict[str, ast.Module] = {}
        self._index: Dict[str, _ModuleIndex] = {}
        self._tlocks: Optional[Dict[str, Set[str]]] = None
        self._coll_wit: Optional[dict] = None
        self._block_wit: Optional[dict] = None
        self._ordered_cache: Dict[str, Tuple[str, ...]] = {}

    # -- construction --------------------------------------------------

    @classmethod
    def from_trees(cls, trees: Dict[str, ast.Module]) -> "CallGraph":
        g = cls()
        g.trees = dict(trees)
        known = set(trees)
        for rel in sorted(trees):
            g._index[rel] = _ModuleIndex(rel, trees[rel], known)
        for rel in sorted(trees):
            _Collector(g, rel).run(trees[rel])
        return g

    # -- resolution ----------------------------------------------------

    def resolve(
        self,
        rel: str,
        dotted: Optional[str],
        enclosing_class: Optional[str],
        local_defs: Dict[str, str],
    ) -> Optional[str]:
        """Resolve a callee's dotted spelling to a node key, or None
        for opaque callees (stdlib, torch, attribute chains we cannot
        follow). Under-approximates by design."""
        if not dotted:
            return None
        idx = self._index[rel]
        if "." not in dotted:
            if dotted in local_defs:
                return f"{rel}::{local_defs[dotted]}"
            if dotted in idx.toplevel:
                return f"{rel}::{idx.toplevel[dotted]}"
            if dotted in idx.from_names:
                trel, tname = idx.from_names[dotted]
                tidx = self._index.get(trel)
                if tidx and tname in tidx.toplevel:
                    return f"{trel}::{tname}"
            return None
        base, tail = dotted.rsplit(".", 1)
        if base in ("self", "cls") and enclosing_class:
            sym = idx.methods.get((enclosing_class, tail))
            if sym:
                return f"{rel}::{sym}"
            return None
        if base in idx.mod_aliases:
            trel = idx.mod_aliases[base]
            tidx = self._index.get(trel)
            if tidx and tail in tidx.toplevel:
                return f"{trel}::{tail}"
        return None

    def lock_id(
        self,
        rel: str,
        expr: ast.expr,
        enclosing_class: Optional[str],
    ) -> str:
        """Module-qualified lock identity: '<rel>::<name>' for module
        locks, '<rel>::<Class>.<name>' for instance locks, and the
        defining module's id for locks reached through an import
        alias — so same-named locks in different planes never alias
        into a false cycle."""
        dotted = _dotted(expr) or "<lock>"
        if "." not in dotted:
            return f"{rel}::{dotted}"
        base, tail = dotted.rsplit(".", 1)
        if base in ("self", "cls") and enclosing_class:
            return f"{rel}::{enclosing_class}.{tail}"
        idx = self._index[rel]
        if base in idx.mod_aliases:
            return f"{idx.mod_aliases[base]}::{tail}"
        return f"{rel}::{dotted}"

    def is_rlock(self, lock_id: str) -> bool:
        rel, _, name = lock_id.partition("::")
        idx = self._index.get(rel)
        return bool(idx) and name in idx.rlocks

    # -- fixpoint summaries --------------------------------------------

    def transitive_locks(self) -> Dict[str, Set[str]]:
        """node key -> every lock id it (or anything it calls,
        transitively) acquires."""
        if self._tlocks is not None:
            return self._tlocks
        out: Dict[str, Set[str]] = {
            k: {e.name for e in n.events if e.kind == "acquire"}
            for k, n in self.nodes.items()
        }
        changed = True
        while changed:
            changed = False
            for k in sorted(self.nodes):
                for ev in self.nodes[k].events:
                    if ev.kind != "call" or not ev.resolved:
                        continue
                    extra = out.get(ev.resolved, set()) - out[k]
                    if extra:
                        out[k] |= extra
                        changed = True
        self._tlocks = out
        return out

    def _witness_fixpoint(self, direct):
        """node key -> (label, line, via-key-or-None) for the first
        reachable site ``direct`` recognizes; via-links chain to a
        concrete witness path."""
        wit: Dict[str, Tuple[str, int, Optional[str]]] = {}
        for k in sorted(self.nodes):
            d = direct(self.nodes[k])
            if d is not None:
                wit[k] = (d[0], d[1], None)
        changed = True
        while changed:
            changed = False
            for k in sorted(self.nodes):
                if k in wit:
                    continue
                for ev in self.nodes[k].events:
                    if ev.kind == "call" and ev.resolved in wit:
                        wit[k] = (ev.name, ev.line, ev.resolved)
                        changed = True
                        break
        return wit

    def collective_witness(self):
        if self._coll_wit is None:
            self._coll_wit = self._witness_fixpoint(
                lambda n: next(
                    (
                        (e.name, e.line)
                        for e in n.events
                        if e.kind == "collective"
                    ),
                    None,
                )
            )
        return self._coll_wit

    def blocking_witness(self):
        if self._block_wit is None:
            self._block_wit = self._witness_fixpoint(
                lambda n: next(
                    (
                        (e.name, e.line)
                        for e in n.events
                        if e.kind == "blocking"
                    ),
                    None,
                )
            )
        return self._block_wit

    def witness_path(self, key: str, witness: dict,
                     max_hops: int = 6) -> str:
        """'f -> g -> global_view' from the via-links in ``witness``."""
        parts: List[str] = []
        cur: Optional[str] = key
        for _ in range(max_hops):
            if cur is None or cur not in witness:
                break
            label, _line, via = witness[cur]
            if via is None:
                parts.append(label)
                break
            parts.append(self.nodes[via].symbol
                         if via in self.nodes else label)
            cur = via
        return " -> ".join(parts) if parts else "?"

    def ordered_collectives(self, key: str) -> Tuple[str, ...]:
        """The statement-ordered collective tails ``key`` emits,
        inlined through resolved calls (cycle-guarded, capped) — the
        JT502 branch-order signature."""
        return self._ordered(key, set())

    def _ordered(self, key: str, visiting: Set[str]) -> Tuple[str, ...]:
        if key in self._ordered_cache:
            return self._ordered_cache[key]
        if key in visiting or key not in self.nodes:
            return ()
        visiting.add(key)
        out: List[str] = []
        for ev in self.nodes[key].events:
            if ev.kind == "collective":
                out.append(ev.name)
            elif ev.kind == "call" and ev.resolved:
                out.extend(self._ordered(ev.resolved, visiting))
            if len(out) >= 16:
                break
        visiting.discard(key)
        self._ordered_cache[key] = tuple(out[:16])
        return self._ordered_cache[key]


def lock_display(lock_id: str) -> str:
    """'checker/dispatch.py::_stats_lock' -> 'dispatch.py::_stats_lock'
    — short but still unambiguous in a finding message."""
    rel, _, name = lock_id.partition("::")
    return f"{rel.rsplit('/', 1)[-1]}::{name}"


class _Collector:
    """Statement-ordered walk of one module producing FunctionNodes
    with their event lists."""

    def __init__(self, graph: CallGraph, rel: str):
        self.g = graph
        self.rel = rel

    def run(self, tree: ast.Module) -> None:
        module_node = FunctionNode(self.rel, "<module>", tree)
        self.g.nodes[module_node.key] = module_node
        self._walk_body(
            tree.body, module_node, held=(), div=0, devloop=0,
            enclosing_class=None, local_defs={},
        )

    # -- function registration -----------------------------------------

    def _def_node(self, fn: ast.AST, symbol: str,
                  enclosing_class: Optional[str],
                  local_defs: Dict[str, str]) -> None:
        node = FunctionNode(self.rel, symbol, fn)
        self.g.nodes[node.key] = node
        inner_defs = dict(local_defs)
        for stmt in fn.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                inner_defs[stmt.name] = f"{symbol}.{stmt.name}"
        # a def body runs later, on its caller's schedule: lock /
        # divergence context does NOT flow in
        self._walk_body(
            fn.body, node, held=(), div=0, devloop=0,
            enclosing_class=enclosing_class, local_defs=inner_defs,
        )

    # -- statements ----------------------------------------------------

    def _walk_body(self, stmts: Sequence[ast.stmt], node: FunctionNode,
                   held: Tuple[str, ...], div: int, devloop: int,
                   enclosing_class: Optional[str],
                   local_defs: Dict[str, str]) -> None:
        for stmt in stmts:
            self._stmt(stmt, node, held, div, devloop,
                       enclosing_class, local_defs)

    def _stmt(self, stmt: ast.stmt, node: FunctionNode,
              held: Tuple[str, ...], div: int, devloop: int,
              enclosing_class: Optional[str],
              local_defs: Dict[str, str]) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            symbol = (
                f"{node.symbol}.{stmt.name}"
                if node.symbol != "<module>"
                else (
                    f"{enclosing_class}.{stmt.name}"
                    if enclosing_class
                    else stmt.name
                )
            )
            ldefs = dict(local_defs)
            ldefs[stmt.name] = symbol
            local_defs[stmt.name] = symbol
            self._def_node(stmt, symbol, enclosing_class, ldefs)
            return
        if isinstance(stmt, ast.ClassDef) and node.symbol == "<module>":
            for sub in stmt.body:
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    self._def_node(
                        sub, f"{stmt.name}.{sub.name}", stmt.name, {}
                    )
            return
        if isinstance(stmt, ast.With):
            acquired: List[str] = []
            for item in stmt.items:
                if _is_lock_expr(item.context_expr):
                    lid = self.g.lock_id(
                        self.rel, item.context_expr, enclosing_class
                    )
                    node.events.append(Event(
                        "acquire", lid,
                        item.context_expr.lineno,
                        item.context_expr.col_offset,
                        held + tuple(acquired),
                        div > 0, devloop > 0,
                    ))
                    acquired.append(lid)
                else:
                    self._expr(item.context_expr, node, held, div,
                               devloop, enclosing_class, local_defs)
            self._walk_body(
                stmt.body, node, held + tuple(acquired), div, devloop,
                enclosing_class, local_defs,
            )
            return
        if isinstance(stmt, (ast.If, ast.While)):
            branch_div = is_divergent_expr(stmt.test)
            self._expr(stmt.test, node, held, div, devloop,
                       enclosing_class, local_defs)
            inner = div + (1 if branch_div else 0)
            self._walk_body(stmt.body, node, held, inner, devloop,
                            enclosing_class, local_defs)
            self._walk_body(stmt.orelse, node, held, inner, devloop,
                            enclosing_class, local_defs)
            return
        if isinstance(stmt, ast.For):
            dev = is_device_iter(stmt.iter)
            self._expr(stmt.iter, node, held, div, devloop,
                       enclosing_class, local_defs)
            inner = devloop + (1 if dev else 0)
            self._walk_body(stmt.body, node, held, div, inner,
                            enclosing_class, local_defs)
            self._walk_body(stmt.orelse, node, held, div, devloop,
                            enclosing_class, local_defs)
            return
        if isinstance(stmt, ast.Try):
            self._walk_body(stmt.body, node, held, div, devloop,
                            enclosing_class, local_defs)
            for h in stmt.handlers:
                self._walk_body(h.body, node, held, div, devloop,
                                enclosing_class, local_defs)
            self._walk_body(stmt.orelse, node, held, div, devloop,
                            enclosing_class, local_defs)
            self._walk_body(stmt.finalbody, node, held, div, devloop,
                            enclosing_class, local_defs)
            return
        # every remaining statement kind: scan its expressions
        for sub in ast.iter_child_nodes(stmt):
            if isinstance(sub, ast.expr):
                self._expr(sub, node, held, div, devloop,
                           enclosing_class, local_defs)

    # -- expressions ---------------------------------------------------

    def _expr(self, node_expr: ast.expr, node: FunctionNode,
              held: Tuple[str, ...], div: int, devloop: int,
              enclosing_class: Optional[str],
              local_defs: Dict[str, str]) -> None:
        for sub in self._calls_in(node_expr):
            self._record_call(sub, node, held, div, devloop,
                              enclosing_class, local_defs)

    def _calls_in(self, expr: ast.expr) -> List[ast.Call]:
        """Call nodes in ``expr`` in source order, NOT descending into
        lambda bodies (they run later, without this context)."""
        out: List[ast.Call] = []
        stack: List[ast.AST] = [expr]
        while stack:
            n = stack.pop()
            if isinstance(n, ast.Lambda):
                continue
            if isinstance(n, ast.Call):
                out.append(n)
            stack.extend(reversed(list(ast.iter_child_nodes(n))))
        out.sort(key=lambda c: (c.lineno, c.col_offset))
        return out

    def _record_call(self, call: ast.Call, node: FunctionNode,
                     held: Tuple[str, ...], div: int, devloop: int,
                     enclosing_class: Optional[str],
                     local_defs: Dict[str, str]) -> None:
        pos = (call.lineno, call.col_offset)
        ctx = dict(held=held, divergent=div > 0, device_loop=devloop > 0)
        tail = collective_tail(call)
        if tail is not None:
            node.collective_sites[pos] = tail
            node.events.append(Event(
                "collective", tail, call.lineno, call.col_offset, **ctx
            ))
            return
        bdesc = blocking_desc(call)
        if bdesc is not None:
            node.events.append(Event(
                "blocking", bdesc, call.lineno, call.col_offset, **ctx
            ))
            return
        dotted = _dotted(call.func)
        resolved = self.g.resolve(
            self.rel, dotted, enclosing_class, local_defs
        )
        node.call_resolutions[pos] = resolved
        node.events.append(Event(
            "call", dotted or "<dynamic>", call.lineno,
            call.col_offset, resolved=resolved, **ctx
        ))
