"""planelint Family E, part 1 (JT501/JT502): SPMD collective safety.

A pod program is one program run by N processes; its collectives only
terminate when every member reaches the same collective in the same
order. Two spellings break that silently on localhost (where tier-1's
gloo pods are small and fast) and catastrophically at 50x:

- JT501 — a collective under process-divergent control flow (a branch
  tested on ``process_index()``/``dist.get_rank()``/``process_id``/
  ``os.getpid``/``host_of``), or inside a per-device loop. Member 0
  enters the all-gather, member 1 took the other arm: the pod wedges.
  ``is_multiprocess()``/``dist.is_initialized()``/
  ``dist.get_world_size()`` gates are deliberately NOT divergent —
  every member computes the same value, so ``if not
  is_multiprocess(): return arrs`` stays the sanctioned fast path.
- JT502 — both arms of a branch reach collectives, but in different
  orders. Even when every member takes SOME arm, members on different
  arms meet different barriers first and cross-match (gloo pairs them
  by sequence, not by name) — a hang or, worse, silently exchanged
  payloads.

Both rules are interprocedural: a call into a helper that reaches a
collective (per ``CallGraph.collective_witness``) counts as the
collective itself, with the witness path in the message.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Sequence, Set, Tuple

from jepsen_tpu_torch.analysis.callgraph import CallGraph, FunctionNode
from jepsen_tpu_torch.analysis.findings import Finding

RULE_DIVERGENT_COLLECTIVE = "JT501"
RULE_DIVERGENT_ORDER = "JT502"


def check_podrules(
    graph: CallGraph, targets: Set[str]
) -> List[Finding]:
    findings: List[Finding] = []
    coll = graph.collective_witness()
    for nkey in sorted(graph.nodes):
        node = graph.nodes[nkey]
        if node.rel not in targets:
            continue
        findings.extend(_check_divergent(graph, node, coll))
        findings.extend(_check_branch_order(graph, node))
    findings.sort(key=lambda f: (f.file, f.line, f.col, f.rule))
    return findings


def _context(ev) -> str:
    if ev.divergent:
        return "under process-divergent control flow"
    return "inside a per-device loop"


def _check_divergent(graph: CallGraph, node: FunctionNode,
                     coll) -> List[Finding]:
    findings: List[Finding] = []
    for ev in node.events:
        if not (ev.divergent or ev.device_loop):
            continue
        if ev.kind == "collective":
            findings.append(
                Finding(
                    rule=RULE_DIVERGENT_COLLECTIVE,
                    file=node.rel,
                    line=ev.line,
                    col=ev.col,
                    severity="error",
                    message=(
                        f"collective {ev.name}() {_context(ev)} — "
                        "pod members that branch differently never "
                        "meet in the barrier (SPMD divergence)"
                    ),
                    symbol=node.symbol,
                )
            )
        elif ev.kind == "call" and ev.resolved in coll:
            path = graph.witness_path(ev.resolved, coll)
            findings.append(
                Finding(
                    rule=RULE_DIVERGENT_COLLECTIVE,
                    file=node.rel,
                    line=ev.line,
                    col=ev.col,
                    severity="error",
                    message=(
                        f"collective reachable {_context(ev)} via "
                        f"{path} — hoist it above the divergent "
                        "branch or gate on a pod-uniform value"
                    ),
                    symbol=node.symbol,
                )
            )
    return findings


def _branch_sequence(
    graph: CallGraph, node: FunctionNode, stmts: Sequence[ast.stmt]
) -> Tuple[str, ...]:
    """The ordered collective tails this branch emits, inlining
    resolved helpers via ``ordered_collectives`` and skipping nested
    defs/lambdas (they run on someone else's schedule)."""
    out: List[str] = []
    stack: List[ast.AST] = list(reversed(list(stmts)))
    calls: List[ast.Call] = []
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            continue
        if isinstance(n, ast.Call):
            calls.append(n)
        stack.extend(reversed(list(ast.iter_child_nodes(n))))
    calls.sort(key=lambda c: (c.lineno, c.col_offset))
    for c in calls:
        pos = (c.lineno, c.col_offset)
        tail = node.collective_sites.get(pos)
        if tail is not None:
            out.append(tail)
            continue
        resolved = node.call_resolutions.get(pos)
        if resolved:
            out.extend(graph.ordered_collectives(resolved))
    return tuple(out[:16])


def _check_branch_order(
    graph: CallGraph, node: FunctionNode
) -> List[Finding]:
    if node.fn_ast is None or node.symbol == "<module>":
        return []
    findings: List[Finding] = []
    stack: List[ast.AST] = list(node.fn_ast.body) \
        if hasattr(node.fn_ast, "body") else []
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            continue
        if isinstance(n, ast.If) and n.orelse:
            seq_then = _branch_sequence(graph, node, n.body)
            seq_else = _branch_sequence(graph, node, n.orelse)
            if seq_then and seq_else and seq_then != seq_else:
                findings.append(
                    Finding(
                        rule=RULE_DIVERGENT_ORDER,
                        file=node.rel,
                        line=n.lineno,
                        col=n.col_offset,
                        severity="error",
                        message=(
                            "branch arms reach collectives in "
                            f"different orders ({', '.join(seq_then)}"
                            f" vs {', '.join(seq_else)}) — members "
                            "on different arms cross-match barriers"
                        ),
                        symbol=node.symbol,
                    )
                )
        stack.extend(ast.iter_child_nodes(n))
    return findings
