"""planelint Family D (JT4xx): whole-program lock discipline.

Family B pins what a function does *while lexically inside* a ``with
lock:`` block. Family D answers the questions that killed real systems
in the lockdep literature and that the pod plane makes urgent
here:

- JT401 — do two plane locks ever nest in opposite orders anywhere in
  the package (the classic ABBA deadlock)? The lock-order graph has an
  edge A->B for every site that acquires B while holding A, directly
  or through any resolved call chain; a cycle means two threads can
  each hold one lock and wait forever on the other.
- JT402 — is a pod collective (``global_view``'s all-gather, the
  ``init_pod``/``init_process_group`` handshake, ``new_group``,
  ``all_reduce``, ``launch_pod``) reachable while ANY plane lock is
  held? Collectives are barriers: a member that blocks on a contended lock while its
  peers sit in the barrier wedges the whole pod, and the stragglers
  can't even time out cleanly.
- JT403 — is a blocking call (``.join()``/``.result()``/socket ops/
  ``time.sleep``) reachable under a lock *through a call chain*? The
  direct case is Family B's JT202; JT403 is its interprocedural
  upgrade and fires only with at least one call hop, so the two rules
  partition the hazard instead of double-reporting it.

All three ride the CallGraph summaries; lock identity is module-
qualified (see ``CallGraph.lock_id``) so the several same-named
``_stats_lock``s across planes can never weave a false cycle.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from jepsen_tpu_torch.analysis.callgraph import CallGraph, lock_display
from jepsen_tpu_torch.analysis.findings import Finding

RULE_LOCK_CYCLE = "JT401"
RULE_COLLECTIVE_UNDER_LOCK = "JT402"
RULE_BLOCKING_REACHABLE_UNDER_LOCK = "JT403"


def _edge_sites(
    graph: CallGraph,
) -> Dict[Tuple[str, str], Tuple[str, str, int, str]]:
    """Lock-order edges (held, acquired) -> the first witness site
    (rel, symbol, line, via-description). Self-edges are excluded:
    re-entry is RLock territory and ABBA needs two locks."""
    tlocks = graph.transitive_locks()
    sites: Dict[Tuple[str, str], Tuple[str, str, int, str]] = {}

    def note(src: str, dst: str, rel: str, sym: str, line: int,
             via: str) -> None:
        if src == dst:
            return
        key = (src, dst)
        cand = (rel, sym, line, via)
        if key not in sites or (cand[0], cand[2]) < (
            sites[key][0], sites[key][2]
        ):
            sites[key] = cand

    for nkey in sorted(graph.nodes):
        node = graph.nodes[nkey]
        for ev in node.events:
            if ev.kind == "acquire":
                for held in ev.held:
                    note(held, ev.name, node.rel, node.symbol,
                         ev.line, "direct")
            elif ev.kind == "call" and ev.resolved and ev.held:
                callee_sym = (
                    graph.nodes[ev.resolved].symbol
                    if ev.resolved in graph.nodes else ev.name
                )
                for acquired in sorted(
                    tlocks.get(ev.resolved, ())
                ):
                    for held in ev.held:
                        note(held, acquired, node.rel, node.symbol,
                             ev.line, f"via {callee_sym}()")
    return sites


def _sccs(adj: Dict[str, Set[str]]) -> List[List[str]]:
    """Iterative Tarjan; returns SCCs with >= 2 members."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]

    for root in sorted(adj):
        if root in index:
            continue
        work: List[Tuple[str, int]] = [(root, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                index[v] = low[v] = counter[0]
                counter[0] += 1
                stack.append(v)
                on_stack.add(v)
            advanced = False
            succs = sorted(adj.get(v, ()))
            for i in range(pi, len(succs)):
                w = succs[i]
                if w not in index:
                    work[-1] = (v, i + 1)
                    work.append((w, 0))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[v])
            if low[v] == index[v]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == v:
                        break
                if len(scc) >= 2:
                    out.append(sorted(scc))
    return out


def check_lockorder(
    graph: CallGraph, targets: Set[str]
) -> List[Finding]:
    """Run JT401/402/403 over the graph; findings anchor only in
    ``targets`` (the Family D file set, intersected with any
    --changed-only scope)."""
    findings: List[Finding] = []
    findings.extend(_check_cycles(graph, targets))
    findings.extend(_check_reachable(graph, targets))
    findings.sort(key=lambda f: (f.file, f.line, f.col, f.rule))
    return findings


def _check_cycles(graph: CallGraph, targets: Set[str]) -> List[Finding]:
    sites = _edge_sites(graph)
    adj: Dict[str, Set[str]] = {}
    for (src, dst) in sites:
        adj.setdefault(src, set()).add(dst)
        adj.setdefault(dst, set())
    findings: List[Finding] = []
    for scc in _sccs(adj):
        members = set(scc)
        internal = sorted(
            (
                (site[0], site[2], edge, site)
                for edge, site in sites.items()
                if edge[0] in members and edge[1] in members
            ),
        )
        anchored = [e for e in internal if e[0] in targets]
        if not anchored:
            continue  # cycle lives entirely outside the linted scope
        rel, line, _edge, site = anchored[0]
        order = " -> ".join(lock_display(l) for l in scc)
        edges_text = "; ".join(
            f"{lock_display(e[0])}->{lock_display(e[1])} at "
            f"{s[0]}:{s[2]} ({s[3]})"
            for _r, _l, e, s in internal
        )
        findings.append(
            Finding(
                rule=RULE_LOCK_CYCLE,
                file=rel,
                line=line,
                col=0,
                severity="error",
                message=(
                    f"lock-order cycle ({order}): these locks nest in "
                    f"conflicting orders — ABBA deadlock. Edges: "
                    f"{edges_text}"
                ),
                symbol=site[1],
            )
        )
    return findings


def _check_reachable(
    graph: CallGraph, targets: Set[str]
) -> List[Finding]:
    coll = graph.collective_witness()
    block = graph.blocking_witness()
    findings: List[Finding] = []
    for nkey in sorted(graph.nodes):
        node = graph.nodes[nkey]
        if node.rel not in targets:
            continue
        for ev in node.events:
            if not ev.held:
                continue
            held = ", ".join(lock_display(h) for h in ev.held)
            if ev.kind == "collective":
                findings.append(
                    Finding(
                        rule=RULE_COLLECTIVE_UNDER_LOCK,
                        file=node.rel,
                        line=ev.line,
                        col=ev.col,
                        severity="error",
                        message=(
                            f"collective {ev.name}() issued while "
                            f"holding {held} — a pod member blocked "
                            "on this lock strands every peer in the "
                            "barrier (whole-pod wedge)"
                        ),
                        symbol=node.symbol,
                    )
                )
            elif ev.kind == "call" and ev.resolved:
                if ev.resolved in coll:
                    path = graph.witness_path(ev.resolved, coll)
                    findings.append(
                        Finding(
                            rule=RULE_COLLECTIVE_UNDER_LOCK,
                            file=node.rel,
                            line=ev.line,
                            col=ev.col,
                            severity="error",
                            message=(
                                f"collective reachable under {held} "
                                f"via {path} — release every plane "
                                "lock before entering a pod barrier"
                            ),
                            symbol=node.symbol,
                        )
                    )
                if ev.resolved in block:
                    path = graph.witness_path(ev.resolved, block)
                    findings.append(
                        Finding(
                            rule=RULE_BLOCKING_REACHABLE_UNDER_LOCK,
                            file=node.rel,
                            line=ev.line,
                            col=ev.col,
                            severity="error",
                            message=(
                                f"blocking call reachable under "
                                f"{held} via {path} — plane locks "
                                "are for bookkeeping, never held "
                                "across a wait (interprocedural "
                                "JT202)"
                            ),
                            symbol=node.symbol,
                        )
                    )
    return findings
