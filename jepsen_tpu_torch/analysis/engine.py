"""planelint engine: rule catalog, file-set configuration, runner (a
copy of jepsen_tpu.analysis.engine, pointed at the port's tree).

Five rule families over per-family file sets:

- Family A (JT1xx, ``hotpath``) runs over the device hot-path
  modules — the files where an implicit host sync or an unaccounted
  launch silently adds a device->host wait per check that
  ``LAUNCH_STATS["host_syncs"]`` never counts.
- Family B (JT2xx, ``concurrency``) runs over every threaded layer —
  dispatch plane, kernel build, service daemon, chaos — where a stats
  write outside its lock or a blocking call under one breaks the
  accounting/fairness contracts the tier-1 suite pins.
- Family C (JT3xx, ``obsrules``) runs over the flight-recorder-
  instrumented tree — spans close via context manager, nothing
  emits under a plane lock, and no obs call is reachable from
  compile-traced code.
- Family D (JT4xx, ``lockorder``) is whole-program: the lock-order
  graph over every plane lock (ABBA cycles), plus collectives and
  blocking calls reachable under a lock through any call chain.
- Family E (JT5xx, ``podrules`` + ``determinism``) is whole-program:
  collectives under process-divergent control flow or with divergent
  ordering, and nondeterministic values flowing into the durable
  content-hash funnels.

Families A-C are per-file; D/E ride the package-wide ``CallGraph``
built once per run (``callgraph.py``, the shared interprocedural
core). ``run_lint`` walks the package, applies inline suppressions,
and returns findings; the CLI layers the baseline on top.
"""

from __future__ import annotations

import ast
import fnmatch
import os
import subprocess
from typing import Dict, List, Optional, Sequence, Set, Tuple

from jepsen_tpu_torch.analysis.callgraph import CallGraph
from jepsen_tpu_torch.analysis.concurrency import check_concurrency
from jepsen_tpu_torch.analysis.determinism import check_determinism
from jepsen_tpu_torch.analysis.findings import (
    Finding,
    apply_suppressions,
    bare_suppression_findings,
    parse_suppressions,
    scan_suppression_entries,
)
from jepsen_tpu_torch.analysis.hotpath import check_hotpath
from jepsen_tpu_torch.analysis.lockorder import check_lockorder
from jepsen_tpu_torch.analysis.obsrules import check_obs
from jepsen_tpu_torch.analysis.podrules import check_podrules

#: Family A: the hot-path residency set (paths relative to the
#: jepsen_tpu_torch package root, forward slashes); device.py holds the
#: funnel (_host_get, copy_to_host_async, wait_train), wgl_kfrontier.py
#: kernel B's launches, pod/slicing.py the mesh's gloo staging
FAMILY_A_FILES = (
    "device.py",
    "checker/wgl_bitset.py",
    "checker/wgl_kfrontier.py",
    "checker/sharded.py",
    "checker/dispatch.py",
    "checker/streaming.py",
    "checker/txn_graph.py",
    "pod/slicing.py",
)

#: Family B: the lock-discipline set (the reference's, plus the port's
#: device.py and the kernel build, which serializes under a lock of its
#: own)
FAMILY_B_FILES = (
    "device.py",
    "checker/_build.py",
    "checker/dispatch.py",
    "checker/chaos.py",
    "checker/wgl_bitset.py",
    "checker/sharded.py",
    "checker/streaming.py",
    "checker/txn_graph.py",
    "checker/checkpoint.py",
    "runtime/core.py",
    "service/*.py",
    "pod/topology.py",
    "pod/faultdomains.py",
    "pod/launcher.py",
    "cli.py",
)

#: Family C: the flight-recorder emission-discipline set — every
#: module that calls (or implements) obs.span/obs.instant
FAMILY_C_FILES = (
    "checker/*.py",
    "service/*.py",
    "obs/*.py",
    "pod/*.py",
    "cli.py",
)

#: Family D: every module holding (or reachable while holding) a
#: plane lock — the lock-order graph's anchor set. The graph itself
#: always spans the whole package; this set only scopes where
#: findings may land.
FAMILY_D_FILES = (
    "device.py",
    "checker/*.py",
    "runtime/core.py",
    "service/*.py",
    "pod/*.py",
    "obs/*.py",
    "cli.py",
)

#: Family E: the pod-collective surface (JT501/502) plus the durable
#: content-hash funnels (JT503)
FAMILY_E_FILES = (
    "pod/*.py",
    "checker/dispatch.py",
    "checker/sharded.py",
    "checker/wgl_bitset.py",
    "checker/checkpoint.py",
    "checker/streaming.py",
    "service/*.py",
    "cli.py",
)

#: rule catalog: id -> (title, guarded invariant)
RULES: Dict[str, Tuple[str, str]] = {
    "JT000": (
        "unparseable file",
        "every linted file must parse — a syntax error hides every "
        "other finding in the file",
    ),
    "JT001": (
        "bare suppression",
        "suppressions must record WHY an invariant is waived",
    ),
    "JT101": (
        "implicit host sync",
        "every device->host fetch funnels through device._host_get "
        "(one counted sync per check): no .item()/.tolist()/.numpy(), "
        "coercion, iteration or boolean test of a device value",
    ),
    "JT102": (
        "bare synchronize",
        "sync barriers (torch.cuda/stream/event .synchronize()) must "
        "be counted fetches, not silent waits",
    ),
    "JT103": (
        "unaccounted launch",
        "every kernel launch registers in LAUNCH_STATS",
    ),
    "JT104": (
        "unguarded crossing",
        "device->host copies (.cpu(), .to('cpu')) ride the funnel or "
        "the chaos resilient_call/deadline ladder",
    ),
    "JT105": (
        "cross-stream reuse without record_use",
        "a tensor a launch on another stream uses is record_use'd "
        "before it is freed or written again",
    ),
    "JT106": (
        "build cache-key hazard",
        "kernel wrappers take no mutable defaults and close over no "
        "mutable module state behind the build cache",
    ),
    "JT107": (
        "raw tunable read",
        "perf-registry knobs resolve through "
        "jepsen_tpu_torch.perf.knobs, never as raw module constants "
        "in hot paths",
    ),
    "JT201": (
        "stats mutation outside lock",
        "every *_STATS mutation happens under its declared lock",
    ),
    "JT202": (
        "blocking call under lock",
        "plane locks are held for bookkeeping only, never across "
        "waits",
    ),
    "JT203": (
        "unjoinable thread",
        "thread creation comes with a bounded-join drain seam",
    ),
    "JT204": (
        "hook invoked under lock",
        "user hooks run outside the ledger lock (re-entrancy safe)",
    ),
    "JT205": (
        "unlocked aggregate stats read",
        "aggregate stats reads go through a locked snapshot() helper",
    ),
    "JT206": (
        "membership mutation outside lock",
        "cross-member membership/routing state (member sets, hash "
        "rings, route tables) mutates only under the membership "
        "lock — routers must never read a half-updated ring",
    ),
    "JT207": (
        "process control under a held lock",
        "signal sends (os.kill, Process.terminate) and subprocess "
        "spawns happen outside registry/ring/plane locks — decide "
        "under the lock, release it, then fork/signal",
    ),
    "JT301": (
        "span not context-managed",
        "span(...) is always entered via with — a held span "
        "silently drops its event",
    ),
    "JT302": (
        "trace emission under plane lock",
        "span/instant emission happens after every plane lock is "
        "released",
    ),
    "JT303": (
        "obs call in compile-traced code",
        "no obs emission is reachable from torch.compile/torch.jit "
        "tracing — trace-time clock reads bake into the compiled "
        "graph",
    ),
    "JT304": (
        "trace emission in per-device loop",
        "no span/instant emission inside a per-device or per-member "
        "loop — ring churn must stay O(1) per plane crossing, not "
        "O(mesh size); emit the aggregate after the loop",
    ),
    "JT305": (
        "per-append launch inside a stream loop",
        "loops over stream appends/chunks route their tails through "
        "the dispatch plane's stream bucket — a direct launch or "
        "collect per append pays the one-sync floor k times where "
        "the coalesced bucket pays it ~k/bucket_size times",
    ),
    "JT401": (
        "lock-order cycle",
        "plane locks nest in one global order — a cycle in the "
        "lock-order graph is a latent ABBA deadlock",
    ),
    "JT402": (
        "collective reachable under lock",
        "no pod collective (global_view all-gather, all_reduce, "
        "init_pod/init_process_group/new_group/launch_pod "
        "handshakes) is reachable while any plane lock is held — a "
        "member parked on the lock wedges the whole pod",
    ),
    "JT403": (
        "blocking call reachable under lock",
        "no blocking call is reachable under a plane lock through "
        "any call chain (the interprocedural closure of JT202)",
    ),
    "JT501": (
        "collective under divergent control flow",
        "collectives execute unconditionally-or-uniformly: never "
        "under a process_index/host-dependent branch or per-device "
        "loop (SPMD divergence wedges the barrier)",
    ),
    "JT502": (
        "divergent collective ordering",
        "all branch arms reach collectives in the same order — "
        "members on different arms must meet the same barriers in "
        "the same sequence",
    ),
    "JT503": (
        "nondeterministic content-hash input",
        "durable hashes (checkpoint sha256, streaming prefix rows, "
        "service check ids) consume only run- and process-"
        "deterministic inputs, or resume/coalescing silently break",
    ),
}

#: rules that exist independent of any family (engine-level)
META_RULES: Tuple[str, ...] = ("JT000", "JT001")

#: family letter -> its rule ids (the catalog partition)
FAMILY_RULES: Dict[str, Tuple[str, ...]] = {
    "A": ("JT101", "JT102", "JT103", "JT104", "JT105", "JT106",
          "JT107"),
    "B": ("JT201", "JT202", "JT203", "JT204", "JT205", "JT206",
          "JT207"),
    "C": ("JT301", "JT302", "JT303", "JT304", "JT305"),
    "D": ("JT401", "JT402", "JT403"),
    "E": ("JT501", "JT502", "JT503"),
}

#: the families lint_source/run_lint actually dispatch. rules_total()
#: derives from this, and the tests and chip_smoke's lint phase pin
#: rules_total at 27 — so silently disabling a family here fails them.
ACTIVE_FAMILIES: Tuple[str, ...] = ("A", "B", "C", "D", "E")


def rules_total(
    families: Sequence[str] = ACTIVE_FAMILIES,
) -> int:
    """Number of rules active for the given families (plus the
    engine-level meta rules)."""
    return len(META_RULES) + sum(
        len(FAMILY_RULES[f]) for f in families
    )


def _match(rel: str, patterns: Sequence[str]) -> bool:
    return any(fnmatch.fnmatch(rel, p) for p in patterns)


def package_root() -> str:
    """Absolute path of the jepsen_tpu_torch package directory."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def repo_root() -> str:
    return os.path.dirname(package_root())


def default_baseline_path() -> str:
    """The port's own baseline (the JAX package keeps
    planelint_baseline.json)."""
    return os.path.join(repo_root(), "planelint_torch_baseline.json")


def families_for(rel: str) -> Tuple[str, ...]:
    fams = []
    if _match(rel, FAMILY_A_FILES):
        fams.append("A")
    if _match(rel, FAMILY_B_FILES):
        fams.append("B")
    if _match(rel, FAMILY_C_FILES):
        fams.append("C")
    if _match(rel, FAMILY_D_FILES):
        fams.append("D")
    if _match(rel, FAMILY_E_FILES):
        fams.append("E")
    return tuple(fams)


def _syntax_error_finding(rel: str, e: SyntaxError) -> Finding:
    return Finding(
        rule="JT000",
        file=rel,
        line=e.lineno or 0,
        col=e.offset or 0,
        severity="error",
        message=f"syntax error: {e.msg}",
    )


def _intra_findings(
    tree: ast.Module, rel: str, families: Sequence[str]
) -> List[Finding]:
    findings: List[Finding] = []
    if "A" in families:
        findings.extend(check_hotpath(tree, rel))
    if "B" in families:
        findings.extend(check_concurrency(tree, rel))
    if "C" in families:
        findings.extend(check_obs(tree, rel))
    return findings


def _whole_program_findings(
    graph: CallGraph,
    d_targets: Set[str],
    e_targets: Set[str],
) -> List[Finding]:
    findings: List[Finding] = []
    if d_targets:
        findings.extend(check_lockorder(graph, d_targets))
    if e_targets:
        findings.extend(check_podrules(graph, e_targets))
        findings.extend(check_determinism(graph, e_targets))
    return findings


def lint_source(
    source: str,
    rel: str = "<corpus>",
    families: Sequence[str] = ACTIVE_FAMILIES,
) -> List[Finding]:
    """Lint one source string (the tests' corpus entry and the
    single-file path behind lint_file). Families D/E see only this
    file's call graph here; run_lint gives them the whole package."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [_syntax_error_finding(rel, e)]
    findings = _intra_findings(tree, rel, families)
    if "D" in families or "E" in families:
        graph = CallGraph.from_trees({rel: tree})
        findings.extend(
            _whole_program_findings(
                graph,
                {rel} if "D" in families else set(),
                {rel} if "E" in families else set(),
            )
        )
    suppressed, bare = parse_suppressions(source)
    findings = apply_suppressions(findings, suppressed)
    findings.extend(bare_suppression_findings(rel, bare))
    findings.sort(key=lambda f: (f.file, f.line, f.col, f.rule))
    return findings


def lint_file(path: str, rel: str) -> List[Finding]:
    fams = families_for(rel)
    if not fams:
        return []
    with open(path, encoding="utf-8") as f:
        source = f.read()
    return lint_source(source, rel=rel, families=fams)


def _walk_package(root: str) -> List[Tuple[str, str]]:
    """Every .py under ``root`` as (abs path, package-relative
    posix path), deterministic order."""
    out: List[Tuple[str, str]] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(
            d for d in dirnames
            if d not in ("__pycache__", ".git")
        )
        for name in sorted(filenames):
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            out.append((path, rel))
    return out


def run_lint(
    root: Optional[str] = None,
    only: Optional[Sequence[str]] = None,
) -> List[Finding]:
    """Lint the package tree under ``root`` (default: the
    jepsen_tpu_torch package). Findings carry package-relative paths.

    ``only`` restricts where findings may LAND (the --changed-only
    scope); the D/E call graph still spans the whole package, so a
    change in one file that creates a lock-order cycle with an
    unchanged file is reported as long as one anchor edge is in
    scope."""
    root = root or package_root()
    only_set = None if only is None else {
        r.replace(os.sep, "/") for r in only
    }
    findings: List[Finding] = []
    sources: Dict[str, str] = {}
    trees: Dict[str, ast.Module] = {}

    def in_scope(rel: str) -> bool:
        return only_set is None or rel in only_set

    for path, rel in _walk_package(root):
        with open(path, encoding="utf-8") as f:
            source = f.read()
        sources[rel] = source
        try:
            trees[rel] = ast.parse(source)
        except SyntaxError as e:
            if families_for(rel) and in_scope(rel):
                findings.append(_syntax_error_finding(rel, e))

    d_targets: Set[str] = set()
    e_targets: Set[str] = set()
    for rel, tree in trees.items():
        fams = families_for(rel)
        if not fams:
            continue
        if in_scope(rel):
            findings.extend(_intra_findings(tree, rel, fams))
            if "D" in fams:
                d_targets.add(rel)
            if "E" in fams:
                e_targets.add(rel)

    if d_targets or e_targets:
        graph = CallGraph.from_trees(trees)
        findings.extend(
            _whole_program_findings(graph, d_targets, e_targets)
        )

    suppress_by_file: Dict[str, Dict[int, set]] = {}
    for rel, source in sources.items():
        if not families_for(rel) or not in_scope(rel):
            continue
        suppressed, bare = parse_suppressions(source)
        suppress_by_file[rel] = suppressed
        findings.extend(bare_suppression_findings(rel, bare))
    findings = [
        f
        for f in findings
        if f.rule not in suppress_by_file.get(f.file, {}).get(
            f.line, ()
        )
    ]
    findings.sort(key=lambda f: (f.file, f.line, f.col, f.rule))
    return findings


# --------------------------------------------------------------------
# CI surface: changed-file scoping, suppression census, baseline
# hygiene
# --------------------------------------------------------------------


def changed_files(
    root: Optional[str] = None, repo: Optional[str] = None
) -> List[str]:
    """Package-relative paths of the .py files git considers changed
    (working tree + staged vs HEAD, plus untracked), scoped to files
    under ``root``. Empty when git is unavailable."""
    root = os.path.abspath(root or package_root())
    repo = os.path.abspath(repo or os.path.dirname(root))
    names: Set[str] = set()
    for cmd in (
        ["git", "-C", repo, "diff", "--name-only", "HEAD", "--"],
        ["git", "-C", repo, "ls-files", "--others",
         "--exclude-standard"],
    ):
        try:
            r = subprocess.run(
                cmd, capture_output=True, text=True, check=False
            )
        except OSError:
            return []
        if r.returncode != 0:
            continue
        names.update(
            ln.strip() for ln in r.stdout.splitlines() if ln.strip()
        )
    rels: List[str] = []
    for name in sorted(names):
        if not name.endswith(".py"):
            continue
        rel = os.path.relpath(os.path.join(repo, name), root)
        if rel.startswith(".."):
            continue
        rels.append(rel.replace(os.sep, "/"))
    return rels


def suppression_census(
    root: Optional[str] = None,
    only: Optional[Sequence[str]] = None,
) -> Dict[str, dict]:
    """rule id -> {"count", "sites": [{"file","line","reason"}]} for
    every *reasoned* suppression in the linted tree. Bare disables
    are JT001 findings, not census entries. This is the reviewable
    record of which invariants are waived where, and why."""
    root = root or package_root()
    only_set = None if only is None else {
        r.replace(os.sep, "/") for r in only
    }
    census: Dict[str, dict] = {}
    for path, rel in _walk_package(root):
        if not families_for(rel):
            continue
        if only_set is not None and rel not in only_set:
            continue
        with open(path, encoding="utf-8") as f:
            source = f.read()
        for line, rules, reason in scan_suppression_entries(source):
            if not reason:
                continue
            for rid in rules:
                ent = census.setdefault(
                    rid, {"count": 0, "sites": []}
                )
                ent["count"] += 1
                ent["sites"].append(
                    {"file": rel, "line": line, "reason": reason}
                )
    return dict(sorted(census.items()))


def file_symbols(tree: ast.Module) -> Set[str]:
    """Every dotted def/class path a finding's ``symbol`` field could
    name in this file (plus '<module>')."""
    syms: Set[str] = {"<module>"}

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
            ):
                dotted = (
                    f"{prefix}.{child.name}" if prefix else child.name
                )
                syms.add(dotted)
                visit(child, dotted)
            else:
                visit(child, prefix)

    visit(tree, "")
    return syms


def stale_baseline_entries(
    baseline: Dict[str, int], root: Optional[str] = None
) -> List[str]:
    """Baseline keys whose file::symbol no longer exists — dead
    grandfather entries that would otherwise ride forever. The CLI
    warns on these and --update-baseline prunes them."""
    root = root or package_root()
    stale: List[str] = []
    symbol_cache: Dict[str, Optional[Set[str]]] = {}
    for key in sorted(baseline):
        parts = key.split("::")
        if len(parts) != 3:
            stale.append(key)
            continue
        rel, symbol, _rule = parts
        path = os.path.join(root, rel.replace("/", os.sep))
        if not os.path.isfile(path):
            stale.append(key)
            continue
        if rel not in symbol_cache:
            try:
                with open(path, encoding="utf-8") as f:
                    symbol_cache[rel] = file_symbols(
                        ast.parse(f.read())
                    )
            except SyntaxError:
                symbol_cache[rel] = None
        syms = symbol_cache[rel]
        if syms is None:
            continue  # unparseable: JT000 owns this, not staleness
        base = symbol.split(".<lambda>")[0]
        if symbol not in syms and base not in syms:
            stale.append(key)
    return stale
