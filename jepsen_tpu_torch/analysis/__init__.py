"""planelint for the port: static analysis for the plane's own
invariants (a copy of jepsen_tpu.analysis, Family A retargeted to
PyTorch, Families B-E grown to torch.distributed).

Stdlib-ast only (no new dependencies; importing it imports neither
torch nor jax): the rules encode at review time what the port enforces
at runtime — the device._host_get sync funnel, launch accounting,
chaos guards, cross-stream record_use and build-cache discipline
(Family A, JT1xx), stats-lock / blocking-call
/ hook discipline (Family B, JT2xx), flight-recorder emission
discipline (Family C, JT3xx) — and, on the shared interprocedural
call graph (``callgraph.py``), the whole-program properties the pod
and durability subsystems live on: lock-order acyclicity and
collective/blocking reachability under locks (Family D, JT4xx),
SPMD collective uniformity and content-hash determinism (Family E,
JT5xx).

Entry points: ``python -m jepsen_tpu_torch.cli lint`` (with
``--sarif`` for CI annotation and ``--changed-only`` for diff-scoped
runs) and ``jepsen_tpu_torch.analysis.run_lint()``; the port's
baseline is ``planelint_torch_baseline.json``. See README's port
section.
"""

from jepsen_tpu_torch.analysis.callgraph import (  # noqa: F401
    CallGraph,
    reachable_closure,
)
from jepsen_tpu_torch.analysis.engine import (  # noqa: F401
    ACTIVE_FAMILIES,
    FAMILY_A_FILES,
    FAMILY_B_FILES,
    FAMILY_C_FILES,
    FAMILY_D_FILES,
    FAMILY_E_FILES,
    FAMILY_RULES,
    META_RULES,
    RULES,
    changed_files,
    default_baseline_path,
    families_for,
    file_symbols,
    lint_file,
    lint_source,
    package_root,
    repo_root,
    rules_total,
    run_lint,
    stale_baseline_entries,
    suppression_census,
)
from jepsen_tpu_torch.analysis.findings import (  # noqa: F401
    Finding,
    apply_baseline,
    load_baseline,
    save_baseline,
    scan_suppression_entries,
)
from jepsen_tpu_torch.analysis.sarif import (  # noqa: F401
    MINIMAL_SCHEMA,
    to_sarif,
    validate_sarif,
)
