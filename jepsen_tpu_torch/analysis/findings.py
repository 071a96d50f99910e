"""planelint finding model, inline suppressions, and the baseline.

A Finding is one rule violation pinned to ``file:line``. Findings key
for baseline purposes on (file, enclosing symbol, rule) — NOT the line
number — so unrelated edits above a grandfathered finding don't churn
``planelint_baseline.json``.

Inline suppressions::

    x = float(fr)  # planelint: disable=JT101 reason=post-sync artifact

A trailing comment suppresses its own line; a comment alone on a line
suppresses the next line. ``reason=`` is mandatory: a bare disable is
itself reported (JT001) — the suppression syntax exists to record WHY
an invariant is waived, not to wave findings through silently.
"""

from __future__ import annotations

import dataclasses
import io
import json
import re
import tokenize
from collections import Counter
from typing import Dict, List, Optional, Tuple

#: the meta-rule: a suppression comment with no reason annotation
RULE_BARE_SUPPRESSION = "JT001"

_SUPPRESS_RE = re.compile(
    r"#\s*planelint:\s*disable=([A-Za-z0-9_,\s]+?)"
    r"(?:\s+reason=(.+))?$"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation: rule id + location + severity + message."""

    rule: str
    file: str  # repo-relative posix path (or a test-corpus label)
    line: int
    col: int
    severity: str  # "error" | "warning"
    message: str
    symbol: str = "<module>"  # enclosing def/class dotted path

    @property
    def location(self) -> str:
        return f"{self.file}:{self.line}"

    def key(self) -> str:
        """Line-drift-tolerant identity for baseline matching."""
        return f"{self.file}::{self.symbol}::{self.rule}"

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "file": self.file,
            "line": self.line,
            "col": self.col,
            "severity": self.severity,
            "message": self.message,
            "symbol": self.symbol,
        }

    def render(self) -> str:
        return (
            f"{self.file}:{self.line}:{self.col}: {self.rule} "
            f"[{self.severity}] {self.message}  (in {self.symbol})"
        )


# --------------------------------------------------------------------
# Inline suppressions
# --------------------------------------------------------------------


def scan_suppression_entries(
    source: str,
) -> List[Tuple[int, Tuple[str, ...], str]]:
    """Every planelint disable comment in ``source`` as
    (governed line, sorted rule ids, reason-or-empty). The shared
    scanner behind ``parse_suppressions`` and the census."""
    entries: List[Tuple[int, Tuple[str, ...], str]] = []
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            rules = tuple(sorted(
                r.strip() for r in m.group(1).split(",") if r.strip()
            ))
            line = tok.start[0]
            reason = (m.group(2) or "").strip()
            # A comment alone on its line governs the NEXT line; a
            # trailing comment governs its own.
            prefix = tok.line[: tok.start[1]]
            target = line + 1 if not prefix.strip() else line
            entries.append((target if reason else line, rules, reason))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass  # the ast parse will report the real syntax problem
    return entries


def parse_suppressions(
    source: str,
) -> Tuple[Dict[int, set], List[Tuple[int, str]]]:
    """Scan comments for planelint disables.

    Returns (suppressed, bare): ``suppressed`` maps line number ->
    set of rule ids disabled there; ``bare`` lists (line, rules-text)
    for disables missing the mandatory ``reason=`` annotation.
    """
    suppressed: Dict[int, set] = {}
    bare: List[Tuple[int, str]] = []
    for line, rules, reason in scan_suppression_entries(source):
        if not reason:
            bare.append((line, ",".join(rules)))
            continue
        suppressed.setdefault(line, set()).update(rules)
    return suppressed, bare


def apply_suppressions(
    findings: List[Finding],
    suppressed: Dict[int, set],
) -> List[Finding]:
    return [
        f
        for f in findings
        if f.rule not in suppressed.get(f.line, ())
    ]


# --------------------------------------------------------------------
# Baseline
# --------------------------------------------------------------------

BASELINE_VERSION = 1


def load_baseline(path: str) -> Dict[str, int]:
    """{finding key: grandfathered count}; missing file = empty."""
    try:
        with open(path) as f:
            data = json.load(f)
    except FileNotFoundError:
        return {}
    if not isinstance(data, dict):
        raise ValueError(f"malformed baseline at {path}")
    counts = data.get("findings", {})
    return {str(k): int(v) for k, v in counts.items()}


def save_baseline(path: str, findings: List[Finding]) -> None:
    counts = Counter(f.key() for f in findings)
    payload = {
        "version": BASELINE_VERSION,
        "comment": (
            "Grandfathered planelint findings. New code must lint "
            "clean; shrink this file, never grow it."
        ),
        "findings": dict(sorted(counts.items())),
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=False)
        f.write("\n")


def apply_baseline(
    findings: List[Finding],
    baseline: Dict[str, int],
) -> Tuple[List[Finding], Dict[str, int]]:
    """Split findings into (new, matched-count-by-key). Each baseline
    entry absorbs up to its recorded count of same-key findings; the
    rest are new."""
    budget = dict(baseline)
    new: List[Finding] = []
    matched: Dict[str, int] = {}
    for f in findings:
        k = f.key()
        if budget.get(k, 0) > 0:
            budget[k] -= 1
            matched[k] = matched.get(k, 0) + 1
        else:
            new.append(f)
    return new, matched


def bare_suppression_findings(
    rel: str, bare: List[Tuple[int, str]], symbols: Optional[dict] = None
) -> List[Finding]:
    out = []
    for line, rules in bare:
        sym = "<module>"
        if symbols:
            sym = symbols.get(line, "<module>")
        out.append(
            Finding(
                rule=RULE_BARE_SUPPRESSION,
                file=rel,
                line=line,
                col=0,
                severity="error",
                message=(
                    f"suppression of {rules} without a reason= "
                    "annotation — record why the invariant is waived"
                ),
                symbol=sym,
            )
        )
    return out
