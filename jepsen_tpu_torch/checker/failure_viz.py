"""Failure-artifact rendering: the reference's `linear.svg` role.

On an invalid verdict, knossos renders the point of death — the
returning op that could not linearize and the configurations that
survived up to it (jepsen/src/jepsen/checker.clj:146-154, output
truncated to 10 configs). Here the input is `decode_frontier`'s JSON
(wgl_bitset.py): the failed op plus, per surviving config, its state
and which open-window ops it had / hadn't linearized.

The artifact is a self-contained SVG written next to results.json:
a strip of the open window's ops (one lane per slot) and one row per
surviving config — state on the left, a green chip where the config
linearized that slot's op, a hollow chip where it is still pending.
A human can read off at a glance why every configuration rejected the
failing op.
"""

from __future__ import annotations

import html
from typing import Any, Dict, List, Optional

_GREEN = "#6db656"
_RED = "#d2322d"
_GRAY = "#b9b9b9"
_INK = "#333333"

_ROW_H = 26
_CHIP_W = 30
_LEFT = 210
_TOP = 96


def _op_label(op: Dict[str, Any]) -> str:
    v = op.get("value")
    if isinstance(v, list):
        v = " ".join(str(x) for x in v)
    return f"{op.get('f', '?')} {v}"


def render_failure_svg(
    failure: Dict[str, Any],
    failed_op_index: Optional[int] = None,
    title: str = "linearizability failure",
) -> str:
    """Render the failure report dict to SVG markup."""
    configs: List[dict] = failure.get("configs", [])
    failed = failure.get("failed_op", {})

    # The open window at death: union of slots across configs (they
    # all share the same open ops; order lanes by slot).
    slots: Dict[int, dict] = {}
    for cfg in configs:
        for op in cfg.get("linearized", []) + cfg.get("pending", []):
            slots.setdefault(op["slot"], op)
    lanes = [slots[s] for s in sorted(slots)]

    w = max(_LEFT + _CHIP_W * max(len(lanes), 1) + 40, 560)
    h = _TOP + _ROW_H * max(len(configs), 1) + 48
    out = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" '
        f'height="{h}" font-family="sans-serif" font-size="12">',
        f'<rect width="{w}" height="{h}" fill="white"/>',
        f'<text x="16" y="24" font-size="15" fill="{_INK}">'
        f"{html.escape(title)}</text>",
    ]
    idx = (
        f" (history index {failed_op_index})"
        if failed_op_index is not None
        else ""
    )
    out.append(
        f'<text x="16" y="46" fill="{_RED}" font-size="13">'
        f"could not linearize: {html.escape(_op_label(failed))}{idx}"
        f"</text>"
    )
    out.append(
        f'<text x="16" y="{_TOP - 28}" fill="{_INK}">'
        f"{len(configs)} surviving config(s) before this op "
        f"(truncated to 10); open window below</text>"
    )
    # Lane headers: the open ops.
    for j, op in enumerate(lanes):
        x = _LEFT + j * _CHIP_W + _CHIP_W / 2
        out.append(
            f'<text x="{x}" y="{_TOP - 8}" text-anchor="middle" '
            f'font-size="10" fill="{_INK}" transform="rotate(-35 '
            f'{x} {_TOP - 8})">{html.escape(_op_label(op))}</text>'
        )
    lane_index = {op["slot"]: j for j, op in enumerate(lanes)}
    for i, cfg in enumerate(configs):
        y = _TOP + i * _ROW_H
        state = cfg.get("state")
        out.append(
            f'<text x="16" y="{y + 16}" fill="{_INK}">config {i}: '
            f"state={html.escape(str(state))}</text>"
        )
        done = {op["slot"] for op in cfg.get("linearized", [])}
        pend = {op["slot"] for op in cfg.get("pending", [])}
        for slot, j in lane_index.items():
            x = _LEFT + j * _CHIP_W + 4
            if slot in done:
                out.append(
                    f'<rect x="{x}" y="{y + 4}" width="{_CHIP_W - 8}" '
                    f'height="16" rx="3" fill="{_GREEN}"/>'
                )
            elif slot in pend:
                out.append(
                    f'<rect x="{x}" y="{y + 4}" width="{_CHIP_W - 8}" '
                    f'height="16" rx="3" fill="none" stroke="{_GRAY}"/>'
                )
    ly = _TOP + _ROW_H * max(len(configs), 1) + 20
    out.append(
        f'<rect x="16" y="{ly - 11}" width="12" height="12" rx="3" '
        f'fill="{_GREEN}"/><text x="34" y="{ly}" fill="{_INK}">'
        f"linearized</text>"
        f'<rect x="120" y="{ly - 11}" width="12" height="12" rx="3" '
        f'fill="none" stroke="{_GRAY}"/><text x="138" y="{ly}" '
        f'fill="{_INK}">still pending</text>'
    )
    out.append("</svg>")
    return "".join(out)


def write_failure_svg(
    failure: Dict[str, Any],
    run_dir: str,
    name: str = "linear.svg",
    failed_op_index: Optional[int] = None,
) -> str:
    """Write the artifact into run_dir (the checker.clj:146-154 output
    path role); returns the file path."""
    import os

    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, name)
    with open(path, "w") as fh:
        fh.write(
            render_failure_svg(
                failure, failed_op_index=failed_op_index
            )
        )
    return path
