"""Host-side utilities: copies of jepsen_tpu.utils.util's
integer_interval_set_str and natural_key, the two helpers the
reductions and G2 checkers use (the rest of the module has no user in
the port yet)."""

from __future__ import annotations

def integer_interval_set_str(xs) -> str:
    """Render a set of integers as compact interval notation, e.g.
    "#{1..3 5 7..9}" (ref: jepsen/src/jepsen/util.clj
    integer-interval-set-str, used by checker set results). Non-integer
    collections render as a plain sorted set string."""
    xs = list(xs)
    if not xs:
        return "#{}"
    if not all(isinstance(x, int) and not isinstance(x, bool) for x in xs):
        return "#{" + " ".join(repr(x) for x in sorted(xs, key=repr)) + "}"
    xs = sorted(set(xs))
    runs = []
    lo = prev = xs[0]
    for x in xs[1:]:
        if x == prev + 1:
            prev = x
            continue
        runs.append((lo, prev))
        lo = prev = x
    runs.append((lo, prev))
    body = " ".join(
        str(a) if a == b else f"{a}..{b}" for a, b in runs
    )
    return "#{" + body + "}"


def natural_key(v) -> tuple:
    """Deterministic total-order sort key for mixed-type values.

    Numbers sort among themselves by value (bools as 0/1), strings after
    numbers, everything else last by repr. For homogeneous int inputs the
    order matches a plain sort, so hot paths that sort int keys keep their
    results byte-identical. Replaces the ad-hoc try/except sorts that threw
    on e.g. [3, "a"] key mixes.
    """
    if isinstance(v, bool):
        return (0, float(v), 1, "", "")
    if isinstance(v, (int, float)):
        return (0, float(v), 0, "", "")
    if isinstance(v, str):
        return (1, 0.0, 0, v, "")
    return (2, 0.0, 0, type(v).__name__, repr(v))
