"""The reference's verdict of one pool item, in the form the entries
give the program's: {"valid": bool, "failed": ...}. For one register
history `failed` is the failing op's index (None when valid); for a
keyed history it is the sorted list of [key, failing index or None]
over every key, so a key left unchecked or judged wrongly shows."""

from __future__ import annotations

from portbench.reference import wgl


def verdict(item: dict) -> dict:
    if item["keyed"]:
        per_key = wgl.check_keyed(item["ops"])
        return {
            "valid": wgl.verdict_of(per_key),
            "failed": sorted([k, r["failed_op_index"]]
                             for k, r in per_key.items()),
        }
    r = wgl.check(item["ops"])
    return {"valid": r["valid?"], "failed": r["failed_op_index"]}
