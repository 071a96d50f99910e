"""What every generator's pool is made of: plain op dicts (type, f,
value, process, time), and items that carry them with their label."""

from __future__ import annotations

import random
from typing import List


def invoked(ops: List[dict]) -> int:
    """Client ops invoked: the unit of ops_per_s."""
    return sum(1 for o in ops
               if o["type"] == "invoke" and isinstance(o["process"], int))


def item(ops: List[dict], label: str, corrupt: bool, keyed: bool) -> dict:
    return {"ops": ops, "label": label, "corrupt": corrupt, "keyed": keyed,
            "invoked": invoked(ops)}


def pool_seeds(seed: int, n: int) -> List[int]:
    """n seeds drawn from the run's seed (any int, however large)."""
    rng = random.Random(f"portbench:{seed}")
    return [rng.getrandbits(63) for _ in range(n)]


def corrupt_key_read(ops: List[dict], key, frac: float) -> List[dict]:
    """A copy of a keyed history in which the first ok read of `key` at
    or after `frac` of that key's ops, and that saw a value, sees nil
    instead. No op writes nil, so once a write of the key has completed
    the read cannot be linearized: the key fails at that read."""
    mine = [i for i, o in enumerate(ops)
            if isinstance(o["value"], list) and o["value"][0] == key]
    for i in mine[int(frac * len(mine)):]:
        o = ops[i]
        if o["type"] == "ok" and o["f"] == "read" and o["value"][1] is not None:
            out = list(ops)
            out[i] = dict(o, value=[key, None])
            return out
    raise ValueError(f"key {key}: no ok read to corrupt after {frac}")
