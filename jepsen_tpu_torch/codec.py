"""Client payload codec: structured values <-> bytes.

Reference: jepsen/src/jepsen/codec.clj (EDN <-> byte arrays for client
payloads, :9-29). JSON with the store's tag scheme here, so payloads
round-trip tuples/sets/KV values exactly.
"""

from __future__ import annotations

import json
from typing import Any

from jepsen_tpu_torch.store import _decode_value, _encode_value


def encode(value: Any) -> bytes:
    """Value -> bytes (nil-safe, like codec.clj:9-17)."""
    return json.dumps(_encode_value(value)).encode("utf-8")


def decode(data: bytes) -> Any:
    """Bytes -> value; empty input decodes to None (codec.clj:19-29)."""
    if not data:
        return None
    return _decode_value(json.loads(data.decode("utf-8")))
