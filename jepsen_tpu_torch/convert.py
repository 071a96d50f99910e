"""Carry prepared inputs across from the reference package.

from_reference(obj) turns a jepsen_tpu EventStream or ReturnSteps into
the port's, reading the numpy fields by attribute name (nothing of
jepsen_tpu is imported). The tests use it to feed both packages the
same prepared input.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from jepsen_tpu_torch.checker.events import EventStream, ReturnSteps


def _copy(v):
    return np.array(v, copy=True) if isinstance(v, np.ndarray) else v


def from_reference(obj):
    """The port's EventStream / ReturnSteps with the same field values
    (arrays copied, so later memos on either side stay separate)."""
    if hasattr(obj, "kind") and hasattr(obj, "window"):
        cls = EventStream
    elif hasattr(obj, "occ") and hasattr(obj, "crashed"):
        cls = ReturnSteps
    else:
        raise TypeError(f"not an EventStream or ReturnSteps: {type(obj)}")
    fields = {
        f.name: _copy(getattr(obj, f.name)) for f in dataclasses.fields(cls)
    }
    if cls is EventStream:
        fields["value_codes"] = dict(obj.value_codes)
    return cls(**fields)
