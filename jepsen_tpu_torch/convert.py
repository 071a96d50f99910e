"""Carry prepared inputs across from the reference package.

from_reference(obj) turns a jepsen_tpu EventStream, ReturnSteps,
BankPlane, G2Plane or ColumnarHistory into the port's, reading the
fields by attribute name (nothing of jepsen_tpu is imported). The tests
use it to feed both packages the same prepared input.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from jepsen_tpu_torch.checker.adya import G2Plane
from jepsen_tpu_torch.checker.bank import BankPlane
from jepsen_tpu_torch.checker.events import EventStream, ReturnSteps
from jepsen_tpu_torch.history.columnar import ColumnarHistory, Encoder
from jepsen_tpu_torch.history.ops import Op


def _copy(v):
    return np.array(v, copy=True) if isinstance(v, np.ndarray) else v


def _op(o) -> Op:
    return Op(type=o.type, f=o.f, value=o.value, process=o.process,
              time=o.time, index=o.index, error=o.error,
              extra=dict(o.extra))


def _encoder(e) -> Encoder:
    out = Encoder()
    out.f_codes = dict(e.f_codes)
    out.value_codes = dict(e.value_codes)
    out._f_rev = list(e._f_rev)
    out._value_rev = list(e._value_rev)
    return out


def _kind(obj):
    if hasattr(obj, "kind") and hasattr(obj, "window"):
        return EventStream
    if hasattr(obj, "occ") and hasattr(obj, "crashed"):
        return ReturnSteps
    if hasattr(obj, "bal") and hasattr(obj, "reads"):
        return BankPlane
    if hasattr(obj, "key_code") and hasattr(obj, "is_ok"):
        return G2Plane
    if hasattr(obj, "encoder") and hasattr(obj, "pair"):
        return ColumnarHistory
    raise TypeError(
        "not an EventStream, ReturnSteps, BankPlane, G2Plane or "
        f"ColumnarHistory: {type(obj)}"
    )


def from_reference(obj):
    """The port's object of the same kind with the same field values
    (arrays copied, so later memos on either side stay separate; ops
    rebuilt as the port's Op)."""
    cls = _kind(obj)
    fields = {
        f.name: _copy(getattr(obj, f.name)) for f in dataclasses.fields(cls)
    }
    if cls is EventStream:
        fields["value_codes"] = dict(obj.value_codes)
    elif cls is BankPlane:
        fields["reads"] = [_op(o) for o in obj.reads]
        fields["unexpected"] = [(_op(o), list(ks))
                                for o, ks in obj.unexpected]
    elif cls is G2Plane:
        fields["keys"] = list(obj.keys)
    elif cls is ColumnarHistory:
        fields["encoder"] = _encoder(obj.encoder)
        fields["extra"] = {k: (dict(v) if isinstance(v, dict) else _copy(v))
                           for k, v in obj.extra.items()}
    return cls(**fields)
