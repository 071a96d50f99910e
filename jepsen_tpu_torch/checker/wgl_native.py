"""ctypes binding of the native (C++) WGL oracle rung and the native
events->steps prep: the counterpart of jepsen_tpu.checker.wgl_native,
on the port's own copies of the sources (csrc/wgl_native.cc,
csrc/wgl_prep.cc), built with g++ at first use (_build.native_library).

``check_events_native`` runs the same set-based frontier search as
``wgl_oracle.check_events`` at C++ speed (the knossos.wgl role,
jepsen/src/jepsen/checker.clj:127-158). Scope: models whose state fits
an int32 (register family, mutex, and the packed count-vector queue,
whose packed envelope is enforced HERE: an out-of-envelope code would
drive the C++ step into undefined-behaviour shifts), with windows <= 64
slots. Outside the envelope, or without g++, the functions return None
and callers fall back to the Python oracle.

``prep_steps_native`` is events_to_steps in one C++ pass, byte-identical
to events._events_to_steps_numpy.
"""

from __future__ import annotations

import ctypes
from typing import Any, Optional, Tuple, Union

import numpy as np

from jepsen_tpu_torch.checker import _build
from jepsen_tpu_torch.checker.events import (
    EV_RETURN,
    EventStream,
    ReturnSteps,
    crashed_invokes,
    n_words,
)
from jepsen_tpu_torch.checker.models import (
    Model,
    model as get_model,
    packed_queue_envelope,
)

#: model name -> its id in csrc/wgl_native.cc's step()
_MODEL_IDS = {
    "cas-register": 0,
    "register": 1,
    "mutex": 2,
    "unordered-queue-packed": 3,
}

#: library name -> loaded CDLL, or None when it could not be built
_libs: dict = {}

_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

#: library name -> (function, restype, argtypes)
_SIGNATURES = {
    "wgl_native": ("wgl_native_check", ctypes.c_longlong, [
        _I32P, _I32P, _I32P, _I32P, _I32P,
        _U8P,  # crashed invokes: the dominance pruning's input
        ctypes.c_longlong, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_longlong),  # out_stats[2] or NULL
    ]),
    "wgl_prep": ("wgl_prep_steps", ctypes.c_longlong, [
        _I32P, _I32P, _I32P, _I32P, _I32P,
        ctypes.c_void_p,  # op_index (int32*) or NULL
        ctypes.c_longlong, ctypes.c_int32, ctypes.c_int32,
        _U8P, _I32P, _I32P, _I32P, _I32P, _I32P, _I32P, _I32P,
    ]),
}


def _load(name: str):
    """The named host library's entry function, its signature declared;
    None when the library cannot be built."""
    if name not in _libs:
        so = _build.native_library(name)
        fn = None
        if so is not None:
            fname, restype, argtypes = _SIGNATURES[name]
            fn = getattr(ctypes.CDLL(str(so)), fname)
            fn.restype = restype
            fn.argtypes = argtypes
        _libs[name] = fn
    return _libs[name]


def available() -> bool:
    return _load("wgl_native") is not None


def prep_available() -> bool:
    return _load("wgl_prep") is not None


def _c(arr) -> np.ndarray:
    return np.ascontiguousarray(arr, np.int32)


def prep_steps_native(events: EventStream, W: int) -> Optional[ReturnSteps]:
    """events_to_steps at C++ speed (one O(n) pass, row memcpys per
    return), or None when there is no toolchain or the stream is
    malformed (the numpy path then decides)."""
    fn = _load("wgl_prep")
    if fn is None:
        return None
    n = len(events)
    nw = n_words(W)
    n_ret = int(np.sum(events.kind == EV_RETURN))
    out_occ = np.zeros((n_ret, W), np.uint8)
    out_f = np.zeros((n_ret, W), np.int32)
    out_a = np.zeros((n_ret, W), np.int32)
    out_b = np.zeros((n_ret, W), np.int32)
    out_slot = np.zeros(n_ret, np.int32)
    out_crash = np.zeros((n_ret, nw), np.int32)
    out_opidx = np.full(n_ret, -1, np.int32)
    out_fresh = np.zeros((n_ret, nw), np.int32)
    opidx = _c(events.op_index) if events.op_index is not None else None
    rc = fn(
        _c(events.kind), _c(events.slot), _c(events.f), _c(events.a),
        _c(events.b),
        opidx.ctypes.data_as(ctypes.c_void_p) if opidx is not None
        else None,
        n, W, nw, out_occ, out_f, out_a, out_b, out_slot, out_crash,
        out_opidx, out_fresh,
    )
    if rc != n_ret:
        return None
    return ReturnSteps(
        occ=out_occ.view(bool),
        f=out_f,
        a=out_a,
        b=out_b,
        slot=out_slot,
        live=np.ones(n_ret, bool),
        crashed=out_crash,
        op_index=out_opidx,
        init_state=events.init_state,
        W=W,
        fresh=out_fresh,
    )


def check_events_native(
    events: EventStream,
    model: Any = "cas-register",
    return_stats: bool = False,
) -> Union[None, bool, Tuple[bool, dict]]:
    """Native-oracle verdict, or None when outside the native envelope
    (window > 64, rich-state model, packed queue outside its envelope,
    or no C++ toolchain)."""
    m: Model = get_model(model)
    model_id = _MODEL_IDS.get(m.name)
    if model_id is None or events.window > 64:
        return None
    if m.name == "unordered-queue-packed" and not packed_queue_envelope(
        events
    ):
        return None
    fn = _load("wgl_native")
    if fn is None:
        return None
    stats = (ctypes.c_longlong * 2)()
    rc = fn(
        _c(events.kind), _c(events.slot), _c(events.f), _c(events.a),
        _c(events.b), crashed_invokes(events).astype(np.uint8), len(events),
        int(m.initial(events.init_state)), model_id, events.window,
        stats,
    )
    if rc < 0:
        return None
    valid = bool(rc)
    if not return_stats:
        return valid
    failed_at = int(stats[1])
    op_idx = None
    if failed_at >= 0 and events.op_index is not None:
        op_idx = int(events.op_index[failed_at])
    return valid, {
        "max_frontier": int(stats[0]),
        "failed_at": None if failed_at < 0 else failed_at,
        "failed_op_index": op_idx,
    }
