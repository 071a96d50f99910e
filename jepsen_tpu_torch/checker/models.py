"""Sequential-object models for linearizability checking.

A copy of the host side of jepsen_tpu.checker.models, with PyTorch
twins of its device functions. A model is a pure transition function
over dense int32 codes, in two synchronized implementations:

- ``step_py(state, f, a, b) -> (ok, state')`` — scalar Python, consumed
  by the CPU oracle.
- ``step_torch(state, f, a, b) -> (ok, state')`` — broadcastable torch
  tensor code, consumed by the K-frontier scans. ``state`` may be
  [K, 1] while f/a/b are [1, W]; the result broadcasts to [K, W].

Op encoding shared by both: an op is (f, a, b) int32s, where f is a
model-local code and a/b are interned value codes (NIL=-1 encodes None).

  cas-register:  read v   -> (F_READ,  code(v), 0)    ok iff state==a
                 write v  -> (F_WRITE, code(v), 0)    always ok, state'=a
                 cas[u,v] -> (F_CAS,   code(u), code(v)) ok iff state==u,
                                                         state'=b

The CUDA kernels (csrc/*.cu) carry the same transitions in C, selected
by ``Model.kernel_id``; the plain versions call the torch twins here.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

NIL = -1

F_READ, F_WRITE, F_CAS = 0, 1, 2

#: op.f spellings accepted per model f-code.
F_NAMES: Dict[Any, int] = {
    "read": F_READ,
    "r": F_READ,
    ":read": F_READ,
    "write": F_WRITE,
    "w": F_WRITE,
    ":write": F_WRITE,
    "cas": F_CAS,
    "compare-and-set": F_CAS,
    ":cas": F_CAS,
}


def cas_register_step_py(state: int, f: int, a: int, b: int) -> Tuple[bool, int]:
    if f == F_READ:
        return state == a, state
    if f == F_WRITE:
        return True, a
    if f == F_CAS:
        return state == a, b
    raise ValueError(f"unknown f code {f}")


def cas_register_step_torch(state, f, a, b):
    is_read = f == F_READ
    is_write = f == F_WRITE
    is_cas = f == F_CAS
    ok = is_write | ((state == a) & (is_read | is_cas))
    state2 = torch.where(is_write, a, torch.where(is_cas, b, state))
    return ok, state2


def register_step_py(state: int, f: int, a: int, b: int) -> Tuple[bool, int]:
    """Plain read/write register (knossos model/register): cas is invalid."""
    if f == F_READ:
        return state == a, state
    if f == F_WRITE:
        return True, a
    return False, state


def register_step_torch(state, f, a, b):
    is_read = f == F_READ
    is_write = f == F_WRITE
    ok = is_write | (is_read & (state == a))
    state2 = torch.where(is_write, a, state)
    return ok, state2


# -- bitset-kernel slot transitions ------------------------------------------
#
# The bitset WGL kernel (wgl_bitset.py) represents the frontier as an
# [S, 2^W] bit tensor over (state-row, linearized-mask) configs, with
# state row = value code + 1 (NIL -> row 0). A model describes a slot's
# op (f, a, b) with four values:
#
#   (src_is_union, src_row, dst_row, valid)
#
# src_is_union: the op linearizes from ANY state (write); otherwise only
# from src_row. dst_row is the state row after linearization. valid=False
# means f is outside the model and the slot never linearizes. The
# functions map [..., W] int tensors elementwise.


def cas_register_bitset_slot(f, a, b):
    is_write = f == F_WRITE
    is_cas = f == F_CAS
    dst = torch.where(is_cas, b, a) + 1
    return is_write, a + 1, dst, f == f


def register_bitset_slot(f, a, b):
    return f == F_WRITE, a + 1, a + 1, f != F_CAS


class Model:
    """A named model: python + torch step functions over int32 codes,
    plus the op.f -> f-code mapping used when encoding histories.

    jax_capable keeps the reference's name: False marks models whose
    state does not fit a machine word (e.g. queue multisets), which
    route to the CPU oracle. kernel_id names the model's transition in
    the CUDA kernels (-1: no kernel transition)."""

    def __init__(
        self,
        name: str,
        step_py: Callable,
        step_torch: Optional[Callable],
        f_names: Dict[Any, int],
        jax_capable: bool = True,
        initial: Optional[Callable[[int], Any]] = None,
        crashed_droppable_fs: Tuple[int, ...] = (),
        bitset_slot: Optional[Callable] = None,
        bitset_rows: Optional[Callable[[int], int]] = None,
        kernel_init_code: Optional[Callable[[int], int]] = None,
        packed_variant: Optional[str] = None,
        packed_ok: Optional[Callable] = None,
        state_repr: Optional[Callable] = None,
        kernel_id: int = -1,
    ):
        self.name = name
        self.step_py = step_py
        self.step_torch = step_torch
        self.f_names = f_names
        self.jax_capable = jax_capable
        self._initial = initial
        self.crashed_droppable_fs = frozenset(crashed_droppable_fs)
        self.bitset_slot = bitset_slot
        self._bitset_rows = bitset_rows
        self._kernel_init_code = kernel_init_code
        self.packed_variant = packed_variant
        self.packed_ok = packed_ok
        self._state_repr = state_repr
        self.kernel_id = kernel_id

    def bitset_rows(self, n_value_codes: int) -> int:
        if self._bitset_rows is not None:
            return self._bitset_rows(n_value_codes)
        return n_value_codes + 1

    def initial(self, init_code: int):
        """The model's initial configuration state for an interned
        initial-value code (identity for register-family models)."""
        if self._initial is not None:
            return self._initial(init_code)
        return init_code

    def kernel_init_code(self, init_code: int) -> int:
        """int32 initial state the K-frontier kernels scan from."""
        if self._kernel_init_code is not None:
            return self._kernel_init_code(init_code)
        return init_code

    def state_repr(self, state, dec):
        """Human-readable state for failure reports: ``dec`` maps a
        value CODE back to the original value."""
        if self._state_repr is not None:
            return self._state_repr(state, dec)
        if isinstance(state, int):
            return dec(state)
        return state

    def f_code(self, f) -> int:
        """Model f-code for an op.f, or -1 if the op is outside the model."""
        return self.f_names.get(f, -1)

    def __repr__(self) -> str:
        return f"Model({self.name})"


# -- mutex -------------------------------------------------------------------

F_ACQUIRE, F_RELEASE = 0, 1

MUTEX_F_NAMES: Dict[Any, int] = {
    "acquire": F_ACQUIRE,
    ":acquire": F_ACQUIRE,
    "lock": F_ACQUIRE,
    "release": F_RELEASE,
    ":release": F_RELEASE,
    "unlock": F_RELEASE,
}


def mutex_step_py(state: int, f: int, a: int, b: int) -> Tuple[bool, int]:
    if f == F_ACQUIRE:
        return state == 0, 1
    if f == F_RELEASE:
        return state == 1, 0
    raise ValueError(f"unknown f code {f}")


def mutex_step_torch(state, f, a, b):
    is_acq = f == F_ACQUIRE
    ok = (is_acq & (state == 0)) | (~is_acq & (state == 1))
    # state*0 keeps the frontier axis in the output shape
    state2 = state * 0 + is_acq.to(state.dtype)
    return ok, state2


def mutex_bitset_slot(f, a, b):
    is_acq = f == F_ACQUIRE
    src = torch.where(is_acq, 0, 1) + 1
    dst = torch.where(is_acq, 1, 0) + 1
    return f != f, src, dst, f == f


# -- unordered queue ---------------------------------------------------------

F_ENQ, F_DEQ = 0, 1

QUEUE_F_NAMES: Dict[Any, int] = {
    "enqueue": F_ENQ,
    ":enqueue": F_ENQ,
    "enq": F_ENQ,
    "dequeue": F_DEQ,
    ":dequeue": F_DEQ,
    "deq": F_DEQ,
}


def unordered_queue_step_py(state, f: int, a: int, b: int):
    """State is a multiset of value codes as a sorted tuple. Enqueue
    always succeeds; dequeue succeeds iff the value is present."""
    if f == F_ENQ:
        return True, tuple(sorted(state + (a,)))
    if f == F_DEQ:
        if a in state:
            out = list(state)
            out.remove(a)
            return True, tuple(out)
        return False, state
    raise ValueError(f"unknown f code {f}")


# -- packed unordered queue: the device-capable encoding ---------------------
#
# A bounded multiset over a SMALL value domain packs into one int32 as
# a count vector — 4 bits per value code, codes 0..6 (7 nibbles = 28
# bits, keeping the int32 sign bit clear).

PACKED_QUEUE_MAX_CODES = 7   # nibbles that fit below the sign bit
PACKED_QUEUE_MAX_COUNT = 15  # per-value enqueue bound (one nibble)


def unordered_queue_packed_step_py(state: int, f: int, a: int, b: int):
    if a < 0:
        # NIL value (crashed dequeue with unknown value): never
        # linearizes.
        return False, state
    shift = 4 * a
    if f == F_ENQ:
        return True, state + (1 << shift)
    if f == F_DEQ:
        if (state >> shift) & 15:
            return True, state - (1 << shift)
        return False, state
    raise ValueError(f"unknown f code {f}")


def unordered_queue_packed_step_torch(state, f, a, b):
    nil = a < 0
    shift = 4 * torch.clamp(a, min=0)  # clamp: negative shifts are UB
    cnt = (state >> shift) & 15
    is_enq = f == F_ENQ
    ok = ~nil & (is_enq | ((f == F_DEQ) & (cnt > 0)))
    delta = torch.where(is_enq, 1, -1) << shift
    state2 = torch.where(ok, state + delta, state)
    return ok, state2


def packed_queue_state_repr(state: int, dec):
    """Unpack a count-vector state to {value: count} for reports."""
    out = {}
    for code in range(PACKED_QUEUE_MAX_CODES):
        cnt = (state >> (4 * code)) & 15
        if cnt:
            out[dec(code)] = cnt
    return out


def tuple_queue_state_repr(state, dec):
    return sorted((dec(c) for c in state), key=repr)


def packed_queue_envelope(events) -> bool:
    """True when the stream fits the packed count-vector encoding:
    every value code < PACKED_QUEUE_MAX_CODES and no value enqueued
    more than PACKED_QUEUE_MAX_COUNT times in total."""
    import numpy as np

    from jepsen_tpu_torch.checker import events as ev

    enq = (events.kind == ev.EV_INVOKE) & (events.f == F_ENQ)
    codes = events.a[(events.kind != ev.EV_NOP)]
    if codes.size and int(codes.max()) >= PACKED_QUEUE_MAX_CODES:
        return False
    enq_codes = events.a[enq]
    if enq_codes.size and int(enq_codes.min()) < 0:
        return False
    if enq_codes.size:
        counts = np.bincount(
            enq_codes, minlength=PACKED_QUEUE_MAX_CODES
        )
        if int(counts.max()) > PACKED_QUEUE_MAX_COUNT:
            return False
    return True


#: transition ids shared with csrc/bitset_scan.cu and
#: csrc/kfrontier_scan.cu (keep in sync with their model_step /
#: slot_decode switches)
KERNEL_CAS_REGISTER, KERNEL_REGISTER, KERNEL_MUTEX, KERNEL_PACKED_QUEUE = (
    0, 1, 2, 3,
)

MODELS: Dict[str, Model] = {
    "cas-register": Model(
        "cas-register", cas_register_step_py, cas_register_step_torch,
        F_NAMES, crashed_droppable_fs=(F_READ,),
        bitset_slot=cas_register_bitset_slot,
        kernel_id=KERNEL_CAS_REGISTER,
    ),
    "register": Model(
        "register", register_step_py, register_step_torch, F_NAMES,
        crashed_droppable_fs=(F_READ,),
        bitset_slot=register_bitset_slot,
        kernel_id=KERNEL_REGISTER,
    ),
    "mutex": Model(
        "mutex", mutex_step_py, mutex_step_torch, MUTEX_F_NAMES,
        initial=lambda init_code: 0,
        bitset_slot=mutex_bitset_slot,
        bitset_rows=lambda n: 3,
        kernel_id=KERNEL_MUTEX,
    ),
    "unordered-queue": Model(
        "unordered-queue", unordered_queue_step_py, None, QUEUE_F_NAMES,
        jax_capable=False, initial=lambda init_code: (),
        packed_variant="unordered-queue-packed",
        packed_ok=packed_queue_envelope,
        state_repr=tuple_queue_state_repr,
    ),
    "unordered-queue-packed": Model(
        "unordered-queue-packed", unordered_queue_packed_step_py,
        unordered_queue_packed_step_torch, QUEUE_F_NAMES,
        initial=lambda init_code: 0,
        kernel_init_code=lambda init_code: 0,
        state_repr=packed_queue_state_repr,
        kernel_id=KERNEL_PACKED_QUEUE,
    ),
}


def model(name_or_model) -> Model:
    if isinstance(name_or_model, Model):
        return name_or_model
    m = MODELS.get(name_or_model)
    if m is None:
        raise KeyError(
            f"unknown model {name_or_model!r}; have {sorted(MODELS)}"
        )
    return m
