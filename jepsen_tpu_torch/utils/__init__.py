"""Host-side helpers (the port of jepsen_tpu.utils): stdlib only, so
importing the package pulls in neither torch nor jax."""

from jepsen_tpu_torch.utils.util import (
    JepsenTimeout,
    majority,
    minority,
    real_pmap,
    bounded_pmap,
    timeout,
    retry,
    with_retry,
    relative_time_nanos,
    RelativeTime,
    nemesis_intervals,
    longest_common_prefix,
    fcatch,
    integer_interval_set_str,
    rand_exp,
    NamedLocks,
)

__all__ = [
    "JepsenTimeout",
    "majority",
    "minority",
    "real_pmap",
    "bounded_pmap",
    "timeout",
    "retry",
    "with_retry",
    "relative_time_nanos",
    "RelativeTime",
    "nemesis_intervals",
    "longest_common_prefix",
    "fcatch",
    "integer_interval_set_str",
    "rand_exp",
    "NamedLocks",
]
