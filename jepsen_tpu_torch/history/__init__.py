"""History model: operations and histories (copies of jepsen_tpu.history)."""

from jepsen_tpu_torch.history.history import History
from jepsen_tpu_torch.history.ops import (
    FAIL,
    INFO,
    INVOKE,
    OK,
    TYPES,
    Op,
    fail_op,
    info_op,
    invoke_op,
    ok_op,
)

__all__ = [
    "Op",
    "INVOKE",
    "OK",
    "FAIL",
    "INFO",
    "TYPES",
    "invoke_op",
    "ok_op",
    "fail_op",
    "info_op",
    "History",
]
