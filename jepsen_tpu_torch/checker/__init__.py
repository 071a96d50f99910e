"""Checkers of the port: the linearizability check of one history
(linearizable.py), on the CUDA kernels (csrc/) or their plain PyTorch
versions, and the columnar and transactional checkers beside it.

Re-exports resolve lazily (PEP 562), as in jepsen_tpu.checker:
importing one submodule does not import the others."""

_EXPORTS = {
    "TxnGraphChecker": "jepsen_tpu_torch.checker.txn_graph",
    "fold_txn_graph": "jepsen_tpu_torch.checker.txn_graph",
    "txn_graph_checker": "jepsen_tpu_torch.checker.txn_graph",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        )
    import importlib

    value = getattr(importlib.import_module(mod), name)
    globals()[name] = value  # resolve once per process
    return value
