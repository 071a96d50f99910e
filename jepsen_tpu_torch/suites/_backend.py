"""The suites' ``--backend`` flag: the device their checkers run on.

A departure from the JAX package's suites, whose checkers pick their
device themselves: the port's run on the CUDA card unless
``--backend cpu`` asks for the CPU, as the `cli test` command's do.
Without a card (and without ``--backend cpu``) a suite's `main` exits
254 before any worker starts or any run directory is made."""

from __future__ import annotations

import sys
from typing import Optional

EXIT_CRASH = 254


def add_backend_arg(p) -> None:
    p.add_argument("--backend", choices=("cpu", "cuda"), default=None,
                   help="device the check runs on (default: the CUDA "
                        "card; cpu runs the plain PyTorch versions)")


def backend_device(args) -> Optional[str]:
    """"cpu" for --backend cpu, else None (the CUDA card)."""
    return "cpu" if args.backend == "cpu" else None


def no_card(device) -> bool:
    """True, after saying why on stderr, when ``device`` needs a CUDA
    card this host lacks."""
    from jepsen_tpu_torch.device import resolve_device

    try:
        resolve_device(device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return True
    return False
