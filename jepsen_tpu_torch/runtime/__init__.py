"""Runtime: orchestrator, workers, and the client protocol.

The host-side core that records histories for the checkers on the
CUDA card: the port's copy of jepsen_tpu.runtime, over the port's Op,
History and Store. Reference: jepsen/src/jepsen/core.clj, client.clj.
"""

from jepsen_tpu_torch.runtime.client import (
    AtomClient,
    AtomRegister,
    Client,
    ClientFailed,
    noop,
)
from jepsen_tpu_torch.runtime.core import (
    ClientWorker,
    NemesisWorker,
    Scheduler,
    run,
)

__all__ = [
    "AtomClient",
    "AtomRegister",
    "Client",
    "ClientFailed",
    "ClientWorker",
    "NemesisWorker",
    "Scheduler",
    "noop",
    "run",
]
