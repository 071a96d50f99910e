"""Control plane: remote execution over SSH, with dummy and local
modes.

Reference: jepsen/src/jepsen/control.clj (exec/upload/download, shell
escaping, sudo/cd scoping, retries, the *dummy* stub) and
reconnect.clj (self-healing session wrapper).

The port's copy of jepsen_tpu.control: the sessions (core.py) and the
remote scripting helpers (util.py: daemons, signals, archives).
"""

from jepsen_tpu_torch.control.core import (
    DummyRemote,
    LocalRemote,
    RemoteError,
    Session,
    SshRemote,
    escape,
    on_nodes,
)

__all__ = [
    "DummyRemote",
    "LocalRemote",
    "RemoteError",
    "Session",
    "SshRemote",
    "escape",
    "on_nodes",
]
