"""Graceful-drain signal handling for the checker daemon (a copy of
jepsen_tpu.service.drain).

``serve_forever`` only ever died to KeyboardInterrupt before this
module: a SIGTERM (the orchestrator's polite kill) tore the process
down mid-request. The helper here converts the first SIGTERM/SIGINT
into a *drain*: a callback runs on a side thread (signal handlers run
on the main thread INSIDE serve_forever's poll loop, so calling
``HTTPServer.shutdown()`` directly from the handler would deadlock —
shutdown() blocks until the serve loop exits, and the serve loop
cannot advance while the handler holds the main thread), and a second
signal of the same kind escalates to the previous (default) handler —
a wedged drain never makes the process unkillable.
"""

from __future__ import annotations

import signal
import threading
from typing import Callable, Dict, Iterable, Optional

#: signals a graceful server drains on by default
DEFAULT_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class DrainHandle:
    """Installed-state handle: ``triggered`` flips when the first
    drain signal lands; ``restore()`` reinstates the previous
    handlers (tests install/uninstall repeatedly in one process)."""

    def __init__(self, signals: Iterable[int]):
        self.signals = tuple(signals)
        self.triggered = threading.Event()
        self.signum: Optional[int] = None
        self._previous: Dict[int, object] = {}

    def restore(self) -> None:
        for sig, prev in self._previous.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):  # non-main thread / exotic sig
                pass
        self._previous.clear()


def install_signal_drain(
    on_drain: Callable[[int], None],
    signals: Iterable[int] = DEFAULT_SIGNALS,
) -> DrainHandle:
    """Route the first SIGTERM/SIGINT to ``on_drain(signum)`` on a
    fresh daemon thread; re-raise the SECOND occurrence through the
    previously-installed handler (typically the default: die). Returns
    a DrainHandle; call ``restore()`` when the server is done.

    Must run on the main thread (CPython restricts signal.signal);
    callers embedding a server in a non-main thread (the in-process
    tests) simply skip installation and call the server's drain
    entry directly.
    """
    handle = DrainHandle(signals)

    def _handler(signum, frame):
        if handle.triggered.is_set():
            # Second signal: the operator means it. Restore + re-raise
            # through the original disposition.
            prev = handle._previous.get(signum)
            handle.restore()
            if callable(prev):
                prev(signum, frame)
            else:
                signal.raise_signal(signum)
            return
        handle.signum = signum
        handle.triggered.set()
        # planelint: disable=JT203 reason=the drain thread is launched FROM a signal handler, which must return immediately; serve_forever's shutdown path is the join seam
        threading.Thread(
            target=on_drain, args=(signum,), daemon=True,
            name="graceful-drain",
        ).start()

    for sig in handle.signals:
        handle._previous[sig] = signal.signal(sig, _handler)
    return handle
