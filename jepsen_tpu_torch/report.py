"""Report + REPL conveniences.

Reference: jepsen/src/jepsen/report.clj (stdout-to-file macro) and
repl.clj (last-test loader) — the small quality-of-life ring around the
store.
"""

from __future__ import annotations

import contextlib
import io
import os
import sys
from typing import Optional, Tuple

from jepsen_tpu_torch.history.history import History
from jepsen_tpu_torch.store import Store


@contextlib.contextmanager
def to_file(test, filename: str):
    """Capture stdout into <run_dir>/<filename> while also echoing it
    (report.clj's to macro)."""
    run_dir = test.get("run_dir") or "."
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, filename)

    class Tee(io.TextIOBase):
        def __init__(self, *streams):
            self.streams = streams

        def write(self, s):
            for st in self.streams:
                st.write(s)
            return len(s)

        def flush(self):
            for st in self.streams:
                st.flush()

    with open(path, "w") as f:
        old = sys.stdout
        sys.stdout = Tee(old, f)
        try:
            yield path
        finally:
            sys.stdout = old


def last_test(
    store_root: str = "store", name: Optional[str] = None
) -> Optional[Tuple[dict, History, Optional[dict]]]:
    """Load the most recent stored run: (test, history, results) —
    repl.clj's last-test, for poking at runs interactively."""
    st = Store(store_root)
    run_dir = st.latest(name)
    if run_dir is None:
        return None
    return (
        st.load_test(run_dir),
        st.load_history(run_dir),
        st.load_results(run_dir),
    )
