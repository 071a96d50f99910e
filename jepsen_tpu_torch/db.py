"""DB automation: set up / tear down the system under test per node.

Reference: jepsen/src/jepsen/db.clj — DB protocol (:8-10), Primary
(:12-13), LogFiles (:15-16), and cycle! (teardown-everything then
set-up-everything in parallel, retrying the whole cycle up to 3 times
on SetupFailed, :24-67).

The port's copy of jepsen_tpu.db, over the port's control plane.
"""

from __future__ import annotations

from typing import List, Optional

from jepsen_tpu_torch.control.core import Session, on_nodes

CYCLE_TRIES = 3


class SetupFailed(Exception):
    """Raise from setup() to retry the whole teardown/setup cycle."""


class DB:
    """Protocol (db.clj:8-16). Sessions come from the test's control
    plane; override what applies."""

    def setup(self, test, node: str, session: Session) -> None:
        pass

    def teardown(self, test, node: str, session: Session) -> None:
        pass

    def setup_primary(self, test, node: str, session: Session) -> None:
        """One-time setup on the first node; override to opt in."""

    def log_files(self, test, node: str) -> List[str]:
        return []


noop = DB


def cycle(test) -> None:
    """Tear down then set up the DB on all nodes concurrently, retrying
    the whole cycle up to CYCLE_TRIES times on SetupFailed
    (db.clj:24-67). Teardown errors are swallowed (fcatch); the primary
    (first node) gets setup_primary after general setup."""
    db: DB = test["db"]
    tries = CYCLE_TRIES
    while True:
        # A failed previous attempt may have left waiters timing out on
        # the setup barrier; a broken Barrier stays broken until reset.
        barrier = test.get("barrier")
        if barrier is not None:
            try:
                barrier.reset()
            except Exception:
                pass

        def teardown_one(node, sess):
            try:
                db.teardown(test, node, sess)
            except Exception:
                pass

        on_nodes(test, teardown_one)
        try:
            on_nodes(test, lambda n, s: db.setup(test, n, s))
            primary = test["nodes"][0]
            on_nodes(
                test,
                lambda n, s: db.setup_primary(test, n, s),
                [primary],
            )
            return
        except Exception as e:
            root = e.__cause__ or e
            if isinstance(root, SetupFailed) and tries > 1:
                tries -= 1
                continue
            raise


def snarf_logs(test, dest_dir: str) -> None:
    """Download every node's DB log files into dest_dir/<node>/
    (core.clj:98-130's log snarfing)."""
    import os

    from jepsen_tpu_torch.control.core import sessions_for

    db: Optional[DB] = test.get("db")
    if db is None:
        return
    sess = sessions_for(test)
    for node in test.get("nodes", []):
        files = db.log_files(test, node)
        if not files:
            continue
        node_dir = os.path.join(dest_dir, node)
        os.makedirs(node_dir, exist_ok=True)
        for f in files:
            local = os.path.join(node_dir, os.path.basename(f))
            try:
                sess[node].download(f, local)
            except Exception:
                pass  # best-effort, like the shutdown-hook snarf
