"""Bank workload: transfers between accounts; reads must always sum to
the invariant total.

Reference: jepsen/src/jepsen/tests/bank.clj:20-44 (read + diff-transfer
generator), :179-193 (test bundle: 8 accounts, total 100, max transfer
5). The in-memory BankClient plays the tests.clj atom-db role; its
`snapshot_reads=False` mode reads accounts one at a time WITHOUT the
transfer lock — the classic non-transactional read anomaly — so the
full runtime can produce genuinely invalid histories for differential
tests.
"""

from __future__ import annotations

import random
import threading
import time as _time
from typing import Dict, Optional

from jepsen_tpu_torch.checker.bank import BankChecker
from jepsen_tpu_torch.generator import pure as gen
from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.runtime.client import Client, ClientFailed


def read_op(*_):
    return {"f": "read"}


def transfer_op(rng: random.Random, accounts, max_transfer: int):
    def make():
        a, b = rng.sample(list(accounts), 2)
        return {
            "f": "transfer",
            "value": {
                "from": a,
                "to": b,
                "amount": 1 + rng.randrange(max_transfer),
            },
        }

    return make


def generator(
    accounts=range(8),
    max_transfer: int = 5,
    rng: Optional[random.Random] = None,
):
    """Mix of reads and different-account transfers (bank.clj:20-44)."""
    rng = rng or random.Random()
    return gen.mix(
        [read_op, transfer_op(rng, list(accounts), max_transfer)], rng=rng
    )


class BankClient(Client):
    """In-memory bank. Transfers are always atomic (single lock);
    snapshot_reads=False makes reads scan account-by-account without
    the lock, observing torn totals under concurrency."""

    def __init__(
        self,
        accounts=range(8),
        total: int = 100,
        snapshot_reads: bool = True,
        allow_negative: bool = False,
        _shared=None,
    ):
        self.accounts = list(accounts)
        self.snapshot_reads = snapshot_reads
        self.allow_negative = allow_negative
        if _shared is not None:
            self._lock, self._balances = _shared
        else:
            self._lock = threading.Lock()
            per = total // len(self.accounts)
            self._balances: Dict = {a: per for a in self.accounts}
            self._balances[self.accounts[0]] += total - per * len(
                self.accounts
            )

    def open(self, test, node):
        return BankClient(
            self.accounts,
            snapshot_reads=self.snapshot_reads,
            allow_negative=self.allow_negative,
            _shared=(self._lock, self._balances),
        )

    def invoke(self, test, op: Op) -> Op:
        if op.f == "read":
            if self.snapshot_reads:
                with self._lock:
                    return op.with_(type="ok", value=dict(self._balances))
            out = {}
            for a in self.accounts:  # torn read: no lock, one at a time
                out[a] = self._balances[a]
                _time.sleep(0.001)  # linger mid-scan so transfers land
            return op.with_(type="ok", value=out)
        if op.f == "transfer":
            v = op.value
            with self._lock:
                if (
                    not self.allow_negative
                    and self._balances[v["from"]] < v["amount"]
                ):
                    raise ClientFailed("insufficient funds")
                self._balances[v["from"]] -= v["amount"]
                self._balances[v["to"]] += v["amount"]
            return op.with_(type="ok")
        raise ValueError(f"unknown op {op.f!r}")


def workload(
    accounts=range(8),
    total: int = 100,
    max_transfer: int = 5,
    n_ops: int = 400,
    rng: Optional[random.Random] = None,
    snapshot_reads: bool = True,
    negative_balances: bool = False,
    device=None,
) -> dict:
    """Test-map slots (bank.clj:179-193). ``device`` is the checker's
    (None: the CUDA card)."""
    rng = rng or random.Random(0)
    return {
        "accounts": list(accounts),
        "total_amount": total,
        "max_transfer": max_transfer,
        "client": BankClient(
            accounts, total, snapshot_reads=snapshot_reads
        ),
        "generator": gen.clients(
            gen.limit(n_ops, generator(accounts, max_transfer, rng))
        ),
        "checker": BankChecker(negative_balances=negative_balances,
                               device=device),
    }
