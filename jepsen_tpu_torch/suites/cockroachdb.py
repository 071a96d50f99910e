"""CockroachDB suite: the richest nemesis catalog in the reference.

Reference: cockroachdb/src/jepsen/cockroach/ (2,515 LoC) — named
nemesis maps carrying their own :during/:final generators
(nemesis.clj:28-59), pairwise composition routing f through
[name, inner-f] (nemesis.clj:62-105), slowing / restarting wrappers
(nemesis.clj:152-199), five graded clock-skew severities over the
bump-time C tool (nemesis.clj:231-268), a strobe-skew nemesis
(nemesis.clj:201-229), and a range-split nemesis (nemesis.clj:270-316).
Workloads: register / bank / sets / monotonic / g2
(cockroach/{register,bank,sets,monotonic,adya}.clj).

Here a nemesis spec is a dict {name, during, final, client, clocks};
`compose_specs` merges any number of them by prefixing f with
"<name>:" (the tuple-f trick, string-shaped), mixing the during
generators and concatenating the finals — so every pairwise (or wider)
combination from the catalog composes mechanically, exactly what the
reference's test matrix does.

Real mode drives CockroachDB through the `cockroach sql` CLI on the
nodes (the control plane executes statements); dummy mode plugs the
workloads' in-memory clients in, as everywhere else.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Optional

from jepsen_tpu_torch import nemesis as nemlib, net as netlib
from jepsen_tpu_torch import nemesis_time
from jepsen_tpu_torch.control.core import on_nodes, sessions_for
from jepsen_tpu_torch.control.util import (
    grepkill,
    install_archive,
    signal_proc,
    start_daemon,
    stop_daemon,
)
from jepsen_tpu_torch.db import DB
from jepsen_tpu_torch.generator import pure as gen
from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.os import Debian
from jepsen_tpu_torch.runtime.client import Client, ClientFailed

DIR = "/opt/cockroach"
BINARY = f"{DIR}/cockroach"
PIDFILE = f"{DIR}/cockroach.pid"
LOGFILE = f"{DIR}/cockroach.log"
TARBALL = (
    "https://binaries.cockroachdb.com/"
    "cockroach-v2.1.0.linux-amd64.tgz"
)

#: interruption cadence (nemesis.clj:19-23)
NEMESIS_DELAY = 5
NEMESIS_DURATION = 5


class CockroachDB(DB):
    """Install + run cockroach per node (cockroach/auto.clj's role)."""

    def start(self, test, node, session):
        joins = ",".join(f"{n}:26257" for n in test["nodes"])
        start_daemon(
            session,
            BINARY,
            "start",
            "--insecure",
            f"--advertise-host={node}",
            f"--join={joins}",
            f"--store=path={DIR}/data",
            pidfile=PIDFILE,
            logfile=LOGFILE,
            chdir=DIR,
        )

    def kill(self, test, node, session):
        stop_daemon(session, PIDFILE, signal="KILL")

    def setup(self, test, node, session):
        install_archive(session, test.get("tarball", TARBALL), DIR)
        self.start(test, node, session)
        if node == test["nodes"][0]:
            session.exec(
                BINARY, "init", "--insecure", f"--host={node}",
                check=False,
            )

    def teardown(self, test, node, session):
        stop_daemon(session, PIDFILE)
        session.exec("rm", "-rf", f"{DIR}/data", sudo=True, check=False)

    def log_files(self, test, node):
        return [LOGFILE]


class CockroachSqlClient(Client):
    """Base for clients speaking SQL via the cockroach CLI on the node
    (the reference uses JDBC; the control plane is our wire)."""

    def __init__(self, node: Optional[str] = None):
        self.node = node

    def _sql(self, test, stmt: str) -> str:
        sess = sessions_for(test)[self.node]
        return sess.exec(
            BINARY, "sql", "--insecure", f"--host={self.node}",
            "--format=tsv", "-e", stmt,
        )

    @staticmethod
    def _rows(out: str) -> List[List[str]]:
        lines = [ln for ln in out.splitlines() if ln.strip()]
        return [ln.split("\t") for ln in lines[1:]]  # drop header


class SqlRegisterClient(CockroachSqlClient):
    """Keyed CAS registers over SQL (cockroach/register.clj's role):
    kv(id INT PRIMARY KEY, val INT); cas via conditional UPDATE ...
    RETURNING. Reads crash to :fail, mutations to :info."""

    def open(self, test, node):
        return SqlRegisterClient(node)

    def setup(self, test):
        try:
            self._sql(
                test,
                "CREATE TABLE IF NOT EXISTS kv "
                "(id INT PRIMARY KEY, val INT);",
            )
        except Exception:
            pass  # another worker's setup won the race

    def invoke(self, test, op: Op) -> Op:
        from jepsen_tpu_torch import independent

        kv = op.value
        if not isinstance(kv, independent.KV):
            raise ValueError(f"expected KV value, got {kv!r}")
        k, v = int(kv.key), kv.value
        # the split nemesis watches the written keyrange
        test.setdefault("keyrange", set()).add(k)
        try:
            if op.f == "read":
                rows = self._rows(self._sql(
                    test, f"SELECT val FROM kv WHERE id = {k};"
                ))
                val = int(rows[0][0]) if rows else None
                return op.with_(
                    type="ok", value=independent.KV(kv.key, val)
                )
            if op.f == "write":
                self._sql(
                    test,
                    f"UPSERT INTO kv VALUES ({k}, {int(v)});",
                )
                return op.with_(type="ok")
            if op.f == "cas":
                old, new = v
                rows = self._rows(self._sql(
                    test,
                    f"UPDATE kv SET val = {int(new)} WHERE id = {k} "
                    f"AND val = {int(old)} RETURNING val;",
                ))
                return op.with_(type="ok" if rows else "fail")
            raise ValueError(f"unknown op f={op.f!r}")
        except ValueError:
            raise
        except Exception as e:
            if op.f == "read":
                raise ClientFailed(str(e))
            raise  # runtime converts mutations to :info


class SqlBankClient(CockroachSqlClient):
    """Bank transfers in one BEGIN..COMMIT batch
    (cockroach/bank.clj's role)."""

    def __init__(self, node=None, accounts=range(8), total: int = 100):
        super().__init__(node)
        self.accounts = list(accounts)
        self.total = total

    def open(self, test, node):
        return SqlBankClient(node, self.accounts, self.total)

    def setup(self, test):
        per = self.total // len(self.accounts)
        rows = ",".join(f"({a},{per})" for a in self.accounts)
        try:
            self._sql(
                test,
                "CREATE TABLE IF NOT EXISTS accounts "
                "(id INT PRIMARY KEY, balance BIGINT); "
                f"UPSERT INTO accounts VALUES {rows};",
            )
        except Exception:
            pass

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "read":
                rows = self._rows(self._sql(
                    test, "SELECT id, balance FROM accounts;"
                ))
                return op.with_(
                    type="ok",
                    value={int(r[0]): int(r[1]) for r in rows},
                )
            if op.f == "transfer":
                v = op.value
                amt, frm, to = (
                    int(v["amount"]), int(v["from"]), int(v["to"])
                )
                # One guarded statement (Postgres dialect — cockroach
                # has no ROW_COUNT()): debit and credit apply together
                # or not at all, so an insufficient balance can't mint
                # money on the credit side. RETURNING exposes whether
                # the guard matched: zero rows back means the transfer
                # never applied, which must surface as :fail, not :ok
                # (ref marks insufficient-balance transfers :fail).
                out = self._sql(
                    test,
                    "UPDATE accounts SET balance = CASE "
                    f"WHEN id = {frm} THEN balance - {amt} "
                    f"ELSE balance + {amt} END "
                    f"WHERE id IN ({frm}, {to}) AND "
                    f"(SELECT balance FROM accounts WHERE id = {frm}) "
                    f">= {amt} RETURNING id;",
                )
                applied = bool(self._rows(out))
                return op.with_(type="ok" if applied else "fail")
            raise ValueError(f"unknown op f={op.f!r}")
        except ValueError:
            raise
        except Exception as e:
            if op.f == "read":
                raise ClientFailed(str(e))
            raise


# -- nemesis catalog ---------------------------------------------------------


def single_gen(name: Optional[str] = None) -> Dict[str, Any]:
    """start/stop cycle with the standard delays (nemesis.clj:31-37);
    final stops the fault."""
    start = {"f": "start"}
    stop = {"f": "stop"}
    return {
        "during": gen.repeat(lambda: [
            gen.sleep(NEMESIS_DELAY),
            gen.once(dict(start)),
            gen.sleep(NEMESIS_DURATION),
            gen.once(dict(stop)),
        ]),
        "final": gen.once(dict(stop)),
    }


def none_spec(rng=None) -> Dict[str, Any]:
    return {
        "name": "blank",
        "during": None,
        "final": None,
        "client": nemlib.Noop(),
        "clocks": False,
    }


def parts_spec(rng=None) -> Dict[str, Any]:
    return {
        **single_gen(),
        "name": "parts",
        "client": nemlib.partition_random_halves(rng=rng),
        "clocks": False,
    }


def majring_spec(rng=None) -> Dict[str, Any]:
    return {
        **single_gen(),
        "name": "majring",
        "client": nemlib.partition_majorities_ring(rng=rng),
        "clocks": False,
    }


def _take_n_shuffled(n: int, rng):
    r = rng or random.Random()

    def targeter(nodes):
        picked = list(nodes)
        r.shuffle(picked)
        return picked[:n]

    return targeter


def startstop_spec(n: int = 1, rng=None) -> Dict[str, Any]:
    """SIGSTOP/SIGCONT n random nodes (nemesis.clj:127-133)."""
    return {
        **single_gen(),
        "name": f"startstop{n if n > 1 else ''}",
        "client": nemlib.hammer_time(
            "cockroach", targeter=_take_n_shuffled(n, rng)
        ),
        "clocks": False,
    }


def startkill_spec(n: int = 1, rng=None) -> Dict[str, Any]:
    """Kill -9 + restart n random nodes (nemesis.clj:135-142): the
    node-start-stopper runs kill on :start and restart on :stop, like
    the reference's (node-start-stopper targeter kill! start!)."""
    db = CockroachDB()

    def kill_fn(test, node, sess):
        grepkill(sess, "cockroach", signal="KILL")
        return "killed"

    def restart_fn(test, node, sess):
        db.start(test, node, sess)
        return "started"

    return {
        **single_gen(),
        "name": f"startkill{n if n > 1 else ''}",
        "client": nemlib.node_start_stopper(
            _take_n_shuffled(n, rng), kill_fn, restart_fn
        ),
        "clocks": False,
    }


class Slowing(nemlib.Nemesis):
    """Wraps a nemesis: on start, slow the network by dt seconds; on
    stop, restore speeds (nemesis.clj:152-176)."""

    def __init__(self, inner: nemlib.Nemesis, dt_s: float):
        self.inner = inner
        self.dt_s = dt_s

    def _net(self, test):
        return test.get("net") or netlib.NoopNet()

    def setup(self, test):
        self._net(test).fast(test)
        self.inner.setup(test)
        return self

    def invoke(self, test, op: Op) -> Op:
        if op.f == "start":
            self._net(test).slow(test, mean_ms=self.dt_s * 1000)
            return self.inner.invoke(test, op)
        if op.f == "stop":
            try:
                return self.inner.invoke(test, op)
            finally:
                self._net(test).fast(test)
        return self.inner.invoke(test, op)

    def teardown(self, test):
        self._net(test).fast(test)
        self.inner.teardown(test)


class Restarting(nemlib.Nemesis):
    """Wraps a nemesis: after its :stop resolves, restarts the db on
    every node (nemesis.clj:178-199)."""

    def __init__(self, inner: nemlib.Nemesis, db: Optional[DB] = None):
        self.inner = inner
        self.db = db or CockroachDB()

    def setup(self, test):
        self.inner.setup(test)
        return self

    def invoke(self, test, op: Op) -> Op:
        out = self.inner.invoke(test, op)
        if op.f == "stop":

            def fn(node, sess):
                try:
                    self.db.start(test, node, sess)
                    return "started"
                except Exception as e:  # surface, don't crash the run
                    return str(e)

            status = on_nodes(test, fn, test["nodes"])
            return out.with_(value=[out.value, status])
        return out

    def teardown(self, test):
        self.inner.teardown(test)


class BumpTime(nemlib.Nemesis):
    """On start, bump clocks by dt seconds on a random half of the
    nodes via the bump-time C tool; on stop, reset clocks
    (nemesis.clj:231-252)."""

    def __init__(self, dt_s: float, rng=None):
        self.dt_s = dt_s
        self.rng = rng or random.Random()
        self.clock = nemesis_time.clock_nemesis()

    def setup(self, test):
        self.clock.setup(test)
        return self

    def invoke(self, test, op: Op) -> Op:
        if op.f == "start":
            targets = [
                n for n in test["nodes"] if self.rng.random() < 0.5
            ] or [self.rng.choice(test["nodes"])]  # never a no-op cycle
            bump = op.with_(
                f="bump",
                value={n: int(self.dt_s * 1000) for n in targets},
            )
            out = self.clock.invoke(test, bump)
            return op.with_(type="info", value=out.value)
        if op.f == "stop":
            out = self.clock.invoke(test, op.with_(f="reset"))
            return op.with_(type="info", value=out.value)
        return self.clock.invoke(test, op)

    def teardown(self, test):
        self.clock.teardown(test)


class StrobeTime(nemlib.Nemesis):
    """On start, strobe clocks between now and +delta ms flipping every
    period ms for duration seconds (nemesis.clj:201-215)."""

    def __init__(self, delta_ms=200, period_ms=10, duration_s=10):
        self.args = (delta_ms, period_ms, duration_s)
        self.clock = nemesis_time.clock_nemesis()

    def setup(self, test):
        self.clock.setup(test)
        return self

    def invoke(self, test, op: Op) -> Op:
        if op.f == "start":
            d, p, s = self.args
            plan = {
                n: {"delta": d, "period": p, "duration": s}
                for n in test["nodes"]
            }
            out = self.clock.invoke(
                test, op.with_(f="strobe", value=plan)
            )
            return op.with_(type="info", value=out.value)
        if op.f == "stop":
            out = self.clock.invoke(test, op.with_(f="reset"))
            return op.with_(type="info", value=out.value)
        return self.clock.invoke(test, op)

    def teardown(self, test):
        self.clock.teardown(test)


def skew_spec(name: str, dt_s: float, rng=None,
              slowing_s: Optional[float] = None) -> Dict[str, Any]:
    """Graded clock-skew nemesis; big/huge wrap in Slowing so the skew
    lands while the network drags (nemesis.clj:254-268)."""
    client: nemlib.Nemesis = Restarting(BumpTime(dt_s, rng=rng))
    if slowing_s is not None:
        client = Slowing(client, slowing_s)
    return {
        **single_gen(),
        "name": name,
        "client": client,
        "clocks": True,
    }


def small_skews(rng=None):
    return skew_spec("small-skews", 0.100, rng)


def subcritical_skews(rng=None):
    return skew_spec("subcritical-skews", 0.200, rng)


def critical_skews(rng=None):
    return skew_spec("critical-skews", 0.250, rng)


def big_skews(rng=None):
    return skew_spec("big-skews", 0.5, rng, slowing_s=0.5)


def huge_skews(rng=None):
    return skew_spec("huge-skews", 5.0, rng, slowing_s=5.0)


def strobe_skews_spec() -> Dict[str, Any]:
    return {
        "during": gen.repeat(lambda: [
            gen.once({"f": "start"}),
            gen.once({"f": "stop"}),
        ]),
        "final": gen.once({"f": "stop"}),
        "name": "strobe-skews",
        "client": Restarting(StrobeTime()),
        "clocks": True,
    }


class SplitNemesis(nemlib.Nemesis):
    """Range-split just below the most recently written key
    (nemesis.clj:270-316): consults the test's keyrange (maintained by
    set-like clients) and issues ALTER TABLE ... SPLIT AT."""

    def __init__(self, rng=None):
        self.already: set = set()
        self.rng = rng or random.Random()

    def invoke(self, test, op: Op) -> Op:
        keyrange = test.get("keyrange")
        ks = sorted(set(keyrange or ()) - self.already)
        if not ks:
            return op.with_(type="info", value="nothing-to-split")
        k = ks[-1]
        self.already.add(k)
        if test.get("dummy"):
            return op.with_(type="info", value=["split", k])
        node = self.rng.choice(test["nodes"])
        sess = sessions_for(test)[node]
        try:
            sess.exec(
                BINARY, "sql", "--insecure", f"--host={node}", "-e",
                f"ALTER TABLE kv SPLIT AT VALUES ({int(k)});",
            )
            return op.with_(type="info", value=["split", k])
        except Exception as e:
            return op.with_(type="info", value=["split-failed", str(e)])


def split_spec(delay_s: float = 2.0, rng=None) -> Dict[str, Any]:
    return {
        "during": gen.repeat(lambda: [
            gen.sleep(delay_s),
            gen.once({"f": "split"}),
        ]),
        "final": None,
        "name": "splits",
        "client": SplitNemesis(rng=rng),
        "clocks": False,
    }


#: the named catalog, as the reference's test matrix consumes it
NEMESES: Dict[str, Callable[..., Dict[str, Any]]] = {
    "none": none_spec,
    "parts": parts_spec,
    "majority-ring": majring_spec,
    "start-stop": startstop_spec,
    "start-stop-2": lambda rng=None: startstop_spec(2, rng),
    "start-kill": startkill_spec,
    "start-kill-2": lambda rng=None: startkill_spec(2, rng),
    "small-skews": small_skews,
    "subcritical-skews": subcritical_skews,
    "critical-skews": critical_skews,
    "big-skews": big_skews,
    "huge-skews": huge_skews,
    "strobe-skews": lambda rng=None: strobe_skews_spec(),
    "splits": lambda rng=None: split_spec(rng=rng),
}


def compose_specs(specs: List[Dict[str, Any]],
                  rng=None) -> Dict[str, Any]:
    """Merge nemesis specs (nemesis.clj:62-105): route f through
    "<name>:<f>", mix the during generators, concat the finals."""
    specs = [s for s in specs if s is not None]
    names = [s["name"] for s in specs]
    assert len(set(names)) == len(names), f"duplicate names: {names}"
    def route(name):  # generator ops are dicts at this layer
        return lambda o: {**o, "f": f"{name}:{o['f']}"}

    routed = []
    durings = []
    finals = []
    for s in specs:
        name = s["name"]
        fs = {f"{name}:{f}": f for f in ("start", "stop", "split")}
        routed.append((fs, s["client"]))
        if s.get("during") is not None:
            durings.append(gen.gmap(route(name), s["during"]))
        if s.get("final") is not None:
            finals.append(gen.gmap(route(name), s["final"]))
    return {
        "name": "+".join(names),
        "during": gen.mix(durings, rng=rng) if durings else None,
        # a list is a sequential generator: finals run in order
        "final": finals if finals else None,
        "client": nemlib.compose(routed),
        "clocks": any(s.get("clocks") for s in specs),
    }


# -- workloads ---------------------------------------------------------------


def _register_workload(opts):
    from jepsen_tpu_torch.workloads import register

    return register.keyed_workload(
        keys=range(opts.get("keys", 8)),
        per_key_ops=opts.get("per_key_ops", 50),
        rng=opts.get("rng"),
        device=opts.get("device"),
    )


def _bank_workload(opts):
    from jepsen_tpu_torch.workloads import bank

    return bank.workload(
        n_ops=opts.get("ops", 400),
        rng=opts.get("rng"),
        snapshot_reads=not opts.get("broken_reads", False),
        device=opts.get("device"),
    )


def _sets_workload(opts):
    from jepsen_tpu_torch.workloads import set as set_wl

    return set_wl.workload(
        n_adds=opts.get("ops", 400), rng=opts.get("rng")
    )


def _monotonic_workload(opts):
    from jepsen_tpu_torch.workloads import monotonic

    return monotonic.workload(
        n_ops=opts.get("ops", 200),
        skewed=opts.get("skewed", False),
        rng=opts.get("rng"),
    )


def _g2_workload(opts):
    from jepsen_tpu_torch.workloads import adya

    return adya.workload(
        n_keys=opts.get("keys", 20),
        serializable=not opts.get("weak", False),
        device=opts.get("device"),
    )


WORKLOADS: Dict[str, Callable[[dict], dict]] = {
    "register": _register_workload,
    "bank": _bank_workload,
    "sets": _sets_workload,
    "monotonic": _monotonic_workload,
    "g2": _g2_workload,
}


def cockroach_test(opts: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Assemble a test map: workload by name, any composition of named
    nemeses (a list composes pairwise+), CLI-shaped options."""
    opts = dict(opts or {})
    rng = opts.pop("rng", None) or random.Random(opts.pop("seed", 0))
    opts.setdefault("rng", rng)
    dummy = opts.pop("dummy", False)
    workload_name = opts.pop("workload", "register")
    nemesis_names = opts.pop("nemesis", ["none"])
    if isinstance(nemesis_names, str):
        nemesis_names = [nemesis_names]
    time_limit_s = opts.pop("time_limit", None)

    spec = WORKLOADS[workload_name](opts)
    opts.pop("device", None)
    nspec = compose_specs(
        [
            n if isinstance(n, dict) else NEMESES[n](rng=rng)
            for n in nemesis_names
        ],
        rng=rng,
    )
    # Workload generators arrive thread-scoped already (gen.clients /
    # concurrent_generator inside the workload modules) — no rewrap.
    client_gen = spec["generator"]
    parts = [client_gen]
    if nspec["during"] is not None:
        parts.append(gen.nemesis(nspec["during"]))
    generator = gen.any_gen(*parts) if len(parts) > 1 else client_gen
    if time_limit_s:
        generator = gen.time_limit(time_limit_s, generator)
    # Both finals (workload + nemesis) sit OUTSIDE the time limit: a
    # truncated run must still drain/read/heal before analysis.
    finals = []
    if spec.get("final_generator") is not None:
        finals.append(spec["final_generator"])
    if nspec["final"] is not None:
        finals.append(gen.nemesis(nspec["final"]))
    if finals:
        generator = gen.phases(generator, *finals)

    test: Dict[str, Any] = {
        "name": f"cockroachdb-{workload_name}-{nspec['name']}",
        "os": Debian(),
        "db": CockroachDB(),
        "client": spec["client"],
        "net": netlib.IptablesNet(),
        "nemesis": nspec["client"],
        "generator": generator,
        "checker": spec["checker"],
        "dummy": dummy,
    }
    # Real mode swaps SQL clients in where they exist (register, bank);
    # the other workloads keep their in-memory clients — the same
    # tradeoff the tidb suite makes for its non-bank workloads.
    if not dummy:
        if workload_name == "register":
            test["client"] = SqlRegisterClient()
        elif workload_name == "bank":
            test["client"] = SqlBankClient()
    if dummy:
        test["os"] = None
        test["db"] = None
        test["net"] = netlib.MemNet()
        # in-memory clients come with the workload specs already
    for k in ("os", "db"):
        if test.get(k) is None:
            test.pop(k, None)
    test.update(opts)
    test.pop("rng", None)
    return test


def main(argv=None) -> int:
    """Suite entry point (cockroach pattern: workload + nemesis flags).
    """
    import argparse

    from jepsen_tpu_torch.runtime import run
    from jepsen_tpu_torch.suites._backend import (
        EXIT_CRASH, add_backend_arg, backend_device, no_card,
    )

    p = argparse.ArgumentParser(prog="jepsen_tpu_torch.suites.cockroachdb")
    p.add_argument("--nodes", default="n1,n2,n3,n4,n5")
    p.add_argument("--workload", default="register",
                   choices=sorted(WORKLOADS))
    p.add_argument("--nemesis", default="none",
                   help="comma-separated names from the catalog: "
                        + ",".join(sorted(NEMESES)))
    p.add_argument("--time-limit", type=float, default=30.0)
    p.add_argument("--concurrency", type=int, default=10)
    p.add_argument("--dummy", action="store_true")
    p.add_argument("--store", default="store")
    add_backend_arg(p)
    args = p.parse_args(argv)
    device = backend_device(args)
    if no_card(device):  # before any worker or run directory
        return EXIT_CRASH
    test = cockroach_test({
        "device": device,
        "dummy": args.dummy,
        "workload": args.workload,
        "nemesis": [n for n in args.nemesis.split(",") if n],
        "nodes": [n for n in args.nodes.split(",") if n],
        "time_limit": args.time_limit,
    })
    test["concurrency"] = args.concurrency
    test["store"] = args.store
    test = run(test)
    valid = test["results"].get("valid?")
    print(f"valid?={valid}")
    return 0 if valid is True else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
