"""The port's fault layer (jepsen_tpu_torch.net, .nemesis and the
control/util.py helpers under them) against the JAX package's, on the
CPU.

Every case of tests/test_nemesis.py runs against both packages, as one
test parametrised by package (the file's source loaded once per
package; the port's LinearizableChecker takes device="cpu"): the grudge
algebra, the Partitioner on MemNet, compose's routing and f-translation,
the control plane, hammer_time, truncate_file, the iptables shapes, the
timeout wrapper, the clock scrambler, the sleep anchor under the
runtime's scheduler, and the partitioned run invalid beside the healed
run valid. Then the two packages side by side:

- the grudge algebra and the five Partitioner constructors give equal
  grudges for the same node lists and the same random.Random seeds;
- hammer_time, truncate_file, clock_scrambler and the iptables and
  ipfilter nets record equal DummyRemote command lists for the same ops
  (the clock scrambler's target seconds are time-dependent: its lines
  are compared with the digits masked);
- a 250-op partitioned register history recorded by the port's runtime
  (the reference test's shape) is written to JSON lines and loaded by
  each package: the reference's check_events_bucketed(interpret=True,
  race=False) and the port's LinearizableChecker(device="cpu") agree
  on valid? and failed_op_index.

Tolerance: exact."""

import random
import re
from pathlib import Path

import pytest

from jepsen_tpu import nemesis as r_nem
from jepsen_tpu import net as r_net
from jepsen_tpu.control import core as r_control
from jepsen_tpu.history import ops as r_ops

from jepsen_tpu_torch import nemesis as t_nem
from jepsen_tpu_torch import net as t_net
from jepsen_tpu_torch.control import core as t_control
from jepsen_tpu_torch.history import ops as t_ops

from test_torch_generator import PKGS, load_cases, restored_run_logs, run_case

TESTS = Path(__file__).resolve().parent

NEMESIS_CASES = {
    pkg: load_cases(
        TESTS / "test_nemesis.py", pkg,
        subs=[("LinearizableChecker()",
               'LinearizableChecker(device="cpu")')],
    )
    for pkg in PKGS
}
CASE_NAMES = sorted(n for n in vars(NEMESIS_CASES["jepsen_tpu"])
                    if n.startswith("test_"))

SIDES = {
    "ref": (r_nem, r_net, r_control, r_ops),
    "port": (t_nem, t_net, t_control, t_ops),
}
NODES = ["n1", "n2", "n3", "n4", "n5"]


@pytest.fixture(autouse=True)
def _restore_run_logs():
    with restored_run_logs():
        yield


def test_the_cases_load_each_package():
    assert len(CASE_NAMES) == 19
    for pkg, mod in NEMESIS_CASES.items():
        assert mod.nem.__name__ == f"{pkg}.nemesis"
        assert mod.netlib.__name__ == f"{pkg}.net"
        assert mod.majority.__module__ == f"{pkg}.utils.util"


@pytest.mark.parametrize("case", CASE_NAMES)
@pytest.mark.parametrize("pkg", PKGS)
def test_nemesis_case(pkg, case, request):
    run_case(NEMESIS_CASES[pkg], case, request)


# -- the grudge algebra, side by side ----------------------------------------


def _grudge(g):
    return {k: sorted(v) for k, v in g.items()}


@pytest.mark.parametrize("n", [2, 3, 4, 5, 7, 9])
def test_grudge_algebra_equal(n):
    nodes = [f"n{i}" for i in range(1, n + 1)]
    assert t_nem.bisect(nodes) == r_nem.bisect(nodes)
    assert t_nem.split_one(nodes, loner=nodes[-1]) == r_nem.split_one(
        nodes, loner=nodes[-1])
    assert _grudge(t_nem.complete_grudge(t_nem.bisect(nodes))) == _grudge(
        r_nem.complete_grudge(r_nem.bisect(nodes)))
    assert _grudge(t_nem.bridge(nodes)) == _grudge(r_nem.bridge(nodes))
    for seed in range(6):
        assert t_nem.split_one(nodes, rng=random.Random(seed)) == \
            r_nem.split_one(nodes, rng=random.Random(seed))
        if n >= 3:
            assert _grudge(t_nem.majorities_ring(
                nodes, rng=random.Random(seed))) == _grudge(
                r_nem.majorities_ring(nodes, rng=random.Random(seed)))


_PARTITIONERS = {
    "halves": lambda nem, seed: nem.partition_halves(),
    "random_halves": lambda nem, seed: nem.partition_random_halves(
        random.Random(seed)),
    "random_node": lambda nem, seed: nem.partition_random_node(
        random.Random(seed)),
    "majorities_ring": lambda nem, seed: nem.partition_majorities_ring(
        random.Random(seed)),
    "partitioner": lambda nem, seed: nem.partitioner(
        lambda nodes: nem.complete_grudge(nem.split_one(nodes,
                                                        loner=nodes[1]))),
}


@pytest.mark.parametrize("kind", sorted(_PARTITIONERS))
def test_partitioners_cut_the_same_links_on_memnet(kind):
    seen = {}
    for side, (nem, net, _, ops) in SIDES.items():
        mem = net.MemNet()
        test = {"nodes": NODES, "net": mem}
        p = _PARTITIONERS[kind](nem, 7).setup(test)
        trace = []
        for f in ("start", "stop", "start", "start", "stop"):
            out = p.invoke(test, ops.invoke_op("nemesis", f))
            trace.append((out.type, out.f, out.value,
                          sorted(mem.dropped_pairs())))
        p.teardown(test)
        trace.append(sorted(mem.dropped_pairs()))
        seen[side] = trace
    assert seen["port"] == seen["ref"]
    assert any(t[3] for t in seen["port"][:-1])
    assert seen["port"][-1] == []


# -- command lines on the recording DummyRemote, side by side ---------------


def recording_remote(control, responses=None):
    """A DummyRemote of ``control``'s package that also logs each
    command's stdin (ipf rules, config files)."""
    class Recording(control.DummyRemote):
        def connect(self, node):
            return Recording(self.responses, self.log, node)

        def execute(self, cmd, sudo=False, cd=None, stdin=None):
            out = super().execute(cmd, sudo=sudo, cd=cd, stdin=stdin)
            if stdin is not None:
                with self._lock:
                    self.log.append({"node": self.node, "type": "stdin",
                                     "cmd": stdin})
            return out

    return Recording(responses=dict(responses or {}))


def node_log(remote, nodes):
    """Each node's calls in order: commands, stdin, and transfers (an
    upload by its local file's name: each package uploads its own
    copy)."""
    out = {}
    for n in nodes:
        out[n] = [(e["type"], e.get("cmd") or e["remote"],
                   Path(e["local"]).name if "local" in e else None)
                  for e in remote.log if e["node"] == n]
    return out


def _commands(side, build, f_values, nodes=NODES, responses=None):
    nem, net, control, ops = SIDES[side]
    remote = recording_remote(control, responses)
    test = {"nodes": list(nodes), "remote": remote}
    n = build(nem, net, test).setup(test)
    outs = []
    for f, v in f_values:
        out = n.invoke(test, ops.invoke_op("nemesis", f, v))
        outs.append((out.type, out.f, out.value))
    n.teardown(test)
    return outs, node_log(remote, nodes)


def _both(build, f_values, **kw):
    return (_commands("ref", build, f_values, **kw),
            _commands("port", build, f_values, **kw))


def test_hammer_time_commands_equal():
    ref, port = _both(
        lambda nem, net, test: nem.hammer_time(
            "etcd", rng=random.Random(4)),
        [("start", None), ("start", None), ("stop", None),
         ("stop", None), ("start", None), ("stop", None)])
    assert port == ref
    lines = [c for cs in port[1].values() for _, c, _ in cs]
    assert any("killall -s STOP etcd" in c for c in lines)
    assert any("killall -s CONT etcd" in c for c in lines)


def test_compose_of_hammer_time_translates_pause_resume():
    class Frozen(dict):
        def __hash__(self):
            return hash(tuple(sorted(self.items())))

    def build(nem, net, test):
        return nem.compose({
            Frozen({"pause": "start", "resume": "stop"}):
                nem.hammer_time("etcd", targeter=lambda ns: ns[2]),
        })

    ref, port = _both(build, [("pause", None), ("resume", None)])
    assert port == ref
    assert [o[1] for o in port[0]] == ["pause", "resume"]
    assert port[0][0][2] == {"n3": ["paused", "etcd"]}


def test_truncate_file_commands_equal():
    ref, port = _both(
        lambda nem, net, test: nem.truncate_file(),
        [("truncate", {"n2": {"file": "/data/wal", "drop": 64},
                       "n4": {"file": "/data/snap", "drop": 7}})])
    assert port == ref
    assert "truncate -c -s -64 /data/wal" in port[1]["n2"][0][1]


def test_clock_scrambler_commands_equal():
    def mask(result):
        outs, cmds = result
        digits = re.compile(r"\d{6,}")
        return ([(t, f, sorted(v)) for t, f, v in outs],
                {n: [(k, digits.sub("T", c), u) for k, c, u in cs]
                 for n, cs in cmds.items()})

    ref, port = _both(
        lambda nem, net, test: nem.clock_scrambler(60, rng=random.Random(3)),
        [("scramble", None), ("scramble", None)], nodes=["n1"])
    assert mask(port) == mask(ref)
    # one node, one rng: the same offsets drawn in the same order
    r_t, p_t = ref[0][0][2]["n1"], port[0][0][2]["n1"]
    assert abs(p_t - r_t) <= 2


_IP = {"getent": (0, "10.0.0.9 x\n", "")}


@pytest.mark.parametrize("kind", ["IptablesNet", "IpfilterNet"])
def test_net_command_shapes_equal(kind):
    seen = {}
    for side, (nem, net, control, ops) in SIDES.items():
        remote = recording_remote(control, _IP)
        test = {"nodes": NODES, "remote": remote, "net": getattr(net, kind)()}
        raised = []
        net.drop_all(test, {"n1": {"n3", "n4"}, "n5": {"n2"}})
        test["net"].drop(test, "n2", "n3")
        for shape in ("slow", "flaky", "fast"):
            try:  # ipfilter has no tc backend: slow and flaky raise
                getattr(test["net"], shape)(test)
            except NotImplementedError as e:
                raised.append((shape, str(e)))
        net.heal(test)
        seen[side] = (node_log(remote, NODES), raised)
    assert seen["port"] == seen["ref"]
    assert all(seen["port"][0].values())
    assert len(seen["port"][1]) == (2 if kind == "IpfilterNet" else 0)


def test_partitioner_over_iptables_commands_equal():
    def build(nem, net, test):
        test["net"] = net.IptablesNet()
        return nem.partition_random_halves(random.Random(2))

    ref, port = _both(build, [("start", None), ("stop", None)],
                      responses=_IP)
    assert port == ref
    assert port[0][0][2][0] == "isolated"


# -- the partitioned history, recorded by the port, checked by both --------


def test_partitioned_history_checks_as_the_reference(tmp_path):
    """The reference test's shape (tests/test_nemesis.py's
    partition run): the port's runtime records it, both packages load
    the same JSON lines and check them."""
    from jepsen_tpu.checker.events import history_to_events as r_events
    from jepsen_tpu.checker.linearizable import check_events_bucketed
    from jepsen_tpu.store import Store as RStore

    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
    from jepsen_tpu_torch.generator import pure as gen
    from jepsen_tpu_torch.runtime import run
    from jepsen_tpu_torch.store import Store as TStore
    from jepsen_tpu_torch.store import write_history_jsonl
    from jepsen_tpu_torch.workloads.register import (
        ReplicatedRegisterClient,
        op_mix,
    )

    rng = random.Random(11)
    test = run({
        "nodes": ["n1", "n2", "n3", "n4"],
        "net": t_net.MemNet(),
        "client": ReplicatedRegisterClient(latency_s=0.003),
        "nemesis": t_nem.partition_halves(),
        "generator": gen.any_gen(
            gen.clients(gen.limit(250, gen.stagger(
                0.001, op_mix(rng), rng=rng))),
            gen.nemesis(gen.limit(1, gen.stagger(
                0.1, {"f": "start"}, rng=rng)))),
        "checker": LinearizableChecker(device="cpu"),
        "concurrency": 4,
    })
    assert any(o.process == "nemesis" and o.type == "info"
               for o in test["history"].ops)
    write_history_jsonl(str(tmp_path / "history.jsonl"),
                        test["history"].ops)

    port_h = TStore(str(tmp_path)).load_history(str(tmp_path))
    ref_h = RStore(str(tmp_path)).load_history(str(tmp_path))
    port = LinearizableChecker(device="cpu").check(None, port_h)
    ref = check_events_bucketed(r_events(ref_h), interpret=True, race=False)
    assert port["valid?"] is ref["valid?"] is False
    assert port["failed_op_index"] == ref["failed_op_index"]
    assert port["method"] == "gpu-wgl-bitset"
    assert test["results"]["valid?"] is False


# -- a reference fault, kept in both packages ---------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_sleep_under_any_gen_never_anchors_while_a_client_has_an_op(pkg):
    """Pins a fault of the reference's pure generators, which the port
    keeps (ROADMAP queue 3): a Sleep anchors to the context time of the
    poll that commits it, but any_gen commits only the child whose op
    it returns. While a client thread is free, the clients' op is
    always the soonest, so the nemesis's sleep is re-anchored at every
    poll and its op never comes due: the nemesis waits for the clients
    to exhaust. (chip_smoke.py's fault_partition gives its nemesis ops
    their own times instead.)"""
    gen = NEMESIS_CASES[pkg].gen
    g = gen.any_gen(
        gen.clients(gen.limit(1000, {"f": "read"})),
        gen.nemesis([gen.sleep(0.1), gen.once({"f": "start"})]))
    ctx = gen.context(time=0, free_threads=(0, 1, "nemesis"),
                      workers={0: 0, 1: 1, "nemesis": "nemesis"})
    fs = []
    for step in range(400):  # 400 polls 1 ms apart: 0.4 s
        ctx["time"] = step * 1_000_000
        o, g = gen.op(g, {}, ctx)
        fs.append(o["f"])
    assert fs == ["read"] * 400
    # with no client op left, the nemesis's sleep anchors and runs out
    g = gen.any_gen(gen.clients(None),
                    gen.nemesis([gen.sleep(0.1), gen.once({"f": "start"})]))
    seen = []
    for step in range(200):
        ctx["time"] = step * 1_000_000
        pair = gen.op(g, {}, ctx)
        if pair is None:
            break
        o, g = pair
        seen.append(o if o is gen.PENDING else o["f"])
        if o is not gen.PENDING:
            break
    assert seen[-1] == "start" and len(seen) == 101
