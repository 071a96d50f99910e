"""The port's pure generators (jepsen_tpu_torch.generator, and the
keyed generators of jepsen_tpu_torch.independent) against the JAX
package's, on the CPU.

Every case of tests/test_generator.py runs against both packages, as
one test parametrised by package: the file's source is loaded once per
package, with its imports pointed at that package. Then seeded
compositions (mix, stagger and limit with an rng, phases, each_thread,
reserve, time_limit, process_limit, concurrent_generator) go through
each package's simulate / quick_ops / perfect interpreters, built from
the same random.Random(seed): the op lists must be equal in type,
process, f, value and time. Tolerance: exact."""

import contextlib
import importlib
import inspect
import logging
import random
import re
import types
from pathlib import Path

import pytest

from jepsen_tpu import independent as r_ind
from jepsen_tpu.generator import pure as r_gen

from jepsen_tpu_torch import independent as t_ind
from jepsen_tpu_torch.generator import pure as t_gen

# the packages' __init__ re-export a function named simulate
r_sim = importlib.import_module("jepsen_tpu.generator.simulate")
t_sim = importlib.import_module("jepsen_tpu_torch.generator.simulate")

TESTS = Path(__file__).resolve().parent
PKGS = ("jepsen_tpu", "jepsen_tpu_torch")


def load_cases(path: Path, pkg: str, subs=()) -> types.ModuleType:
    """A test file's module, its imports pointed at ``pkg`` (and each
    (pattern, replacement) of ``subs`` applied for the port)."""
    src = path.read_text()
    if pkg == "jepsen_tpu_torch":
        src = re.sub(r"\bjepsen_tpu\b", "jepsen_tpu_torch", src)
        for pat, rep in subs:
            src = src.replace(pat, rep)
    mod = types.ModuleType(f"_{path.stem}_{pkg}")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


@contextlib.contextmanager
def restored_run_logs():
    """run() with a store hangs a FileHandler on its package's logger
    and sets the logger's level: take both off again on the way out,
    for the tests that share this worker."""
    saved = {}
    for name in PKGS:
        lg = logging.getLogger(name)
        saved[name] = (lg.level, list(lg.handlers))
    try:
        yield
    finally:
        for name, (level, handlers) in saved.items():
            lg = logging.getLogger(name)
            for h in list(lg.handlers):
                if h not in handlers:
                    lg.removeHandler(h)
                    h.close()
            lg.setLevel(level)


def run_case(mod, case: str, request) -> None:
    """Call ``mod.case`` with the fixtures its signature names."""
    fn = getattr(mod, case)
    fn(**{name: request.getfixturevalue(name)
          for name in inspect.signature(fn).parameters})


GEN_CASES = {pkg: load_cases(TESTS / "test_generator.py", pkg)
             for pkg in PKGS}
CASE_NAMES = sorted(n for n in vars(GEN_CASES["jepsen_tpu"])
                    if n.startswith("test_"))


def test_the_cases_load_each_package():
    assert len(CASE_NAMES) == 26
    for pkg, mod in GEN_CASES.items():
        assert mod.gen.__name__ == f"{pkg}.generator"
        assert mod.perfect.__module__ == f"{pkg}.generator.simulate"


@pytest.mark.parametrize("case", CASE_NAMES)
@pytest.mark.parametrize("pkg", PKGS)
def test_generator_case(pkg, case, request):
    run_case(GEN_CASES[pkg], case, request)


# -- seeded compositions through both interpreters ----------------------


NS = {
    "ref": types.SimpleNamespace(gen=r_gen, sim=r_sim, ind=r_ind),
    "port": types.SimpleNamespace(gen=t_gen, sim=t_sim, ind=t_ind),
}


def register_mix(g, rng, n_values=5):
    """The register workload's r/w/cas mix: a dict, a zero-arity and a
    two-arity function (the op lambdas' signature sniffing)."""
    return g.mix([
        {"f": "read"},
        lambda: {"f": "write", "value": rng.randrange(n_values)},
        lambda test, ctx: {
            "f": "cas",
            "value": [rng.randrange(n_values), rng.randrange(n_values)],
        },
    ], rng=rng)


def comp_staggered_mix(ns, rng):
    g = ns.gen
    return g.clients(g.limit(
        60, g.stagger(1e-8, register_mix(g, rng), rng=rng)))


def comp_phases(ns, rng):
    g = ns.gen
    return g.phases(
        g.clients(g.limit(8, register_mix(g, rng))),
        g.each_thread([g.once({"f": "a"}), g.once({"f": "b"})]),
        g.limit(12, g.reserve(1, {"f": "w"}, {"f": "r"})),
        g.synchronize(g.clients(g.limit(
            6, g.stagger(5e-9, register_mix(g, rng), rng=rng)))),
    )


def comp_time_limit(ns, rng):
    g = ns.gen
    return g.time_limit(200e-9, g.clients(
        g.stagger(4e-9, register_mix(g, rng), rng=rng)))


def comp_process_limit(ns, rng):
    g = ns.gen
    return g.clients(g.process_limit(
        6, g.mix([g.once({"value": x}) for x in range(40)], rng=rng)))


def comp_concurrent(ns, rng):
    g = ns.gen
    return ns.ind.concurrent_generator(
        2, list(range(5)),
        lambda k: g.limit(4 + k, register_mix(g, rng)),
    )


def comp_sequential(ns, rng):
    g = ns.gen
    return ns.ind.sequential_generator(
        list(range(3)), lambda k: g.limit(3, register_mix(g, rng)))


COMPOSITIONS = {
    "staggered_mix": comp_staggered_mix,
    "phases": comp_phases,
    "time_limit": comp_time_limit,
    "process_limit": comp_process_limit,
    "concurrent": comp_concurrent,
    "sequential": comp_sequential,
}


def _crash_every_third():
    """A complete_fn that crashes every third op (:info, so the
    process retires) and completes the rest :ok after a latency that
    depends on the op: exercises retirement and reordering."""
    n = {"i": 0}

    def complete(o):
        n["i"] += 1
        kind = "info" if n["i"] % 3 == 0 else "ok"
        return {**o, "type": kind, "time": o["time"] + 7 + n["i"] % 5}

    return complete


def four_threads(g):
    return g.context(
        time=0, free_threads=(0, 1, 2, 3, g.NEMESIS),
        workers={0: 0, 1: 1, 2: 2, 3: 3, g.NEMESIS: g.NEMESIS},
    )


INTERPRETERS = {
    "quick_ops": lambda ns, g, ctx: ns.sim.quick_ops(g, ctx=ctx),
    "perfect": lambda ns, g, ctx: ns.sim.perfect(g, ctx=ctx),
    "perfect_info": lambda ns, g, ctx: ns.sim.perfect_info(g, ctx=ctx),
    "simulate": lambda ns, g, ctx: ns.sim.simulate(
        g, _crash_every_third(), ctx=ctx),
}

KEYS = ("type", "process", "f", "value", "time")


def _ops(ns, comp, interp, seed):
    rng = random.Random(seed)
    g = COMPOSITIONS[comp](ns, rng)
    ctx = four_threads(ns.gen)
    out = INTERPRETERS[interp](ns, g, ctx)
    return [tuple(_plain(o.get(k)) for k in KEYS) for o in out]


def _plain(v):
    """KV values of either package as a plain pair."""
    if type(v).__name__ == "KV":
        return ("KV", v.key, _plain(v.value))
    if isinstance(v, list):
        return [_plain(x) for x in v]
    return v


#: quick_ops cannot block, so it takes no composition that waits (a
#: stagger's or a synchronize's op is PENDING in a zero-latency run)
PAIRS = [(c, i) for c in sorted(COMPOSITIONS) for i in sorted(INTERPRETERS)
         if not (i == "quick_ops" and c in ("time_limit", "phases",
                                            "staggered_mix"))]


@pytest.mark.parametrize("comp,interp", PAIRS)
def test_seeded_compositions_match_the_reference(comp, interp):
    for seed in (0, 14):
        want = _ops(NS["ref"], comp, interp, seed)
        got = _ops(NS["port"], comp, interp, seed)
        assert want, (comp, interp)
        assert got == want, (comp, interp, seed)


def test_the_keyed_generators_wrap_values_in_the_ports_kv():
    ops = t_sim.perfect(comp_concurrent(NS["port"], random.Random(3)),
                        ctx=four_threads(t_gen))
    assert ops and all(isinstance(o["value"], t_ind.KV) for o in ops)
    assert {o["value"].key for o in ops} == set(range(5))


def test_concurrent_generator_rejects_a_ragged_thread_count():
    g = t_ind.concurrent_generator(2, [0, 1], lambda k: t_gen.once({}))
    ctx = t_gen.context(time=0, free_threads=(0, 1, 2, t_gen.NEMESIS),
                        workers={0: 0, 1: 1, 2: 2,
                                 t_gen.NEMESIS: t_gen.NEMESIS})
    with pytest.raises(ValueError, match="multiple of the group size"):
        t_gen.op(g, {}, ctx)
