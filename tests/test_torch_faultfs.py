"""The port's LD_PRELOAD disk-fault shim (jepsen_tpu_torch.faultfs and
jepsen_tpu_torch/resources/faultfs.cc) against the JAX package's, on
the CPU.

Every case of tests/test_faultfs.py runs against both packages, as one
test parametrised by package: each package's faultfs.cc is built with
g++ once (a module-scoped fixture a package) and injects real EIO,
flaky and cleared faults into live processes, an fd opened before the
flip included (the port's shim built with the port's SHIM_FLAGS). Then
side by side, on the recording DummyRemote: the nemesis's setup, start,
flaky, delay, clear and a targeted subset record the same calls (the
config files piped on stdin included), but for the one departure, the
shim's -U_FORTIFY_SOURCE; and env_for, conf_path and write_config
agree. The departure is pinned: where the compiler defines
_FORTIFY_SOURCE (as Ubuntu's g++ does at -O2), the reference's command
fails to build faultfs.cc and the port's builds it.

Tolerance: exact."""

import errno
import os
import subprocess
from pathlib import Path

import pytest

from jepsen_tpu import faultfs as r_faultfs
from jepsen_tpu.control import core as r_control
from jepsen_tpu.history import ops as r_ops

from jepsen_tpu_torch import faultfs as t_faultfs
from jepsen_tpu_torch.control import core as t_control
from jepsen_tpu_torch.history import ops as t_ops

from test_torch_generator import PKGS, load_cases
from test_torch_nemesis import node_log, recording_remote

TESTS = Path(__file__).resolve().parent

FAULTFS_CASES = {pkg: load_cases(TESTS / "test_faultfs.py", pkg)
                 for pkg in PKGS}
CASE_NAMES = sorted(n for n in vars(FAULTFS_CASES["jepsen_tpu"])
                    if n.startswith("test_"))


def _flaky_until_both(mod):
    """test_shim_flaky_probability, drawing until it has seen both a
    faulted and a clean `cat` (at most 300) rather than a fixed 30. A
    `cat` at probability=50 makes several calls on the file and comes
    out clean only if every one is spared, about 13 times in 100 for
    a g++ 12 build: 30 draws see no clean one about 1.5 % of the
    time, 300 about 10^-18. The assertion is the file's own."""
    def test_shim_flaky_probability(shim):
        mod._conf(shim, mode="flaky", probability=50)
        outcomes = []
        while len(outcomes) < 300 and len(set(outcomes)) < 2:
            outcomes.append(mod._cat(shim).returncode != 0)
        assert any(c for c in outcomes)
        assert any(not c for c in outcomes)
    return test_shim_flaky_probability


for _mod in FAULTFS_CASES.values():
    _mod.test_shim_flaky_probability = _flaky_until_both(_mod)
MODULES = {"jepsen_tpu": r_faultfs, "jepsen_tpu_torch": t_faultfs}
SIDES = {"ref": (r_faultfs, r_control, r_ops),
         "port": (t_faultfs, t_control, t_ops)}


def shim_source(mod):
    return os.path.join(os.path.dirname(mod.__file__), "resources",
                        "faultfs.cc")


@pytest.fixture(scope="module")
def shims(tmp_path_factory):
    """Each package's shim, built from its own resources/faultfs.cc."""
    out = {}
    for pkg, mod in MODULES.items():
        d = tmp_path_factory.mktemp(f"faultfs-{pkg}")
        so = d / "faultfs.so"
        flags = getattr(mod, "SHIM_FLAGS", ("-O2", "-shared", "-fPIC"))
        subprocess.run(
            ["g++", *flags, "-o", str(so), shim_source(mod), "-ldl"],
            check=True,
        )
        data = d / "data"
        data.mkdir()
        (data / "file").write_text("payload\n")
        out[pkg] = {"so": str(so), "data": str(data), "conf": str(d / "conf")}
    return out


def test_the_cases_load_each_package():
    assert len(CASE_NAMES) == 6
    for pkg, mod in FAULTFS_CASES.items():
        assert mod.faultfs is MODULES[pkg]
    assert Path(t_faultfs._RES) == Path(t_faultfs.__file__).parent / \
        "resources"


@pytest.mark.parametrize("case", CASE_NAMES)
@pytest.mark.parametrize("pkg", PKGS)
def test_faultfs_case(pkg, case, shims):
    fn = getattr(FAULTFS_CASES[pkg], case)
    fn(*([shims[pkg]] if "shim" in fn.__code__.co_varnames[
        :fn.__code__.co_argcount] else []))


def _nemesis_run(side):
    faultfs, control, ops = SIDES[side]
    remote = recording_remote(control)
    test = {"nodes": ["n1", "n2", "n3"], "remote": remote}
    nem = faultfs.faultfs_nemesis("/var/lib/db").setup(test)
    outs = []
    for f, v in (("start", None), ("flaky", 5), ("delay", 2500),
                 ("clear", None), ("start", {"n2": None}),
                 ("flaky", {"n1": 40, "n3": None}), ("stop", None)):
        out = nem.invoke(test, ops.invoke_op("nemesis", f, v))
        outs.append((out.type, out.f, out.value))
    nem.teardown(test)
    return outs, node_log(remote, test["nodes"])


def _without_the_departure(result):
    outs, log = result
    return outs, {n: [(k, c.replace(" -U_FORTIFY_SOURCE", ""), u)
                      for k, c, u in calls] for n, calls in log.items()}


def test_nemesis_calls_equal():
    ref, port = _nemesis_run("ref"), _nemesis_run("port")
    assert _without_the_departure(port) == ref
    builds = [c for _, c, _ in port[1]["n1"] if c.startswith("g++")]
    assert builds == ["g++ -O2 -shared -fPIC -U_FORTIFY_SOURCE -o "
                      "/opt/jepsen-tpu/faultfs.so /opt/jepsen-tpu/faultfs.cc "
                      "-ldl"]
    assert port[0][4][2] == {"n2": "fail"}
    n1 = port[1]["n1"]
    assert ("upload", "/opt/jepsen-tpu/faultfs.cc", "faultfs.cc") in n1
    confs = [c for k, c, _ in n1 if k == "stdin"]
    assert "mode=flaky\n" in confs[2] and "probability=5\n" in confs[2]


@pytest.mark.parametrize("prefix", ["/var/lib/db", "/a", "/data/etcd/"])
def test_env_and_conf_paths_equal(prefix):
    assert t_faultfs.env_for(prefix) == r_faultfs.env_for(prefix)
    assert t_faultfs.conf_path(prefix) == r_faultfs.conf_path(prefix)
    assert (t_faultfs.TOOL_DIR, t_faultfs.SO_PATH) == (
        r_faultfs.TOOL_DIR, r_faultfs.SO_PATH)
    seen = {}
    for side, (faultfs, control, _) in SIDES.items():
        remote = recording_remote(control)
        s = control.sessions_for({"nodes": ["n1"], "remote": remote})["n1"]
        faultfs.write_config(s, prefix, mode="fail", err=errno.ENOSPC,
                             probability=7, delay_us=9)
        seen[side] = node_log(remote, ["n1"])
    assert seen["port"] == seen["ref"]


def test_shim_builds_where_the_compiler_fortifies(tmp_path):
    """The departure's pin: _FORTIFY_SOURCE defined ahead of the
    install's flags, as a compiler that fortifies by default does. The
    reference's command fails on faultfs.cc ("inlining failed in call
    to always_inline"); the port's SHIM_FLAGS build it, and the shim
    still injects."""
    def build(flags, name):
        return subprocess.run(
            ["g++", "-D_FORTIFY_SOURCE=3", *flags, "-o",
             str(tmp_path / name), shim_source(t_faultfs), "-ldl"],
            capture_output=True, text=True)

    ref = build(("-O2", "-shared", "-fPIC"), "ref.so")
    assert ref.returncode != 0 and "always_inline" in ref.stderr
    port = build(t_faultfs.SHIM_FLAGS, "port.so")
    assert port.returncode == 0, port.stderr
    data = tmp_path / "data"
    data.mkdir()
    (data / "file").write_text("payload\n")
    shim = {"so": str(tmp_path / "port.so"), "data": str(data),
            "conf": str(tmp_path / "conf")}
    FAULTFS_CASES["jepsen_tpu_torch"].test_shim_injects_and_clears_eio(shim)
