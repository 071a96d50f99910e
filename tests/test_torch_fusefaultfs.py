"""The port's mount-level FUSE fault filesystem (jepsen_tpu_torch/
resources/fusefaultfs.cc, built locally by jepsen_tpu_torch.utils.cc,
and the FuseFaultFSNemesis of jepsen_tpu_torch.faultfs), on the CPU.

The mount cases of tests/test_fusefaultfs.py run against the port: the
source is loaded with its imports pointed at jepsen_tpu_torch, so the
binary builds from the port's resources/ into the port's own cache
(build/jepsen_tpu_torch/native/): passthrough, break all and clear,
break write only, a custom errno, the flaky shape, and a statically
linked writer afflicted through the mount.

The reference file's end-to-end nemesis case installs the daemon at
/opt/jepsen-tpu/fusefaultfs and kills every process named fusefaultfs
first (install_fuse's `pkill -x`): two such cases running at once in
parallel test workers would kill each other's mount. So the port's
install_fuse is held to the reference's command lines on the recording
DummyRemote, and the live nemesis runs on a mount of the port's own
binary (install=False, the mode a DB that mounts in its own setup
uses) through a LocalRemote: start breaks every op, clear heals,
teardown clears, fuse_status reads the control file.

Needs root, /dev/fuse and g++, as the reference file does; skips with a
reason elsewhere. Tolerance: exact."""

import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import pytest

from jepsen_tpu import faultfs as r_faultfs
from jepsen_tpu.control import core as r_control
from jepsen_tpu.history import ops as r_ops

from jepsen_tpu_torch import faultfs as t_faultfs
from jepsen_tpu_torch.control import core as t_control
from jepsen_tpu_torch.history import ops as t_ops
from jepsen_tpu_torch.utils import cc

from test_torch_generator import load_cases
from test_torch_nemesis import node_log, recording_remote

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent

FUSE = load_cases(TESTS / "test_fusefaultfs.py", "jepsen_tpu_torch")
MOUNT_CASES = sorted(n for n in vars(FUSE) if n.startswith("test_")
                     and n != "test_nemesis_driver_end_to_end")

pytestmark = pytest.mark.skipif(
    not FUSE._fuse_usable(), reason="no /dev/fuse, not root, or no g++"
)


@pytest.fixture
def mount():
    m = FUSE.Mount()
    try:
        yield m
    finally:
        m.close()


def test_the_cases_load_the_port():
    assert len(MOUNT_CASES) == 6
    assert FUSE.build_exe is cc.build_exe
    assert Path(FUSE._SRC) == (REPO / "jepsen_tpu_torch" / "resources"
                               / "fusefaultfs.cc")
    exe = cc.build_exe(FUSE._SRC, "fusefaultfs")
    assert Path(exe).parent == REPO / "build" / "jepsen_tpu_torch" / "native"


@pytest.mark.parametrize("case", MOUNT_CASES)
def test_fuse_case(case, mount, tmp_path):
    fn = getattr(FUSE, case)
    names = fn.__code__.co_varnames[:fn.__code__.co_argcount]
    fn(**{n: {"mount": mount, "tmp_path": tmp_path}[n] for n in names})


def test_install_fuse_commands_equal():
    seen = {}
    for side, (faultfs, control, ops) in {
            "ref": (r_faultfs, r_control, r_ops),
            "port": (t_faultfs, t_control, t_ops)}.items():
        remote = recording_remote(control, {"cat /m/.faultfs-ctl": (
            0, "classes= \n", "")})
        test = {"nodes": ["n1", "n2"], "remote": remote}
        nem = faultfs.fuse_faultfs_nemesis("/b", "/m").setup(test)
        outs = []
        for f, v in (("start", None), ("flaky", 2.5), ("delay", 700),
                     ("clear", {"n2": None}), ("stop", None)):
            out = nem.invoke(test, ops.invoke_op("nemesis", f, v))
            outs.append((out.type, out.f, out.value))
        nem.teardown(test)
        s = control.sessions_for(test)["n1"]
        status = faultfs.fuse_status(s, "/m")
        faultfs.fuse_unmount(s, "/m")
        seen[side] = (outs, status, node_log(remote, ["n1", "n2"]))
    assert seen["port"] == seen["ref"]
    outs, status, log = seen["port"]
    assert outs[1][2] == {"n1": "flaky all 250", "n2": "flaky all 250"}
    assert status == "classes= \n"
    assert ("upload", "/opt/jepsen-tpu/fusefaultfs.cc",
            "fusefaultfs.cc") in log["n1"]


def test_nemesis_on_a_live_mount():
    from jepsen_tpu_torch.control import LocalRemote
    from jepsen_tpu_torch.control.core import sessions_for
    from jepsen_tpu_torch.history.ops import invoke_op

    exe = cc.build_exe(FUSE._SRC, "fusefaultfs")
    base = tempfile.mkdtemp(prefix="fusefaultfs-port-nem-")
    backing = os.path.join(base, "real")
    mnt = os.path.join(base, "mnt")
    os.makedirs(backing)
    os.makedirs(mnt)
    test = {"nodes": ["n1"], "remote": LocalRemote()}
    sess = sessions_for(test)["n1"]
    # the binary daemonizes once the mount is up
    subprocess.run([exe, backing, mnt], check=True, timeout=30)
    nem = t_faultfs.FuseFaultFSNemesis(backing, mnt, install=False)
    try:
        deadline = time.time() + 5
        while "classes=" not in _status(sess, mnt):
            assert time.time() < deadline, "mount did not come up"
            time.sleep(0.05)
        nem.setup(test)
        p = os.path.join(mnt, "f")
        with open(p, "w") as fh:
            fh.write("ok")
        out = nem.invoke(test, invoke_op(0, "start"))
        assert out.type == "info" and out.value == {"n1": "break all"}
        with pytest.raises(OSError):
            open(p).read()
        out = nem.invoke(test, invoke_op(0, "clear"))
        assert out.value == {"n1": "clear"}
        with open(p) as fh:
            assert fh.read() == "ok"
        nem.invoke(test, invoke_op(0, "start"))
        nem.teardown(test)  # clears
        with open(p) as fh:
            assert fh.read() == "ok"
    finally:
        t_faultfs.fuse_unmount(sess, mnt)
        shutil.rmtree(base, ignore_errors=True)


def _status(sess, mnt):
    try:
        return t_faultfs.fuse_status(sess, mnt)
    except t_control.RemoteError:
        return ""
