"""The port's presentation layer (codec.py, report.py, web.py and the
`serve` command) against the JAX package's, on the CPU.

Every case of tests/test_web.py, and tests/test_store_cli.py's codec,
report, dashboard and zip-export cases, run on both packages (each
file's source loaded once per package). Over one store written by the
reference, both packages' `render_index` and `render_dir` return the
same HTML, and both codecs the same bytes. Last, `python -m
jepsen_tpu_torch.cli serve` starts on a host with no card (CUDA
hidden) and answers `GET /`. Tolerance: exact."""

import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

from jepsen_tpu import codec as r_codec, independent as r_ind, web as r_web
from jepsen_tpu.history.history import History as RHistory
from jepsen_tpu.history.ops import invoke_op, ok_op
from jepsen_tpu.store import Store as RStore

from jepsen_tpu_torch import codec as t_codec, independent as t_ind
from jepsen_tpu_torch import web as t_web
from jepsen_tpu_torch.store import Store as TStore

from test_torch_generator import PKGS, TESTS, load_cases, restored_run_logs
from test_torch_protocols import expand_cases, run_local_case

REPO = TESTS.parent

WEB_CASES = {pkg: load_cases(TESTS / "test_web.py", pkg) for pkg in PKGS}
STORE_CLI_CASES = {pkg: load_cases(TESTS / "test_store_cli.py", pkg)
                   for pkg in PKGS}
#: test_store_cli.py's cases of the presentation layer (the rest of
#: the file runs in test_torch_cli.py and test_torch_runtime.py)
STORE_CLI_NAMES = ("test_codec_roundtrip", "test_report_helpers",
                   "test_web_dashboard_renders", "test_web_zip_export")
CASES = ([("web", *c) for c in expand_cases(WEB_CASES["jepsen_tpu"])]
         + [("store_cli", n, n, {}) for n in STORE_CLI_NAMES])


@pytest.fixture(autouse=True)
def _restore_run_logs():
    with restored_run_logs():
        yield


def test_the_cases_load_each_package():
    assert len(CASES) == 9
    for pkg in PKGS:
        assert WEB_CASES[pkg].make_server.__module__ == f"{pkg}.web"
        assert STORE_CLI_CASES[pkg].codec.__name__ == f"{pkg}.codec"


@pytest.mark.parametrize("f,cid,name,params", CASES,
                         ids=[f"{f}::{cid}" for f, cid, _, _ in CASES])
@pytest.mark.parametrize("pkg", PKGS)
def test_web_case(pkg, f, cid, name, params, request):
    mods = WEB_CASES if f == "web" else STORE_CLI_CASES
    run_local_case(mods[pkg], name, params, request)


def _reference_store(root):
    """Three runs written by the reference: valid, invalid and one whose
    checker could not decide, the last with a nested directory."""
    st = RStore(root)
    for name, valid in (("good-test", True), ("bad-test", False),
                        ("odd test&", "unknown")):
        h = RHistory([invoke_op(0, "write", 1), ok_op(0, "write", 1)])
        test = {"name": name, "history": h, "start_time": 1700000000.0}
        st.make_run_dir(test)
        st.save_1(test)
        test["results"] = {"valid?": valid}
        st.save_2(test)
        if name.startswith("odd"):
            os.makedirs(os.path.join(test["run_dir"], "n1"))
            with open(os.path.join(test["run_dir"], "n1", "db.log"),
                      "w") as fh:
                fh.write("log\n")
    return st


def test_dashboard_html_equals_the_reference(tmp_path):
    root = str(tmp_path / "store")
    _reference_store(root)
    rst, tst = RStore(root), TStore(root)
    assert t_web.render_index(tst) == r_web.render_index(rst)
    assert t_web.render_index(tst).count("<tr style=") == 3
    rels = [""]
    for name, stamps in sorted(rst.tests().items()):
        for stamp in stamps:
            rels += [os.path.join(name, stamp), os.path.join(name, stamp,
                                                             "n1")]
    rels += ["..", "../..", "missing"]
    for rel in rels:
        assert t_web.render_dir(tst, rel) == r_web.render_dir(rst, rel), rel
    assert t_web.render_dir(tst, "..") is None


def test_codec_bytes_equal_the_reference():
    values = [None, 42, "x", [1, 2], {"a": 1}, (1, 2), {1, 2},
              {0: 10, 1: None}]
    for v in values:
        assert t_codec.encode(v) == r_codec.encode(v), v
        assert t_codec.decode(r_codec.encode(v)) == v
    assert t_codec.encode(t_ind.KV("k", [3, 4])) == \
        r_codec.encode(r_ind.KV("k", [3, 4]))
    assert t_codec.decode(b"") is None


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_serve_answers_without_a_card(tmp_path):
    """`cli serve` in a child with CUDA hidden: it answers GET / with
    the stored runs, then a SIGTERM drains it and it exits 0."""
    root = str(tmp_path / "store")
    _reference_store(root)
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch.cli", "serve",
         "--store", root, "--port", str(port)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    try:
        deadline = time.monotonic() + 60
        body = None
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/", timeout=5) as r:
                    assert r.status == 200
                    body = r.read().decode()
                break
            except OSError:
                time.sleep(0.2)
        assert body is not None, proc.communicate(timeout=10)
        assert "good-test" in body and "bad-test" in body
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=30)
        assert proc.returncode == 0, err[-3000:]
        assert f"on http://127.0.0.1:{port}" in out.decode()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
