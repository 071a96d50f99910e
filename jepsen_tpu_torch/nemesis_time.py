"""Clock-fault toolkit: deploy the C++ clock tools and drive them.

Reference: jepsen/src/jepsen/nemesis/time.clj — uploads the C sources
and compiles them with gcc on every node into /opt/jepsen (:14-52); the
clock nemesis handles :reset/:bump/:strobe/:check-offsets and stops
ntpd first (:89-135); randomized fault generators (:137-173). The C++
sources live in jepsen_tpu_torch/resources/ (bump_time.cc, strobe_time.cc),
byte-equal copies of the JAX package's.

The port's copy of jepsen_tpu.nemesis_time;
tests/test_torch_time_faults.py holds the two against each other.
"""

from __future__ import annotations

import os
import random as _random
import time as _time
from typing import Dict, Optional

from jepsen_tpu_torch.control.core import Session, on_nodes
from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.nemesis import Nemesis

TOOL_DIR = "/opt/jepsen-tpu"
_RES = os.path.join(os.path.dirname(__file__), "resources")


def install_tools(session: Session) -> None:
    """Upload + compile the clock tools on a node (time.clj:14-41)."""
    session.exec("mkdir", "-p", TOOL_DIR, sudo=True)
    session.exec("chmod", "777", TOOL_DIR, sudo=True)
    for name in ("bump_time", "strobe_time"):
        src = os.path.join(_RES, f"{name}.cc")
        remote_src = f"{TOOL_DIR}/{name}.cc"
        session.upload(src, remote_src)
        session.exec(
            "g++", "-O2", "-o", f"{TOOL_DIR}/{name}", remote_src,
            sudo=True,
        )


def stop_ntp(session: Session) -> None:
    """NTP would instantly undo our skew (time.clj:54-66)."""
    for svc in ("ntp", "ntpd", "systemd-timesyncd", "chronyd"):
        session.exec("service", svc, "stop", sudo=True, check=False)


def current_offset(session: Session) -> float:
    """Node wall-clock minus local wall-clock, seconds."""
    out = session.exec("date", "+%s.%N")
    try:
        return float(out.strip()) - _time.time()
    except ValueError:
        return 0.0


class ClockNemesis(Nemesis):
    """f-routed clock faults (time.clj:89-135):

    - reset: set every node's clock from the control host's
    - bump: value {node: delta_ms} -> one-shot jumps via bump_time
    - strobe: value {node: {"delta": ms, "period": ms, "duration": s}}
    - check-offsets: report {node: offset_s} (rendered by
      checker.perf.clock_plot)
    """

    def setup(self, test) -> "ClockNemesis":
        def fn(node, sess):
            stop_ntp(sess)
            install_tools(sess)

        on_nodes(test, fn)
        return self

    def invoke(self, test, op: Op) -> Op:
        if op.f == "reset":
            now = int(_time.time())

            def fn(node, sess):
                sess.exec("date", "+%s", "-s", f"@{now}", sudo=True)

            return op.with_(type="info", value=on_nodes(test, fn))
        if op.f == "bump":
            plan: Dict[str, int] = op.value or {}

            def fn(node, sess):
                return sess.exec(
                    f"{TOOL_DIR}/bump_time", str(int(plan[node])),
                    sudo=True,
                ).strip()

            return op.with_(
                type="info", value=on_nodes(test, fn, list(plan))
            )
        if op.f == "strobe":
            plan = op.value or {}

            def fn(node, sess):
                spec = plan[node]
                return sess.exec(
                    f"{TOOL_DIR}/strobe_time",
                    str(int(spec["delta"])),
                    str(int(spec["period"])),
                    str(int(spec["duration"])),
                    sudo=True,
                ).strip()

            return op.with_(
                type="info", value=on_nodes(test, fn, list(plan))
            )
        if op.f == "check-offsets":
            offs = on_nodes(
                test, lambda node, sess: current_offset(sess)
            )
            return op.with_(type="info", value={"clock-offsets": offs})
        raise ValueError(f"clock nemesis can't handle f={op.f!r}")

    def teardown(self, test) -> None:
        now = int(_time.time())

        def fn(node, sess):
            sess.exec("date", "+%s", "-s", f"@{now}", sudo=True,
                      check=False)

        try:
            on_nodes(test, fn)
        except Exception:
            pass


def clock_nemesis() -> ClockNemesis:
    return ClockNemesis()


# -- randomized generators (time.clj:137-173) --------------------------------


def bump_gen(test, rng: Optional[_random.Random] = None,
             max_ms: int = 262144) -> dict:
    """A bump op skewing a random node subset by +/- up to max_ms."""
    rng = rng or _random
    nodes = [n for n in test["nodes"] if rng.random() < 0.5] or [
        rng.choice(test["nodes"])
    ]
    return {
        "f": "bump",
        "value": {
            n: rng.choice([-1, 1]) * rng.randrange(1000, max_ms)
            for n in nodes
        },
    }


def strobe_gen(test, rng: Optional[_random.Random] = None,
               max_delta_ms: int = 262144) -> dict:
    rng = rng or _random
    nodes = [n for n in test["nodes"] if rng.random() < 0.5] or [
        rng.choice(test["nodes"])
    ]
    return {
        "f": "strobe",
        "value": {
            n: {
                "delta": rng.randrange(1000, max_delta_ms),
                "period": rng.randrange(1, 1000),
                "duration": rng.randrange(1, 32),
            }
            for n in nodes
        },
    }


def reset_gen(test, rng=None) -> dict:
    return {"f": "reset"}


def clock_gen(rng: Optional[_random.Random] = None):
    """Mix of reset/bump/strobe/check-offsets ops (time.clj:163-173)."""
    from jepsen_tpu_torch.generator import pure as gen

    r = rng or _random.Random()

    def make(test, ctx):
        which = r.random()
        if which < 0.25:
            o = reset_gen(test, r)
        elif which < 0.5:
            o = bump_gen(test, r)
        elif which < 0.75:
            o = strobe_gen(test, r)
        else:
            o = {"f": "check-offsets"}
        return dict(o)

    return make
