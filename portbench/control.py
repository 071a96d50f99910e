"""The comparison's control: the plain reference put in the program's
place with one guarantee of the configuration broken, run through the
harness (`core.run_cell`) at a cell's own size and load, so that the
harness's own comparison judges it. Each control breaks a guarantee
that its cell's configuration states:

- `crashed` (the keyed cell): a crashed (:info) op may take effect at
  any time after its invocation; the control takes every crashed op as
  one that never happened (`wgl.check(drop_crashed=True)`).
- `fail-ok` (the single-register cell, whose clean runs crash no op):
  a :fail op never took effect; the control takes every :fail op as
  one that completed :ok.

It needs no card:

    python3 -m portbench.control --workload CELL --seconds S --seeds 1 2 3 \
        [--control crashed|fail-ok]

prints one JSON line a seed, with `correct` and the numbers compared.
The benchmark's runs do not run it."""

from __future__ import annotations

import argparse
import json
import os
import sys

from portbench import core, spec
from portbench.reference import wgl


def _verdict(item: dict, ops, **kw) -> dict:
    """The reference's normalized verdict of `ops` in the item's place
    (reference/judge.py's form)."""
    if item["keyed"]:
        per_key = wgl.check_keyed(ops, **kw)
        return {"valid": wgl.verdict_of(per_key),
                "failed": sorted([k, r["failed_op_index"]]
                                 for k, r in per_key.items())}
    r = wgl.check(ops, **kw)
    return {"valid": r["valid?"], "failed": r["failed_op_index"]}


def control_verdict(item: dict) -> dict:
    return _verdict(item, item["ops"], drop_crashed=True)


def fail_as_ok(ops):
    """A copy of a history in which every client op's :fail completion
    reads :ok (the ops themselves are left as they are)."""
    return [dict(o, type="ok")
            if o["type"] == "fail" and isinstance(o["process"], int) else o
            for o in ops]


def fail_ok_verdict(item: dict) -> dict:
    return _verdict(item, fail_as_ok(item["ops"]))


class ControlEntry:
    """The mix's entry with the control in the program's place: the
    same closed loop over the same schedule of pool items."""

    verdict = staticmethod(control_verdict)

    @staticmethod
    def prepare(run):
        return None

    @classmethod
    def window(cls, run, state, schedule):
        return core.closed_loop(run.seconds, schedule,
                                lambda i: cls.verdict(run.items[i]))


class FailOkEntry(ControlEntry):
    """The control that takes every :fail op as :ok."""

    verdict = staticmethod(fail_ok_verdict)


#: --control's choices
CONTROLS = {"crashed": ControlEntry, "fail-ok": FailOkEntry}


def readings(root: str, workload: str, seed: int, seconds: float,
             processes: int, pkg: str = spec.PKG,
             control: str = "crashed") -> dict:
    res = core.run_cell(root, workload, seed, seconds, False,
                        device="cpu", pkg=pkg, judge_processes=processes,
                        entry=CONTROLS[control])
    return {"workload": workload, "control": control, "seed": seed,
            "correct": res["correct"],
            "attempted": res["attempted"], "checks": res["checks"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", choices=sorted(CONTROLS), default="crashed",
                   help="the guarantee broken (default: crashed)")
    args = p.parse_args(argv)
    core.set_env(os.path.dirname(spec.PKG))
    root = os.path.dirname(spec.PKG)
    procs = max(min((os.cpu_count() or 2) - 1, 8), 1)
    for s in args.seeds:
        print(json.dumps(readings(root, args.workload, s, args.seconds,
                                  procs, control=args.control)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
