"""The comparison's control: the plain reference put in the program's
place with one guarantee of the configuration broken, run through the
harness (`core.run_cell`) at a cell's own size and load, so that the
harness's own comparison judges it. The configuration states that a
crashed (:info) op may take effect at any time after its invocation;
the control takes every crashed op as one that never happened
(`wgl.check(drop_crashed=True)`). It needs no card:

    python3 -m portbench.control --workload CELL --seconds S --seeds 1 2 3

prints one JSON line a seed, with `correct` and the numbers compared.
The benchmark's runs do not run it."""

from __future__ import annotations

import argparse
import json
import os
import sys

from portbench import core, spec
from portbench.reference import wgl


def control_verdict(item: dict) -> dict:
    if item["keyed"]:
        per_key = wgl.check_keyed(item["ops"], drop_crashed=True)
        return {"valid": wgl.verdict_of(per_key),
                "failed": sorted([k, r["failed_op_index"]]
                                 for k, r in per_key.items())}
    r = wgl.check(item["ops"], drop_crashed=True)
    return {"valid": r["valid?"], "failed": r["failed_op_index"]}


class ControlEntry:
    """The mix's entry with the control in the program's place: the
    same closed loop over the same schedule of pool items."""

    @staticmethod
    def prepare(run):
        return None

    @staticmethod
    def window(run, state, schedule):
        return core.closed_loop(run.seconds, schedule,
                                lambda i: control_verdict(run.items[i]))


def readings(root: str, workload: str, seed: int, seconds: float,
             processes: int, pkg: str = spec.PKG) -> dict:
    res = core.run_cell(root, workload, seed, seconds, False,
                        device="cpu", pkg=pkg, judge_processes=processes,
                        entry=ControlEntry)
    return {"workload": workload, "seed": seed, "correct": res["correct"],
            "attempted": res["attempted"], "checks": res["checks"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    core.set_env(os.path.dirname(spec.PKG))
    root = os.path.dirname(spec.PKG)
    procs = max(min((os.cpu_count() or 2) - 1, 8), 1)
    for s in args.seeds:
        print(json.dumps(readings(root, args.workload, s, args.seconds,
                                  procs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
