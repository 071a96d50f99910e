"""The comparison's control: the plain reference put in the program's
place with one guarantee of the configuration broken, run through the
harness (`core.run_cell`) at a cell's own size and load, so that the
harness's own comparison judges it.

Each control is a file of its own, `controls/<name>.py`, with
`verdict(item)` in the form of the configuration's reference and a
docstring that names the guarantee it breaks. A configuration's file
lists the controls that break its guarantees (`"controls"`); a control
it does not list is refused. It needs no card:

    python3 -m portbench.control --workload CELL --control NAME \
        --seconds S --seeds 1 2 3

prints one JSON line a seed, with `correct` and the numbers compared.
The benchmark's runs do not run it."""

from __future__ import annotations

import argparse
import json
import os
import sys

from portbench import core, spec


def load(cell: "spec.Cell", name: str):
    """The control `name` of the cell's configuration."""
    listed = cell.config.get("controls", [])
    if name not in listed:
        raise LookupError(
            f"configuration {cell.config.get('name')!r} of cell "
            f"{cell.name!r} lists the controls {listed}, not {name!r}")
    return spec.load_module(cell.pkg, "controls", name)


class ControlEntry:
    """The mix's entry with a control in the program's place: the same
    closed loop over the same schedule of pool items."""

    def __init__(self, control):
        self.control = control

    def prepare(self, run):
        return None

    def window(self, run, state, schedule):
        return core.closed_loop(
            run.seconds, schedule,
            lambda i: self.control.verdict(run.items[i]))


def readings(root: str, workload: str, seed: int, seconds: float,
             processes: int, control: str, pkg: str = spec.PKG) -> dict:
    entry = ControlEntry(load(spec.load_cell(root, workload, pkg), control))
    res = core.run_cell(root, workload, seed, seconds, False,
                        device="cpu", pkg=pkg, judge_processes=processes,
                        entry=entry)
    return {"workload": workload, "control": control, "seed": seed,
            "correct": res["correct"],
            "attempted": res["attempted"], "checks": res["checks"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--control", required=True,
                   help="the guarantee broken: a control that the cell's "
                        "configuration lists")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    root = os.path.dirname(spec.PKG)
    core.set_env(root)
    try:
        load(spec.load_cell(root, args.workload), args.control)
    except (OSError, LookupError) as e:
        print(f"portbench.control: {e}", file=sys.stderr)
        return 2
    procs = max(min((os.cpu_count() or 2) - 1, 8), 1)
    for s in args.seeds:
        print(json.dumps(readings(root, args.workload, s, args.seconds,
                                  procs, args.control)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
