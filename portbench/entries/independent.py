"""One caller, back to back, through the etcd suite's checker map,
`IndependentChecker(LinearizableChecker(model))`, on the card: one
check of every key of a keyed history. Client ops' values are the
program's [key value] tuples (`independent.KV`), made in set-up; the
nemesis's ops pass as they are. Each check gets a new list of op
dicts, so the program builds a History it has not seen."""

from portbench.core import closed_loop
from portbench.entries._common import around_check, warm_items


def prepare(run):
    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
    from jepsen_tpu_torch.independent import KV, IndependentChecker

    checker = IndependentChecker(LinearizableChecker(
        model=run.cell.config["model"],
        device=None if run.device == "cuda" else run.device))
    inputs = [[dict(o, value=KV(*o["value"]))
               if isinstance(o["process"], int) else o for o in it["ops"]]
              for it in run.items]
    state = {"checker": checker, "inputs": inputs}
    for i in warm_items(run):
        check(state, i)
    return state


def check(state, i) -> dict:
    out = state["checker"].check({}, list(state["inputs"][i]))
    failed = []
    for k, r in out["results"].items():
        bad = r.get("valid?") is False
        failed.append([k, r.get("failed_op_index") if bad else None])
    return {"valid": out["valid?"], "failed": sorted(failed)}


def window(run, state, schedule):
    def call(i):
        with around_check(run):
            return check(state, i)

    return closed_loop(run.seconds, schedule, call)
