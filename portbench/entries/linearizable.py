"""One caller, back to back, through `LinearizableChecker(model)` on the
card: one check of a whole single-register history, with no keyed
split, as a Jepsen run's analysis phase (or `analyze` of a stored run)
hands the checker one history and waits. Each check gets a new list of
op dicts, so the program builds a History it has not seen."""

from portbench.core import closed_loop
from portbench.entries._common import around_check, warm_items


def prepare(run):
    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker

    checker = LinearizableChecker(
        model=run.cell.config["model"],
        device=None if run.device == "cuda" else run.device)
    state = {"checker": checker, "inputs": [it["ops"] for it in run.items]}
    for i in warm_items(run):
        check(state, i)
    return state


def check(state, i) -> dict:
    out = state["checker"].check({}, list(state["inputs"][i]))
    valid = out["valid?"]
    return {"valid": valid,
            "failed": out.get("failed_op_index") if valid is False else None}


def window(run, state, schedule):
    def call(i):
        with around_check(run):
            return check(state, i)

    return closed_loop(run.seconds, schedule, call)
