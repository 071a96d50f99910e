"""Invoked client ops of every history the window checked, over the
time from the window's start to the verdict that closed it."""


def read(run):
    done = [r for r in run.records if r.verdict is not None]
    if not done:
        return None
    end = max(r.t1 for r in run.records)
    ops = sum(run.items[r.item]["invoked"] for r in done)
    return ops / (end - run.t_window0)
