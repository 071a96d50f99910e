"""What the entries share: the warm-up's choice of items, and the
harness's own span around each check in a traced run (a
`torch.profiler` annotation that names the device trace's idle gaps)."""

import contextlib


def warm_items(run):
    """A valid history and a corrupted one: every kernel shape and both
    tiers the window runs."""
    firsts = [0]
    firsts += [i for i, it in enumerate(run.items) if it["corrupt"]][:1]
    return firsts


def around_check(run):
    if not run.trace:
        return contextlib.nullcontext()
    import torch

    from portbench.devtrace import CHECK

    return torch.profiler.record_function(CHECK)
