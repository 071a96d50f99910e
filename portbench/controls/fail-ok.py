"""Breaks etcd-register's guarantee that a :fail op never took effect
(its clean runs crash no op, so `crashed` has nothing to break): the
cas-register reference with every client op's :fail completion read as
:ok."""

from portbench.reference import cas_register


def fail_as_ok(ops):
    """A copy of a history in which every client op's :fail completion
    reads :ok (the ops themselves are left as they are)."""
    return [dict(o, type="ok")
            if o["type"] == "fail" and isinstance(o["process"], int) else o
            for o in ops]


def verdict(item: dict) -> dict:
    return cas_register.judge_ops(item, fail_as_ok(item["ops"]))
