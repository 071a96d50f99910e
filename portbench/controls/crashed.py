"""Breaks etcd-keyed's guarantee that a crashed (:info) op may take
effect at any time after its invocation: the cas-register reference
with every crashed op taken as one that never happened."""

from portbench.reference import cas_register


def verdict(item: dict) -> dict:
    return cas_register.judge_ops(item, item["ops"], drop_crashed=True)
