"""The port's host utilities (jepsen_tpu_torch.utils) against the JAX
package's, on the CPU.

Every case of tests/test_util.py runs on both packages (the file's
source loaded once per package). The port's `utils` package re-exports
the reference's sixteen names, each the port's own object from
`jepsen_tpu_torch.utils.util`, and the seeded helpers give the same
values as the reference's on the same inputs. Tolerance: exact."""

import random

import pytest

from jepsen_tpu import utils as r_utils
from jepsen_tpu.history.ops import info_op as r_info_op
from jepsen_tpu.utils import util as r_util

from jepsen_tpu_torch import utils as t_utils
from jepsen_tpu_torch.history.ops import info_op as t_info_op
from jepsen_tpu_torch.utils import util as t_util

from test_torch_generator import PKGS, TESTS, load_cases, run_case

UTIL_CASES = {pkg: load_cases(TESTS / "test_util.py", pkg) for pkg in PKGS}
CASE_NAMES = sorted(n for n in vars(UTIL_CASES["jepsen_tpu"])
                    if n.startswith("test_"))


def test_the_cases_load_each_package():
    assert len(CASE_NAMES) == 7
    for pkg, mod in UTIL_CASES.items():
        assert mod.real_pmap.__module__ == f"{pkg}.utils.util"
        assert mod.History.__module__ == f"{pkg}.history.history"


@pytest.mark.parametrize("name", CASE_NAMES)
@pytest.mark.parametrize("pkg", PKGS)
def test_util_case(pkg, name, request):
    run_case(UTIL_CASES[pkg], name, request)


def test_all_equals_the_reference():
    assert t_utils.__all__ == r_utils.__all__
    assert len(t_utils.__all__) == 16


@pytest.mark.parametrize("name", r_utils.__all__)
def test_each_reexport_is_the_ports_own(name):
    obj = getattr(t_utils, name)
    assert obj is getattr(t_util, name)
    assert obj.__module__ == "jepsen_tpu_torch.utils.util"
    assert obj is not getattr(r_utils, name)


def test_seeded_helpers_equal_the_reference():
    """rand_exp on the same seeded stream, longest_common_prefix,
    integer_interval_set_str and nemesis_intervals on the same inputs."""
    r_rng, t_rng = random.Random(3), random.Random(3)
    assert [t_util.rand_exp(2.5, t_rng) for _ in range(200)] == \
        [r_util.rand_exp(2.5, r_rng) for _ in range(200)]
    for seqs in ([], [[1, 2, 3], [1, 2, 4]], [[1], [2]], [[5, 6], [5, 6]],
                 ["abcd", "abxy", "ab"]):
        assert t_util.longest_common_prefix(seqs) == \
            r_util.longest_common_prefix(seqs)
    for xs in ([], [1], [1, 2, 3, 5, 7, 8, 9], [4, 2, 3, 10]):
        assert t_util.integer_interval_set_str(xs) == \
            r_util.integer_interval_set_str(xs)
    fs = ["start", "stop", "start", "start", "stop", "stop", "start"]

    def ops(info_op):
        return [info_op("nemesis", f, None).with_(index=i, time=i)
                for i, f in enumerate(fs)]

    def shape(intervals):
        return [[None if o is None else o.index for o in iv]
                for iv in intervals]

    assert shape(t_util.nemesis_intervals(ops(t_info_op))) == \
        shape(r_util.nemesis_intervals(ops(r_info_op)))


def test_timeout_retry_and_locks():
    """The port's control-flow helpers on their own: timeout's default
    and raise, with_retry's count, fcatch, a named lock per name and a
    relative clock that only moves forward."""
    import time

    assert t_util.timeout(0.05, time.sleep, 1, default="late") == "late"
    with pytest.raises(t_util.JepsenTimeout):
        t_util.timeout(0.05, time.sleep, 1)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("flaky")
        return "ok"

    assert t_util.with_retry(flaky, retries=5, backoff=0.0) == "ok"
    assert len(calls) == 3
    assert isinstance(t_util.fcatch(lambda: 1 / 0)(), ZeroDivisionError)
    locks = t_util.NamedLocks()
    assert locks.lock("a") is locks.lock("a")
    assert locks.lock("a") is not locks.lock("b")
    with locks.locking("a"):
        assert locks.lock("a").locked()
    a = t_util.relative_time_nanos(reset=True)
    assert t_util.relative_time_nanos() >= a >= 0
    assert t_util.bounded_pmap(lambda x: x + 1, range(5), bound=2) == \
        [1, 2, 3, 4, 5]
