"""Workload kits: reusable generator + client + checker bundles.

The port's copy of jepsen_tpu.workloads (itself the analog of the
reference's jepsen.tests.* packages, jepsen/src/jepsen/tests/): each
module exposes a `workload(**opts)` returning a dict of test map slots
to merge into a test spec, plus an in-memory client so the whole stack
runs (and is tested) with zero I/O. The generators and clients are
plain Python; a workload's checker runs on the CUDA card unless its
``device`` says otherwise (the `test` command passes ``--backend``).
"""

from jepsen_tpu_torch.workloads import adya, bank, long_fork, register, set

__all__ = ["adya", "bank", "long_fork", "register", "set"]
