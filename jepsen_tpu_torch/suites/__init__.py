"""Per-database test suites.

The analog of the reference's ~27 per-database Leiningen projects
(etcd/, zookeeper/, tidb/, ... — SURVEY.md §2.5). Each suite module
exposes `<name>_test(opts) -> test map` plus, where it has one, a
`main()` wired to the shared CLI, following the canonical 197-line etcd
shape (etcd/src/jepsen/etcd.clj:149-188).

Every `<name>_test(opts)` (and `simple.make_test(suite, opts)`) takes a
``device`` opt: the device its checkers run on, None (the default)
meaning the CUDA card, "cpu" the plain PyTorch versions. Each suite's
`main` takes ``--backend`` as the `cli test` command does.
"""

from jepsen_tpu_torch.suites import (
    aerospike,
    chronos,
    cockroachdb,
    consul,
    crate,
    dgraph,
    elasticsearch,
    etcd,
    faunadb,
    galera,
    hazelcast,
    mongodb,
    percona,
    rabbitmq,
    simple,
    tidb,
    yugabyte,
    zookeeper,
)

__all__ = [
    "aerospike", "chronos", "cockroachdb", "consul", "crate",
    "dgraph", "elasticsearch", "etcd", "faunadb", "galera",
    "hazelcast", "mongodb", "percona", "rabbitmq", "simple", "tidb",
    "yugabyte", "zookeeper",
]
