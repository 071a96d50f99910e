"""Workload pieces of the port: so far only the checkers that the CLI's
workloads need (the generators and clients are harness, not ported)."""
