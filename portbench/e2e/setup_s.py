"""Process start to the first timed check: imports, the pools, the
program's build and warm-up (compilation in a checkout's first run)."""


def read(run):
    return run.setup_s
