"""libfaketime wrapper: run a DB binary under a skewed/rate-shifted
clock without touching the system clock.

Reference: jepsen/src/jepsen/faketime.clj:8-31 — moves the real binary
aside and installs a shell wrapper that exec's it under faketime with a
rate multiplier; rate-skewed clocks diverge continuously, which shakes
out lease/timeout logic the one-shot bump can't.

The port's copy of jepsen_tpu.faketime; tests/test_torch_time_faults.py
holds the two against each other.
"""

from __future__ import annotations

from jepsen_tpu_torch.control.core import Session

SCRIPT = """#!/bin/sh
# jepsen-tpu faketime wrapper (reference: jepsen.faketime)
exec faketime -f "{spec}" {real} "$@"
"""


def wrap_binary(
    session: Session,
    binary: str,
    rate: float = 1.0,
    offset_s: float = 0.0,
) -> None:
    """Replace `binary` with a faketime wrapper running the original at
    the given clock rate and initial offset (faketime.clj:8-26)."""
    real = f"{binary}.real"
    # idempotent move-aside
    session.exec(
        "sh", "-c",
        f"test -f {real} || mv {binary} {real}",
        sudo=True,
    )
    sign = "+" if offset_s >= 0 else "-"
    spec = f"{sign}{abs(offset_s):g}s x{rate:g}"
    session.exec(
        "sh", "-c", f"cat > {binary}",
        sudo=True,
        stdin=SCRIPT.format(spec=spec, real=real),
    )
    session.exec("chmod", "+x", binary, sudo=True)


def unwrap_binary(session: Session, binary: str) -> None:
    """Restore the real binary (faketime.clj:28-31)."""
    real = f"{binary}.real"
    session.exec(
        "sh", "-c", f"test -f {real} && mv -f {real} {binary} || true",
        sudo=True,
    )
