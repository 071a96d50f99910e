"""The card's peaks, read from the card, and the roofline arithmetic
(copied from the port's chip_smoke.py `bound()`, so a later change to
the program cannot move the yardstick).

The INT32 rate is the SM count times 64 INT32 lanes per SM per clock
times the card's maximum SM clock; the memory rate is the H100 SXM's
published 3.35 TB/s of HBM3."""

from __future__ import annotations

import subprocess

#: HBM3 bytes per second of one H100 SXM (NVIDIA's data sheet)
HBM_BYTES_S = 3.35e12

#: INT32 operations per SM per clock on Hopper (64 INT32 lanes per SM)
INT32_OPS_PER_SM_CLK = 64


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def card() -> dict:
    """The card's name, power limit, SM count, maximum SM clock and the
    INT32 rate they give."""
    import torch

    props = torch.cuda.get_device_properties(0)
    name_limit = _smi("name,power.limit")
    max_sm_mhz = float(_smi("clocks.max.sm").split()[0])
    return {
        "nvidia_smi": name_limit,
        "sms": props.multi_processor_count,
        "max_sm_mhz": max_sm_mhz,
        "int32_ops_s": (props.multi_processor_count * INT32_OPS_PER_SM_CLK
                        * max_sm_mhz * 1e6),
        "hbm_bytes_s": HBM_BYTES_S,
    }


def least_seconds(ops: float, nbytes: float, card_: dict) -> tuple:
    """(seconds, "operations" | "bytes"): the least time the card needs
    for `ops` INT32 word operations and `nbytes` bytes, whichever bounds
    it."""
    t_ops = ops / card_["int32_ops_s"]
    t_bytes = nbytes / card_["hbm_bytes_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
