"""Multi-word K-frontier WGL scan in PyTorch ops — the counterpart of
jepsen_tpu.checker.wgl_jax (which has no Pallas kernel, so neither has
this module a hand-written one).

Formulation (just-in-time linearization, tensorized):

- A configuration is (state, mask): the register's value code and a
  multi-word int32 bitset ([NW] words, 32 slots each) of which open ops
  have linearized; masks lift the window limit to 128 slots.
- The frontier is a fixed-size buffer of K configurations with a
  validity mask; set semantics come from all-pairs dedup and a stable
  compaction.
- Each return step runs the closure (rounds of expand -> dedup ->
  prune, to an array fixpoint bounded by W+4 rounds; an unconverged
  exit taints the verdict), then filters to configurations with the
  returning op linearized and clears its bit.
- Dominance pruning: (s, m) dominates (s, m') when their live bits
  agree and m's crashed bits are a subset of m''s.

alive=True is a witness even after overflow; alive=False with overflow
is "unknown", and the ladder in linearizable.py escalates K. This is
the ladder rung used where the single-word kernel's gate (_pallas_ok)
is false and this scan's (_jax_ok) is true. The step loop runs on the
host; each closure round reads one flag back (through _host_get on the
card).
"""

from __future__ import annotations

from typing import Tuple

import torch

from jepsen_tpu_torch.checker.events import ReturnSteps, slot_bit_table
from jepsen_tpu_torch.checker.models import model as get_model
from jepsen_tpu_torch.device import host_value, resolve_device

SENTINEL = 2**31 - 1


def _canonicalize(s, m, v, crashed, K: int):
    """One set-canonicalization pass over [N] candidate rows:
    exact-duplicate kill (lowest row wins), dominance kill against the
    step's [NW] crashed mask, stable compaction of survivors to the
    front, and overflow = any survivor past row K.
    Returns (s[:K], m[:K], v[:K], overflow).

    A kill needs both rows valid, so the all-pairs tests run over the
    valid rows only (in their original order, which keeps "lowest row
    wins"), and the compaction is the stable partition valid-then-
    invalid; word by word, so no [N, N, NW] intermediate is built."""
    vi = torch.nonzero(v).squeeze(1)
    sv, mv = s[vi], m[vi]
    n = vi.shape[0]
    eq = sv[:, None] == sv[None, :]
    meq = torch.ones((n, n), dtype=torch.bool, device=s.device)
    live_eq = torch.ones_like(meq)
    cra_sub = torch.ones_like(meq)
    for w in range(m.shape[1]):
        col, cr = mv[:, w], crashed[w]
        meq &= col[:, None] == col[None, :]
        live = col & ~cr
        live_eq &= live[:, None] == live[None, :]
        cra = col & cr
        cra_sub &= (cra[:, None] & cra[None, :]) == cra[:, None]
    idx = torch.arange(n, device=s.device)
    dup = eq & meq & (idx[:, None] < idx[None, :])
    dom = eq & live_eq & cra_sub & ~meq
    kill = (dup | dom).any(dim=0)
    v = v.clone()
    v[vi[kill]] = False

    order = torch.cat([torch.nonzero(v).squeeze(1),
                       torch.nonzero(~v).squeeze(1)])
    s, m, v = s[order], m[order], v[order]
    overflow = v[K:].any()
    return s[:K], m[:K], v[:K], overflow


def wgl_scan_steps(steps: ReturnSteps, model_name: str, K: int, dev):
    """Scan over precompiled return steps on device dev ->
    (alive, overflow, died_op_index) as Python values. live=False rows
    are padding."""
    step_t = get_model(model_name).step_torch
    W = steps.W
    NW = steps.NW
    bitw = torch.from_numpy(slot_bit_table(W)).to(dev)  # [W, NW]
    occ = torch.from_numpy(steps.occ).to(dev)
    sf = torch.from_numpy(steps.f).to(dev)
    sa = torch.from_numpy(steps.a).to(dev)
    sb = torch.from_numpy(steps.b).to(dev)
    crashed = torch.from_numpy(steps.crashed).to(dev)

    fs = torch.full((K,), SENTINEL, dtype=torch.int32, device=dev)
    fs[0] = int(steps.init_state)
    fm = torch.zeros((K, NW), dtype=torch.int32, device=dev)
    fv = torch.zeros(K, dtype=torch.bool, device=dev)
    fv[0] = True
    overflow = torch.zeros((), dtype=torch.bool, device=dev)

    def closure_round(fs, fm, fv, i):
        lin = ((fm[:, None, :] & bitw[None, :, :]) != 0).any(dim=-1)
        elig = fv[:, None] & occ[i][None, :] & ~lin
        ok, s2 = step_t(fs[:, None], sf[i][None, :], sa[i][None, :],
                        sb[i][None, :])
        cand_v = (elig & ok).reshape(-1)
        cand_s = s2.to(torch.int32).reshape(-1)
        cand_m = (fm[:, None, :] | bitw[None, :, :]).reshape(-1, NW)
        return _canonicalize(
            torch.cat([fs, cand_s]),
            torch.cat([fm, cand_m], dim=0),
            torch.cat([fv, cand_v]),
            crashed[i], K,
        )

    for i in range(len(steps)):
        if not steps.live[i]:
            continue
        changed, r, covf = True, 0, torch.zeros_like(overflow)
        while changed and r <= W + 4:
            nfs, nfm, nfv, ovf2 = closure_round(fs, fm, fv, i)
            changed_t = (
                (nfs != fs).any() | (nfm != fm).any() | (nfv != fv).any()
            )
            fs, fm, fv, covf = nfs, nfm, nfv, covf | ovf2
            changed = bool(host_value(changed_t))
            r += 1
        # exited still changing (round bound hit): taint like overflow
        overflow = overflow | covf | changed
        bitword = bitw[int(steps.slot[i])]
        has = ((fm & bitword[None, :]) != 0).any(dim=-1)
        fm = fm & ~bitword[None, :]
        fv = fv & has
        if not bool(host_value(fv.any())):
            return False, bool(host_value(overflow)), int(steps.op_index[i])
    return True, bool(host_value(overflow)), -1


def check_steps_torch(
    steps: ReturnSteps, model: str = "cas-register", K: int = 64,
    device=None,
) -> Tuple[bool, bool, int]:
    """Run the scan over precompiled return steps:
    (alive, overflow, died_op_index)."""
    dev = resolve_device(device)
    return wgl_scan_steps(
        steps, model if isinstance(model, str) else model.name, K, dev
    )
