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

wgl_scan_keys is the key-batched scan (the counterpart of
jepsen_tpu.checker.sharded._vmap_scan, a jax.vmap of wgl_scan_steps):
the same algorithm over an explicit leading key axis, every key
stepping together, a key's closure rounds stopping when it alone has
converged, as a vmapped while loop stops each batch element.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
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


def _canonicalize_keys(s, m, v, crashed, K: int):
    """_canonicalize over a leading key axis: s [B, N], m [B, N, NW],
    v [B, N], crashed [B, NW]. The all-pairs tests run over the first
    nv rows of each key's valid-first stable order, nv the most valid
    rows of any key (read to the host), with rows a key does not hold
    masked out, so each key's kills, order and overflow are exactly
    _canonicalize's."""
    B, N, NW = m.shape
    order = torch.argsort((~v).to(torch.int8), dim=1, stable=True)
    nv = int(host_value(v.sum(dim=1).max()))
    idx = order[:, :nv]
    sv = s.gather(1, idx)
    mv = m.gather(1, idx[:, :, None].expand(B, nv, NW))
    vv = v.gather(1, idx)
    eq = sv[:, :, None] == sv[:, None, :]
    meq = torch.ones((B, nv, nv), dtype=torch.bool, device=s.device)
    live_eq = torch.ones_like(meq)
    cra_sub = torch.ones_like(meq)
    for w in range(NW):
        col, cr = mv[:, :, w], crashed[:, w, None]
        meq &= col[:, :, None] == col[:, None, :]
        live = col & ~cr
        live_eq &= live[:, :, None] == live[:, None, :]
        cra = col & cr
        cra_sub &= (cra[:, :, None] & cra[:, None, :]) == cra[:, :, None]
    ar = torch.arange(nv, device=s.device)
    dup = eq & meq & (ar[:, None] < ar[None, :])
    dom = eq & live_eq & cra_sub & ~meq
    both = vv[:, :, None] & vv[:, None, :]
    kill = (both & (dup | dom)).any(dim=1)
    v = v.scatter(1, idx, vv & ~kill)

    order = torch.argsort((~v).to(torch.int8), dim=1, stable=True)
    s = s.gather(1, order)
    m = m.gather(1, order[:, :, None].expand(B, N, NW))
    v = v.gather(1, order)
    return s[:, :K], m[:, :K], v[:, :K], v[:, K:].any(dim=1)


def wgl_scan_keys(cols, model_name: str, K: int, dev):
    """Key-batched scan over stacked per-key steps: cols are the host
    arrays of sharded.stack_streams (occ/f/a/b [B, n, W], slot, live,
    op_index [B, n], crashed [B, n, NW], init_state [B] as kernel codes)
    -> (alive, overflow, died_op_index), int32 [B] tensors on dev.
    Per key the same verdict as wgl_scan_steps on that key's steps; a
    blank key (no live steps) is alive with no overflow."""
    occ, sf, sa, sb, slot, live, crashed, opidx, init_state = cols
    step_t = get_model(model_name).step_torch
    B, n, W = occ.shape
    NW = crashed.shape[-1]
    bitw = torch.from_numpy(slot_bit_table(W)).to(dev)  # [W, NW]
    occ_t, sf_t, sa_t, sb_t, cr_t = (
        torch.from_numpy(x).to(dev) for x in (occ, sf, sa, sb, crashed)
    )
    slot_t = torch.from_numpy(slot.astype(np.int64)).to(dev)
    live_t = torch.from_numpy(live).to(dev)
    opidx_t = torch.from_numpy(opidx).to(dev)

    fs = torch.full((B, K), SENTINEL, dtype=torch.int32, device=dev)
    fs[:, 0] = torch.from_numpy(init_state).to(dev)
    fm = torch.zeros((B, K, NW), dtype=torch.int32, device=dev)
    fv = torch.zeros((B, K), dtype=torch.bool, device=dev)
    fv[:, 0] = True
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    overflow = torch.zeros(B, dtype=torch.bool, device=dev)
    died = torch.full((B,), -1, dtype=torch.int32, device=dev)

    def closure_round(fs, fm, fv, i):
        lin = ((fm[:, :, None, :] & bitw) != 0).any(dim=-1)  # [B, K, W]
        elig = fv[:, :, None] & occ_t[:, i, None, :] & ~lin
        ok, s2 = step_t(fs[:, :, None], sf_t[:, i, None, :],
                        sa_t[:, i, None, :], sb_t[:, i, None, :])
        return _canonicalize_keys(
            torch.cat([fs, s2.to(torch.int32).reshape(B, -1)], dim=1),
            torch.cat([fm, (fm[:, :, None, :] | bitw).reshape(B, -1, NW)],
                      dim=1),
            torch.cat([fv, (elig & ok).reshape(B, -1)], dim=1),
            cr_t[:, i], K,
        )

    for i in range(n):
        if not live[:, i].any():
            continue
        stepping = alive & live_t[:, i]
        changed, covf, r = stepping, torch.zeros_like(overflow), 0
        # a key runs round r while its own last round changed its
        # frontier, up to W+4 rounds (wgl_scan_steps' loop, per key)
        while r <= W + 4 and bool(host_value(changed.any())):
            nfs, nfm, nfv, ovf2 = closure_round(fs, fm, fv, i)
            diff = ((nfs != fs).any(dim=1) | (nfm != fm).any(dim=(1, 2))
                    | (nfv != fv).any(dim=1))
            fs = torch.where(changed[:, None], nfs, fs)
            fm = torch.where(changed[:, None, None], nfm, fm)
            fv = torch.where(changed[:, None], nfv, fv)
            covf = covf | (changed & ovf2)
            changed = changed & diff
            r += 1
        # exited still changing (round bound hit): taint like overflow
        overflow = overflow | (stepping & (covf | changed))
        bitword = bitw[slot_t[:, i]]  # [B, NW]
        has = ((fm & bitword[:, None, :]) != 0).any(dim=-1)
        fm = torch.where(stepping[:, None, None],
                         fm & ~bitword[:, None, :], fm)
        fv = torch.where(stepping[:, None], fv & has, fv)
        now_dead = stepping & ~fv.any(dim=1)
        died = torch.where(now_dead & (died < 0), opidx_t[:, i], died)
        alive = alive & ~now_dead
    return alive.to(torch.int32), overflow.to(torch.int32), died
