"""The pure geometry of the port's two CUDA kernels, on the CPU.

Kernel A (csrc/bitset_scan.cu) lays one key's [S, M] frontier over a
block: each lane of each warp owns some mask-word columns of every row
(wgl_bitset.geometry). These tests hold that layout to what the kernel
relies on:

- every mask word has exactly one owner, for every (W, S) that plan()
  admits and every store that fits it;
- each slot's exchange class (within the word, with another lane,
  between a thread's columns, with another warp) agrees with a
  brute-force reading of _add_bit's partner word;
- registers a thread and shared memory a block stay under the card's
  limits (255 registers, 232,448 bytes);
- the geometries geometry() picks are the ones the .cu instantiates.

Kernel B (csrc/kfrontier_scan.cu) ranks candidates by warp ballots over
a compacted live table (wgl_kfrontier.candidate_ranks); on random
tables the ranks follow the reference's w-major, then k, order, and
the free slots' ranks match the reference's exclusive scan.

Tolerance: exact equality (integer arithmetic)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from jepsen_tpu_torch.checker import models
from jepsen_tpu_torch.checker import wgl_bitset as bs
from jepsen_tpu_torch.checker import wgl_kfrontier as kf

ROWS = (8, 16, 24, 32)


def _admitted():
    """(W, S) pairs plan() admits for the cas-register model, S being
    every row bucket up to MAX_ROWS."""
    m = models.model("cas-register")
    out = []
    for W in bs.W_BUCKETS:
        for S in ROWS:
            # value codes giving S state rows after the bucket
            got = bs.plan(m, W, S - 1)
            if got is not None:
                out.append(got)
    return sorted(set(out))


ADMITTED = _admitted()


def _geometries():
    out = []
    for W, S in ADMITTED:
        for placement in (None,) + bs.STORES:
            try:
                out.append((W, S, placement, bs.geometry(W, S, placement)))
            except ValueError:
                pass
    return out


GEOMETRIES = _geometries()


def test_plan_admits_the_main_path_shapes():
    assert (12, 8) in ADMITTED and (16, 8) in ADMITTED
    assert all(W in bs.W_BUCKETS and S <= bs.MAX_ROWS for W, S in ADMITTED)
    # every admitted shape has a geometry with no placement asked
    for W, S in ADMITTED:
        assert bs.geometry(W, S).M == bs.bitset_words(W)


@pytest.mark.parametrize(
    "W,S,placement,geo", GEOMETRIES,
    ids=[f"W{w}-S{s}-{p}" for w, s, p, _ in GEOMETRIES])
def test_every_mask_word_has_one_owner(W, S, placement, geo):
    M = bs.bitset_words(W)
    assert geo.M == M and 32 * geo.warps * geo.cols == M
    seen = np.zeros(M, np.int64)
    for warp in range(geo.warps):
        for lane in range(32):
            for col in range(geo.cols):
                j = geo.word(warp, lane, col)
                assert 0 <= j < M
                assert geo.owner(j) == (warp, lane, col)
                seen[j] += 1
    assert (seen == 1).all()


def _pairs(w: int, M: int):
    """(j0, j1) for every word j1 that _add_bit(., w) fills from word
    j0: a row holding j + 1 in word j shows where each word goes (for
    w >= 5 the words move whole); for w < 5 a word of all ones shows
    which words it reaches (a sample of 256 words at large M)."""
    if w >= 5:
        moved = bs._add_bit(torch.arange(1, M + 1, dtype=torch.int32), w)
        return [(int(moved[j1]) - 1, j1)
                for j1 in torch.nonzero(moved).flatten().tolist()]
    out = []
    for j0 in range(0, M, max(1, M // 256)):
        row = torch.zeros(M, dtype=torch.int32)
        row[j0] = -1
        out += [(j0, j1) for j1 in
                torch.nonzero(bs._add_bit(row, w)).flatten().tolist()]
    return out


@pytest.mark.parametrize("W,S", [(12, 8), (13, 8), (14, 8), (16, 8),
                                 (16, 16), (17, 8), (19, 32)])
def test_slot_classes_agree_with_add_bit(W, S):
    M = bs.bitset_words(W)
    pairs = {w: _pairs(w, M) for w in range(W)}
    for placement in bs.STORES:
        try:
            geo = bs.geometry(W, S, placement)
        except ValueError:
            continue
        for w in range(W):
            kinds = set()
            assert len(pairs[w]) == (min(M, 256) if w < 5 else M // 2)
            for j0, j1 in pairs[w]:
                a, b = geo.owner(j0), geo.owner(j1)
                if j1 == j0:
                    kinds.add("word")
                elif a[:2] == b[:2]:
                    kinds.add("column")
                elif a[0] == b[0]:
                    kinds.add("lane")
                else:
                    kinds.add("warp")
            assert kinds == {geo.slot_class(w)}, (W, S, placement, w, kinds)


def test_slot_class_boundaries():
    order = ["word", "lane", "column", "warp"]
    for W, S, placement, geo in GEOMETRIES:
        classes = [geo.slot_class(w) for w in range(W)]
        # w < 5 within the word, 5..9 across lanes, then the thread's
        # columns, then warps; classes never interleave
        assert classes[:5] == ["word"] * 5
        assert classes[5:10] == ["lane"] * min(5, W - 5)
        assert [order.index(c) for c in classes] == sorted(
            order.index(c) for c in classes)
        n_col = sum(c == "column" for c in classes)
        assert n_col == min(geo.cbits, max(W - 10, 0))
        if geo.warps == 1:
            assert "warp" not in classes
        assert {w for w in range(W) if classes[w] == "warp"} == {
            w for w in range(10 + geo.cbits, W)}


@pytest.mark.parametrize(
    "W,S,placement,geo", GEOMETRIES,
    ids=[f"W{w}-S{s}-{p}" for w, s, p, _ in GEOMETRIES])
def test_geometry_within_card_limits(W, S, placement, geo):
    assert geo.registers <= 255
    assert geo.smem_bytes <= 232_448
    assert geo.smem_bytes == 4 * bs.smem_words(W, S, geo.M, geo.store,
                                               geo.warps)
    # the instance's __launch_bounds__, and the registers it leaves
    assert geo.warps <= bs.max_warps(geo.store, S, geo.cols)
    assert geo.registers <= bs.register_cap(geo.store, S, geo.cols)
    assert placement is None or geo.store == placement


def test_instances_match_the_cuda_source():
    src = (Path(bs.__file__).parents[1] / "csrc" / "bitset_scan.cu").read_text()
    block = src[src.index("#define BITSET_INSTANCES"):]
    block = block[:block.index("\n\n")]
    got = tuple(tuple(int(x) for x in m)
                for m in re.findall(r"X\((\d+), (\d+), (\d+)\)", block))
    assert got == bs.INSTANCES
    for W, S, placement, geo in GEOMETRIES:
        assert bs._instantiated(geo.store, S, geo.cols)


def test_shared_store_is_refused_when_it_does_not_fit():
    with pytest.raises(ValueError):
        bs.geometry(19, 32, "shared")
    with pytest.raises(ValueError):
        bs.geometry(12, 8, "nowhere")
    assert bs.geometry(19, 32).store == "global"


def _reference_ranks(fv, occ, new):
    """wgl_pallas.py:192-195: candidates flattened w-major then k over
    [W, K]; rank = exclusive cumsum of the new flags."""
    K, W = len(fv), len(occ)
    flat = np.zeros(W * K, np.int64)
    for w in range(W):
        for k in range(K):
            if occ[w] == 1 and fv[k] == 1 and new(w, k):
                flat[w * K + k] = 1
    rank = np.cumsum(flat) - flat
    return {(c // K, c % K): int(rank[c]) for c in np.nonzero(flat)[0]}


@pytest.mark.parametrize("K,W,threads,p_live", [
    (128, 32, 256, 0.08), (128, 32, 256, 0.6), (256, 16, 256, 0.3),
    (128, 32, 128, 0.5), (512, 8, 256, 0.2), (100, 20, 64, 0.9)])
def test_candidate_ranks_follow_reference_order(K, W, threads, p_live):
    rng = np.random.default_rng(K * W + threads)
    for _ in range(4):
        fv = (rng.random(K) < p_live).astype(np.int32)
        occ = (rng.random(W) < 0.7).astype(np.int32)
        keep = rng.random((W, K)) < 0.5

        def new(w, k):
            return bool(keep[w, k])

        got = kf.candidate_ranks(fv, occ, new, threads)
        assert got == _reference_ranks(fv, occ, new)


@pytest.mark.parametrize("K,threads", [(128, 256), (256, 256), (512, 256),
                                       (100, 64)])
def test_free_slot_ranks_match_reference_scan(K, threads):
    rng = np.random.default_rng(K + threads)
    for p in (0.0, 0.1, 0.5, 1.0):
        fv = (rng.random(K) < p).astype(np.int32)
        live, free = kf.live_and_free(fv, threads)
        assert live == [int(t) for t in np.nonzero(fv == 1)[0]]
        # the reference: frank = exclusive cumsum of (fv != 1); rank r
        # goes to the r-th free slot
        fr = (fv != 1).astype(np.int64)
        frank = np.cumsum(fr) - fr
        assert free == [int(t) for t in np.nonzero(fr)[0]]
        assert all(free[frank[t]] == t for t in np.nonzero(fr)[0])
