"""The port's scalar oracles that complete rowbowt_tpu_torch/engine/naive.py
(bwt_at, find_range, count, get_seeds_greedy and
get_markers_greedy_overlap_seeding) == the JAX package's
(rowbowt_tpu/engine/naive.py), and TorchIndex.lean == DeviceIndex.lean, on
the 3-document panel of tests/test_torch_seeds.py (ftab k = 6, markers with
window 10) loaded by each package: the panel's reads, their reverse
complements and random reads.  Every output is an integer, so equality is
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rowbowt_tpu.engine import locate as JL
from rowbowt_tpu.engine import naive as JN
from rowbowt_tpu.engine.device import DeviceIndex
from rowbowt_tpu.index import RbtIndex as JaxRbtIndex
from rowbowt_tpu_torch.alphabet import revcomp
from rowbowt_tpu_torch.engine import locate as TL
from rowbowt_tpu_torch.engine import naive as TN
from rowbowt_tpu_torch.engine.batch import encode_batch
from rowbowt_tpu_torch.engine.count import find_ranges
from rowbowt_tpu_torch.engine.device import TorchIndex
from rowbowt_tpu_torch.index import RbtIndex
from test_torch_seeds import build_panel


@pytest.fixture(scope="module")
def oracle_panel(tmp_path_factory):
    """(JAX RbtIndex, port RbtIndex, the saved directories, reads): the
    panel's reads, their reverse complements, 12 random reads and an empty
    one."""
    dirs, _, reads = build_panel(tmp_path_factory.mktemp("torch_oracles"))
    rng = np.random.default_rng(5)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    reads = (reads + [revcomp(r).tobytes() for r in reads]
             + [rng.choice(acgt, size=int(n)).tobytes() for n in rng.integers(1, 40, 12)]
             + [b""])
    return JaxRbtIndex.load(dirs["idx"]), RbtIndex.load(dirs["idx"]), dirs, reads


def _codes(idx, r):
    return idx.alpha.encode(np.frombuffer(r, np.uint8)).astype(np.int64)


def test_bwt_at_matches_jax(oracle_panel):
    jidx, tidx, _, _ = oracle_panel
    got = [TN.bwt_at(tidx, i) for i in range(tidx.n)]
    assert got == [JN.bwt_at(jidx, i) for i in range(jidx.n)]
    np.testing.assert_array_equal(
        got, np.repeat(jidx.run_head, np.diff(np.append(jidx.run_start, jidx.n))))


@pytest.mark.parametrize("use_ftab", [True, False])
def test_find_range_and_count_match_jax(oracle_panel, use_ftab):
    jidx, tidx, _, reads = oracle_panel
    found = 0
    for r in reads:
        jc, tc = _codes(jidx, r), _codes(tidx, r)
        want = JN.find_range(jidx, jc, use_ftab=use_ftab)
        assert TN.find_range(tidx, tc, use_ftab=use_ftab) == want, r
        assert TN.count(tidx, tc) == JN.count(jidx, jc)
        found += want[1] >= want[0]
    assert 0 < found < len(reads)


def test_find_range_matches_the_batched_count(oracle_panel):
    """The oracle's ranges are the batched engine's (K1's plain twin on the
    CPU), with and without the ftab start."""
    _, tidx, _, reads = oracle_panel
    tx = TorchIndex.from_index(tidx, "cpu")
    qc, lens = encode_batch(tidx, reads, pad_to=64)
    for use_ftab in (True, False):
        lo, hi = find_ranges(tx, torch.from_numpy(qc), torch.from_numpy(lens), use_ftab)
        want = [TN.find_range(tidx, _codes(tidx, r), use_ftab=use_ftab) for r in reads]
        assert list(zip(lo.tolist(), hi.tolist())) == want


@pytest.mark.parametrize("min_length", [0, 5, 12])
def test_get_seeds_greedy_matches_jax(oracle_panel, min_length):
    jidx, tidx, _, reads = oracle_panel
    several = 0
    for r in reads:
        want = JN.get_seeds_greedy(jidx, _codes(jidx, r), min_length)
        got = TN.get_seeds_greedy(tidx, _codes(tidx, r), min_length)
        assert [(s.rn, s.qstart, s.qend) for s in got] == [(s.rn, s.qstart, s.qend)
                                                           for s in want], r
        several += len(want) > 1
    assert several > 0


def _overlap_calls(naive, idx, codes, wsize, max_range):
    calls = []
    try:
        naive.get_markers_greedy_overlap_seeding(
            idx, codes, wsize, max_range,
            lambda rn, q, mbuf: calls.append((rn, q, [int(v) for v in mbuf])))
    except RuntimeError as e:  # the reference-inherited livelock guard
        calls.append(("raised", str(e)))
    return calls


@pytest.mark.parametrize("wsize,max_range", [(5, 1000), (10, 1000), (10, 3)])
def test_get_markers_greedy_overlap_seeding_matches_jax(oracle_panel, wsize, max_range):
    jidx, tidx, _, reads = oracle_panel
    seeds = markers = 0
    for r in reads:
        want = _overlap_calls(JN, jidx, _codes(jidx, r), wsize, max_range)
        assert _overlap_calls(TN, tidx, _codes(tidx, r), wsize, max_range) == want, r
        seeds += len(want)
        markers += sum(len(c[2]) for c in want if c[0] != "raised")
    assert seeds > len(reads) and (markers > 0 or max_range < 10)


def test_get_markers_greedy_overlap_seeding_refusals_match_jax(oracle_panel):
    jidx, tidx, dirs, _ = oracle_panel
    codes = _codes(tidx, b"ACGTACGTAC")
    for naive, idx in ((JN, jidx), (TN, tidx)):
        with pytest.raises(ValueError, match="wsize cannot be less than ftab k-1"):
            naive.get_markers_greedy_overlap_seeding(idx, codes, 4, 1000, print)
    for naive, index in ((JN, JaxRbtIndex), (TN, RbtIndex)):
        with pytest.raises(ValueError, match="ftab required"):
            naive.get_markers_greedy_overlap_seeding(index.load(dirs["bare"]), codes, 10, 1000,
                                                     print)


def test_lean_drops_exactly_the_jax_keys(oracle_panel):
    jidx, tidx, _, reads = oracle_panel
    dx = DeviceIndex.from_index(jidx)
    tx = TorchIndex.from_index(tidx, "cpu")
    assert TorchIndex._LEAN_DROP == DeviceIndex._LEAN_DROP
    lean, dlean = tx.lean(), dx.lean()
    # the two views differ only in the rows each package keeps resident
    # (the JAX one keeps fblock beside fblock64 at this n)
    assert set(tx.arrays) - set(lean.arrays) == set(dx.arrays) - set(dlean.arrays)
    assert set(lean.arrays) == set(tx.arrays) - set(DeviceIndex._LEAN_DROP)
    assert {"occ_flat", "ltk"} <= set(tx.arrays) - set(lean.arrays)
    assert all(lean.arrays[k] is tx.arrays[k] for k in lean.arrays)  # a view, no copies
    assert (lean.n, lean.R, lean.ftab_k, lean.device) == (tx.n, tx.R, tx.ftab_k, tx.device)
    qc, lens = encode_batch(tidx, reads, pad_to=64)
    want = JL.find_ranges_w_toehold(dlean, jnp.asarray(qc), jnp.asarray(lens))
    got = TL.find_ranges_w_toehold(lean, torch.from_numpy(qc), torch.from_numpy(lens))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_lean_needs_a_dense_backend(oracle_panel):
    """Without a dense LF backend (occ1, the fused rows or bwt4) lean
    refuses, as the JAX package's does."""
    jidx, tidx, _, _ = oracle_panel
    dense = ("occ1_flat", "fblock", "fblock64", "bwt4")
    dx = DeviceIndex.from_index(jidx)
    dx = DeviceIndex({k: v for k, v in dx.arrays.items() if k not in dense}, dx.n, dx.R, dx.A,
                     dx.ma_wsize, dx.ftab_k, dx.acgt_codes)
    tx = TorchIndex.from_index(tidx, "cpu")
    tx = TorchIndex({k: v for k, v in tx.arrays.items() if k not in dense}, tx.n, tx.R, tx.A,
                    tx.ma_wsize, tx.ftab_k, tx.acgt_codes, tx.device)
    for x in (dx, tx):
        with pytest.raises(AssertionError):
            x.lean()
