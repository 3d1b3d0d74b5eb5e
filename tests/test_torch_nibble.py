"""The nibble-count marker rows of a big index: the port's
marker_nibble_rank, BigIndex._ma_cnt64 (with its ma_cnt64.npy cache) and
ops/rank._ms_nibble == the JAX package's (rowbowt_tpu/bigindex.py,
rowbowt_tpu/ops/rank.py), on the marker panel of tests/test_bigindex.py at
n_sup 3 and 4, torch on the CPU.  The bounds of the nibble rows also equal
those of the port's run pack and bucketed CSR and a numpy ma_start1.  The
JAX package serves marker bounds from these rows under RBT_MA_NIB=1 when the
run pack does not fit; the port's TorchIndex.from_big never does (the
bucketed bound serves), and its marker engines there equal the JAX
package's over its nibble rows.  Every output is an integer, so equality is
exact."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rowbowt_tpu.bigindex as JB
import rowbowt_tpu_torch.bigindex as TB
from rowbowt_tpu.engine import markers as JM
from rowbowt_tpu.engine import seeds as JS
from rowbowt_tpu.ops import rank as JR
from rowbowt_tpu_torch.engine import markers as TM
from rowbowt_tpu_torch.engine import seeds as TS
from rowbowt_tpu_torch.engine.device import PLANE_KEYS, TorchIndex
from rowbowt_tpu_torch.ops import rank as TR
from test_bigindex import _reads_of
from test_torch_bigindex import _batch, _eq, _twins, from_jax, marker_panel  # noqa: F401


def _ma_row(marker_panel, n_sup=4):
    idx, text, markers, codes, sa = marker_panel
    return _twins(codes, idx, n_sup, sa=sa, markers=markers, w=idx.ma_wsize)[1].ma_row


def test_marker_nibble_rank_matches_jax(marker_panel):
    idx = marker_panel[0]
    ma_row = _ma_row(marker_panel)
    want = JB.marker_nibble_rank(ma_row, idx.n)
    got = TB.marker_nibble_rank(ma_row, idx.n)
    assert want is not None and got.shape == (((idx.n + 63) >> 6) + 1, 16)
    _eq([got], [want])
    assert int(got[-1, 0]) == ma_row.shape[0] and (got[:, 1:9] != 0).any()


@pytest.mark.parametrize("case", ["no markers", "16 on a row", "15 on a row", "M >= 2^31"])
def test_marker_nibble_rank_edges_match_jax(marker_panel, case):
    """None where the JAX function gives None: a row with more than 15
    entries, or 2^31 entries and more (int32 checkpoints); rows otherwise,
    whose _ms_nibble at every row is JAX's and ma_row's lower bound."""
    from rowbowt_tpu.engine.device import DeviceIndex

    n = marker_panel[0].n
    rows = {"no markers": lambda: np.zeros(0, np.uint32),
            "16 on a row": lambda: np.sort(np.r_[np.full(16, 70), np.arange(0, n, 37)]),
            "15 on a row": lambda: np.sort(np.r_[np.full(15, n - 1), np.full(15, 64), [0, 1]]),
            # a read-only view: 2^31 entries without their 8 GiB
            "M >= 2^31": lambda: np.broadcast_to(np.uint32(5), (1 << 31,))}
    ma_row = rows[case]().astype(np.uint32, copy=False)
    want = JB.marker_nibble_rank(ma_row, n)
    got = TB.marker_nibble_rank(ma_row, n)
    if case in ("16 on a row", "M >= 2^31"):
        assert want is None and got is None
        return
    _eq([got], [want])
    i = np.arange(n + 1, dtype=np.int64)
    dx = DeviceIndex({"ma_cnt64": jnp.asarray(want)}, n, 0, 6, 0, 0, ())
    tx = TorchIndex.from_arrays({"ma_cnt64": got}, n=n, R=0, A=6, ma_wsize=0, ftab_k=0,
                                acgt_codes=(), device="cpu")
    wms = JR._ms_nibble(dx, jnp.asarray(i))
    _eq([TR._ms_nibble(tx, torch.from_numpy(i))], [wms])
    np.testing.assert_array_equal(np.asarray(wms), np.searchsorted(ma_row, i, "left"))


@pytest.fixture(scope="module", params=[3, 4], ids=["n_sup3", "n_sup4"])
def nib_twins(request, marker_panel):
    idx, text, markers, codes, sa = marker_panel
    jb, tb = _twins(codes, idx, request.param, sa=sa, markers=markers, w=idx.ma_wsize)
    return idx, text, jb, tb


@pytest.fixture
def nib_case(nib_twins, monkeypatch):
    """(idx, text, JAX DeviceIndex over the nibble-count rows, the port's
    from_big view, [port indexes holding the nibble rows]) with the run pack
    taken away in both packages and RBT_MA_NIB=1.  The port's nibble
    indexes: the JAX one's arrays, and from_big's view with _ma_cnt64's
    rows added (from_big itself puts none on the device)."""
    idx, text, jb, tb = nib_twins
    monkeypatch.setenv("RBT_MA_NIB", "1")
    monkeypatch.setattr(JB.BigIndex, "_ma_runpack", lambda self: None)
    monkeypatch.setattr(TB.BigIndex, "_ma_runpack", lambda self: None)
    dx = jb.device_index()
    tx = TorchIndex.from_big(tb, "cpu")
    nib = dataclasses.replace(tx, arrays=dict(tx.arrays,
                                              ma_cnt64=torch.from_numpy(tb._ma_cnt64())))
    return idx, text, dx, tx, [from_jax(dx), nib]


def test_from_big_keeps_the_bucketed_bound(nib_case, nib_twins, monkeypatch):
    """Where the run pack does not fit, the JAX package under RBT_MA_NIB=1
    puts its nibble rows on the device; the port's from_big puts the
    bucketed CSR there, the same as without the variable."""
    _, _, dx, tx, _ = nib_case
    assert "ma_cnt64" in dx.arrays and "ma_off" not in dx.arrays
    assert {"ma_off", "ma_row"} <= set(tx.arrays)
    assert not {"ma_cnt64", "ma_rec", "ma_roff", "ma_sd16"} & set(tx.arrays)
    assert set(tx.arrays) - {"ma_off"} == _viewed(dx) - {"ma_cnt64"} and tx.ma_bs
    monkeypatch.delenv("RBT_MA_NIB")
    bare = TorchIndex.from_big(nib_twins[3], "cpu")
    assert sorted(bare.arrays) == sorted(tx.arrays) and bare.ma_bs == tx.ma_bs


def test_the_run_pack_comes_before_the_nibble_rows(nib_twins, monkeypatch):
    idx, _, jb, tb = nib_twins
    monkeypatch.setenv("RBT_MA_NIB", "1")
    dx = jb.device_index()
    tx = TorchIndex.from_big(tb, "cpu")
    assert set(tx.arrays) == _viewed(dx)
    assert "ma_rec" in tx.arrays and "ma_cnt64" not in tx.arrays and tx.ma_rp == dx.ma_rp


def _viewed(dx) -> set:
    """The keys of the port's view of a JAX DeviceIndex's tables: the
    two-level nibble rows under their bit planes' keys."""
    return {PLANE_KEYS.get(k, k) for k in dx.arrays}


def test_ms_nibble_matches_jax_and_ma_start1(nib_case):
    idx, _, dx, _, txs = nib_case
    i = np.arange(-3, idx.n + 70, dtype=np.int64)  # clamped below 0 and above n
    want = JR._ms_nibble(dx, jnp.asarray(i))
    ma_row = np.asarray(idx.ma_row).astype(np.int64)
    np.testing.assert_array_equal(np.asarray(want),
                                  np.searchsorted(ma_row, np.clip(i, 0, idx.n), "left"))
    for tx in txs:
        _eq([TR._ms_nibble(tx, torch.from_numpy(i))], [want], "ms_nibble")


def _random_ranges(n, rng, k=600):
    a = rng.integers(0, n, size=k)
    lo = a.astype(np.int64)
    hi = np.minimum(a + rng.integers(0, 300, size=k), n - 1).astype(np.int64)
    lo[:4], hi[:4] = 1, 0
    lo[4], hi[4] = 0, n - 1
    return lo, hi


def test_nibble_bounds_match_the_marker_routes(nib_case, nib_twins, monkeypatch):
    """The nibble rows' bounds (_ms_nibble at lo and hi + 1) == the JAX
    package's markers_bounds over them, == the port's markers_bounds over
    the bucketed CSR and the run pack of the same BigIndex, == a numpy
    ma_start1."""
    idx, _, dx, bucketed, txs = nib_case
    monkeypatch.undo()
    run_pack = TorchIndex.from_big(nib_twins[3], "cpu")
    assert "ma_off" in bucketed.arrays and "ma_rec" in run_pack.arrays
    lo, hi = _random_ranges(idx.n, np.random.default_rng(43))
    want = JR.markers_bounds(dx, jnp.asarray(lo), jnp.asarray(hi))
    wat = JR.markers_at_range(dx, jnp.asarray(lo), jnp.asarray(hi), 16)
    ma_row = np.asarray(idx.ma_row).astype(np.int64)
    s = np.searchsorted(ma_row, lo, "left")
    np.testing.assert_array_equal(np.asarray(want[0]), s)
    np.testing.assert_array_equal(
        np.asarray(want[1]), np.maximum(np.searchsorted(ma_row, hi + 1, "left") - s, 0))
    tlo, thi = torch.from_numpy(lo), torch.from_numpy(hi)
    for tx in txs:
        s_nib = TR._ms_nibble(tx, torch.clamp(tlo, 0, idx.n))
        e_nib = TR._ms_nibble(tx, torch.clamp(thi + 1, 0, idx.n))
        _eq([s_nib, torch.clamp(e_nib - s_nib, min=0)], want, "nibble bounds")
    for tx in (bucketed, run_pack):
        _eq(TR.markers_bounds(tx, tlo, thi), want, "bounds")
        _eq(TR.markers_at_range(tx, tlo, thi, 16), wat, "at")


def test_marker_engines_match_jax_over_its_nibble_rows(nib_case):
    """The port's marker engines over from_big's bucketed bound == the JAX
    package's over its nibble rows."""
    idx, text, dx, tx, _ = nib_case
    qc, lens, q, ln = _batch(idx, _reads_of(text, np.random.default_rng(8)) + [b""])
    want = JM.find_ranges_w_markers(dx, jnp.asarray(qc), jnp.asarray(lens), wsize=6,
                                    max_range=100, max_k=8)
    gwant = JS.markers_greedy_seeding(dx, jnp.asarray(qc), jnp.asarray(lens), wsize=6,
                                      max_range=100, max_seeds=4, max_k=8, use_ftab=False,
                                      values=False)
    _eq(TM.find_ranges_w_markers(tx, q, ln, wsize=6, max_range=100, max_k=8), want,
        "w_markers")
    _eq(TS.markers_greedy_seeding(tx, q, ln, wsize=6, max_range=100, max_seeds=4, max_k=8,
                                  use_ftab=False, values=False), gwant, "greedy")
    assert (np.asarray(want[3]) > 0).any()


def test_ma_cnt64_cache(nib_twins, tmp_path, monkeypatch):
    """_ma_cnt64 writes ma_cnt64.npy beside a loaded artifact under the JAX
    package's name and format: each package reads the other's, a second
    load uses it, and a cache of the wrong shape or dtype is rebuilt.  The
    JAX package reads it under RBT_MA_NIB=1; the port needs no variable."""
    idx, _, jb, tb = nib_twins
    p = str(tmp_path / "big")
    tb.save(p)
    cache = os.path.join(p, "ma_cnt64.npy")
    assert not os.path.exists(cache)
    want = JB.marker_nibble_rank(jb.ma_row, jb.n)
    _eq([TB.BigIndex.load(p)._ma_cnt64()], [want])
    assert os.path.exists(cache)
    monkeypatch.setenv("RBT_MA_NIB", "1")
    _eq([np.load(cache)], [want])
    _eq([JB.BigIndex.load(p)._ma_cnt64()], [want])  # the JAX package reads the port's cache
    _eq([TB.BigIndex.load(p)._ma_cnt64()], [want])
    np.save(cache, want[:-1])  # one row short: stale
    _eq([TB.BigIndex.load(p)._ma_cnt64()], [want])
    _eq([np.load(cache)], [want])  # ... and replaced
    np.save(cache, want.astype(np.int64))  # the wrong dtype
    _eq([TB.BigIndex.load(p)._ma_cnt64()], [want])
    _eq([np.load(cache)], [want])
