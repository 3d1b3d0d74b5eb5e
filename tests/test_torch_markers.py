"""The port's rb_align -m primitives (markers_bounds, markers_at_range,
markers_for_ranges; plain torch on the CPU) == the JAX package's, buffer for
buffer, on conftest.rand_index.  Every output is an integer, so equality is
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rowbowt_tpu.engine.device import DeviceIndex
from rowbowt_tpu.engine.markers import markers_for_ranges as jax_markers_for_ranges
from rowbowt_tpu.ops import rank as JR
from rowbowt_tpu_torch.engine.device import TorchIndex
from rowbowt_tpu_torch.engine.markers import markers_for_ranges
from rowbowt_tpu_torch.ops import rank as TR


@pytest.fixture(scope="module")
def pair(rand_index):
    jidx = rand_index[0]
    return DeviceIndex.from_index(jidx), TorchIndex.from_index(jidx, "cpu")


@pytest.fixture(scope="module")
def ranges(pair):
    """Random ranges (some wide enough to hold more than 8 markers), empty
    (1, 0) ranges, the full range, single rows, and ranges ending at n-1."""
    n = pair[1].n
    rng = np.random.default_rng(41)
    a = rng.integers(0, n, size=512)
    w = rng.integers(0, 200, size=512)
    lo = a.astype(np.int32)
    hi = np.minimum(a + w, n - 1).astype(np.int32)
    lo[:8], hi[:8] = 1, 0
    lo[8], hi[8] = 0, n - 1
    hi[9:40] = lo[9:40]
    hi[40:48] = n - 1
    return lo, hi


def _eq(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


def test_markers_bounds_matches_jax(pair, ranges):
    dx, tx = pair
    lo, hi = ranges
    got = TR.markers_bounds(tx, torch.from_numpy(lo), torch.from_numpy(hi))
    _eq(got, JR.markers_bounds(dx, jnp.asarray(lo), jnp.asarray(hi)))
    cnt = got[1].numpy()
    assert (cnt[:8] == 0).all() and cnt[8] == tx.arrays["ma_val"].shape[0]


@pytest.mark.parametrize("max_k", [2, 8, 64])
def test_markers_at_range_matches_jax(pair, ranges, max_k):
    """max_k 2 and 8 truncate some lanes (count > max_k), 64 truncates only
    the full range."""
    dx, tx = pair
    lo, hi = ranges
    got = TR.markers_at_range(tx, torch.from_numpy(lo), torch.from_numpy(hi), max_k)
    _eq(got, JR.markers_at_range(dx, jnp.asarray(lo), jnp.asarray(hi), max_k))
    vals, cnt = (g.numpy() for g in got)
    assert vals.shape == (lo.shape[0], max_k)
    assert (cnt > max_k).any() and ((cnt > 0) & (cnt <= max_k)).any()


@pytest.mark.parametrize("max_k", [2, 64])
def test_markers_for_ranges_matches_jax(pair, ranges, max_k):
    dx, tx = pair
    lo, hi = ranges
    got = markers_for_ranges(tx, torch.from_numpy(lo), torch.from_numpy(hi), max_k=max_k)
    _eq(got, jax_markers_for_ranges(dx, jnp.asarray(lo), jnp.asarray(hi), max_k=max_k))


def test_markers_at_range_matches_host_csr(pair, ranges):
    """Against the CSR itself, without ma_start1: the entries of rows
    [lo, hi] are ma_val[searchsorted(ma_row, lo) : searchsorted(ma_row, hi+1)]."""
    tx = pair[1]
    lo, hi = ranges
    ma_row = tx.arrays["ma_row"].numpy()
    ma_val = tx.arrays["ma_val"].numpy()
    vals, cnt = TR.markers_at_range(tx, torch.from_numpy(lo), torch.from_numpy(hi), 4096)
    for b in range(lo.shape[0]):
        s = np.searchsorted(ma_row, lo[b], "left")
        e = max(np.searchsorted(ma_row, hi[b] + 1, "left"), s)
        assert cnt[b] == e - s
        np.testing.assert_array_equal(vals[b, :e - s].numpy(), ma_val[s:e])


def test_markers_bounds_without_ma_start1_names_roadmap(pair, ranges):
    tx = pair[1]
    arrays = {k: v for k, v in tx.arrays.items() if k != "ma_start1"}
    bare = TorchIndex(arrays, tx.n, tx.R, tx.A, tx.ma_wsize, tx.ftab_k, tx.acgt_codes,
                      tx.device)
    # without ma_start1: two binary searches over ma_row, equal to the JAX
    # package's branch and to the dense table's bounds
    dx = pair[0]
    dxs = DeviceIndex({k: v for k, v in dx.arrays.items() if k != "ma_start1"}, dx.n, dx.R,
                      dx.A, dx.ma_wsize, dx.ftab_k, dx.acgt_codes)
    lo, hi = ranges
    got = TR.markers_bounds(bare, torch.from_numpy(lo), torch.from_numpy(hi))
    _eq(got, JR.markers_bounds(dxs, jnp.asarray(lo), jnp.asarray(hi)))
    for g, w in zip(got, TR.markers_bounds(tx, torch.from_numpy(lo), torch.from_numpy(hi))):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    # a big index's run-pack tables (bigindex.marker_run_pack) serve the
    # bounds without ma_start1: the dense table's values, and the JAX package's
    from rowbowt_tpu_torch.bigindex import marker_run_pack

    off, sd16, rec, ma_rp = marker_run_pack(tx.arrays["ma_row"].numpy(), tx.n)
    tabs = {"ma_roff": off, "ma_sd16": sd16, "ma_rec": rec}
    bare = TorchIndex.from_arrays({**{k: v.numpy() for k, v in arrays.items() if k != "ma_row"},
                                   **tabs}, n=tx.n, R=tx.R, A=tx.A, ma_wsize=tx.ma_wsize,
                                  ftab_k=tx.ftab_k, acgt_codes=tx.acgt_codes, device="cpu",
                                  ma_rp=ma_rp)
    dxb = DeviceIndex({**{k: jnp.asarray(v) for k, v in tabs.items()},
                       "F": jnp.zeros(tx.A + 1, jnp.int64)}, tx.n, tx.R, tx.A, tx.ma_wsize, 0,
                      tx.acgt_codes, ma_rp=ma_rp)
    lo, hi = ranges
    got = TR.markers_bounds(bare, torch.from_numpy(lo).long(), torch.from_numpy(hi).long())
    _eq(got, JR.markers_bounds(dxb, jnp.asarray(lo, jnp.int64), jnp.asarray(hi, jnp.int64)))
    want = TR.markers_bounds(tx, torch.from_numpy(lo), torch.from_numpy(hi))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def _marker_reads(text, seed):
    """Substrings of 3-40 bases of the text (some shorter than the window),
    substrings with a substitution (failed searches), and length-0 lanes."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    ok = np.flatnonzero(np.isin(text, acgt))
    out = []
    for q in range(48):
        L = int(rng.integers(3, 41))
        p = int(rng.choice(ok[ok < len(text) - L]))
        r = text[p:p + L].copy()
        if q % 4 == 3:
            r[rng.integers(0, L)] = rng.choice(acgt)
        out.append(bytes(r))
    return out + [b""] * 2


@pytest.mark.parametrize("wsize,max_range,max_k", [(7, 1 << 62, 32), (5, 40, 4), (3, 1 << 62, 2)])
def test_find_ranges_w_markers_matches_jax_and_naive(rand_index, pair, wsize, max_range, max_k):
    """Buffer-equal to JAX; each lane's packed tail equals the oracle's
    lf.markers where nothing overflowed, and its last max_k entries where
    something did."""
    from rowbowt_tpu.engine.batch import encode_batch as jax_encode
    from rowbowt_tpu.engine.markers import find_ranges_w_markers as jax_fwm
    from rowbowt_tpu_torch.engine import naive
    from rowbowt_tpu_torch.engine.markers import find_ranges_w_markers

    jidx, text = rand_index
    dx, tx = pair
    reads = _marker_reads(text, seed=42 + wsize)
    qc, lens = jax_encode(jidx, reads, pad_to=64)
    kw = dict(wsize=wsize, max_range=max_range, max_k=max_k)
    want = jax_fwm(dx, jnp.asarray(qc), jnp.asarray(lens), **kw)
    got = find_ranges_w_markers(tx, torch.from_numpy(qc), torch.from_numpy(lens), **kw)
    _eq(got, want)
    lo, hi, buf, used, over = (g.numpy() for g in got)
    for b, r in enumerate(reads):
        lfd = naive.find_range_w_markers(jidx, jidx.alpha.encode(np.frombuffer(r, np.uint8))
                                         .astype(np.int64), wsize, max_range)
        assert (lo[b], hi[b]) == lfd.rn, b
        mk = [int(x) for x in lfd.markers]
        assert used[b] == min(len(mk), max_k) and over[b] == (len(mk) > max_k), b
        if not over[b]:
            assert buf[b, max_k - used[b]:].tolist() == mk, b
    assert (used > 0).any() and (hi < lo).any()


@pytest.mark.parametrize("max_k", [1, 8])
def test_at_ranges_batched_matches_jax(max_k):
    """Random text spans over sorted positions with ties, empty spans, spans
    before and after every position, and the empty table."""
    from rowbowt_tpu.midx import PosMarkers as JaxPosMarkers
    from rowbowt_tpu.midx import at_ranges_batched as jax_at_ranges
    from rowbowt_tpu_torch.midx import PosMarkers, at_ranges_batched

    rng = np.random.default_rng(43)
    pos = rng.integers(0, 5000, size=300)
    val = rng.integers(0, 1 << 40, size=300)
    pm, jpm = PosMarkers.from_pairs(pos, val), JaxPosMarkers.from_pairs(pos, val)
    np.testing.assert_array_equal(pm.pos, jpm.pos)
    np.testing.assert_array_equal(pm.val, jpm.val)
    lo = rng.integers(-10, 5100, size=256).astype(np.int32)
    hi = (lo + rng.integers(-3, 120, size=256)).astype(np.int32)
    lo[:4], hi[:4] = 0, -1
    for p in (pm, PosMarkers.from_pairs([], [])):
        jp = JaxPosMarkers(p.pos, p.val)
        want = jax_at_ranges(*jp.device(), jnp.asarray(lo), jnp.asarray(hi), max_k)
        got = at_ranges_batched(*p.device("cpu"), torch.from_numpy(lo), torch.from_numpy(hi),
                                max_k)
        _eq(got, want)
        for b in range(0, 256, 17):
            m = p.at_range(int(lo[b]), int(hi[b]))
            assert got[1][b] == len(m)
            assert got[0][b, :min(len(m), max_k)].tolist() == m[:max_k].tolist()
    assert (got[1] == 0).all()
