"""The port's locate path (rowbowt_tpu_torch.engine.locate and the toehold,
phi and doc primitives of ops/rank.py, plain torch on the CPU) == the JAX
package's, buffer for buffer, on conftest.rand_index and one read batch.
Every output is an integer, so equality is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rowbowt_tpu.construct.build import build_index as jax_build
from rowbowt_tpu.engine import locate as JL
from rowbowt_tpu.engine.batch import encode_batch as jax_encode
from rowbowt_tpu.engine.device import DeviceIndex
from rowbowt_tpu.ops import rank as JR
from rowbowt_tpu_torch.engine import locate as TL
from rowbowt_tpu_torch.engine.batch import encode_batch
from rowbowt_tpu_torch.engine.device import TorchIndex
from rowbowt_tpu_torch.ops import rank as TR

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _reads(text, seed):
    """Substrings of 1-12 bases (up to hundreds of hits), substrings with a
    substitution, random strings (empty ranges), then length-0 pad lanes
    (the whole BWT as their range)."""
    rng = np.random.default_rng(seed)
    acgt_pos = np.flatnonzero(np.isin(text, ACGT))
    out = []
    for q in range(40):
        L = int(rng.integers(1, 13))
        p = int(rng.choice(acgt_pos[acgt_pos < len(text) - L]))
        r = text[p:p + L].copy()
        if q % 5 == 3:
            r[rng.integers(0, L)] = rng.choice(ACGT)
        elif q % 5 == 4:
            r = rng.choice(ACGT, size=L)
        out.append(bytes(r))
    return out + [b""] * 3


@pytest.fixture(scope="module", params=[True, False], ids=["fb64", "fb96"])
def pair(request, rand_index):
    """(JAX DeviceIndex, port TorchIndex, qcodes, lengths) over rand_index."""
    jidx, text = rand_index
    dx = DeviceIndex.from_index(jidx, fb64=request.param)
    tx = TorchIndex.from_index(jidx, "cpu", fb64=request.param)
    reads = _reads(text, seed=31)
    qc, lens = encode_batch(jidx, reads, pad_to=16)
    jqc, jlens = jax_encode(jidx, reads, pad_to=16)
    np.testing.assert_array_equal(qc, jqc)
    np.testing.assert_array_equal(lens, jlens)
    return dx, tx, qc, lens


def _eq(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(w)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _toeholds(pair):
    dx, tx, qc, lens = pair
    want = JL.find_ranges_w_toehold(dx, jnp.asarray(qc), jnp.asarray(lens))
    got = TL.find_ranges_w_toehold(tx, torch.from_numpy(qc), torch.from_numpy(lens))
    return want, got


def test_find_ranges_w_toehold_matches_jax(pair):
    want, got = _toeholds(pair)
    _eq(got, want)
    lo, hi, k = (g.numpy() for g in got)
    n = pair[1].n
    assert ((hi < lo) & (k == 0)).any()  # empty ranges: toehold 0
    assert (hi - lo + 1 > 16).any() and (lo == 0).any() & (hi == n - 1).any()


@pytest.mark.parametrize("max_hits", [1, 4, 16])
def test_locate_matches_jax(pair, max_hits):
    (jlo, jhi, jk), (lo, hi, k) = _toeholds(pair)
    dx, tx = pair[:2]
    want = JL.locate(dx, jlo, jhi, jk, max_hits=max_hits)
    got = TL.locate(tx, lo, hi, k, max_hits=max_hits)
    _eq(got, want)
    assert got[0].shape == (lo.shape[0], max_hits)


@pytest.mark.parametrize("max_hits", [None, 3])
def test_locate_ragged_matches_jax(pair, max_hits):
    """Unbounded (the pad lanes locate every one of the n positions) and capped."""
    (jlo, jhi, jk), (lo, hi, k) = _toeholds(pair)
    dx, tx = pair[:2]
    want = JL.locate_ragged(dx, jlo, jhi, jk, max_hits=max_hits)
    got = TL.locate_ragged(tx, lo, hi, k, max_hits=max_hits)
    _eq(got, want)
    flat, offs = got
    sizes = np.diff(offs)
    assert len(np.unique(sizes)) > 3 and (flat >= 0).all()
    if max_hits is None:
        assert sizes.max() == tx.n
        assert np.array_equal(np.sort(flat[offs[-2]:offs[-1]]), np.arange(tx.n))
    else:
        assert sizes.max() == max_hits


def test_resolve_docs_matches_jax(pair):
    (jlo, jhi, jk), (lo, hi, k) = _toeholds(pair)
    dx, tx = pair[:2]
    flat, _ = TL.locate_ragged(tx, lo, hi, k)
    want = JL.resolve_docs(dx, jnp.asarray(flat))
    got = TL.resolve_docs(tx, torch.from_numpy(flat))
    _eq(got, want)
    assert set(got[0].tolist()) == {0, 1, 2}


def test_toehold_from_range_matches_jax(pair):
    """Random rows and ranges, including empty ones and hi = n-1."""
    dx, tx = pair[:2]
    rng = np.random.default_rng(32)
    lo = rng.integers(0, tx.n, size=1024).astype(np.int32)
    hi = rng.integers(0, tx.n, size=1024).astype(np.int32)
    lo[:8], hi[:8] = 1, 0
    hi[8:16] = tx.n - 1
    want = JR.toehold_from_range(dx, jnp.asarray(lo), jnp.asarray(hi))
    got = TR.toehold_from_range(tx, torch.from_numpy(lo), torch.from_numpy(hi))
    _eq([got], [want])
    assert (got.numpy()[:8] == 0).all() and (got.numpy()[hi < lo] == 0).all()


def test_phi_step_matches_jax(pair):
    """Random positions, with 0 and n-1, chained for a few steps."""
    dx, tx = pair[:2]
    rng = np.random.default_rng(33)
    i = rng.integers(0, tx.n, size=1024).astype(np.int32)
    i[:2] = 0, tx.n - 1
    ji, ti = jnp.asarray(i), torch.from_numpy(i)
    for _ in range(4):
        ji, ti = JR.phi_step(dx, ji), TR.phi_step(tx, ti)
        _eq([ti], [ji])


def test_phi_step_without_phi1_names_roadmap(pair):
    tx = pair[1]
    arrays = {k: v for k, v in tx.arrays.items() if k != "phi1"}
    bare = TorchIndex(arrays, tx.n, tx.R, tx.A, tx.ma_wsize, tx.ftab_k, tx.acgt_codes,
                      tx.device)
    # without phi1: the predecessor search over pred_pos, at every position,
    # equal to phi1 and to the JAX package's predecessor branch
    dx = pair[0]
    dxp = DeviceIndex({k: v for k, v in dx.arrays.items() if k != "phi1"}, dx.n, dx.R, dx.A,
                      dx.ma_wsize, dx.ftab_k, dx.acgt_codes)
    i = np.arange(tx.n, dtype=np.int32)
    got = TR.phi_step(bare, torch.from_numpy(i))
    _eq([got], [JR.phi_step(dxp, jnp.asarray(i))])
    np.testing.assert_array_equal(got.numpy(), tx.arrays["phi1"].numpy())
    # a big index's SA-adjacency breakpoint table (bigindex.big_locate_tables)
    # serves phi without phi1: phi1's values, and the JAX package's
    phi = tx.arrays["phi1"].numpy().astype(np.int64)
    bp = np.flatnonzero(np.r_[True, np.diff(phi) != 1])
    tabs = {"pred_pos": bp.astype(np.uint32), "phi_at": phi[bp].astype(np.uint32)}
    bare.arrays.update({k: torch.from_numpy(v.astype(np.int64)) for k, v in tabs.items()})
    dxb = DeviceIndex({**{k: jnp.asarray(v) for k, v in tabs.items()},
                       "F": jnp.zeros(tx.A + 1, jnp.int64)}, tx.n, tx.R, tx.A, tx.ma_wsize, 0,
                      tx.acgt_codes)
    i = np.arange(tx.n, dtype=np.int64)
    got = TR.phi_step(bare, torch.from_numpy(i))
    _eq([got], [JR.phi_step(dxb, jnp.asarray(i))])
    np.testing.assert_array_equal(got.numpy(), phi)


def test_locate_without_sa_samples_raises(rand_index):
    """An index built without SA samples has no toehold: -s is refused."""
    text = rand_index[1]
    tx = TorchIndex.from_index(jax_build(text, with_sa_samples=False), "cpu")
    assert not tx.has_sa and "kval" not in tx.arrays
    q = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="no toehold SA samples"):
        TL.find_ranges_w_toehold(tx, q, torch.full((2,), 4, dtype=torch.int32))


@pytest.mark.parametrize("wsize", [3, 5])
def test_find_ranges_w_toehold_chkpnts_matches_jax_and_naive(pair, rand_index, wsize):
    from rowbowt_tpu.engine.naive import find_range_w_toehold_chkpnts as jax_naive_chk
    from rowbowt_tpu_torch.engine import naive

    dx, tx, qc, lens = pair
    want = JL.find_ranges_w_toehold_chkpnts(dx, jnp.asarray(qc), jnp.asarray(lens), wsize=wsize)
    got = TL.find_ranges_w_toehold_chkpnts(tx, torch.from_numpy(qc), torch.from_numpy(lens),
                                           wsize=wsize)
    _eq(got, want)
    clo, chi, ck, cqs, cqe, ncp = (g.numpy() for g in got)
    jidx, text = rand_index
    C = clo.shape[1]
    for b in np.flatnonzero(lens):  # the batched version skips length-0 lanes (m > 0)
        codes = qc[b, qc.shape[1] - lens[b]:].astype(np.int64)
        lfs = naive.find_range_w_toehold_chkpnts(jidx, codes, wsize)
        assert [(l.rn, l.qstart, l.qend, l.ssamp) for l in lfs] == \
            [(l.rn, l.qstart, l.qend, l.ssamp) for l in jax_naive_chk(jidx, codes, wsize)]
        assert ncp[b] == len(lfs), b
        for j, lfd in enumerate(lfs[:C]):
            assert (clo[b, j], chi[b, j], ck[b, j], cqs[b, j], cqe[b, j]) == (
                *lfd.rn, lfd.ssamp, lfd.qstart, lfd.qend), (b, j)
    assert (ncp == 0).any() and (ncp > 1).any()


@pytest.mark.parametrize("max_hits", [1, 6])
def test_find_locs_matches_jax(pair, max_hits):
    dx, tx, qc, lens = pair
    want = JL.find_locs(dx, jnp.asarray(qc), jnp.asarray(lens), max_hits=max_hits)
    got = TL.find_locs(tx, torch.from_numpy(qc), torch.from_numpy(lens), max_hits=max_hits)
    _eq(got, want)
    assert (got[3].numpy() == max_hits).any()


def test_chkpnts_without_kval_names_roadmap(pair):
    """Without kval the checkpoints carry the per-step run-space toehold:
    equal to the JAX package's per-step branch and to the kval route."""
    dx, tx, qc, lens = pair
    bare = TorchIndex({k: v for k, v in tx.arrays.items() if k != "kval"}, tx.n, tx.R, tx.A,
                      tx.ma_wsize, tx.ftab_k, tx.acgt_codes, tx.device)
    dxb = DeviceIndex({k: v for k, v in dx.arrays.items() if k != "kval"}, dx.n, dx.R, dx.A,
                      dx.ma_wsize, dx.ftab_k, dx.acgt_codes)
    q, ln = torch.from_numpy(qc), torch.from_numpy(lens)
    got = TL.find_ranges_w_toehold_chkpnts(bare, q, ln, 3)
    _eq(got, JL.find_ranges_w_toehold_chkpnts(dxb, jnp.asarray(qc), jnp.asarray(lens), wsize=3))
    want = TL.find_ranges_w_toehold_chkpnts(tx, q, ln, 3)
    ncp = want[5].numpy()
    valid = np.arange(got[0].shape[1])[None, :] < ncp[:, None]
    for g, w in zip(got, want):
        g, w = g.numpy(), w.numpy()
        np.testing.assert_array_equal(g[valid] if g.ndim == 2 else g,
                                      w[valid] if w.ndim == 2 else w)
