"""The port's two-level big (n >= 2^31) index (rowbowt_tpu_torch.bigindex,
TorchIndex.from_big, the fb2 rank, trajectory toehold, phi and marker
branches; plain torch on the CPU) == the JAX package's (rowbowt_tpu.bigindex
and its engines), array for array and buffer for buffer, on the fixtures of
tests/test_bigindex.py at n_sup 3 and 4: the random-text index of conftest,
the 4-document marker panel and the merge-order (codes, SA).  The port's
index comes both from the JAX device_index leaves (TorchIndex.from_arrays)
and from its own BigIndex (TorchIndex.from_big).  Every output is an
integer, so equality is exact.  Also: the CUDA launch path of K1 over the
two-level rows with its C entry replaced by a recorder."""

import ctypes
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rowbowt_tpu.bigindex as JB
import rowbowt_tpu_torch.bigindex as TB
from rowbowt_tpu.engine import locate as JL
from rowbowt_tpu.engine import markers as JM
from rowbowt_tpu.engine import seeds as JS
from rowbowt_tpu.engine.count import find_ranges as jax_find_ranges
from rowbowt_tpu.index import pack_marker
from rowbowt_tpu.ops import rank as JR
from rowbowt_tpu_torch import _native
from rowbowt_tpu_torch.alphabet import Alphabet
from rowbowt_tpu_torch.engine import locate as TL
from rowbowt_tpu_torch.engine import markers as TM
from rowbowt_tpu_torch.engine import seeds as TS
from rowbowt_tpu_torch.engine.batch import encode_batch
from rowbowt_tpu_torch.engine.count import find_ranges
from rowbowt_tpu_torch.engine.device import PLANE_KEYS, PLANE_SYMS, TorchIndex, bit_planes
from rowbowt_tpu_torch.ops import cuda_lf
from rowbowt_tpu_torch.ops import rank as TR
from test_bigindex import _codes_of, _marker_fixture, _reads_of

LAYOUTS = {"fb2_64": (128, True), "fb2": (128, False), "fb2_256": (256, False)}


def _alpha(jidx):
    return Alphabet(np.asarray(jidx.alpha.bytes_))


def _twins(codes, jidx, n_sup, block=128, sa=None, markers=None, w=0):
    """(JAX BigIndex, port BigIndex) over the same codes.  The port's is built
    with its own from_codes; the JAX one with its own from_codes for 128-
    symbol rows, else from the port's rows (the JAX package builds 256-symbol
    rows only in its PFP builder)."""
    tb = TB.BigIndex.from_codes(codes, _alpha(jidx), n_sup=n_sup, block=block)
    if block == 128:
        jb = JB.BigIndex.from_codes(codes, jidx.alpha, n_sup=n_sup)
    else:
        jb = JB.BigIndex(fb2=tb.fb2.copy(), base=tb.base.copy(), F=tb.F.copy(), n=tb.n,
                         A=tb.A, per_blk=tb.per_blk, alpha=jidx.alpha)
    for big in (jb, tb):
        if sa is not None:
            big.attach_locate(codes, sa)
        if markers is not None:
            big.attach_markers(sa, [m.text_pos for m in markers],
                               [pack_marker(m.seq, m.pos, m.allele) for m in markers], w)
    return jb, tb


def from_jax(dx) -> TorchIndex:
    """The port's index over a JAX DeviceIndex's leaves."""
    return TorchIndex.from_arrays({k: np.asarray(v) for k, v in dx.arrays.items()}, n=dx.n,
                                  R=dx.R, A=dx.A, ma_wsize=dx.ma_wsize, ftab_k=dx.ftab_k,
                                  acgt_codes=dx.acgt_codes, device="cpu", ma_bs=dx.ma_bs,
                                  pp_bs=dx.pp_bs, ma_rp=dx.ma_rp)


def _eq(got, want, what=""):
    for j, (g, w) in enumerate(zip(got, want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype, (what, j, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} output {j}")


def _batch(jidx, reads, pad_to=None):
    qc, lens = encode_batch(jidx, reads, pad_to=pad_to)
    return qc, lens, torch.from_numpy(qc), torch.from_numpy(lens)


# ---------------------------------------------------------------------------
# the numpy tables

@pytest.fixture(scope="module")
def marker_panel():
    """(jax RbtIndex, text, markers, codes, sa) of tests/test_bigindex.py's
    marker fixture."""
    idx, text, markers = _marker_fixture()
    return idx, text, markers, _codes_of(idx), np.asarray(idx.kval).astype(np.uint32)


@pytest.fixture(scope="module", params=[3, 4], ids=["n_sup3", "n_sup4"])
def v2(request, marker_panel):
    """JAX and port BigIndexes with the locate and marker tables."""
    idx, text, markers, codes, sa = marker_panel
    jb, tb = _twins(codes, idx, request.param, sa=sa, markers=markers, w=idx.ma_wsize)
    return idx, text, jb, tb


TABLES = ("from_codes", "locate_tables", "marker_tables", "phi_pack", "marker_buckets",
          "run_pack")


@pytest.mark.parametrize("table", TABLES)
def test_tables_match_jax(marker_panel, table):
    idx, text, markers, codes, sa = marker_panel
    tpos = np.array([m.text_pos for m in markers], np.int64)
    packed = np.array([pack_marker(m.seq, m.pos, m.allele) for m in markers], np.int64)
    jrow, _ = JB.big_marker_tables(sa, tpos, packed, idx.ma_wsize, idx.n)
    if table == "from_codes":
        for n_sup in (3, 4):
            jb = JB.BigIndex.from_codes(codes, idx.alpha, n_sup=n_sup)
            tb = TB.BigIndex.from_codes(codes, _alpha(idx), n_sup=n_sup)
            _eq((tb.fb2, tb.base, tb.F), (jb.fb2, jb.base, jb.F))
            assert (tb.n, tb.A, tb.per_blk, tb.n_sup) == (jb.n, jb.A, jb.per_blk, n_sup)
    elif table == "locate_tables":
        want = JB.big_locate_tables(codes, sa, A=idx.A, chunk=500)
        got = TB.big_locate_tables(codes, sa, A=idx.A, chunk=500)
        assert list(got) == list(want)
        _eq(got.values(), want.values())
    elif table == "marker_tables":
        _eq(TB.big_marker_tables(sa, tpos, packed, idx.ma_wsize, idx.n),
            JB.big_marker_tables(sa, tpos, packed, idx.ma_wsize, idx.n))
    elif table == "phi_pack":
        lt = JB.big_locate_tables(codes, sa, A=idx.A)
        _eq(TB.phi_pack_tables(lt["pred_pos"], lt["phi_at"], idx.n),
            JB.phi_pack_tables(lt["pred_pos"], lt["phi_at"], idx.n))
    elif table == "marker_buckets":
        (toff, tbs), (joff, jbs) = (TB.marker_buckets(jrow, idx.n),
                                    JB.marker_buckets(jrow, idx.n))
        _eq([toff], [joff])
        assert tbs == jbs
    else:
        got, want = TB.marker_run_pack(jrow, idx.n), JB.marker_run_pack(jrow, idx.n)
        assert want is not None and got[3] == want[3]
        _eq(got[:3], want[:3])
        # and on the degenerate structures of the JAX package's own tests
        assert TB.marker_run_pack(np.full(200, 17, np.int64), 1000) is None
        dense = np.arange(0, 4000, 2, dtype=np.int64) + (5 << 16)
        got, want = TB.marker_run_pack(dense, 10_000_000), JB.marker_run_pack(dense, 10_000_000)
        assert got[3] == want[3] and got[3][0] < 16
        _eq(got[:3], want[:3])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_directory_loads_in_the_other_package(v2, tmp_path, writer):
    """A directory saved by one package loads in the other, and the disk
    caches one package writes next to it (fb2_64, phi, run pack) are read,
    not rebuilt, by the other."""
    idx, _, jb, tb = v2
    docs = dict(doc_starts=np.asarray(idx.doc_starts), doc_names=list(idx.doc_names))
    src = dataclasses.replace(jb if writer == "jax" else tb, **docs)
    p = str(tmp_path / "big")
    src.save(p)
    assert TB.BigIndex.is_big_dir(p) and not TB.BigIndex.is_big_dir(str(tmp_path))
    back = (TB if writer == "jax" else JB).BigIndex.load(p)
    assert (back.n, back.A, back.per_blk, back.ma_wsize, back.doc_names) == (
        src.n, src.A, src.per_blk, src.ma_wsize, src.doc_names)
    np.testing.assert_array_equal(back.alpha.bytes_, src.alpha.bytes_)
    for k in ("fb2", "base", "F") + TB.BigIndex._OPT:
        np.testing.assert_array_equal(np.asarray(getattr(back, k)), getattr(src, k), err_msg=k)
    caches = ["fb2_64.npy", "phi_rows.npy", "phi_delta.npy", "ma_runpack.npz"]
    if writer == "jax":
        dx = JB.BigIndex.load(p).device_index()
        stamps = {f: os.stat(os.path.join(p, f)).st_mtime_ns for f in caches}
        tx = TorchIndex.from_big(TB.BigIndex.load(p), "cpu")
    else:
        tx = TorchIndex.from_big(TB.BigIndex.load(p), "cpu")
        stamps = {f: os.stat(os.path.join(p, f)).st_mtime_ns for f in caches}
        dx = JB.BigIndex.load(p).device_index()
    assert {f: os.stat(os.path.join(p, f)).st_mtime_ns for f in caches} == stamps
    want = _viewed(dx.arrays)
    assert sorted(tx.arrays) == sorted(want)
    _eq([tx.arrays[k] for k in sorted(want)], [want[k] for k in sorted(want)])


def _widened(a):
    a = np.asarray(a)
    return a.astype(np.int64) if a.dtype == np.uint32 else a


def _viewed(arrays) -> dict:
    """The tables the port's view holds for a JAX DeviceIndex's leaves:
    each widened, the two-level nibble rows as their bit planes."""
    return {PLANE_KEYS.get(k, k): bit_planes(np.asarray(v), PLANE_SYMS[k], "cpu").numpy()
            if k in PLANE_KEYS else _widened(v) for k, v in arrays.items()}


@pytest.mark.parametrize("cache", ["fb2_64", "phi", "run_pack"])
def test_a_stale_cache_is_rebuilt(marker_panel, tmp_path, cache):
    """A cache that does not fit the artifact next to it (written for
    another one: other row counts, another breakpoint count, the run pack of
    a shorter marker CSR) is rebuilt, not used."""
    idx, text, markers, codes, sa = marker_panel
    _, tb = _twins(codes, idx, 4, sa=sa, markers=markers, w=idx.ma_wsize)
    p = str(tmp_path / "big")
    tb.save(p)
    if cache == "fb2_64":
        np.save(os.path.join(p, "fb2_64.npy"), np.zeros((2 * tb.fb2.shape[0] - 2, 16), np.int32))
    elif cache == "phi":
        rows, delta = TB.phi_pack_tables(tb.pred_pos[:-3], tb.phi_at[:-3], tb.n)
        np.save(os.path.join(p, "phi_rows.npy"), rows)  # the right shape ...
        np.save(os.path.join(p, "phi_delta.npy"), delta)  # ... but 3 breakpoints short
    else:
        off, sd16, rec, (shift, nrows) = TB.marker_run_pack(tb.ma_row[:-8], tb.n)
        np.savez(os.path.join(p, "ma_runpack.npz"), off=off, sd16=sd16, rec=rec,
                 shift=np.int64(shift), nrows=np.int64(nrows))
    want = {"fb2_64": lambda b: (b._fb2_64(),), "phi": lambda b: b._phi_pack(),
            "run_pack": lambda b: b._ma_runpack()[:3]}[cache]
    _eq(want(TB.BigIndex.load(p)), want(tb))  # the stale cache was replaced ...
    _eq(want(TB.BigIndex.load(p)), want(tb))  # ... and the rebuilt one is used


@pytest.fixture(scope="module")
def other_panel(marker_panel):
    """(codes, sa) of the marker panel's text with 40 of its bases changed:
    another BWT of the same n, the same documents and marker positions."""
    from rowbowt_tpu.construct.build import build_index

    idx, text, markers, _, _ = marker_panel
    rng = np.random.default_rng(5)
    text2 = np.array(text)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    at = rng.choice(np.flatnonzero(np.isin(text2, acgt)), 40, replace=False)
    text2[at] = acgt[(np.searchsorted(acgt, text2[at]) + 1) % 4]
    idx2 = build_index(text2, markers=markers, doc_starts=np.asarray(idx.doc_starts),
                       doc_names=list(idx.doc_names), ma_wsize=idx.ma_wsize)
    assert idx2.n == idx.n
    return _codes_of(idx2), np.asarray(idx2.kval).astype(np.uint32)


def _big_answers(tx, reads, jidx):
    """(count ranges, toehold ranges, -m bounds of those, the phi walk of
    those) of tx on the reads: what rbt_align count, -m and -s read."""
    qc, lens, q, ln = _batch(jidx, reads)
    lo, hi, k = TL.find_ranges_w_toehold(tx, q, ln)
    return [*find_ranges(tx, q, ln), lo, hi, k, *TR.markers_bounds(tx, lo, hi),
            *TL.locate(tx, lo, hi, k, max_hits=6)]


def test_a_second_index_saved_over_the_first_answers_as_itself(marker_panel, other_panel,
                                                                tmp_path):
    """Two BigIndex of one n and other codes saved to one directory, each
    loaded after its save (which writes every derived cache): the second's
    view answers the count, toehold, -m and phi-walk queries as a fresh view
    of it does, and as the first's does not; its save left no cache of the
    first behind."""
    idx, text, markers, codes, sa = marker_panel
    codes2, sa2 = other_panel
    p = str(tmp_path / "big")
    reads = _reads_of(text, np.random.default_rng(13)) + [b""]
    views = []
    for c, s in ((codes, sa), (codes2, sa2)):
        _, tb = _twins(c, idx, 4, sa=s, markers=markers, w=idx.ma_wsize)
        tb.save(p)
        assert not set(TB.BigIndex._CACHES) & set(os.listdir(p))
        back = TB.BigIndex.load(p)
        views.append((TorchIndex.from_big(back, "cpu"), TorchIndex.from_big(tb, "cpu")))
        back._ma_cnt64()  # the one cache no device route writes
        assert set(TB.BigIndex._CACHES) <= set(os.listdir(p))
    (first, _), (loaded, fresh) = views
    want = _big_answers(fresh, reads, idx)
    _eq(_big_answers(loaded, reads, idx), want, "the second index")
    assert any(not np.array_equal(g.numpy(), w.numpy())
               for g, w in zip(_big_answers(first, reads, idx), want))
    for name in ("pl2_64", "phi_rows", "phi_delta"):
        np.testing.assert_array_equal(loaded.arrays[name].numpy(), fresh.arrays[name].numpy())


@pytest.mark.parametrize("cache", ["fb2_64", "ma_cnt64", "run_pack", "phi"])
def test_a_cache_older_than_its_source_is_rebuilt(marker_panel, other_panel, tmp_path, cache):
    """A cache of another index's tables, of the right shape, written after
    the artifact and then outdated by a newer source .npy (touched after the
    cache was written), is rebuilt from the artifact, not used."""
    idx, text, markers, codes, sa = marker_panel
    codes2, sa2 = other_panel
    dirs = {}
    for tag, c, s in (("other", codes, sa), ("this", codes2, sa2)):
        _, tb = _twins(c, idx, 4, sa=s, markers=markers, w=idx.ma_wsize)
        dirs[tag] = (str(tmp_path / tag), tb)
        tb.save(dirs[tag][0])
    files, sources, read = {
        "fb2_64": (["fb2_64.npy"], ["fb2"], lambda b: (b._fb2_64(),)),
        "ma_cnt64": (["ma_cnt64.npy"], ["ma_row"], lambda b: (b._ma_cnt64(),)),
        "run_pack": (["ma_runpack.npz"], ["ma_row"], lambda b: b._ma_runpack()[:3]),
        "phi": (["phi_rows.npy", "phi_delta.npy"], ["pred_pos", "phi_at"],
                lambda b: b._phi_pack())}[cache]
    (other, _), (p, tb) = dirs["other"], dirs["this"]
    read(TB.BigIndex.load(other))  # the other index's cache, next to its artifact
    t = min(os.stat(os.path.join(p, f"{name}.npy")).st_mtime_ns for name in sources)
    for f in files:
        with open(os.path.join(other, f), "rb") as src, open(os.path.join(p, f), "wb") as dst:
            dst.write(src.read())  # a copy, newer than this artifact: used as it stands
        os.utime(os.path.join(p, f), ns=(t - 10**10, t - 10**10))  # as if written before ...
    for name in sources:
        os.utime(os.path.join(p, f"{name}.npy"))  # ... the source was touched
    assert not TB.BigIndex.load(p)._fresh(os.path.join(p, files[0]), *sources)
    want = read(tb)
    _eq(read(TB.BigIndex.load(p)), want)  # rebuilt from this artifact ...
    assert TB.BigIndex.load(p)._fresh(os.path.join(p, files[0]), *sources)
    _eq(read(TB.BigIndex.load(p)), want)  # ... and the rebuilt cache is used


# ---------------------------------------------------------------------------
# the count path

@pytest.fixture(scope="module", params=[3, 4], ids=["n_sup3", "n_sup4"])
def count_case(request, rand_index):
    idx, text = rand_index
    codes = _codes_of(idx)
    rng = np.random.default_rng(11)
    reads = []
    for i in range(40):
        L = int(rng.integers(1, 30))
        p = int(rng.integers(0, len(text) - L))
        r = bytearray(text[p:p + L].tobytes())
        if i % 4 == 3:
            r[int(rng.integers(0, L))] = ord("N")
        reads.append(bytes(r))
    return idx, codes, request.param, reads + [b""] * 3


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_find_ranges_matches_jax(count_case, layout):
    idx, codes, n_sup, reads = count_case
    block, fb64 = LAYOUTS[layout]
    jb, tb = _twins(codes, idx, n_sup, block=block)
    dx = jb.device_index(fb64=fb64)
    qc, lens, q, ln = _batch(idx, reads, pad_to=32)
    want = jax_find_ranges(dx, jnp.asarray(qc), jnp.asarray(lens))
    for tx in (from_jax(dx), TorchIndex.from_big(tb, "cpu", fb64=fb64)):
        assert cuda_lf.row_layout(tx) == layout and tx.idx_dtype == torch.int64
        launches = (cuda_lf.LAUNCHES, cuda_lf.LAUNCHES_FB2)
        got = find_ranges(tx, q, ln)
        assert (cuda_lf.LAUNCHES, cuda_lf.LAUNCHES_FB2) == launches
        _eq(got, want, layout)
    lo, hi = (g.numpy() for g in got)
    assert (hi < lo).any() and ((hi >= lo) & (hi - lo < 3)).any()


# ---------------------------------------------------------------------------
# locate

def _v2_twins(marker_panel, n_sup):
    idx, text, markers, codes, sa = marker_panel
    return (idx, text, *_twins(codes, idx, n_sup, sa=sa, markers=markers, w=idx.ma_wsize))


@pytest.fixture(params=[("phi_rows", 4), ("phi_at", 3)], ids=["phi_rows", "phi_at"])
def phi_case(request, marker_panel, monkeypatch):
    """(dx, [port indexes], text, reads) with the bitmap phi rows, or with the
    breakpoint table and its bucket directory (the layout above 2^31
    breakpoints), chosen in both packages; the two at n_sup 4 and 3."""
    kind, n_sup = request.param
    idx, text, jb, tb = _v2_twins(marker_panel, n_sup)
    if kind == "phi_at":
        monkeypatch.setattr(JB.BigIndex, "_phi_pack", lambda self: (None, None))
        monkeypatch.setattr(TB.BigIndex, "_phi_pack", lambda self: (None, None))
    dx = jb.device_index()
    txs = [from_jax(dx), TorchIndex.from_big(tb, "cpu")]
    for tx in txs:
        assert ("phi_rows" in tx.arrays) == (kind == "phi_rows")
        assert ("pp_off" in tx.arrays) == (kind == "phi_at") and "kval" not in tx.arrays
    return idx, dx, txs, text


def test_toehold_locate_and_ragged_match_jax(phi_case):
    idx, dx, txs, text = phi_case
    reads = _reads_of(text, np.random.default_rng(7)) + [b"", b"AC"]
    qc, lens, q, ln = _batch(idx, reads)
    want = JL.find_ranges_w_toehold(dx, jnp.asarray(qc), jnp.asarray(lens))
    wloc = JL.locate(dx, *want, max_hits=6)
    wrag = JL.locate_ragged(dx, *want)
    for tx in txs:
        got = TL.find_ranges_w_toehold(tx, q, ln)
        _eq(got, want, "toehold")
        _eq(TL.locate(tx, *got, max_hits=6), wloc, "locate")
        _eq(TL.locate_ragged(tx, *got), wrag, "locate_ragged")
    flat, offs = wrag
    assert offs[-1] > len(reads) and (np.asarray(want[2])[np.asarray(want[1]) >= 0] > 0).any()


@pytest.mark.parametrize("wsize", [3, 5])
def test_chkpnts_match_jax(phi_case, wsize):
    idx, dx, txs, text = phi_case
    qc, lens, q, ln = _batch(idx, _reads_of(text, np.random.default_rng(33), k=24))
    want = JL.find_ranges_w_toehold_chkpnts(dx, jnp.asarray(qc), jnp.asarray(lens), wsize=wsize)
    for tx in txs:
        _eq(TL.find_ranges_w_toehold_chkpnts(tx, q, ln, wsize=wsize), want, "chkpnts")
    assert (np.asarray(want[5]) > 1).any()


def test_phi_step_at_every_position_matches_jax(phi_case):
    idx, dx, txs, _ = phi_case
    i = np.arange(idx.n, dtype=np.int64)
    want = JR.phi_step(dx, jnp.asarray(i))
    for tx in txs:
        _eq([TR.phi_step(tx, torch.from_numpy(i))], [want], "phi")
    np.testing.assert_array_equal(np.asarray(want), np.asarray(idx.phi1).astype(np.int64))


def test_merge_order_toehold_and_locate_match_jax(rand_index):
    """The merge-order (codes, SA) of the pangenome build, as in
    tests/test_bigindex.py::test_big_from_merge_order_parity."""
    from rowbowt_tpu.construct.merge import merge_construct, split_text_docs

    idx, text = rand_index
    bwt, sa, alpha = merge_construct(split_text_docs(text, idx.doc_starts), sa_dtype=np.uint32)
    jb = JB.BigIndex.from_codes(bwt, alpha, n_sup=4)
    tb = TB.BigIndex.from_codes(bwt, Alphabet(np.asarray(alpha.bytes_)), n_sup=4)
    jb.attach_locate(bwt, sa)
    tb.attach_locate(bwt, sa)
    dx = jb.device_index()
    qc, lens, q, ln = _batch(idx, _reads_of(text, np.random.default_rng(5)))
    want = JL.find_ranges_w_toehold(dx, jnp.asarray(qc), jnp.asarray(lens))
    wloc = JL.locate(dx, *want, max_hits=5)
    for tx in (from_jax(dx), TorchIndex.from_big(tb, "cpu")):
        got = TL.find_ranges_w_toehold(tx, q, ln)
        _eq(got, want, "toehold")
        _eq(TL.locate(tx, *got, max_hits=5), wloc, "locate")


# ---------------------------------------------------------------------------
# markers

@pytest.fixture(params=[("run_pack", 3), ("bucketed", 4)], ids=["run_pack", "bucketed"])
def marker_case(request, marker_panel, monkeypatch):
    """(dx, [port indexes], text) with the run-pack marker rank, or with the
    bucketed lower bound over the CSR (a run structure that does not fit),
    chosen in both packages; the two at n_sup 3 and 4."""
    kind, n_sup = request.param
    idx, text, jb, tb = _v2_twins(marker_panel, n_sup)
    if kind == "bucketed":
        monkeypatch.setattr(JB, "marker_run_pack", lambda *a: None)
        monkeypatch.setattr(TB, "marker_run_pack", lambda *a: None)
    dx = jb.device_index()
    txs = [from_jax(dx), TorchIndex.from_big(tb, "cpu")]
    for tx in txs:
        assert ("ma_rec" in tx.arrays) == (kind == "run_pack")
        assert ("ma_off" in tx.arrays) == (kind == "bucketed")
        assert "ma_start1" not in tx.arrays
    return idx, dx, txs, text


def test_markers_bounds_match_jax(marker_case):
    idx, dx, txs, _ = marker_case
    rng = np.random.default_rng(41)
    a = rng.integers(0, idx.n, size=600)
    lo = a.astype(np.int64)
    hi = np.minimum(a + rng.integers(0, 300, size=600), idx.n - 1).astype(np.int64)
    lo[:4], hi[:4] = 1, 0
    lo[4], hi[4] = 0, idx.n - 1
    want = JR.markers_bounds(dx, jnp.asarray(lo), jnp.asarray(hi))
    wat = JR.markers_at_range(dx, jnp.asarray(lo), jnp.asarray(hi), 16)
    for tx in txs:
        _eq(TR.markers_bounds(tx, torch.from_numpy(lo), torch.from_numpy(hi)), want, "bounds")
        _eq(TR.markers_at_range(tx, torch.from_numpy(lo), torch.from_numpy(hi), 16), wat, "at")
    ma_row = np.asarray(idx.ma_row)
    np.testing.assert_array_equal(np.asarray(want[0]), np.searchsorted(ma_row, lo, "left"))


def test_find_ranges_w_markers_matches_jax(marker_case):
    idx, dx, txs, text = marker_case
    qc, lens, q, ln = _batch(idx, _reads_of(text, np.random.default_rng(8)))
    want = JM.find_ranges_w_markers(dx, jnp.asarray(qc), jnp.asarray(lens), wsize=6,
                                    max_range=100, max_k=8)
    for tx in txs:
        _eq(TM.find_ranges_w_markers(tx, q, ln, wsize=6, max_range=100, max_k=8), want, "w_markers")
    assert (np.asarray(want[3]) > 0).any()


def test_markers_greedy_seeding_matches_jax(marker_case):
    idx, dx, txs, text = marker_case
    qc, lens, q, ln = _batch(idx, _reads_of(text, np.random.default_rng(9), k=32) + [b""])
    # values=False: marker entry ids, as rbt_markers asks for them
    want = JS.markers_greedy_seeding(dx, jnp.asarray(qc), jnp.asarray(lens), wsize=6,
                                     max_range=100, max_seeds=4, max_k=8, use_ftab=False,
                                     values=False)
    for tx in txs:
        _eq(TS.markers_greedy_seeding(tx, q, ln, wsize=6, max_range=100, max_seeds=4,
                                      max_k=8, use_ftab=False, values=False), want, "greedy")
    assert (np.asarray(want[5]) > 0).any() and (np.asarray(want[6]) > 1).any()


def test_seeds_greedy_w_sample_and_longest_seed_match_jax(v2):
    idx, text, jb, tb = v2
    rng = np.random.default_rng(21)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    reads = []
    for _ in range(24):  # longer reads with a substitution: several seeds a lane
        L = int(rng.integers(20, 60))
        p = int(rng.integers(0, len(text) - L))
        r = np.array(text[p:p + L])
        r[int(rng.integers(0, L))] = acgt[int(rng.integers(0, 4))]
        if np.isin(r, acgt).all():
            reads.append(bytes(r))
    dx = jb.device_index()
    qc, lens, q, ln = _batch(idx, reads + [b""])
    for min_length in (0, 5):
        want = JS.seeds_greedy_w_sample(dx, jnp.asarray(qc), jnp.asarray(lens),
                                        min_length=min_length)
        wloc = JS.locate_from_longest_seed(dx, *want, max_hits=4)
        for tx in (from_jax(dx), TorchIndex.from_big(tb, "cpu")):
            got = TS.seeds_greedy_w_sample(tx, q, ln, min_length=min_length)
            _eq(got, want, "seeds")
            _eq(TS.locate_from_longest_seed(tx, *got, max_hits=4), wloc, "longest")
    assert (np.asarray(want[5]) > 1).any()


def test_lmem_refuses_a_big_index(v2):
    """Big artifacts carry no ftab, and --lmem needs one, as in the JAX
    package (rowbowt.hpp:346-349)."""
    idx, _, _, tb = v2
    tx = TorchIndex.from_big(tb, "cpu")
    q, ln = torch.zeros((2, 8), dtype=torch.int32), torch.full((2,), 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="ftab must be enabled"):
        TS.markers_lmem_lanes(tx, q, ln, wsize=10)


def test_from_big_gates_the_tables(v2):
    idx, _, jb, tb = v2
    jb = dataclasses.replace(jb, doc_starts=np.asarray(idx.doc_starts))
    tb = dataclasses.replace(tb, doc_starts=np.asarray(idx.doc_starts))
    for with_locate in (False, True):
        for with_markers in (False, True):
            dx = jb.device_index(with_locate=with_locate, with_markers=with_markers)
            tx = TorchIndex.from_big(tb, "cpu", with_locate=with_locate,
                                     with_markers=with_markers)
            want = _viewed(dx.arrays)
            assert sorted(tx.arrays) == sorted(want)
            assert (tx.R, tx.pp_bs, tx.ma_bs, tx.ma_rp, tx.ftab_k, tx.acgt_codes) == (
                dx.R, dx.pp_bs, dx.ma_bs, dx.ma_rp, 0, dx.acgt_codes)
            _eq([tx.arrays[k] for k in sorted(want)], [want[k] for k in sorted(want)])


# ---------------------------------------------------------------------------
# K1 over the two-level rows: the launch path with its C entry recorded

FB2_ARGS = ("fb", "syms", "F", "base", "blk_mul", "blk_shift", "A", "n", "q", "lengths", "B",
            "L", "lo", "hi", "hi_rec", "threads", "stage", "stream")


@pytest.fixture
def fake_fb2_entry(monkeypatch):
    """The launch path with rbt_lf_count_fb2, the stream and the SM count
    replaced by recorders."""
    rec = {"calls": []}

    class Lib:
        @staticmethod
        def rbt_lf_count_fb2(*a):
            rec["calls"].append(dict(zip(FB2_ARGS, a)))
            return 0

        @staticmethod
        def rbt_lf_count(*a):
            raise AssertionError("the single-level entry was called for two-level rows")

    monkeypatch.setattr(cuda_lf, "_LIB", Lib)
    monkeypatch.setattr(cuda_lf, "LAUNCHES", 0)
    monkeypatch.setattr(cuda_lf, "LAUNCHES_FB2", 0)
    monkeypatch.setattr(cuda_lf, "_raw_stream", lambda dev: 1000 + dev)
    monkeypatch.setattr(cuda_lf, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(cuda_lf.torch.cuda, "current_device", lambda: 0)
    return rec


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_full_batch_block_over_two_level_rows(count_case, fake_fb2_entry, layout):
    """A batch that gives every SM full blocks launches K1 over the
    two-level rows (int64 lanes) in blocks of 512 threads, the size
    csrc/lf.cu LfBounds builds those instances for and the most they
    take."""
    idx, codes, n_sup, _ = count_case
    block, fb64 = LAYOUTS[layout]
    tx = TorchIndex.from_big(TB.BigIndex.from_codes(codes, _alpha(idx), n_sup=n_sup,
                                                    block=block), "cpu", fb64=fb64)
    B, L = 132 * 256, 31
    q, ln = torch.full((B, L), 2, dtype=torch.int32), torch.full((B,), L, dtype=torch.int32)
    cuda_lf.launch_k1(tx, q, ln, use_ftab=False)
    (a,) = fake_fb2_entry["calls"]
    assert (a["threads"], a["stage"]) == (512, 1)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_launch_fb2_passes_int64_n_base_and_the_layouts_per_blk(count_case, fake_fb2_entry,
                                                                layout):
    idx, codes, n_sup, reads = count_case
    block, fb64 = LAYOUTS[layout]
    tb = TB.BigIndex.from_codes(codes, _alpha(idx), n_sup=n_sup, block=block)
    tx = TorchIndex.from_big(tb, "cpu", fb64=fb64)
    tx = dataclasses.replace(tx, n=(1 << 31) + 12_345)  # an n above 2^31 as the kernel sees it
    _, _, q, ln = _batch(idx, reads, pad_to=32)
    lo, hi = cuda_lf.launch_k1(tx, q, ln, use_ftab=True)  # no ftab on a big index
    (a,) = fake_fb2_entry["calls"]
    fb = tx.arrays[PLANE_KEYS[layout]]  # the layout's bit planes
    assert a["fb"] == fb.data_ptr() and a["syms"] == {"fb2_64": 64, "fb2": 128, "fb2_256": 256}[layout]
    assert a["F"] == tx.arrays["F"].data_ptr() and a["base"] == tx.arrays["fb2_base"].data_ptr()
    per_blk = 2 * tb.per_blk if layout == "fb2_64" else tb.per_blk
    assert per_blk == fb.shape[0] // n_sup
    assert (a["blk_mul"], a["blk_shift"]) == TR.superblock_magic(per_blk)
    assert a["n"] == (1 << 31) + 12_345 and a["A"] == tx.A
    assert (a["q"], a["lengths"], a["B"], a["L"]) == (q.data_ptr(), ln.data_ptr(), *q.shape)
    for t, name in ((lo, "lo"), (hi, "hi")):
        assert t.dtype == torch.int64 and t.shape == (q.shape[0],) and t.data_ptr() == a[name]
    assert a["hi_rec"] is None  # no step record: the count alone
    assert (a["threads"], a["stage"], a["stream"]) == (cuda_lf.launch_plan(*q.shape, 132)[0], 1,
                                                       1000)
    assert (cuda_lf.LAUNCHES_FB2, cuda_lf.LAUNCHES) == (1, 0)


def test_fb2_entry_takes_n_as_64_bits(monkeypatch):
    """build() declares rbt_lf_count_fb2's n as a C long long (ctypes would
    cut a Python int above 2^31 to 32 bits otherwise)."""
    class FakeFn:
        argtypes = restype = None

    class FakeLib:
        def __init__(self, path):
            self.fns = {}

        def __getattr__(self, name):
            return self.fns.setdefault(name, FakeFn())

    monkeypatch.setattr(_native, "build_cuda_library", lambda stem: ("lib.so", ""))
    monkeypatch.setattr(cuda_lf.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(cuda_lf, "_LIB", None)
    lib = cuda_lf.build()
    types = lib.rbt_lf_count_fb2.argtypes
    assert len(types) == len(FB2_ARGS)
    assert types[FB2_ARGS.index("n")] is ctypes.c_longlong
    assert all(types[FB2_ARGS.index(k)] is ctypes.c_void_p for k in ("fb", "F", "base", "q", "lo"))
    assert lib.rbt_lf_count_fb2.restype is ctypes.c_int


@pytest.mark.parametrize("fault,error,match", [
    ("int32 F", TypeError, "F must be int64 for fb2_64 rows"),
    ("int32 base", TypeError, "fb2_base must be int64 for fb2_64 rows"),
    ("int64 rows", TypeError, "table must be int32 for fb2_64 rows"),
    ("int64 qcodes", TypeError, "qcodes must be int32"),
    ("int64 lengths", TypeError, "lengths must be int32"),
    ("base shape", ValueError, "fb2_base of shape"),
    ("ftab", ValueError, "take no ftab start"),
])
def test_launch_fb2_refuses_mixed_dtypes(count_case, fake_fb2_entry, fault, error, match):
    idx, codes, n_sup, reads = count_case
    tx = TorchIndex.from_big(TB.BigIndex.from_codes(codes, _alpha(idx), n_sup=n_sup), "cpu")
    _, _, q, ln = _batch(idx, reads, pad_to=32)
    arrays = dict(tx.arrays)
    if fault == "int32 F":
        arrays["F"] = arrays["F"].int()
    elif fault == "int32 base":
        arrays["fb2_base"] = arrays["fb2_base"].int()
    elif fault == "int64 rows":
        arrays["pl2_64"] = arrays["pl2_64"].long()
    elif fault == "int64 qcodes":
        q = q.long()
    elif fault == "int64 lengths":
        ln = ln.long()
    elif fault == "base shape":
        arrays["fb2_base"] = arrays["fb2_base"].reshape(-1)
    else:
        arrays["ftab"] = torch.zeros((4 ** 3, 2), dtype=torch.int32)
    tx = dataclasses.replace(tx, arrays=arrays, ftab_k=3 if fault == "ftab" else 0)
    with pytest.raises(error, match=match):
        cuda_lf.launch_k1(tx, q, ln)
    assert fake_fb2_entry["calls"] == [] and cuda_lf.LAUNCHES_FB2 == cuda_lf.LAUNCHES == 0


@pytest.mark.gpu
def test_cuda_fb2_kernel_matches_plain(count_case):
    """K1 over each two-level layout == find_ranges_plain on the card.  Runs
    only where jax and CUDA are both installed; chip_smoke.py (phases big_chr
    and big_count) makes the same checks with torch alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU mode)")
    idx, codes, n_sup, reads = count_case
    _, _, q, ln = _batch(idx, reads, pad_to=32)
    for layout, (block, fb64) in LAYOUTS.items():
        tb = TB.BigIndex.from_codes(codes, _alpha(idx), n_sup=n_sup, block=block)
        tx = TorchIndex.from_big(tb, "cuda", fb64=fb64)
        got = find_ranges(tx, q.cuda(), ln.cuda())
        want = cuda_lf.find_ranges_plain(tx, q.cuda(), ln.cuda())
        _eq([g.cpu() for g in got], [w.cpu().numpy() for w in want], layout)
