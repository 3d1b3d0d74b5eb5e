"""The port's chunked insertion merge (construct/merge.py) == the JAX
package's, and == the generalized-order oracle of tests/test_merge.py: BWT
codes, the suffix array as int64 and as uint32, the alphabet.  The JAX
package runs twice, with its Python walk (it finds no native library here)
and with the native walk of the port's host library (`jax_native`).  Count
ranges of a merge-built BigIndex equal a PFP-built one's (the two suffix
orders agree on reads without separators)."""

import numpy as np
import pytest
import torch

from rowbowt_tpu_torch.alphabet import Alphabet
from rowbowt_tpu_torch.bigindex import BigIndex
from rowbowt_tpu_torch.construct import merge as M
from rowbowt_tpu_torch.construct import pfp
from rowbowt_tpu_torch.construct import sa as tsa

from test_merge import _rand_parts, gen_bwt_oracle
from test_pfp import _panel
from test_torch_pfp import jax_native  # noqa: F401 (fixture)


def jax_merge(parts, **kw):
    from rowbowt_tpu.construct.merge import merge_construct

    return merge_construct(parts, **kw)


@pytest.mark.parametrize("walk", ["python", "native"])
@pytest.mark.parametrize("sa_dtype", [np.int64, np.uint32], ids=["i64", "u32"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_merge_matches_jax_and_oracle(request, seed, sa_dtype, walk):
    if walk == "native":
        request.getfixturevalue("jax_native")
    rng = np.random.default_rng(seed)
    parts = _rand_parts(rng, k=3 + seed % 3)
    want_bwt, want_sa = gen_bwt_oracle(parts)
    bwt, sa, alpha = M.merge_construct(parts, sa_dtype=sa_dtype, prefetch=seed % 2 == 0)
    jbwt, jsa, jalpha = jax_merge(parts, sa_dtype=sa_dtype, prefetch=False)
    assert bwt.dtype == jbwt.dtype == np.uint8 and sa.dtype == jsa.dtype == sa_dtype
    np.testing.assert_array_equal(bwt, jbwt)
    np.testing.assert_array_equal(sa, jsa)
    np.testing.assert_array_equal(alpha.bytes_, jalpha.bytes_)
    np.testing.assert_array_equal(alpha.decode(bwt), want_bwt)
    np.testing.assert_array_equal(sa.astype(np.int64), want_sa)
    cbwt, csa, _ = M.merge_construct(parts, alpha=alpha, with_sa=False, prefetch=False)
    assert csa is None
    np.testing.assert_array_equal(cbwt, bwt)


def test_python_walk_matches_native():
    """The Python walk (kept for the tests) equals the native one on the
    third document's walk through the first two documents' BWT."""
    rng = np.random.default_rng(9)
    parts = _rand_parts(rng, k=3)
    _, _, alpha = M.merge_construct(parts)
    b01, _, _ = M.merge_construct(parts[:2], alpha=alpha)
    tab = alpha.encode_table()
    A = alpha.size
    counts = np.bincount(tab[np.concatenate(parts[:2]).astype(np.int64)],
                         minlength=A).astype(np.int64)
    Fcum = np.zeros(A + 1, dtype=np.int64)
    np.cumsum(counts, out=Fcum[1:])
    E = np.zeros(A, dtype=np.int64)
    for p in parts[:2]:
        E[int(tab[int(p[-1])])] += 1
    starts = [0, len(parts[0])]
    _, sa01 = gen_bwt_oracle(parts[:2])
    ph_rows = np.sort(np.concatenate(
        [np.nonzero(sa01 == s)[0] for s in starts])).astype(np.int64)
    prev_last = {0: parts[1][-1], len(parts[0]): parts[0][-1]}
    ph_chars = np.array([tab[int(prev_last[int(sa01[r])])] for r in ph_rows], dtype=np.uint8)
    dcodes = tab[parts[2].astype(np.int64)].astype(np.uint8)
    pn = M._walk_native(tsa.require_native("rbt_ebwt_walk"), b01, A, Fcum, E, ph_rows,
                        ph_chars, dcodes)
    pp = M._walk_python(b01, A, Fcum, E, ph_rows, ph_chars, dcodes)
    np.testing.assert_array_equal(pn, pp)


@pytest.mark.parametrize("dtype", [np.uint8, np.int64, np.uint32, np.int32])
def test_interleave_native_matches_numpy(dtype):
    """out[ins] = neu, old in the gaps: the native copy (u8, i64, u32) and
    the numpy one (any other dtype, or no library) agree."""
    rng = np.random.default_rng(3)
    old = rng.integers(0, 200, size=50).astype(dtype)
    neu = rng.integers(0, 200, size=20).astype(dtype)
    ins = np.sort(rng.choice(70, size=20, replace=False)).astype(np.int64)
    got = M._interleave(tsa.require_native("rbt_interleave_u8"), old, ins, neu)
    want = M._interleave(None, old, ins, neu)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[ins], neu)


def test_split_text_docs_matches_jax():
    from rowbowt_tpu.construct.merge import split_text_docs as jsplit

    parts = _rand_parts(np.random.default_rng(5), k=4)
    text = np.concatenate(parts)
    starts = np.concatenate(([0], np.cumsum([len(p) for p in parts])[:-1]))
    got, want = M.split_text_docs(text, starts), jsplit(text, starts)
    assert len(got) == len(want) == len(parts)
    for g, w, p in zip(got, want, parts):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p)


def test_merge_without_native_walk_raises(monkeypatch):
    class Bare:
        pass

    monkeypatch.setattr(tsa, "_NATIVE", Bare())
    monkeypatch.setattr(tsa, "_NATIVE_TRIED", True)
    with pytest.raises(RuntimeError, match="rbt_ebwt_walk"):
        M.merge_construct(_rand_parts(np.random.default_rng(0), k=2), prefetch=False)


@pytest.mark.parametrize("seed", [77, 78])
def test_merge_count_ranges_equal_pfp(seed):
    """A merge-built and a PFP-built BigIndex of one panel give the same
    count ranges for reads without separators: through the CPU engine and
    through the port's find_ranges on the CPU."""
    from rowbowt_tpu_torch.cpu_backend import count_ranges_fb2
    from rowbowt_tpu_torch.engine.count import find_ranges
    from rowbowt_tpu_torch.engine.device import TorchIndex

    rng = np.random.default_rng(seed)
    parts, tpos, packed = _panel(rng, ref_len=500, n_haps=4, w=4)
    text = np.concatenate(parts)
    alpha = Alphabet(np.unique(text))
    res = pfp.pfp_construct(parts, w=5, p=9, probe_pos=pfp.marker_window_positions(tpos, 5))
    pb = pfp.assemble_bigindex(res, alpha, block=128, sup_syms=(res.n + 3) // 4)
    mcodes, _, _ = M.merge_construct(parts, alpha=alpha, with_sa=False, prefetch=False)
    mb = BigIndex.from_codes(mcodes, alpha, n_sup=2)
    tab = alpha.encode_table()
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    qs, L = [], 24
    while len(qs) < 40:
        s = int(rng.integers(0, len(text) - L))
        r = text[s:s + L]
        if np.isin(r, acgt).all():  # reads never hold separators
            qs.append(tab[r.astype(np.int64)])
    qc = np.stack(qs).astype(np.int16)
    lens = np.full(len(qs), L, dtype=np.int32)
    plo, phi_ = count_ranges_fb2(pb, qc, lens)
    mlo, mhi = count_ranges_fb2(mb, qc, lens)
    np.testing.assert_array_equal(plo, mlo)
    np.testing.assert_array_equal(phi_, mhi)
    q, ln = torch.from_numpy(qc.astype(np.int32)), torch.from_numpy(lens)
    for big in (pb, mb):
        lo, hi = find_ranges(TorchIndex.from_big(big, "cpu"), q, ln)
        np.testing.assert_array_equal(lo.numpy(), plo)
        np.testing.assert_array_equal(hi.numpy(), phi_)


def test_merge_timing_tool(monkeypatch, capsys):
    """tools/merge_timing.py's copy runs the merge on a small panel and
    prints its seconds, peak RSS and rate."""
    from rowbowt_tpu_torch.tools import merge_timing

    monkeypatch.setattr("sys.argv", ["merge_timing", "3000", "3"])
    merge_timing.main()
    out, err = capsys.readouterr()
    assert "n=12,041 docs=4 with_sa=True" in err and out.startswith("merge_construct: ")
    assert "M sym/s" in out
