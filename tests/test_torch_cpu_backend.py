"""The port's CPU engine bindings (cpu_backend.py over native/cpu_engine.cpp)
== the JAX package's on the same index and reads: count over the 128- and
256-symbol two-level rows, locate, windowed markers, greedy seeding, count
over a whole index; and count_ranges_fb2 == the port's find_ranges on the
CPU.  The index is a PFP-built panel (construct/pfp.py), saved once and
loaded by each package."""

import numpy as np
import pytest
import torch

from rowbowt_tpu_torch import cpu_backend as C
from rowbowt_tpu_torch.alphabet import Alphabet, revcomp
from rowbowt_tpu_torch.bigindex import BigIndex
from rowbowt_tpu_torch.construct import pfp
from rowbowt_tpu_torch.construct import sa as tsa

from test_pfp import _panel
from test_torch_pfp import jax_native  # noqa: F401 (fixture)

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """(text, {block: saved BigIndex directory}, reads [B] of uint8 arrays):
    a reference + 4 haplotypes panel (window 5), 60 reads: substrings of
    every document, a fifth with one substitution, three random, one of 3
    bases, and one empty."""
    rng = np.random.default_rng(13)
    parts, tpos, packed = _panel(rng, ref_len=700, n_haps=4, n_vars=25, w=5)
    text = np.concatenate(parts)
    alpha = Alphabet(np.unique(text))
    res = pfp.pfp_construct(parts, w=6, p=11, probe_pos=pfp.marker_window_positions(tpos, 5))
    d = tmp_path_factory.mktemp("cpu_backend")
    dirs = {}
    for block in (128, 256):
        big = pfp.assemble_bigindex(res, alpha, block=block, sup_syms=(res.n + 2) // 3)
        pfp.attach_markers_from_probes(big, res, tpos, packed, 5)
        dirs[block] = str(d / f"b{block}")
        big.save(dirs[block])
    reads = []
    while len(reads) < 52:
        L = int(rng.integers(12, 48))
        s = int(rng.integers(0, len(text) - L))
        r = text[s:s + L].copy()
        if np.isin(r, ACGT).all():
            if len(reads) % 5 == 1:
                r[rng.integers(0, L)] = rng.choice(ACGT)
            reads.append(r)
    reads += [rng.choice(ACGT, size=30) for _ in range(3)] + [ACGT[:3].copy()]
    reads += [np.empty(0, np.uint8)]
    return text, dirs, reads


def batch(alpha, reads, width=48):
    """int16 [B, width] right-aligned codes (-1 pad) and int32 lengths."""
    tab = alpha.encode_table()
    qc = np.full((len(reads), width), -1, dtype=np.int16)
    for i, r in enumerate(reads):
        if len(r):
            qc[i, width - len(r):] = tab[r.astype(np.int64)]
    return qc, np.array([len(r) for r in reads], dtype=np.int32)


def both(saved_dir):
    """The directory loaded by the port and by the JAX package."""
    from rowbowt_tpu.bigindex import BigIndex as JaxBigIndex

    return BigIndex.load(saved_dir), JaxBigIndex.load(saved_dir)


def assert_outputs_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_available_matches_jax(jax_native):
    from rowbowt_tpu import cpu_backend as JC

    assert C.available() and JC.available()


@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("fn", ["count_ranges_fb2g", "locate_fb2", "markers_fb2", "greedy_fb2"])
def test_fb2_engines_match_jax(jax_native, saved, fn, block):
    from rowbowt_tpu import cpu_backend as JC

    _, dirs, reads = saved
    big, jbig = both(dirs[block])
    if fn == "greedy_fb2":  # both strands, as rb_markers queries them
        reads = [x for r in reads for x in (r, revcomp(r))]
    qc, lens = batch(big.alpha, reads)
    kw = {"locate_fb2": dict(max_hits=4), "markers_fb2": dict(wsize=5, max_range=1000),
          "greedy_fb2": dict(wsize=5, max_range=1000)}.get(fn, {})
    got = getattr(C, fn)(big, qc, lens, **kw)
    assert_outputs_equal(got, getattr(JC, fn)(jbig, qc, lens, **kw))
    if fn == "locate_fb2":
        lo, hi, k, locs, cnt = got
        assert (hi >= lo).sum() >= 40 and (cnt > 1).any()
    elif fn in ("markers_fb2", "greedy_fb2"):
        assert got[-1].sum() > 0  # markers were probed


def test_count_ranges_fb2_matches_jax_and_find_ranges(jax_native, saved):
    """The 128-symbol count (the bench 'big' baseline) == the JAX binding's,
    == count_ranges_fb2g, and == the port's find_ranges on the CPU."""
    from rowbowt_tpu import cpu_backend as JC
    from rowbowt_tpu_torch.engine.count import find_ranges
    from rowbowt_tpu_torch.engine.device import TorchIndex

    _, dirs, reads = saved
    big, jbig = both(dirs[128])
    qc, lens = batch(big.alpha, reads)
    got = C.count_ranges_fb2(big, qc, lens)
    assert_outputs_equal(got, JC.count_ranges_fb2(jbig, qc, lens))
    assert_outputs_equal(got, C.count_ranges_fb2g(big, qc, lens))
    for fb64 in (True, False):
        lo, hi = find_ranges(TorchIndex.from_big(big, "cpu", fb64=fb64),
                             torch.from_numpy(qc.astype(np.int32)), torch.from_numpy(lens))
        np.testing.assert_array_equal(lo.numpy(), got[0])
        np.testing.assert_array_equal(hi.numpy(), got[1])


def test_count_ranges_matches_jax_and_find_ranges(jax_native, saved):
    """count_ranges over a whole (single-level) index of the same text ==
    the JAX binding over the JAX package's index, and the port's
    find_ranges on the CPU, and the two-level count."""
    from rowbowt_tpu import cpu_backend as JC
    from rowbowt_tpu.construct.build import build_index as jax_build_index
    from rowbowt_tpu_torch.construct.build import build_index
    from rowbowt_tpu_torch.engine.count import find_ranges
    from rowbowt_tpu_torch.engine.device import TorchIndex

    text, dirs, reads = saved
    idx, jidx = build_index(text), jax_build_index(text)
    qc, lens = batch(idx.alpha, reads)
    got = C.count_ranges(idx, qc, lens)
    assert_outputs_equal(got, JC.count_ranges(jidx, qc, lens))
    lo, hi = find_ranges(TorchIndex.from_index(idx, "cpu"),
                         torch.from_numpy(qc.astype(np.int32)), torch.from_numpy(lens))
    np.testing.assert_array_equal(lo.numpy(), got[0])
    np.testing.assert_array_equal(hi.numpy(), got[1])
    assert_outputs_equal(got, C.count_ranges_fb2g(BigIndex.load(dirs[256]), qc, lens))


@pytest.mark.parametrize("fn", ["count_ranges_fb2", "count_ranges_fb2g", "locate_fb2",
                                "markers_fb2", "greedy_fb2", "count_ranges"])
def test_missing_entry_point_raises(monkeypatch, saved, fn):
    """Without the CPU engine in the host library every binding raises and
    available() says so."""
    class Bare:
        pass

    monkeypatch.setattr(tsa, "_NATIVE", Bare())
    monkeypatch.setattr(tsa, "_NATIVE_TRIED", True)
    assert not C.available()
    big = BigIndex.load(saved[1][128])
    qc, lens = batch(big.alpha, saved[2][:2])
    args = {"markers_fb2": (5, 1000), "greedy_fb2": (5, 1000)}.get(fn, ())
    with pytest.raises(RuntimeError, match="host library lacks rbt_cpu_"):
        getattr(C, fn)(big, qc, lens, *args)
