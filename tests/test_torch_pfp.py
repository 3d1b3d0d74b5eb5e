"""The port's PFP construction (construct/pfp.py over native/pfp.cpp, from the
port's host library) == the JAX package's construct/pfp.py, array for array,
and == the port's whole-text oracle (BigIndex.from_codes + attach_locate /
attach_markers over the port's SA-IS), byte for byte, as tests/test_pfp.py
holds the JAX package.

The JAX package finds no native library of its own here; `jax_native` hands
it the port's build of the same sources for the length of one test."""

import ctypes

import numpy as np
import pytest

from rowbowt_tpu_torch import _native
from rowbowt_tpu_torch.alphabet import TERM_BYTE, Alphabet
from rowbowt_tpu_torch.bigindex import BigIndex
from rowbowt_tpu_torch.construct import pfp
from rowbowt_tpu_torch.construct import sa as tsa
from rowbowt_tpu_torch.construct.sa import suffix_array

from test_pfp import _panel

BIG_TABLES = ("fb2", "base", "F", "run_start", "run_head", "samples_last", "pred_pos",
              "phi_at", "cruns_keys", "ma_row", "ma_val")


@pytest.fixture
def jax_native(monkeypatch):
    """rowbowt_tpu.construct.sa loads the port's host library (a handle of
    its own, with the rbt_sais_u8 argtypes that its _load_native sets)."""
    from rowbowt_tpu.construct import sa as jsa

    path, _ = _native.build_host_library()
    lib = ctypes.CDLL(path)
    lib.rbt_sais_u8.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
    lib.rbt_sais_u8.restype = ctypes.c_int
    monkeypatch.setattr(jsa, "_NATIVE", lib)
    monkeypatch.setattr(jsa, "_NATIVE_TRIED", True)
    return lib


def assert_big_equal(got, want, names=BIG_TABLES):
    """Every table of two BigIndexes (either package's) equal, dtype too."""
    assert (got.n, got.A, got.per_blk, got.ma_wsize) == (want.n, want.A, want.per_blk,
                                                         want.ma_wsize)
    np.testing.assert_array_equal(got.alpha.bytes_, want.alpha.bytes_)
    for k in names:
        g, w = getattr(got, k), getattr(want, k)
        assert (g is None) == (w is None), k
        if g is not None:
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=k)


def oracle_big(text, alpha, tpos, packed, wsize, block):
    """The port's whole-text oracle: SA-IS, the BWT codes, from_codes with
    four superblocks, locate and marker tables from the full SA."""
    sa = suffix_array(text)
    n = text.shape[0]
    bwt = alpha.encode_table()[text[(sa - 1) % n].astype(np.int64)].astype(np.uint8)
    big = BigIndex.from_codes(bwt, alpha, n_sup=4, block=block)
    big.attach_locate(bwt, sa)
    big.attach_markers(sa, tpos, packed, wsize)
    return big, sa


def pfp_big(mod, parts, alpha, w, p, tpos, packed, wsize, block):
    """(BigIndex, PfpResult) through `mod` (either package's pfp module)."""
    n = sum(int(x.shape[0]) for x in parts)
    probes = mod.marker_window_positions(tpos, wsize)
    res = mod.pfp_construct(parts, w=w, p=p, probe_pos=probes)
    big = mod.assemble_bigindex(res, alpha, block=block, sup_syms=(n + 3) // 4)
    mod.attach_markers_from_probes(big, res, tpos, packed, wsize)
    return big, res


def texts(kind):
    """(documents, marker text positions, packed markers, window, pfp w, p)."""
    if kind == "random":  # no panel structure, five codes, no separators
        rng = np.random.default_rng(9)
        body = rng.choice(np.frombuffer(b"ACGTN", dtype=np.uint8), size=1500)
        return ([np.concatenate([body, [np.uint8(TERM_BYTE)]])], np.array([5]), np.array([0]),
                3, 5, 7)
    rng = np.random.default_rng(21)  # tandem repeats: deep groups, long runs
    unit = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=37)
    body = np.tile(unit, 60)
    body[rng.integers(0, body.shape[0], size=15)] = ord("A")
    return ([np.concatenate([body, [np.uint8(TERM_BYTE)]])], np.array([9]), np.array([1]),
            4, 4, 5)


def check_against_jax_and_oracle(parts, tpos, packed, wsize, w, p, block):
    from rowbowt_tpu.alphabet import Alphabet as JaxAlphabet
    from rowbowt_tpu.construct import pfp as jpfp

    text = np.concatenate(parts)
    alpha = Alphabet(np.unique(text))
    big, res = pfp_big(pfp, parts, alpha, w, p, tpos, packed, wsize, block)
    jbig, jres = pfp_big(jpfp, parts, JaxAlphabet(np.unique(text)), w, p, tpos, packed,
                         wsize, block)
    # the sweep's outputs, the phi breakpoints, the assembled tables
    for k in ("run_heads", "run_start", "run_sa_first", "run_sa_last", "probe_rows",
              "watch_rows", "watch_sa", "watch_prev"):
        g, want = getattr(res, k), getattr(jres, k)
        assert g.dtype == want.dtype, k
        np.testing.assert_array_equal(g, want, err_msg=k)
    assert (res.n, res.R, res.j0, res.parse_stats) == (jres.n, jres.R, jres.j0, jres.parse_stats)
    np.testing.assert_array_equal(res.run_lens(), jres.run_lens())
    for g, want in zip(pfp.phi_breakpoints(res), jpfp.phi_breakpoints(jres)):
        np.testing.assert_array_equal(g, want)
    assert_big_equal(big, jbig)
    # byte for byte the whole-text oracle's tables
    ob, sa = oracle_big(text, alpha, tpos, packed, wsize, block)
    assert_big_equal(big, ob)
    run_end = np.concatenate((np.asarray(big.run_start)[1:] - 1, [big.n - 1]))
    np.testing.assert_array_equal(res.run_sa_first, sa[np.asarray(big.run_start).astype(np.int64)])
    np.testing.assert_array_equal(res.run_sa_last, sa[run_end])
    return big, res


@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("seed,w,p", [(1, 4, 5), (2, 6, 17), (3, 10, 31)])
def test_pfp_panel_matches_jax_and_oracle(jax_native, seed, w, p, block):
    parts, tpos, packed = _panel(np.random.default_rng(seed), w=4)
    big, _ = check_against_jax_and_oracle(parts, tpos, packed, 5, w, p, block)
    assert big.fb2.shape[1] == 8 + block // 8


@pytest.mark.parametrize("kind", ["random", "repetitive"])
def test_pfp_unstructured_text_matches_jax_and_oracle(jax_native, kind):
    parts, tpos, packed, wsize, w, p = texts(kind)
    check_against_jax_and_oracle(parts, tpos, packed, wsize, w, p, 128)


def test_marker_window_positions_match_jax():
    from rowbowt_tpu.construct import pfp as jpfp

    tpos = np.array([0, 3, 4, 17, 100, 101], dtype=np.int64)
    for wsize in (1, 4, 10):
        got, want = pfp.marker_window_positions(tpos, wsize), jpfp.marker_window_positions(
            tpos, wsize)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_pfp_saved_directory_loads_in_both_packages(jax_native, tmp_path):
    """A PFP-assembled BigIndex saved by the port loads in both packages'
    BigIndex.load with the same tables."""
    from rowbowt_tpu.bigindex import BigIndex as JaxBigIndex

    parts, tpos, packed = _panel(np.random.default_rng(4), w=4)
    big, _ = pfp_big(pfp, parts, Alphabet(np.unique(np.concatenate(parts))), 6, 11, tpos,
                     packed, 5, 256)
    big.save(str(tmp_path / "big"))
    assert_big_equal(BigIndex.load(str(tmp_path / "big")), big)
    assert_big_equal(JaxBigIndex.load(str(tmp_path / "big")), big)


def test_missing_entry_point_raises(monkeypatch):
    """A host library without the PFP entry points, or none at all (the
    compiler refused), makes pfp_construct raise: there is no other route."""
    class Bare:
        pass

    monkeypatch.setattr(tsa, "_NATIVE", Bare())
    monkeypatch.setattr(tsa, "_NATIVE_TRIED", True)
    parts = [np.frombuffer(b"ACGTACGTACGTAAACCCGGGTTT\x01", dtype=np.uint8)]
    with pytest.raises(RuntimeError, match="rbt_pfp_new"):
        pfp.pfp_construct(parts, w=4, p=5)

    def refuse(*a, **k):
        raise _native.BuildError("g++ failed building librbt_host (exit 1)")

    monkeypatch.setattr(_native, "build_shared", refuse)
    monkeypatch.setattr(tsa, "_NATIVE", None)
    monkeypatch.setattr(tsa, "_NATIVE_TRIED", False)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed building librbt_host"):
        pfp.pfp_construct(parts, w=4, p=5)
