"""The two-level rows of a big (n >= 2^31) index as bit planes.

TorchIndex holds a big index's nibble rows (fb2_64, fb2, fb2_256) as three
bit planes a row (engine/device.bit_planes), which the plain ranks
(ops/rank.rank_fblock2, bwt_sym) and the kernels (csrc/lf_rank.cuh Planes)
read.  On small indexes (n_sup 3 and 4, 64-, 128- and 256-symbol rows, 5
and 8 codes, a partial last row) the repack gives back every nibble row,
and the plane rank, LF step and bwt_sym equal the JAX package's over the
nibble rows at every position and code; the superblock multiplier equals
floor division at every row id, up to the int32 limit.  A numpy model of
lf_count2_kernel (each rank split over the lane's two threads as the kernel
splits it, one fetch where lo and hi + 1 share a row, the record written in
step to L) runs behind the fake C entry through cuda_lf.launch_k1: its
ranges equal JAX's, and its record gives JAX's _toehold_trajectory and the
record's contract (tests/test_torch_record.py).  Every output is an
integer, so equality is exact."""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rowbowt_tpu.bigindex as JB
import rowbowt_tpu_torch.bigindex as TB
from rowbowt_tpu.alphabet import Alphabet as JAlphabet
from rowbowt_tpu.engine import locate as JL
from rowbowt_tpu.engine.count import find_ranges as jax_find_ranges
from rowbowt_tpu.ops import rank as JR
from rowbowt_tpu_torch.alphabet import Alphabet
from rowbowt_tpu_torch.engine import locate as TL
from rowbowt_tpu_torch.engine.device import (PLANE_KEYS, PLANE_ROW, PLANE_SYMS, TorchIndex,
                                             bit_planes, nibbles_of_planes, plane_columns)
from rowbowt_tpu_torch.ops import cuda_lf
from rowbowt_tpu_torch.ops import rank as TR
from test_torch_bigindex import LAYOUTS, _eq, from_jax, marker_panel  # noqa: F401
from test_torch_record import _views, layout_case, replay  # noqa: F401
from test_torch_toehold import _ints

# (codes, superblocks, layout): n is not a multiple of any row width, so
# each table's last row is partial
CASES = [(A, n_sup, layout) for A in (5, 8) for n_sup, layout in
         ((3, "fb2_64"), (4, "fb2"), (3, "fb2_256"), (4, "fb2_256"))]


@pytest.fixture(scope="module", params=CASES, ids=[f"A{a}-sup{s}-{k}" for a, s, k in CASES])
def small(request):
    """(layout, BWT codes, JAX DeviceIndex over the nibble rows, the port's
    view over their bit planes, the nibble rows) of random codes in [0, A)
    (every code present), n = 5,000 + 37."""
    A, n_sup, layout = request.param
    rng = np.random.default_rng(100 * A + n_sup)
    n = 5_037
    codes = rng.integers(0, A, n).astype(np.uint8)
    codes[:A] = np.arange(A)
    text = np.frombuffer(b"\x01\x02ACGTNX"[:A], np.uint8)
    block, fb64 = LAYOUTS[layout]
    tb = TB.BigIndex.from_codes(codes, Alphabet(text), n_sup=n_sup, block=block)
    if block == 128:
        jb = JB.BigIndex.from_codes(codes, JAlphabet(text), n_sup=n_sup)
    else:  # the JAX package builds 256-symbol rows only in its PFP builder
        jb = JB.BigIndex(fb2=tb.fb2.copy(), base=tb.base.copy(), F=tb.F.copy(), n=tb.n, A=tb.A,
                         per_blk=tb.per_blk, alpha=JAlphabet(text))
    dx = jb.device_index(fb64=fb64)
    tx = TorchIndex.from_big(tb, "cpu", fb64=fb64)
    assert cuda_lf.row_layout(tx) == layout and n % PLANE_SYMS[layout]
    return layout, codes, dx, tx, np.asarray(dx.arrays[layout])


def _plane_symbols(planes: np.ndarray, syms: int) -> np.ndarray:
    """[rows, syms] codes of plane rows: bit p of symbol 32g + i is bit i of
    plane p's word g (plane_columns)."""
    P = planes[:, plane_columns(syms)].view(np.uint32).astype(np.int64)  # [rows, 3, G]
    bits = (P[:, :, :, None] >> np.arange(32)) & 1
    return (bits << np.arange(3)[None, :, None, None]).sum(axis=1).reshape(len(planes), syms)


def test_repack_round_trip(small):
    """Each plane row holds its nibble row's checkpoints and symbols (the
    pad nibble 15 past n as 7), 128-byte rows at 256 symbols, 0.8x the
    nibble rows' bytes; nibbles_of_planes gives the nibble rows back."""
    layout, codes, dx, tx, nib = small
    syms = PLANE_SYMS[layout]
    planes = tx.arrays[PLANE_KEYS[layout]].numpy()
    n = len(codes)
    assert planes.shape == (nib.shape[0], PLANE_ROW[syms]) and planes.dtype == np.int32
    assert layout not in tx.arrays and tx.planes_bytes == planes.nbytes
    np.testing.assert_array_equal(planes[:, :8], nib[:, :8])
    words = nib[:, 8:].view(np.uint32).astype(np.int64)
    want = ((words[:, :, None] >> (4 * np.arange(8))) & 15).reshape(len(nib), syms)
    got = _plane_symbols(planes, syms)
    np.testing.assert_array_equal(got.reshape(-1)[:n], want.reshape(-1)[:n])
    np.testing.assert_array_equal(got.reshape(-1)[:n], codes)
    assert (want.reshape(-1)[n:] == 15).all() and (got.reshape(-1)[n:] == 7).all()
    np.testing.assert_array_equal(nibbles_of_planes(torch.from_numpy(planes), syms, n).numpy(),
                                  nib)
    # the padding words of each thread's last part stay zero
    used = set(plane_columns(syms).reshape(-1).tolist()) | set(range(8))
    pad = [c for c in range(PLANE_ROW[syms]) if c not in used]
    assert len(pad) == {64: 2, 128: 4, 256: 0}[syms] and not planes[:, pad].any()
    assert PLANE_ROW[syms] * 4 == {64: 64, 128: 96, 256: 128}[syms]
    assert bit_planes(nib, syms, "cpu").numpy().tobytes() == planes.tobytes()


def test_plane_rank_matches_jax_everywhere(small):
    """rank_fblock2 over the planes == the JAX package's over the nibble
    rows at every position i in [0, n] and code, and 0 for an absent code;
    at 8 codes code 7 is the pad's symbol, which no rank below n counts."""
    layout, codes, dx, tx, _ = small
    n, A = len(codes), tx.A
    key, shift = TR._fb2_key(tx)
    assert key == layout
    i = np.tile(np.arange(n + 1, dtype=np.int64), A + 1)
    c = np.repeat(np.arange(-1, A, dtype=np.int32), n + 1)
    got = TR.rank_fblock2(tx, torch.from_numpy(i), torch.from_numpy(c), key, shift)
    want = JR.rank_fblock2(dx, jnp.asarray(i), jnp.asarray(c), key, shift)
    _eq([got], [want], layout)
    occ = np.zeros((n + 1, A), np.int64)
    occ[1:] = np.cumsum(codes[:, None] == np.arange(A), axis=0)
    np.testing.assert_array_equal(got.numpy()[n + 1:].reshape(A, n + 1), occ.T)


def test_plane_lf_step_and_bwt_sym_match_jax(small):
    """lf_step_fblock2 over the planes == JAX's from (i, i + d) for every
    position i, d in {0, 3}, and every code; bwt_sym == JAX's at every
    position."""
    layout, codes, dx, tx, _ = small
    n, A = len(codes), tx.A
    lo = np.tile(np.arange(n, dtype=np.int64), 2 * (A + 1))
    hi = np.minimum(lo + np.repeat([0, 3], n * (A + 1)), n - 1)
    c = np.tile(np.repeat(np.arange(-1, A, dtype=np.int64), n), 2)
    got = TR.lf_step_fblock2(tx, *(torch.from_numpy(x) for x in (lo, hi, c)))
    want = JR.lf_step_fblock2(dx, *(jnp.asarray(x) for x in (lo, hi, c)))
    _eq(got, want, layout)
    i = np.arange(n, dtype=np.int64)
    got = TR.bwt_sym(tx, torch.from_numpy(i))
    _eq([got], [JR.bwt_sym(dx, jnp.asarray(i))], layout)
    np.testing.assert_array_equal(got.numpy(), codes)


@pytest.mark.parametrize("per_blk", [1, 2, 3, 5, 7, 64, 100, 127, 128, 129, 1000, 4097,
                                     (1 << 20) - 1, (1 << 30) + 1, (1 << 31) - 1])
def test_superblock_magic_is_floor_division(per_blk):
    """(row * mul) >> shift == row // per_blk at every row id below 2^20,
    at every row id of the 2^16 below the int32 limit, and on both sides of
    every superblock edge up to it (of the first 2^16 for small per_blk);
    mul fits 32 bits, as the kernels' multiply takes it."""
    mul, shift = TR.superblock_magic(per_blk)
    assert (1 << 31) <= mul < (1 << 32) and 31 <= shift <= 62

    def check(r):
        r = np.asarray(r, np.uint64)
        np.testing.assert_array_equal((r * np.uint64(mul)) >> np.uint64(shift),
                                      r // np.uint64(per_blk), err_msg=str(per_blk))

    top = (1 << 31) - 1
    check(np.arange(1 << 20))
    check(np.arange(top - (1 << 16), top + 1))
    edges = np.arange(1, min(top // per_blk, 1 << 16) + 1, dtype=np.int64) * per_blk
    check(np.concatenate([edges - 1, edges[edges <= top]]))
    with pytest.raises(ValueError, match="per_blk"):
        TR.superblock_magic(0)


def test_superblock_magic_of_every_table(small):
    """The wrapper's (mul, shift) over a table's layout gives each row id of
    the table the superblock whose base the plain rank adds."""
    layout, _, _, tx, _ = small
    rows = tx.arrays[PLANE_KEYS[layout]]
    mul, shift = cuda_lf.superblock_args(rows, tx.arrays["fb2_base"])
    per_blk = rows.shape[0] // tx.arrays["fb2_base"].shape[0]
    r = np.arange(rows.shape[0], dtype=np.uint64)
    np.testing.assert_array_equal((r * np.uint64(mul)) >> np.uint64(shift), r // per_blk)


# ---------------------------------------------------------------------------
# a numpy model of lf_count2_kernel behind the fake C entry

def _popcount(x: int) -> int:
    return bin(x).count("1")


def model_search(planes, syms, F, base, mul, shift, A, n, qc, lens, record, bump):
    """(lo, hi, hi_rec) of lf_count2_kernel, lane by lane: each step's two
    ranks split over the lane's two threads as csrc/lf_rank.cuh
    rank_pair_planes splits them (thread t: checkpoint c where c >> 2 == t,
    its plane parts 2 (1 + m) + t, the matches of its 32-symbol words below
    the offset), lo's row fetched once where hi + 1 shares it, each thread's
    superblock (row * mul) >> shift; with `record`, every lane of the batch
    runs to L, hi_rec[j] its hi before step j.  `bump` counts the edges."""
    kW, kPer = syms // 64, (3 * (syms // 64) + 3) // 4
    rs = syms.bit_length() - 1
    parts = planes.view(np.uint32).reshape(len(planes), 2 * (1 + kPer), 4)
    ones = 0xFFFFFFFF

    def fetch(row, sub):
        # the thread's plane parts, as the kernel loads them
        return [int(x) for m in range(kPer) for x in parts[row, 2 * (1 + m) + sub]]

    def count(words, sub, c, off):
        m = [0 if (c >> k) & 1 else ones for k in range(3)]
        total = 0
        for w in range(kW):
            match = (words[w] ^ m[0]) & (words[kW + w] ^ m[1]) & (words[2 * kW + w] ^ m[2])
            kn = min(max(off - 32 * (sub * kW + w), 0), 32)
            total += _popcount(match & ((1 << kn) - 1))
        return total

    def rank_pair(lo, i1, c):
        has0, has1 = lo < n, i1 < n
        r0, r1 = lo >> rs, i1 >> rs
        one = r0 == r1
        bump("one fetch" if has1 and one else "two fetches" if has1 else "hi + 1 == n")
        p0 = p1 = 0
        for sub in (0, 1):
            v = fetch(r0, sub) if has0 else [0] * (4 * kPer)
            w = v if one or not has1 else fetch(r1, sub)
            ck = (c >> 2) == sub
            k0 = int(parts[r0, c >> 2, c & 3]) if has0 and ck else 0
            k1 = int(parts[r1, c >> 2, c & 3]) if has1 and ck and not one else k0
            p0 += k0 + count(v, sub, c, lo & (syms - 1))
            p1 += k1 + count(w, sub, c, i1 & (syms - 1))
        tot = int(F[c + 1] - F[c])
        cb = int(base[(r0 * mul) >> shift, c]) + p0 if has0 else tot
        ce = int(base[(r1 * mul) >> shift, c]) + p1 if has1 else tot
        return cb, ce

    B, L = qc.shape
    lo_out, hi_out = np.zeros(B, np.int64), np.zeros(B, np.int64)
    rec = np.zeros((L, B), np.int64)
    for b in range(B):
        lo, hi, live = 0, n - 1, True
        jend = min(int(lens[b]), L)
        for j in range(L if record else jend):
            rec[j, b] = hi
            if not (live and j < jend):
                bump("record held")
                continue
            c = int(qc[b, L - 1 - j])
            if not 0 <= c < A:
                bump("absent code")
                lo, hi, live = 1, 0, False
                continue
            cb, ce = rank_pair(lo, hi + 1, c)
            if ce - cb <= 0:
                bump("empty")
                lo, hi, live = 1, 0, False
                continue
            lo = int(F[c]) + cb
            hi = lo + ce - cb - 1
        lo_out[b], hi_out[b] = lo, hi
    return lo_out, hi_out, rec


def model_lib(tx, calls, edges):
    """rbt_lf_count_fb2 as model_search over the operands at the addresses
    the wrapper passes; the single-level entry refuses."""
    key = cuda_lf.row_layout(tx)
    rows = cuda_lf.rows_of(tx, key).shape
    n_sup = tx.arrays["fb2_base"].shape[0]

    def bump(edge):
        edges[edge] = edges.get(edge, 0) + 1

    def rbt_lf_count_fb2(fb, syms, F, base, mul, shift, A, n, q, lengths, B, L, lo, hi, hi_rec,
                         threads, stage, stream):
        calls.append(dict(syms=syms, blk=(mul, shift), B=B, L=L, record=hi_rec is not None))
        if B == 0:
            return 0
        got = model_search(_ints(fb, rows[0] * rows[1], 4).reshape(rows), syms,
                           _ints(F, A + 1, 8), _ints(base, n_sup * 8, 8).reshape(-1, 8), mul,
                           shift, A, n, _ints(q, B * L, 4).reshape(B, L), _ints(lengths, B, 4),
                           hi_rec is not None, bump)
        _ints(lo, B, 8)[:] = got[0]
        _ints(hi, B, 8)[:] = got[1]
        if hi_rec is not None:
            _ints(hi_rec, L * B, 8)[:] = got[2].reshape(-1)
        return 0

    def single(*a):
        raise AssertionError("the single-level entry was called for two-level rows")

    return SimpleNamespace(rbt_lf_count_fb2=rbt_lf_count_fb2, rbt_lf_count=single,
                           rbt_cuda_error_string=lambda rc: b"invalid argument")


@pytest.fixture
def fake_model(monkeypatch):
    """install(tx) puts the model behind the C entry, the stream and the SM
    count replaced; rec["calls"], rec["edges"] what it saw; the trajectory
    toehold's record then comes from the record launch on CPU tensors."""
    rec = {"calls": [], "edges": {}}

    def install(tx):
        monkeypatch.setattr(cuda_lf, "_LIB", model_lib(tx, rec["calls"], rec["edges"]))

    monkeypatch.setattr(cuda_lf, "_raw_stream", lambda dev: 1000 + dev)
    monkeypatch.setattr(cuda_lf, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(cuda_lf.torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(TL.cuda_lf, "find_ranges_record", lambda tx, q, ln: cuda_lf.launch_k1(
        tx, q, ln.to(torch.int32), use_ftab=False, record=True))
    rec["install"] = install
    return rec


def _random_lanes(rng, B: int, L: int, A: int):
    """B right-aligned lanes of random codes in [0, A) (one in eight an
    absent -1), lengths 0..L."""
    qc = rng.integers(0, A, (B, L)).astype(np.int32)
    qc[rng.random((B, L)) < 0.02] = -1
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    for b in range(B):
        qc[b, :L - lens[b]] = -1
    return qc, lens


def test_model_count_matches_jax(small, fake_model):
    """The model behind the launch == JAX's count search over the nibble
    rows on random lanes, and reaches both fetches, a failure, an absent
    code and hi + 1 == n."""
    layout, codes, dx, tx, _ = small
    rng = np.random.default_rng(len(codes) + tx.A)
    for L in (1, 3, 9):
        qc, lens = _random_lanes(rng, 300, L, tx.A)
        fake_model["install"](tx)
        got = cuda_lf.launch_k1(tx, torch.from_numpy(qc), torch.from_numpy(lens), use_ftab=False)
        want = jax_find_ranges(dx, jnp.asarray(qc), jnp.asarray(lens), use_ftab=False)
        _eq(got, want, f"{layout} L={L}")
    assert {"one fetch", "two fetches", "hi + 1 == n", "empty", "absent code"} <= set(
        fake_model["edges"]), fake_model["edges"]
    assert all(c["blk"] == cuda_lf.superblock_args(cuda_lf.rows_of(tx, layout),
                                                   tx.arrays["fb2_base"])
               and not c["record"] for c in fake_model["calls"])


def test_model_record_gives_jax_trajectory_toeholds(layout_case, fake_model):
    """On the marker panel's BigIndex (tests/test_torch_record.py): the
    model's record launch, through engine/locate's trajectory resolve, gives
    JAX's _toehold_trajectory, and its record the contract's (replay), at
    the batch's width and its views."""
    layout, idx, dx, txs, codes, F, (qc, lens, q, ln) = layout_case
    tx = txs[1]
    fake_model["install"](tx)
    for vq, vl in [(qc, lens)] + _views(qc, lens):
        q, ln = torch.from_numpy(np.ascontiguousarray(vq)), torch.from_numpy(vl)
        want = JL._toehold_trajectory(dx, jnp.asarray(vq), jnp.asarray(vl))
        _eq(TL.find_ranges_w_toehold(tx, q, ln), want, f"{layout} width {vq.shape[1]}")
        _eq(cuda_lf.launch_k1(tx, q, ln, use_ftab=False, record=True),
            replay(codes, F, tx.A, vq, vl), f"{layout} record, width {vq.shape[1]}")
    assert all(c["record"] for c in fake_model["calls"])
    assert {"one fetch", "two fetches", "record held"} <= set(fake_model["edges"])


def test_views_hold_one_layout(small):
    """The view's two-level readers find the planes alone: no nibble rows
    stay in it, and a view whose planes are taken away has no fused rows."""
    layout, _, _, tx, _ = small
    assert not set(tx.arrays) & set(PLANE_KEYS) and cuda_lf.row_layout(tx) == layout
    bare = dataclasses.replace(tx, arrays={k: v for k, v in tx.arrays.items()
                                           if k not in PLANE_KEYS.values()})
    assert cuda_lf.row_layout(bare) is None
    with pytest.raises(ValueError, match="no two-level rows"):
        TR._fb2_key(bare)
    assert from_jax(dx_like(tx)).arrays.keys() == tx.arrays.keys()


def dx_like(tx):
    """A stand-in for a JAX DeviceIndex with the nibble rows tx's planes
    were made from, for from_jax."""
    layout = cuda_lf.row_layout(tx)
    arrays = {k: v.numpy() for k, v in tx.arrays.items() if k not in PLANE_KEYS.values()}
    arrays[layout] = nibbles_of_planes(tx.arrays[PLANE_KEYS[layout]], PLANE_SYMS[layout],
                                       tx.n).numpy()
    return SimpleNamespace(arrays=arrays, n=tx.n, R=tx.R, A=tx.A, ma_wsize=tx.ma_wsize,
                           ftab_k=tx.ftab_k, acgt_codes=tx.acgt_codes, ma_bs=tx.ma_bs,
                           pp_bs=tx.pp_bs, ma_rp=tx.ma_rp)
