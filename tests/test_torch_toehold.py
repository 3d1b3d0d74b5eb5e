"""The per-step toehold search of `rbt_align -s` on indexes built from run
samples alone (ops/cuda_lf.find_ranges_toehold, K1's toehold launch) and the
walk kernel's predecessor route (ops/cuda_phi, route "pred").

A numpy model of the kernel's search (csrc/lf.cu, the TOE instance: the LF
steps over the fused rows, hi + 1's rank in hi's own row with the trivial
test packed beside it, the last non-trivial step carried with a count of
the trivial steps after it, one resolve a lane from tk1 or from ltk at the run
found through the bucket directory rs_off over run_start) equals the JAX
package's find_ranges_w_toehold buffer for buffer on a raw-built index (construct/rawio.write_raw, then
build_index_from_raw) with occ1 + tk1 and on the same index with them
dropped (the ltk route), at L = 1, 31 and 100, on read batches that reach
every edge the model counts.  The launch path, with its C entry replaced by
that model reading the addresses the wrapper passes, equals the plain twin;
refused launches raise and count nothing; the routes follow the tables.  On
a `--no-dense` index the toeholds and the walk over the predecessor search
equal the JAX package's, and the walk's launch path with a numpy model of
its kernel (the lower bound through the bucket directory pred_off over
pred_pos) equals the torch walk.  Both directory searches equal the JAX
package's at every position, over a directory of many empty buckets, the
loader's and one of a single bucket.  Every output is an integer, so every
check is exact."""

import ctypes
import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rowbowt_tpu.engine import locate as JL
from rowbowt_tpu.engine.device import DeviceIndex
from rowbowt_tpu.ops import rank as JR
from rowbowt_tpu_torch.construct import build as TB
from rowbowt_tpu_torch.construct import panel as TP
from rowbowt_tpu_torch.construct import rawio as TRAW
from rowbowt_tpu_torch.engine import locate as TL
from rowbowt_tpu_torch.engine.batch import encode_batch
from rowbowt_tpu_torch.engine.device import TorchIndex, run_directory
from rowbowt_tpu_torch.io.fastq import read_seqs
from rowbowt_tpu_torch.ops import cuda_lf, cuda_phi
from test_torch_build import write_inputs

ACGT = np.frombuffer(b"ACGT", np.uint8)
WIDTHS = (1, 31, 100)
ROUTES = ("tk1", "ltk")
TOE_TABLES = ("tk1_flat", "ltk", "run_start", "samples_last")
# the directory spans of the search tests: 2 positions a bucket (most
# buckets empty), the loader's (run_directory's default) and one bucket
# (a binary search over every entry)
SHIFTS = {"small": 1, "loader": None, "one_bucket": 62}


def _raw_index(tmp, idx):
    """idx written as raw .bwt/.ssa/.esa/.docs files and built back from
    the prefix: fused rows, occ1 + tk1 (n below OCC1_MAX_N), no kval."""
    prefix = str(tmp / "raw")
    TRAW.write_raw(idx, prefix)
    raw = TRAW.build_index_from_raw(prefix, ftab_k=0)
    assert raw.kval is None and raw.tk1 is not None and raw.fblock is not None
    return raw


def _text_reads(text, rng, n_reads, max_len):
    """Substrings of the text's ACGT stretches, some with a substitution,
    some random, one with an N (code -1) last, one with an N inside."""
    acgt = np.flatnonzero(np.isin(text, ACGT))
    out = []
    for q in range(n_reads):
        m = int(rng.integers(1, max_len + 1))
        p = int(rng.choice(acgt[acgt < len(text) - m]))
        r = bytearray(text[p:p + m].tobytes())
        if q % 7 == 3:
            r[int(rng.integers(0, m))] = int(rng.choice(ACGT))
        elif q % 7 == 5:
            r = bytearray(rng.choice(ACGT, size=m).tobytes())
        out.append(bytes(r))
    return out + [out[0][:-1] + b"N", b"N" + out[1], b"N"]


def _edge_codes(idx, text):
    """Code lanes the reads do not reach: the text's prefixes behind its
    terminator (the toehold reaches 0, then a trivial step wraps it to
    n - 1), and the BWT read backwards from row n - 1 (every step trivial:
    no non-trivial step at all)."""
    codes = idx.alpha.encode(text).astype(np.int64)
    bwt = np.repeat(idx.run_head, idx.run_lengths()).astype(np.int64)
    lanes = [np.concatenate([[codes[-1]], codes[:m]]) for m in (8, 20, 40)]
    occ = np.zeros(idx.A, np.int64)
    before = np.zeros(idx.n, np.int64)  # rank(i, BWT[i])
    for i, c in enumerate(bwt.tolist()):
        before[i] = occ[c]
        occ[c] += 1
    F = np.asarray(idx.F).astype(np.int64)
    walk, hi = [], idx.n - 1
    for _ in range(30):
        walk.append(bwt[hi])
        hi = F[bwt[hi]] + before[hi]  # LF of the row: the range stays one row
    lanes += [np.array(walk[::-1][-m:]) for m in (1, 5, 30)]
    return lanes


def _lanes(idx, text, reads, L):
    """[B, L] int32 codes (right-aligned, -1 pad) and lengths: the reads and
    the edge lanes cut to their last L codes, then two length-0 lanes."""
    enc = [idx.alpha.encode(np.frombuffer(r, np.uint8)).astype(np.int64) for r in reads]
    enc += _edge_codes(idx, text)
    B = len(enc) + 2 + (len(enc) % 2 == 0)  # odd: never a whole number of blocks
    qc = np.full((B, L), -1, np.int32)
    lens = np.zeros(B, np.int32)
    for b, e in enumerate(enc):
        e = e[-L:]
        qc[b, L - len(e):] = e
        lens[b] = len(e)
    return qc, lens


@pytest.fixture(scope="module")
def raw_cases(tmp_path_factory):
    """{name: (RbtIndex, text, reads)}: the in-repo panel and a random text
    of one document, each raw-built."""
    d = tmp_path_factory.mktemp("torch_toehold")
    inp = write_inputs(d)
    panel = TP.build_panel(inp["fa"], inp["vcf"])
    full = TB.build_index_from_panel(panel)
    reads = [s for _, s, _ in read_seqs(inp["fq"])]
    rng = np.random.default_rng(5)
    text = np.concatenate([rng.choice(ACGT, size=1500), np.array([1], np.uint8)])
    (d / "rand").mkdir()
    return {"panel": (_raw_index(d, full), panel.text,
                      reads + _text_reads(panel.text, rng, 60, 100)),
            "random": (_raw_index(d / "rand", TB.build_index(text)), text,
                       _text_reads(text, rng, 60, 100))}


def _pair(idx, route, fb64=True):
    """(JAX DeviceIndex, port TorchIndex) of idx on the toehold `route`: as
    built (tk1), or with occ1 and tk1 dropped from both (ltk); the
    TorchIndex also holds the tables a load on the card builds for the
    kernels (with_card_tables: over ltk the directory rs_off)."""
    drop = {"occ1_flat", "tk1_flat"} if route == "ltk" else set()
    dx = DeviceIndex.from_index(idx, fb64=fb64)
    dx = DeviceIndex({k: v for k, v in dx.arrays.items() if k not in drop}, dx.n, dx.R, dx.A,
                     dx.ma_wsize, dx.ftab_k, dx.acgt_codes)
    tx = TorchIndex.from_index(idx, "cpu", fb64=fb64)
    tx = dataclasses.replace(tx, arrays={k: v for k, v in tx.arrays.items() if k not in drop})
    return dx, tx.with_card_tables()


# ---------------------------------------------------------------------------
# the numpy model of the kernel

def _symbols(fb, syms):
    """[rows, syms] BWT codes and [rows, 8] checkpoints of fused rows."""
    words = fb[:, 8:].view(np.uint32).astype(np.int64)
    sym = (words[:, :, None] >> (4 * np.arange(8))) & 15
    return sym.reshape(fb.shape[0], syms), fb[:, :8].astype(np.int64)


def packed_rank(sym, ck, r, off, c, syms):
    """rank(i, c) and [BWT[i - 1] == c] at in-row offset `off` (1 <= off <=
    syms) of row r (i = r * syms + off; numpy arrays or ints) as
    csrc/lf_rank.cuh rank_pair_toe gets them: each of a lane's two threads
    holds the checkpoints 4 * sub to 4 * sub + 3 and the 32-symbol blocks b
    with b % 2 == sub, and adds 2 * (its checkpoint of c and its count of c
    below off) + [it holds the symbol at off - 1 and that symbol is c]
    (toe_share) in uint32; one shuffle sums the two, whose half is the
    rank and whose low bit the test."""
    r, off, c = np.broadcast_arrays(np.asarray(r), np.asarray(off), np.asarray(c))
    pos = np.arange(syms)
    packed = np.zeros(r.shape, np.int64)
    for sub in (0, 1):
        held = (pos // 32) % 2 == sub
        below = (sym[r] == c[..., None]) & held & (pos < off[..., None])
        last = ((off >= 1) & held[np.maximum(off - 1, 0)]
                & (sym[r, np.maximum(off - 1, 0)] == c))
        share = np.where(c >> 2 == sub, ck[r, c], 0) + below.sum(-1)
        packed = (packed + 2 * share + last) % (1 << 32)
    return packed >> 1, (packed & 1) == 1


def run_of(t, x, bump=lambda key: None):
    """(run of position x, its start) as lf_tables.cuh run_of finds them: x
    + 1's bucket of the directory t["rs_off"] (shift t["shift"]), then at
    most t["iters"] halvings of the run starts in it, the start from the
    last probe below x + 1 or, where none was, one more load.  `bump` counts
    the edges: an empty bucket, the last bucket, a search that takes every
    halving, a start loaded after the search."""
    rs, off = t["run_start"], t["rs_off"]
    q = x + 1
    b = min(q >> t["shift"], off.shape[0] - 2)
    lo, hi = int(off[b]), int(off[b + 1])
    if lo == hi:
        bump("empty_bucket")
    if b == off.shape[0] - 2:
        bump("last_bucket")
    start, it = None, 0
    while it < t["iters"] and lo < hi:
        mid = (lo + hi) >> 1
        if rs[mid] < q:
            lo, start = mid + 1, int(rs[mid])
        else:
            hi = mid
        it += 1
    if it == t["iters"]:
        bump("iters_reached")
    if start is None:
        bump("start_loaded")
        start = int(rs[lo - 1])
    return lo - 1, start


def resolve_run(t, n, thi):
    """The run of thi as lf_tables.cuh resolve_toehold finds it over ltk:
    the run of min(thi + 1, n - 1) through the directory t (run_of), one
    less where thi + 1 < n starts that run (its start known from the
    search)."""
    r, start = run_of(t, min(thi + 1, n - 1))
    return r - 1 if thi + 1 < n and start == thi + 1 else r


def kernel_model(fb, syms, F, A, n, q, lens, tk1, ltk, run_start, samples_last, R,
                 directory=None, events=None):
    """(lo, hi, k) int32 [B] as csrc/lf.cu's toehold instance computes them:
    K1's steps from the full range over the fused rows, hi + 1's rank taken
    in hi's own row at in-row offset (hi mod syms) + 1 (the whole row where
    hi + 1 starts the next one or equals n), the trivial test (BWT[hi] ==
    c) its packed low bit (packed_rank); the last
    non-trivial step's code and pre-step hi and the trivial steps after it;
    then k = the table value of that step (tk1 where given, else ltk at the
    run of hi, found through the bucket directory over run_start,
    `directory` {"rs_off", "shift", "iters"}: resolve_run) or k0, less the
    trivial steps, mod n.  A per-step toehold
    (lf_step_w_loc's recurrence) rides beside it and must agree.  `events`,
    a dict, counts the edges the lanes reached."""
    ev = events if events is not None else {}
    shift = {64: 6, 128: 7}[syms]
    sym, ck = _symbols(fb, syms)
    F = F.astype(np.int64)

    def rank(i, c):
        if i >= n:
            return int(F[c + 1] - F[c])
        r, off = i >> shift, i & (syms - 1)
        return int(ck[r, c] + np.count_nonzero(sym[r, :off] == c))

    def table(c, hi):
        if tk1 is not None:
            return int(tk1[c * n + hi])
        return int(ltk[c * R + resolve_run(dict(directory, run_start=run_start), n, hi)])

    def bump(key):
        ev[key] = ev.get(key, 0) + 1

    k0 = (int(samples_last[R - 1]) + 1) % n
    B, L = q.shape
    out = np.zeros((3, B), np.int32)
    for b in range(B):
        lo, hi, tc, thi, triv, kstep = 0, n - 1, -1, 0, 0, k0
        steps = min(int(lens[b]), L)
        if steps == 0:
            bump("length_0")
        for j in range(steps):
            c = int(q[b, L - 1 - j])
            if not 0 <= c < A:
                bump("absent_code")
                if j == 0:
                    bump("fail_first_step")
                lo, hi = 1, 0
                break
            i1 = hi + 1
            if i1 == n or i1 & (syms - 1) == 0:
                bump("hi1_is_n" if i1 == n else "hi1_row_start")
            cb, ce = rank(lo, c), rank(i1, c)
            ce_packed, trivial = packed_rank(sym, ck, hi >> shift, (hi & (syms - 1)) + 1, c,
                                             syms)
            assert ce_packed == ce
            if ce - cb <= 0:
                bump("fail_first_step" if j == 0 else "fail_later")
                lo, hi = 1, 0
                break
            if trivial:
                bump("trivial")
                if kstep == 0:
                    bump("k_wraps")
                triv += 1
                kstep = n - 1 if kstep == 0 else kstep - 1
            else:
                bump("nontrivial")
                tc, thi, triv = c, hi, 0
                kstep = table(c, hi)
            lo = int(F[c]) + cb
            hi = lo + ce - cb - 1
        if hi < lo:
            k = 0
        else:
            if tc < 0 and steps:
                bump("no_nontrivial_step")
            k = ((k0 if tc < 0 else table(tc, thi)) - triv) % n
            assert k == kstep, (b, k, kstep)
        out[:, b] = lo, hi, k
    return out[0], out[1], out[2]


def _directory(tx):
    """The model's directory over run_start: tx's rs_off and its (shift,
    iters), or None where tx has none."""
    if "rs_off" not in tx.arrays:
        return None
    return {"rs_off": tx.arrays["rs_off"].numpy(), "shift": tx.rs_bs[0], "iters": tx.rs_bs[1]}


def _model_on(tx, qc, lens, events=None):
    """kernel_model over tx's tables (numpy views of the tensors)."""
    key = cuda_lf.row_layout(tx)
    a = {k: tx.arrays[k].numpy() if k in tx.arrays else None for k in TOE_TABLES}
    return kernel_model(tx.arrays[key].numpy(), cuda_lf._SYMS_PER_ROW[key],
                        tx.arrays["F"].numpy(), tx.A, tx.n, qc, lens, a["tk1_flat"],
                        a["ltk"], a["run_start"], a["samples_last"], tx.R, _directory(tx),
                        events)


def _jax(dx, qc, lens):
    return [np.asarray(t) for t in JL.find_ranges_w_toehold(dx, jnp.asarray(qc),
                                                            jnp.asarray(lens))]


def _eq(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("L", WIDTHS)
@pytest.mark.parametrize("route", ROUTES)
def test_model_and_port_match_jax_on_the_panel(raw_cases, route, L):
    """The model of the kernel and the port's find_ranges_w_toehold (the
    plain twin on the CPU) == the JAX package's, lo, hi and k; B is not a
    multiple of a block's lanes."""
    idx, text, reads = raw_cases["panel"]
    dx, tx = _pair(idx, route)
    assert cuda_lf.toehold_route(tx) == route
    qc, lens = _lanes(idx, text, reads, L)
    assert qc.shape[0] % 2
    want = _jax(dx, qc, lens)
    assert want[0].dtype == np.int32
    _eq(_model_on(tx, qc, lens), want)
    _eq(TL.find_ranges_w_toehold(tx, torch.from_numpy(qc), torch.from_numpy(lens)), want)


@pytest.mark.parametrize("route", ROUTES)
def test_model_reaches_every_edge(raw_cases, route):
    """On both indexes at L = 100 the lanes reach every edge the model
    counts (a failure at the first step and later, -1 codes, length-0
    lanes, hi + 1 == n and hi + 1 at a row start, k == 0 wrapping to
    n - 1, lanes without a non-trivial step) and still equal JAX."""
    events = {}
    for name in ("panel", "random"):
        idx, text, reads = raw_cases[name]
        dx, tx = _pair(idx, route)
        qc, lens = _lanes(idx, text, reads, 100)
        _eq(_model_on(tx, qc, lens, events), _jax(dx, qc, lens))
    want = ("length_0", "absent_code", "hi1_is_n", "hi1_row_start", "fail_first_step",
            "fail_later", "trivial", "nontrivial", "k_wraps", "no_nontrivial_step")
    assert all(events.get(e, 0) > 0 for e in want), events


@pytest.mark.parametrize("route", ROUTES)
def test_model_reaches_every_edge_at_128_symbol_rows(raw_cases, route):
    """The model over 128-symbol rows (fblock) on both indexes at L = 100
    equals the JAX package's find_ranges_w_toehold, its lanes reaching hi +
    1 == n, hi + 1 at a row start, trivial steps inside a row and lanes
    without a non-trivial step."""
    events = {}
    for name in ("panel", "random"):
        idx, text, reads = raw_cases[name]
        dx, tx = _pair(idx, route, fb64=False)
        assert cuda_lf.row_layout(tx) == "fblock"
        qc, lens = _lanes(idx, text, reads, 100)
        _eq(_model_on(tx, qc, lens, events), _jax(dx, qc, lens))
    want = ("hi1_is_n", "hi1_row_start", "trivial", "nontrivial", "k_wraps",
            "no_nontrivial_step", "fail_later")
    assert all(events.get(e, 0) > 0 for e in want), events


def test_raw_toeholds_equal_the_full_sa_index(raw_cases):
    """The same lanes on the index built with the full SA (kval: the
    toehold is SA[hi]) give the raw index's lo, hi and k."""
    idx, text, reads = raw_cases["random"]
    dense = TB.build_index(text)
    qc, lens = _lanes(idx, text, reads, 100)
    q, ln = torch.from_numpy(qc), torch.from_numpy(lens)
    want = TL.find_ranges_w_toehold(TorchIndex.from_index(dense, "cpu"), q, ln)
    for route in ROUTES:
        _eq(_model_on(_pair(idx, route)[1], qc, lens), [w.numpy() for w in want])


@pytest.mark.parametrize("syms", [64, 128])
def test_model_symbol_at_every_hi(raw_cases, syms):
    """The model's trivial test is right at every hi and for every code: the
    packed rank of hi + 1 in hi's own row (packed_rank, the two threads'
    shares in uint32) is rank(hi + 1, c) and its low bit BWT[hi] == c,
    where hi + 1 starts a row or equals n too (the whole row counted; the
    last row's padding is never read)."""
    idx = raw_cases["panel"][0]
    tx = TorchIndex.from_index(idx, "cpu", fb64=syms == 64)
    fb = tx.arrays["fblock64" if syms == 64 else "fblock"].numpy()
    sym, ck = _symbols(fb, syms)
    n, shift = idx.n, syms.bit_length() - 1
    bwt = np.repeat(idx.run_head, idx.run_lengths()).astype(np.int64)
    hi = np.arange(n)
    i1 = hi + 1
    assert ((i1 == n) | (i1 & (syms - 1) == 0)).sum() == -(-n // syms)  # whole rows counted
    occ = np.zeros(idx.A, np.int64)
    rank_i1 = np.zeros((n, idx.A), np.int64)  # rank(hi + 1, c)
    for i, c in enumerate(bwt.tolist()):
        occ[c] += 1
        rank_i1[i] = occ
    for c in range(idx.A):
        rank, trivial = packed_rank(sym, ck, hi >> shift, (hi & (syms - 1)) + 1, c, syms)
        np.testing.assert_array_equal(rank, rank_i1[:, c])
        np.testing.assert_array_equal(trivial, bwt == c)


# ---------------------------------------------------------------------------
# the launch path

def _ints(ptr, count, nbytes):
    ct = ctypes.c_int64 if nbytes == 8 else ctypes.c_int32
    return np.ctypeslib.as_array((ct * count).from_address(ptr)) if count else \
        np.zeros(0, np.int64 if nbytes == 8 else np.int32)


def _toehold_lib(tx, calls, rc):
    """rbt_lf_toehold as the model over the operands at the addresses the
    wrapper passes (reading each toehold table at the width it is told);
    returns rc, writing nothing when rc != 0."""
    key = cuda_lf.row_layout(tx)
    rows = tx.arrays[key].shape

    def rbt_lf_toehold(fb, syms, F, A, n, q, lengths, B, L, tk1, tk1_b, ltk, ltk_b, rs, rs_b,
                       off, off_b, n_off, shift, iters, sl, sl_b, R, lo, hi, k, threads, stage,
                       stream):
        calls.append(dict(syms=syms, A=A, n=n, B=B, L=L, R=R, q=q, lengths=lengths,
                          tk1=(tk1, tk1_b), ltk=(ltk, ltk_b), rs=(rs, rs_b), sl=(sl, sl_b),
                          off=(off, off_b, n_off, shift, iters), threads=threads, stage=stage,
                          stream=stream, out=(lo, hi, k)))
        if rc or B == 0:
            return rc
        assert (off is None) == (tk1 is not None)
        directory = {"rs_off": _ints(off, n_off, off_b), "shift": shift,
                     "iters": iters} if off else None
        got = kernel_model(
            _ints(fb, rows[0] * rows[1], 4).reshape(rows), syms, _ints(F, A + 1, 4), A, n,
            _ints(q, B * L, 4).reshape(B, L), _ints(lengths, B, 4),
            _ints(tk1, A * n, tk1_b) if tk1 else None, _ints(ltk, A * R, ltk_b) if ltk else None,
            _ints(rs, R, rs_b) if rs else None, _ints(sl, R, sl_b), R, directory)
        for ptr, v in zip((lo, hi, k), got):
            _ints(ptr, B, 4)[:] = v
        return rc

    return SimpleNamespace(rbt_lf_toehold=rbt_lf_toehold,
                           rbt_cuda_error_string=lambda code: b"invalid argument")


@pytest.fixture
def fake_toe(monkeypatch):
    rec = {"calls": [], "rc": 0}

    def install(tx):
        monkeypatch.setattr(cuda_lf, "_LIB", _toehold_lib(tx, rec["calls"], rec["rc"]))

    monkeypatch.setattr(cuda_lf, "_raw_stream", lambda dev: 1000 + dev)
    monkeypatch.setattr(cuda_lf, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(cuda_lf.torch.cuda, "current_device", lambda: 0)
    for name in ("LAUNCHES", "LAUNCHES_TOE"):
        monkeypatch.setattr(cuda_lf, name, 0)
    monkeypatch.setattr(cuda_lf, "LAUNCHES_TAB_TOE", {"runs": 0, "dense": 0, "occ1": 0})
    rec["install"] = install
    return rec


def _widened(tx):
    """tx with its toehold tables as int64, as TorchIndex.from_arrays widens
    u32 tables."""
    return dataclasses.replace(tx, arrays={k: v.long() if k in TOE_TABLES else v
                                           for k, v in tx.arrays.items()})


@pytest.mark.parametrize("L", WIDTHS)
@pytest.mark.parametrize("fb64", [True, False], ids=["fblock64", "fblock"])
@pytest.mark.parametrize("route", ROUTES)
def test_launch_path_equals_the_twin(raw_cases, fake_toe, route, fb64, L):
    idx, text, reads = raw_cases["panel"]
    tx = _pair(idx, route, fb64)[1]
    qc, lens = _lanes(idx, text, reads, L)
    q, ln = torch.from_numpy(qc), torch.from_numpy(lens)
    want = cuda_lf.find_ranges_toehold_plain(tx, q, ln)
    for t in (tx, _widened(tx)):
        fake_toe["install"](t)
        got = cuda_lf.launch_toehold(t, q, ln)
        _eq(got, [w.numpy() for w in want])
    c32, c64 = fake_toe["calls"]
    assert cuda_lf.LAUNCHES_TOE == 2 and cuda_lf.LAUNCHES == 0
    assert sum(cuda_lf.LAUNCHES_TAB_TOE.values()) == 0
    for c, nbytes in ((c32, 4), (c64, 8)):
        assert (c["syms"], c["A"], c["n"], c["R"]) == (64 if fb64 else 128, tx.A, tx.n, tx.R)
        assert (c["B"], c["L"]) == tuple(qc.shape) and c["q"] == q.data_ptr()
        assert (c["threads"], bool(c["stage"])) == cuda_lf.launch_plan(*qc.shape, 132)
        assert c["stream"] == 1000 and c["sl"][1] == nbytes
        if route == "tk1":
            assert c["tk1"][1] == nbytes and c["ltk"] == c["rs"] == (None, 0)
            assert c["off"] == (None, 0, 0, 0, 0)
        else:
            assert c["tk1"] == (None, 0) and c["ltk"][1] == c["rs"][1] == nbytes
            off = tx.arrays["rs_off"]
            assert c["off"] == (off.data_ptr(), off.element_size(), off.numel(), *tx.rs_bs)
            assert off.numel() == (tx.n >> tx.rs_bs[0]) + 2
        assert len(set(c["out"])) == 3


def test_launch_path_on_a_view_and_no_lanes(raw_cases, fake_toe):
    """A view one row into a batch is passed as it is; no lanes launch
    nothing and count nothing."""
    idx, text, reads = raw_cases["random"]
    tx = _pair(idx, "ltk")[1]
    qc, lens = _lanes(idx, text, reads, 31)
    q, ln = torch.from_numpy(qc)[1:], torch.from_numpy(lens)[1:]
    fake_toe["install"](tx)
    _eq(cuda_lf.launch_toehold(tx, q, ln),
        [w.numpy() for w in cuda_lf.find_ranges_toehold_plain(tx, q, ln)])
    assert fake_toe["calls"][0]["q"] == q.data_ptr()
    lo, hi, k = cuda_lf.launch_toehold(tx, q[:0], ln[:0])
    assert lo.shape == hi.shape == k.shape == (0,)
    assert cuda_lf.LAUNCHES_TOE == 1 and len(fake_toe["calls"]) == 2


def test_refused_launch_raises_and_counts_nothing(raw_cases, fake_toe):
    idx, text, reads = raw_cases["random"]
    tx = _pair(idx, "tk1")[1]
    fake_toe["rc"] = 1
    fake_toe["install"](tx)
    qc, lens = _lanes(idx, text, reads, 31)
    with pytest.raises(RuntimeError, match="LF kernel launch failed: invalid argument"):
        cuda_lf.launch_toehold(tx, torch.from_numpy(qc), torch.from_numpy(lens))
    assert cuda_lf.LAUNCHES_TOE == 0 and len(fake_toe["calls"]) == 1


@pytest.mark.parametrize("fault,error,match", [
    ("float tk1", TypeError, "tk1_flat must be int32 or int64"),
    ("int64 F", TypeError, "F must be int32 for fblock64 rows"),
    ("int64 qcodes", TypeError, "qcodes must be int32"),
    ("no samples_last", ValueError, "the toehold needs samples_last"),
    ("short ltk", ValueError, "ltk of shape"),
    ("no rs_off", ValueError, "needs rs_off"),
    ("short rs_off", ValueError, "rs_off of shape"),
    ("no fused rows", ValueError, "K1 reads fused-block rows"),
    ("two-level rows", ValueError, "the per-step toehold is the single-level search's"),
    ("lengths shape", ValueError, "lengths must be"),
])
def test_launch_refuses(raw_cases, fake_toe, fault, error, match):
    idx, text, reads = raw_cases["random"]
    tx = _pair(idx, "ltk" if "ltk" in fault or "rs_off" in fault else "tk1")[1]
    fake_toe["install"](tx)
    qc, lens = _lanes(idx, text, reads, 31)
    q, ln = torch.from_numpy(qc), torch.from_numpy(lens)
    arrays = dict(tx.arrays)
    if fault == "float tk1":
        arrays["tk1_flat"] = arrays["tk1_flat"].float()
    elif fault == "int64 F":
        arrays["F"] = arrays["F"].long()
    elif fault == "int64 qcodes":
        q = q.long()
    elif fault == "no samples_last":
        del arrays["samples_last"]
    elif fault == "short ltk":
        arrays["ltk"] = arrays["ltk"][:-1]
    elif fault == "no rs_off":
        del arrays["rs_off"]
    elif fault == "short rs_off":
        arrays["rs_off"] = arrays["rs_off"][:-1]
    elif fault == "no fused rows":
        del arrays["fblock64"]
    elif fault == "two-level rows":
        arrays["pl2_64"] = arrays.pop("fblock64")  # 64 B rows as two-level bit planes
        arrays["fb2_base"] = torch.zeros((1, 8), dtype=torch.int64)
    elif fault == "lengths shape":
        ln = ln[:-1]
    with pytest.raises(error, match=match):
        cuda_lf.launch_toehold(dataclasses.replace(tx, arrays=arrays), q, ln)
    assert fake_toe["calls"] == [] and cuda_lf.LAUNCHES_TOE == 0


@pytest.mark.parametrize("tables", ["fused", "none"])
def test_wrapper_route_follows_the_tables(monkeypatch, tables):
    """On a CUDA tensor find_ranges_toehold launches K1's toehold instance
    exactly when the index has fused rows, and otherwise the tables
    kernel's toehold instance, never the torch loop; CPU tensors take the
    twin; other devices raise.  find_ranges_w_toehold sends an index
    without kval there."""
    arrays = {"fblock64": None} if tables == "fused" else {"bwt4": None}
    tx = SimpleNamespace(arrays=dict(arrays, samples_last=None), has_dense=tables == "none")
    calls = []
    monkeypatch.setattr(cuda_lf, "launch_toehold", lambda *a: calls.append("kernel") or "k")
    monkeypatch.setattr(cuda_lf, "launch_tables",
                        lambda *a, **kw: calls.append(("tables", kw)) or "tab")
    monkeypatch.setattr(cuda_lf, "find_ranges_toehold_plain",
                        lambda *a: calls.append("torch") or "t")
    ln = SimpleNamespace(to=lambda dt: ln)
    q = SimpleNamespace(device=SimpleNamespace(type="cuda"), shape=(4, 8))
    assert cuda_lf.find_ranges_toehold(tx, q, ln) == ("k" if tables == "fused" else "tab")
    assert calls == ["kernel" if tables == "fused" else
                     ("tables", dict(use_ftab=False, toehold=True))]
    calls.clear()
    cpu = SimpleNamespace(device=SimpleNamespace(type="cpu"), shape=(4, 8))
    assert cuda_lf.find_ranges_toehold(tx, cpu, ln) == "t" and calls == ["torch"]
    with pytest.raises(ValueError, match="no LF loop for device"):
        cuda_lf.find_ranges_toehold(tx, SimpleNamespace(device=SimpleNamespace(type="mps")), ln)
    monkeypatch.setattr(cuda_lf, "find_ranges_toehold", lambda *a: "toehold")
    assert TL.find_ranges_w_toehold(tx, q, ln) == "toehold"


# ---------------------------------------------------------------------------
# the walk kernel's predecessor route, on a --no-dense index

@pytest.fixture(scope="module")
def nodense(tmp_path_factory):
    """(JAX DeviceIndex, port TorchIndex, qcodes, lengths, toeholds) of the
    panel built as --no-dense builds it (run-space tables, pred_pos, no
    phi1)."""
    d = tmp_path_factory.mktemp("torch_toehold_nodense")
    inp = write_inputs(d)
    panel = TP.build_panel(inp["fa"], inp["vcf"])
    idx = TB.build_index_from_panel(panel, dense=False)
    assert idx.fblock is None and idx.phi1 is None and idx.kval is None
    dx, tx = DeviceIndex.from_index(idx), TorchIndex.from_index(idx, "cpu").with_card_tables()
    assert "pred_off" in tx.arrays and "rs_off" in tx.arrays
    reads = [s for _, s, _ in read_seqs(inp["fq"]) if len(s) <= 64]
    short = [r[:int(m)] for r, m in zip(reads, np.random.default_rng(3).integers(4, 14,
                                                                                len(reads)))]
    qc, lens = encode_batch(idx, reads + short + [b"", b"ACGTN"], pad_to=64)
    want = _jax(dx, qc, lens)
    got = TL.find_ranges_w_toehold(tx, torch.from_numpy(qc), torch.from_numpy(lens))
    _eq(got, want)
    return dx, tx, want, got


@pytest.mark.parametrize("max_hits", [None, 1, 3])
def test_pred_walk_matches_jax(nodense, max_hits):
    dx, tx, want, got = nodense
    assert cuda_phi.walk_route(tx) == "pred"
    wr = JL.locate_ragged(dx, *(jnp.asarray(w) for w in want), max_hits=max_hits)
    _eq(TL.locate_ragged(tx, *got, max_hits=max_hits), wr)
    assert int((got[1] - got[0] + 1).clamp(min=0).max()) > 3  # a capped lane
    if max_hits is not None:
        _eq(TL.locate(tx, *got, max_hits=max_hits),
            JL.locate(dx, *(jnp.asarray(w) for w in want), max_hits=max_hits))


def bucketed_lower_bound(vals, off, shift, iters, q):
    """csrc/phi_walk.cu bucketed_lower_bound at every q (numpy, int64): q's
    bucket of the directory off (clamped into it), then `iters` fixed
    halvings, each probe clamped into vals, none taken once the bucket's
    segment is empty."""
    vals, off = np.asarray(vals, np.int64), np.asarray(off, np.int64)
    q = np.asarray(q, np.int64)
    b = np.clip(q >> shift, 0, off.shape[0] - 2)
    lo, hi = off[b], off[b + 1]
    for _ in range(iters):
        mid = (lo + hi) >> 1
        take = (vals[np.clip(mid, 0, vals.shape[0] - 1)] < q) & (lo < hi)
        hi = np.where(take | (lo >= hi), hi, mid)
        lo = np.where(take, mid + 1, lo)
    return lo


def pred_model(pp, ptr, sl, R, n, i, directory):
    """The phi step of csrc/phi_walk.cu's Pred at every i: the lower bound of
    i in pred_pos through the bucket directory {"pred_off", "shift",
    "iters"}, the entry before it (the last for none), its run's previous
    sample (index -1 the last) plus the distance, mod n."""
    pp, ptr, sl = (np.asarray(t, np.int64) for t in (pp, ptr, sl))
    i = np.asarray(i, np.int64)
    rk = bucketed_lower_bound(pp, directory["pred_off"], directory["shift"],
                              directory["iters"], i)
    jr = np.where(rk == 0, R - 1, rk - 1)
    j = pp[jr]
    return (sl[ptr[jr] - 1] + np.where(j < i, i - j, i + 1)) % n


def _pred_lib(calls, rc):
    def rbt_phi_walk_pred(pp, ptr, sl, nbytes, R, poff, off_b, n_off, shift, iters, n, k, size,
                          off, out, B, threads, stream):
        calls.append(dict(bytes=nbytes, R=R, n=n, B=B, threads=threads, stream=stream,
                          directory=(poff, off_b, n_off, shift, iters)))
        if rc:
            return rc
        assert n_off == (n >> shift) + 2
        directory = {"pred_off": _ints(poff, n_off, off_b), "shift": shift, "iters": iters}
        pp, ptr, sl = (_ints(p, R, nbytes) for p in (pp, ptr, sl))
        k, size, off = (_ints(p, B, 8) for p in (k, size, off))
        flat = _ints(out, int((off + size).max(initial=0)), 8)
        i = k.astype(np.int64)  # every lane's chain, one step of all at a time
        for j in range(int(size.max(initial=0))):
            if j:
                i = pred_model(pp, ptr, sl, R, n, i, directory)
            live = size > j
            flat[(off + j)[live]] = i[live]
        return rc

    return SimpleNamespace(rbt_phi_walk_pred=rbt_phi_walk_pred,
                           rbt_phi_walk_error_string=lambda code: b"invalid argument")


@pytest.fixture
def fake_walk(monkeypatch):
    rec = {"calls": [], "rc": 0}

    def install():
        monkeypatch.setattr(cuda_phi, "_LIB", _pred_lib(rec["calls"], rec["rc"]))

    monkeypatch.setattr(cuda_phi, "_raw_stream", lambda dev: 1000 + dev)
    monkeypatch.setattr(cuda_phi, "_sm_count", lambda dev: 2)
    monkeypatch.setattr(cuda_phi.torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(cuda_phi, "LAUNCHES", 0)
    rec["install"] = install
    return rec


def _walk_operands(lo, hi, k, max_hits=None):
    size = torch.clamp(hi - lo + 1, min=0).to(torch.int64)
    if max_hits is not None:
        size = size.clamp(max=max_hits)
    return k, size, torch.cumsum(size, 0) - size, torch.full((int(size.sum()),), -7,
                                                               dtype=torch.int64)


@pytest.mark.parametrize("wide", [False, True], ids=["int32_tables", "int64_tables"])
def test_pred_launch_path_walks_like_the_twin(nodense, fake_walk, wide):
    tx = nodense[1]
    if wide:
        tx = dataclasses.replace(tx, arrays={k: v.long() if k in cuda_phi.PRED_TABLES else v
                                             for k, v in tx.arrays.items()})
    fake_walk["install"]()
    B = nodense[3][0].shape[0]
    for lanes, max_hits in ((torch.int32, None), (torch.int64, 5)):
        k, size, off, out = _walk_operands(*(t.to(lanes) for t in nodense[3]), max_hits)
        want = cuda_phi.phi_walk_plain(tx, k, size, off, out.clone())
        assert cuda_phi.launch_walk(tx, k, size, off, out) is out
        assert torch.equal(out, want) and (out >= 0).all()
    calls = fake_walk["calls"]
    assert [(c["bytes"], c["R"], c["n"], c["B"]) for c in calls] == \
        [(8 if wide else 4, tx.R, tx.n, B)] * 2
    off = tx.arrays["pred_off"]
    assert all(c["directory"] == (off.data_ptr(), off.element_size(), off.numel(), *tx.pred_bs)
               for c in calls)
    assert all(c["threads"] == cuda_phi.launch_plan(B, 2) and c["stream"] == 1000
               for c in calls)
    assert cuda_phi.LAUNCHES == 2


def test_pred_launch_refuses_and_counts_nothing(nodense, fake_walk):
    tx = nodense[1]
    args = _walk_operands(*nodense[3], 2)
    mixed = dataclasses.replace(tx, arrays=dict(tx.arrays, pred_pos=tx.arrays["pred_pos"].long()))
    with pytest.raises(TypeError, match="must share a dtype"):
        cuda_phi.launch_walk(mixed, *args)
    gone = dataclasses.replace(tx, arrays={k: v for k, v in tx.arrays.items()
                                           if k != "pred_to_run"})
    with pytest.raises(ValueError, match="the predecessor walk needs pred_to_run"):
        cuda_phi.launch_walk(gone, *args)
    # a view on the card without its directory raises: no search over all R
    bare = dataclasses.replace(tx, arrays={k: v for k, v in tx.arrays.items()
                                           if k != "pred_off"})
    with pytest.raises(ValueError, match="the predecessor walk needs pred_off"):
        cuda_phi.launch_walk(bare, *args)
    short = dataclasses.replace(tx, arrays=dict(tx.arrays, pred_off=tx.arrays["pred_off"][:-1]))
    with pytest.raises(ValueError, match="pred_off"):
        cuda_phi.launch_walk(short, *args)
    fake_walk["rc"] = 1
    fake_walk["install"]()
    with pytest.raises(RuntimeError, match="phi walk kernel launch failed: invalid argument"):
        cuda_phi.launch_walk(tx, *args)
    assert cuda_phi.LAUNCHES == 0 and len(fake_walk["calls"]) == 1


# ---------------------------------------------------------------------------
# the two directory searches, at every position, against JAX

@pytest.mark.parametrize("span", list(SHIFTS))
def test_pred_directory_step_matches_jax_everywhere(nodense, span):
    """Pred's step through a directory over pred_pos (pred_model) == the
    JAX package's phi_step (its predecessor branch, a searchsorted over all
    of pred_pos) at every i in [0, n): i on every pred_pos entry and
    beside it, i = 0 (the lower bound 0, wrapping to R - 1), i = n - 1,
    and both sides of every bucket edge; over 2-position buckets (most
    empty), the loader's and one bucket."""
    dx, tx = nodense[0], nodense[1]
    pp = tx.arrays["pred_pos"].numpy()
    off, (shift, iters) = run_directory(pp, tx.n, SHIFTS[span])
    assert off.shape == ((tx.n >> shift) + 2,)
    if span == "small":
        assert (np.diff(off) == 0).sum() > off.shape[0] // 2  # most buckets empty
    if span == "one_bucket":
        assert off.shape == (2,) and iters == int(np.ceil(np.log2(tx.R + 1)))
    i = np.arange(tx.n, dtype=np.int32)
    want = np.asarray(JR.phi_step(dx, jnp.asarray(i)))
    got = pred_model(pp, tx.arrays["pred_to_run"].numpy(), tx.arrays["samples_last"].numpy(),
                     tx.R, tx.n, i, {"pred_off": off, "shift": shift, "iters": iters})
    np.testing.assert_array_equal(got, want)
    rk = np.searchsorted(pp, i, side="left")
    assert rk[0] == 0 and np.isin(pp, i).all() and i[-1] == tx.n - 1
    edges = np.arange(1, off.shape[0] - 1) << shift
    assert np.isin(edges[edges < tx.n], i).all() and np.isin(edges[edges < tx.n] - 1, i).all()


@pytest.mark.parametrize("span", list(SHIFTS))
def test_ltk_resolve_matches_jax_everywhere(raw_cases, span):
    """The resolve's run of hi through the directory over run_start
    (resolve_run: the run of min(hi + 1, n - 1), one less where hi + 1
    starts it) reads the ltk entry that the JAX package's lf_step_w_loc
    returns for every non-trivial step from [0, hi], at every hi and every
    code that occurs in BWT[0, hi] other than BWT[hi]: every hi past the
    first run, so hi = n - 1 (hi + 1 == n), hi + 1 at every run start and
    both sides of every bucket edge; over 2-position buckets (most empty),
    the loader's and one bucket."""
    idx = raw_cases["panel"][0]
    dx, tx = _pair(idx, "ltk")
    n, R, A = tx.n, tx.R, tx.A
    rs = tx.arrays["run_start"].numpy()
    off, (shift, iters) = run_directory(rs, n, SHIFTS[span])
    t = {"run_start": rs, "rs_off": off, "shift": shift, "iters": iters}
    if span == "small":
        assert (np.diff(off) == 0).sum() > off.shape[0] // 2
    hi = np.tile(np.arange(n, dtype=np.int32), A)
    c = np.repeat(np.arange(A, dtype=np.int32), n)
    lo, k = np.zeros_like(hi), np.zeros_like(hi)
    nlo, nhi, nk = (np.asarray(x) for x in JR.lf_step_w_loc(
        dx, jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(c), jnp.asarray(k)))
    bwt = np.repeat(idx.run_head, idx.run_lengths())
    table = (nlo <= nhi) & (bwt[hi] != c)  # a non-trivial step: nk is the ltk entry
    ltk = tx.arrays["ltk"].numpy()
    got = np.array([ltk[cc * R + resolve_run(t, n, int(h))]
                    for cc, h in zip(c[table], hi[table])])
    np.testing.assert_array_equal(got, nk[table])
    # every hi past the first run (where BWT[0, hi] holds a code other than
    # BWT[hi]), so every bucket edge, hi + 1 == n and every run start
    h = np.unique(hi[table])
    np.testing.assert_array_equal(h, np.arange(rs[1], n))


# ---------------------------------------------------------------------------
# on the card

def _cuda(tx):
    return TorchIndex.from_arrays({k: v.numpy() for k, v in tx.arrays.items()}, n=tx.n, R=tx.R,
                                  A=tx.A, ma_wsize=0, ftab_k=0, acgt_codes=tx.acgt_codes,
                                  device="cuda")


@pytest.mark.gpu
def test_cuda_toehold_kernel_matches_plain(raw_cases):
    """The toehold launch == find_ranges_toehold_plain on the card, both
    routes, at each width.  Runs only where jax and CUDA are both installed;
    chip_smoke.py (phase parity) makes the same checks with torch alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the toehold kernel has no CPU mode)")
    for name, (idx, text, reads) in raw_cases.items():
        for route in ROUTES:
            tx = _cuda(_pair(idx, route)[1])
            for L in WIDTHS:
                qc, lens = _lanes(idx, text, reads, L)
                q, ln = torch.from_numpy(qc).cuda(), torch.from_numpy(lens).cuda()
                got = cuda_lf.find_ranges_toehold(tx, q, ln)
                want = cuda_lf.find_ranges_toehold_plain(tx, q, ln)
                torch.cuda.synchronize()
                _eq([g.cpu() for g in got], [w.cpu().numpy() for w in want])


@pytest.mark.gpu
def test_cuda_pred_walk_matches_plain(nodense):
    """The walk kernel over the predecessor search == the torch walk on the
    card; chip_smoke.py (phase parity) makes the same check."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the walk kernel has no CPU mode)")
    tx = _cuda(nodense[1])
    k, size, off, out = (t.cuda() for t in _walk_operands(*nodense[3]))
    got = cuda_phi.launch_walk(tx, k, size, off, out)
    want = cuda_phi.phi_walk_plain(tx, k, size, off, out.clone().fill_(-1))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
