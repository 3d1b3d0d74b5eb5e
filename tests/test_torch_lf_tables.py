"""The search over the rank tables of an index without fused rows
(ops/cuda_lf.launch_tables, csrc/lf.cu lf_tables_kernel): the count search
of rbt_align count and -m and the per-step toehold search of -s, one
launch a batch, in three rank policies chosen in lf_step_auto's order
(occ1, dense, run-space).

A numpy model of the kernel's arithmetic (one lane at a time: the ftab
start, each policy's two ranks a step (the run-space runs through the
bucket directory; the dense blocks split over the lane's threads, each
counting its words below the offset, and fetched once where lo and hi + 1
share one: DenseStep), the trivial test from the policy's own tables, the
last non-trivial step carried with a count of the trivial steps after it
and resolved once from tk1 or ltk) equals the JAX package's
find_ranges and find_ranges_w_toehold buffer for buffer, and so does the
port's path on the CPU, on the small panel built --no-dense, on the panel of
13 codes (bwt4/occ_blk) and on that panel's raw build (occ1 + tk1; and
without them, the dense tables with ltk), at L = 1, 31 and 100, on batches
that reach every edge the model counts.  The launch path, with its C entry
replaced by that model reading the addresses and widths the wrapper passes,
equals the plain twins; refused launches raise and count nothing; the
routes follow the tables.  One step of the dense and occ1 models at every
block and part edge, on indexes of 13 and 16 codes, equals the JAX
package's and the port's steps.  Every output is an integer, so every
check is exact."""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rowbowt_tpu.engine import count as JC
from rowbowt_tpu.engine.device import DeviceIndex
from rowbowt_tpu.ops import rank as JR
from rowbowt_tpu_torch.construct import build as TB
from rowbowt_tpu_torch.construct import panel as TP
from rowbowt_tpu_torch.construct import rawio as TRAW
from rowbowt_tpu_torch.engine import count as TC
from rowbowt_tpu_torch.engine import locate as TL
from rowbowt_tpu_torch.bigindex import marker_buckets
from rowbowt_tpu_torch.engine.device import (RUN_SEG, TorchIndex, run_directory, run_records,
                                             takes_run_records)
from rowbowt_tpu_torch.io.fastq import read_seqs
from rowbowt_tpu_torch.ops import cuda_lf
from rowbowt_tpu_torch.ops import rank as TR
from rowbowt_tpu_torch.ops.rank import bucketed_lower_bound
from test_torch_build import write_inputs
from test_torch_toehold import (ACGT, _eq, _ints, _jax, _lanes, _text_reads, resolve_run,
                                run_of)

WIDTHS = (1, 31, 100)
# (index, tables dropped from it, rank policy): the count cases
COUNT_CASES = {"nodense": ("nodense", (), "runs"), "iupac": ("iupac", (), "dense"),
               "raw13": ("raw13", (), "occ1"),
               "raw13_dense": ("raw13", ("occ1_flat", "tk1_flat"), "dense")}
# the toehold cases (indexes without kval) and their toehold table
TOE_CASES = {"nodense": ("nodense", (), "runs", "ltk"), "random": ("random", (), "runs", "ltk"),
             "raw13": ("raw13", (), "occ1", "tk1"),
             "raw13_dense": ("raw13", ("occ1_flat", "tk1_flat"), "dense", "ltk")}
TABLE_KEYS = ("occ_flat", "run_start", "run_head", "rs_off", "occ_blk_flat", "occ1_flat",
              "tk1_flat", "ltk", "samples_last", "ftab")


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """{name: (RbtIndex, text, reads)}: the in-repo panel built as --no-dense
    builds it (run-space tables, with an ftab of k = 6), the panel of 13
    codes (bwt4/occ_blk and kval, ftab k = 6), that panel written as raw
    files and built back (occ1 + tk1, no kval, ftab k = 4), and a random
    text of one document built --no-dense (its prefixes take the toehold
    to 0 and wrap it)."""
    d = tmp_path_factory.mktemp("torch_lf_tables")
    rng = np.random.default_rng(11)
    out = {}
    for name, iupac in (("nodense", False), ("iupac", True)):
        (d / name).mkdir()
        inp = write_inputs(d / name, iupac=iupac)
        panel = TP.build_panel(inp["fa"], inp["vcf"])
        idx = TB.build_index_from_panel(panel, ftab_k=6, dense=iupac)
        reads = [s for _, s, _ in read_seqs(inp["fq"])]
        out[name] = (idx, panel.text, reads + _text_reads(panel.text, rng, 60, 100))
    idx, text, reads = out["iupac"]
    prefix = str(d / "iupac" / "raw")
    TRAW.write_raw(idx, prefix)
    out["raw13"] = (TRAW.build_index_from_raw(prefix, ftab_k=4), text, reads)
    text = np.concatenate([rng.choice(ACGT, size=1500), np.array([1], np.uint8)])
    out["random"] = (TB.build_index(text, dense=False, ftab_k=4), text,
                     _text_reads(text, rng, 60, 100))
    return out


def _pair(cases, name, drop=()):
    """(JAX DeviceIndex, port TorchIndex on the CPU, RbtIndex, text, reads)
    of case `name` with the tables `drop` taken from both; the TorchIndex
    also holds the tables a load on the card builds for the kernels
    (with_card_tables)."""
    idx, text, reads = cases[name]
    dx = DeviceIndex.from_index(idx)
    dx = DeviceIndex({k: v for k, v in dx.arrays.items() if k not in drop}, dx.n, dx.R, dx.A,
                     dx.ma_wsize, dx.ftab_k, dx.acgt_codes)
    tx = TorchIndex.from_index(idx, "cpu")
    tx = dataclasses.replace(tx, arrays={k: v for k, v in tx.arrays.items() if k not in drop})
    return dx, tx.with_card_tables(), idx, text, reads


def test_fixtures_have_the_tables_each_case_names(cases):
    """No fused rows on any case; the policy and toehold table as named."""
    assert cases["nodense"][0].fblock is None and cases["nodense"][0].A == 6
    assert cases["iupac"][0].A == 13 and cases["iupac"][0].bwt4 is not None
    assert cases["raw13"][0].kval is None and cases["raw13"][0].tk1 is not None
    for name, (src, drop, policy) in COUNT_CASES.items():
        tx = _pair(cases, src, drop)[1]
        assert cuda_lf.row_layout(tx) is None and cuda_lf.table_policy(tx) == policy, name
        assert tx.has_ftab
    for name, (src, drop, policy, route) in TOE_CASES.items():
        tx = _pair(cases, src, drop)[1]
        assert cuda_lf.table_policy(tx) == policy and cuda_lf.toehold_route(tx) == route, name


# ---------------------------------------------------------------------------
# the numpy model of the kernel

def _nibbles(bwt4):
    """[blocks, 128] symbols of the dense tables' words."""
    words = bwt4.view(np.uint32).astype(np.int64)
    return ((words[:, None] >> (4 * np.arange(8))) & 15).reshape(-1, 128)


DENSE_G = cuda_lf.lane_threads("dense")  # threads a lane of the dense step (kDenseG)


class DenseStep:
    """The dense step of csrc/lf_tables.cuh lf_step_tables, one lane at a
    time: the lane's DENSE_G threads each hold 16 // DENSE_G of a 64 B
    block's words (16-byte part sub + m * DENSE_G in v[m]) and count c
    among their symbols below an offset; the lane sums the shares; one
    fetch serves lo's rank and hi + 1's where both lie in one block, whose
    checkpoint of c is then one entry; BWT[hi] comes from a fetched block
    where hi lies in it (hi + 1's unless hi + 1 starts it or is n, else
    lo's), else from one word.  `bump` counts the edges."""

    def __init__(self, bwt4, occ, F, n, bump=lambda key: None, G=DENSE_G):
        self.sym = _nibbles(np.asarray(bwt4))  # [blocks, 128]
        self.nb = self.sym.shape[0]
        self.occ, self.F, self.n, self.G = np.asarray(occ), F, n, G
        self.bump = bump
        # the in-block offsets of the symbols each thread holds
        self.pos = [np.concatenate([np.arange(8 * w, 8 * w + 8) for w in self.parts(sub)])
                    for sub in range(G)]

    def fetch(self, blk):
        """The 128 symbols of block blk, 16 // G words a thread."""
        return self.sym[blk]

    def parts(self, sub):
        """The block's words thread `sub` holds."""
        per = 4 // self.G
        return [4 * (sub + m * self.G) + e for m in range(per) for e in range(4)]

    def shares(self, block, c, off):
        """[G] each thread's count of c among its symbols below `off`."""
        return [int(np.count_nonzero((block[p] == c) & (p < off))) for p in self.pos]

    def symbol(self, block, off):
        """BWT at in-block offset off, from the one thread that holds it."""
        assert sum(off in p for p in self.pos) == 1
        return int(block[off])

    def step(self, lo, hi, c, toehold=False):
        """(rank(lo, c), rank(hi + 1, c), BWT[hi] or None) of one step, c in
        [0, A): the code's total where a position is n."""
        n, total = self.n, int(self.F[c + 1] - self.F[c])
        i1 = hi + 1
        has0, has1 = lo < n, i1 < n
        b0, b1 = lo >> 7, i1 >> 7
        one = has0 and has1 and b0 == b1
        v0 = self.fetch(b0) if has0 else np.zeros(128, np.int64)
        v1 = v0 if one or not has1 else self.fetch(b1)
        if one:
            self.bump("one_fetch")
        elif has0 and has1:
            self.bump("two_fetches")
        s0, s1 = sum(self.shares(v0, c, lo & 127)), sum(self.shares(v1, c, i1 & 127))
        for off in (lo & 127, i1 & 127):
            if off % (128 // self.G) == 0:
                self.bump("part_boundary")
        k0 = int(self.occ[c * self.nb + b0]) if has0 else 0
        k1 = k0 if one else int(self.occ[c * self.nb + b1]) if has1 else 0
        cb, ce = (k0 + s0 if has0 else total), (k1 + s1 if has1 else total)
        sym = None
        if toehold:
            if has1 and i1 & 127:
                self.bump("hi_in_block1")
                sym = self.symbol(v1, (i1 & 127) - 1)
            elif has0 and hi >> 7 == b0:
                self.bump("hi_in_block0")
                sym = self.symbol(v0, hi & 127)
            else:
                self.bump("hi_word_load")
                sym = int(self.sym[hi >> 7, hi & 127])
        return cb, ce, sym


def tables_model(policy, t, F, A, n, R, q, lens, ftab=None, k=0, acgt=(), toehold=False,
                 events=None):
    """(lo, hi) or with `toehold` (lo, hi, k) [B] as lf_tables_kernel
    computes them over the `policy` tables `t` (numpy: occ, and run_start
    and run_head with the directory rs_off and its shift and iters, and
    where the index has them the run records rec (runs); bwt4 (dense); tk1
    or ltk with run_start, and samples_last for the toehold).  `events`, a
    dict, counts the edges the lanes reached.  A per-step toehold (the JAX
    step's recurrence) rides beside the carried one and must agree."""
    ev = events if events is not None else {}
    F = np.asarray(F).astype(np.int64)

    def bump(key):
        ev[key] = ev.get(key, 0) + 1

    dense = DenseStep(t["bwt4"], t["occ"], F, n, bump) if policy == "dense" else None

    def run_rank(x, c):
        """(rank(x, c), x's run, its start) as the run-space step reads
        them: the run through the directory (run_of), then the run's head
        and count of c from run_head and occ_flat, or from its record."""
        r, start = run_of(t, x, bump)
        if "rec" in t:
            rec = t["rec"].reshape(-1, 8)[r]
            assert rec[0] == start
            start, head, occ = int(rec[0]), int(rec[1]), int(rec[2 + c])
        else:
            head, occ = int(t["run_head"][r]), int(t["occ"][c * R + r])
        return occ + (x - start if head == c else 0), r, start

    def head_of(r):
        return int(t["rec"].reshape(-1, 8)[r, 1] if "rec" in t else t["run_head"][r])

    def rank(i, c):  # occ1: one load a rank
        return int(t["occ"][c * (n + 1) + i])

    def table(c, hi):
        if toehold and "tk1" in t:
            return int(t["tk1"][c * n + hi])
        return int(t["ltk"][c * R + resolve_run(t, n, hi)])

    B, L = q.shape
    out = np.zeros((3 if toehold else 2, B), np.int64)
    k0 = (int(t["samples_last"][R - 1]) + 1) % n if toehold else 0
    for b in range(B):
        lo, hi, j = 0, n - 1, 0
        steps = min(int(lens[b]), L)
        if k and steps >= k:
            kc = 0
            for col in range(L - k, L):
                two = [x for x in range(4) if acgt[x] == q[b, col]]
                if not two:
                    kc = -1
                    break
                kc = (kc << 2) | two[-1]
            if kc >= 0 and ftab[kc, 0] >= 0:
                bump("ftab_start")
                lo, hi, j = int(ftab[kc, 0]), int(ftab[kc, 1]), k
        if steps == 0:
            bump("length_0")
        tc, thi, triv, kstep = -1, 0, 0, k0
        for j in range(j, steps):
            c = int(q[b, L - 1 - j])
            if not 0 <= c < A:
                bump("absent_code")
                if j == 0:
                    bump("fail_first_step")
                lo, hi = 1, 0
                break
            i1 = hi + 1
            if i1 == n:
                bump("hi1_is_n")
            if policy == "runs":
                # lo's run and hi + 1's, each through the directory
                cb = run_rank(lo, c)[0] if lo < n else int(F[c + 1] - F[c])
                if i1 < n:
                    ce, r1, s1 = run_rank(i1, c)
                    if s1 == i1:
                        bump("hi1_starts_run")
                    s = head_of(r1 - 1 if s1 == i1 else r1)
                else:
                    ce = int(F[c + 1] - F[c])
                    s = head_of(R - 1)
            elif policy == "dense":
                cb, ce, s = dense.step(lo, hi, c, toehold)
            else:
                cb, ce = rank(lo, c), rank(i1, c)
                s = c if ce - rank(hi, c) == 1 else -1
            if ce - cb <= 0:
                bump("fail_first_step" if j == 0 else "fail_later")
                lo, hi = 1, 0
                break
            if toehold:
                if s == c:
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
        out[:2, b] = lo, hi
        if toehold:
            if hi < lo:
                out[2, b] = 0
            else:
                if tc < 0 and steps:
                    bump("no_nontrivial_step")
                out[2, b] = ((k0 if tc < 0 else table(tc, thi)) - triv) % n
                assert out[2, b] == kstep, (b, out[2, b], kstep)
    return tuple(o.astype(np.int32 if n < (1 << 31) - 2 else np.int64) for o in out)


def _tables_of(tx, toehold):
    """The model's tables: numpy views of tx's tensors, by the kernel's
    operand names (the run records where tx has them, as the kernel reads
    them then)."""
    policy = cuda_lf.table_policy(tx)
    t = {key: tx.arrays[name].numpy()
         for key, name in (("run_start", "run_start"), ("run_head", "run_head"),
                           ("samples_last", "samples_last"), ("ltk", "ltk"),
                           ("rs_off", "rs_off"), ("rec", "run_rec"))
         if name in tx.arrays}
    if "rs_off" in t:
        t["shift"], t["iters"] = tx.rs_bs
    t["occ"] = tx.arrays[{"runs": "occ_flat", "dense": "occ_blk_flat",
                          "occ1": "occ1_flat"}[policy]].numpy()
    if policy == "dense":
        t["bwt4"] = tx.arrays["bwt4"].numpy()
    if toehold and cuda_lf.toehold_route(tx) == "tk1":
        t["tk1"] = tx.arrays["tk1_flat"].numpy()
    return policy, t


def _model_on(tx, qc, lens, use_ftab=True, toehold=False, events=None):
    policy, t = _tables_of(tx, toehold)
    k = tx.ftab_k if use_ftab and not toehold and tx.has_ftab and qc.shape[1] >= tx.ftab_k else 0
    return tables_model(policy, t, tx.arrays["F"].numpy(), tx.A, tx.n, tx.R, qc, lens,
                        tx.arrays["ftab"].numpy() if k else None, k, tx.acgt_codes, toehold,
                        events)


def _jax_count(dx, qc, lens, use_ftab):
    return [np.asarray(t) for t in JC.find_ranges(dx, jnp.asarray(qc), jnp.asarray(lens),
                                                  use_ftab=use_ftab)]


@pytest.mark.parametrize("use_ftab", [True, False], ids=["ftab", "full"])
@pytest.mark.parametrize("L", WIDTHS)
@pytest.mark.parametrize("case", list(COUNT_CASES))
def test_count_model_and_port_match_jax(cases, case, L, use_ftab):
    """The model's count search and the port's find_ranges (the plain twin
    on the CPU) == the JAX package's find_ranges, lo and hi; B is odd."""
    src, drop, _ = COUNT_CASES[case]
    dx, tx, idx, text, reads = _pair(cases, src, drop)
    qc, lens = _lanes(idx, text, reads, L)
    want = _jax_count(dx, qc, lens, use_ftab)
    assert want[0].dtype == np.int32
    _eq(_model_on(tx, qc, lens, use_ftab), want)
    _eq(TC.find_ranges(tx, torch.from_numpy(qc), torch.from_numpy(lens), use_ftab), want)


@pytest.mark.parametrize("L", WIDTHS)
@pytest.mark.parametrize("case", list(TOE_CASES))
def test_toehold_model_and_port_match_jax(cases, case, L):
    """The model's toehold search and the port's find_ranges_w_toehold ==
    the JAX package's, lo, hi and k."""
    src, drop, _, _ = TOE_CASES[case]
    dx, tx, idx, text, reads = _pair(cases, src, drop + ("kval",))
    qc, lens = _lanes(idx, text, reads, L)
    want = _jax(dx, qc, lens)
    _eq(_model_on(tx, qc, lens, toehold=True), want)
    _eq(TL.find_ranges_w_toehold(tx, torch.from_numpy(qc), torch.from_numpy(lens)), want)


def test_model_reaches_every_edge(cases):
    """Over every case at L = 100 the lanes reach every edge the model
    counts (hi + 1 == n, hi + 1 starting a run, absent codes, a failure at
    the first step and later, length-0 lanes, lanes started from the ftab,
    trivial and non-trivial steps, k == 0 wrapping to n - 1, lanes without a
    non-trivial step; in the run-space directory an empty bucket, the last
    bucket, a search taking every halving and a start loaded after it; in
    the dense step one fetch for both ranks and two, an offset on a part
    boundary, and BWT[hi] from hi + 1's block, from lo's and from one word)
    and still equal JAX."""
    events = {}
    for src, drop, _ in COUNT_CASES.values():
        dx, tx, idx, text, reads = _pair(cases, src, drop)
        qc, lens = _lanes(idx, text, reads, 100)
        _eq(_model_on(tx, qc, lens, events=events), _jax_count(dx, qc, lens, True))
    # the run-space directory at a span of 4 positions (empty buckets under
    # long runs) and of one bucket (a binary search over every run)
    dx, tx, idx, text, reads = _pair(cases, "nodense")
    qc, lens = _lanes(idx, text, reads, 100)
    for shift in (2, 62):
        _eq(_model_on(tx.with_run_tables(shift), qc, lens, events=events),
            _jax_count(dx, qc, lens, True))
    for src, drop, _, _ in TOE_CASES.values():
        dx, tx, idx, text, reads = _pair(cases, src, drop + ("kval",))
        qc, lens = _lanes(idx, text, reads, 100)
        _eq(_model_on(tx, qc, lens, toehold=True, events=events), _jax(dx, qc, lens))
    want = ("hi1_is_n", "hi1_starts_run", "absent_code", "fail_first_step", "fail_later",
            "length_0", "ftab_start", "trivial", "nontrivial", "k_wraps", "no_nontrivial_step",
            "empty_bucket", "last_bucket", "iters_reached", "start_loaded", "one_fetch",
            "two_fetches", "part_boundary", "hi_in_block1", "hi_in_block0", "hi_word_load")
    assert all(events.get(e, 0) > 0 for e in want), [e for e in want if e not in events]


# ---------------------------------------------------------------------------
# one step of the dense and occ1 policies at every edge of a block

STEP_N = 1_337  # not a whole number of 128-symbol blocks
STEP_OFFSETS = (0, 1, 7, 8, 31, 32, 33, 63, 64, 65, 95, 96, 97, 126, 127)


@pytest.fixture(scope="module", params=[13, 16], ids=["13_codes", "16_codes"])
def step_index(request):
    """(RbtIndex with bwt4/occ_blk and occ1/tk1, BWT codes) of a random text
    of `param` codes (the terminator and `param` - 1 symbols), so that the
    nibbles hold codes 8 to `param` - 1."""
    A = request.param
    rng = np.random.default_rng(A)
    text = np.concatenate([rng.integers(3, 3 + A - 1, STEP_N - 1), [1]]).astype(np.uint8)
    idx = TB.build_index(text)
    assert idx.A == A and idx.bwt4 is not None and idx.fblock is None
    codes = np.repeat(idx.run_head, np.diff(np.append(idx.run_start, idx.n))).astype(np.int64)
    occ1 = TB.build_occ1(codes, A)
    tk1 = TB.build_tk1_from_runs(codes, idx.run_start, idx.samples_last, A, occ1.dtype)
    return dataclasses.replace(idx, occ1=occ1, tk1=tk1), codes


def _step_lanes(n, A):
    """(lo, hi, c) int32 of one step: lo and hi + 1 at every offset of
    STEP_OFFSETS in the first, a middle and the last blocks, in one block
    and in neighbouring ones, hi + 1 = n, lo <= hi; every code of [0, A)
    and -1, a code outside it."""
    blocks = sorted({0, 1, (n >> 7) // 2, n >> 7})
    pos = sorted({b * 128 + o for b in blocks for o in STEP_OFFSETS if b * 128 + o < n})
    pairs = [(lo, i1) for lo in pos for i1 in pos + [n]
             if lo < i1 and (i1 >> 7) - (lo >> 7) <= 1 or lo < i1 == n]
    lo, i1 = np.array(pairs).T
    codes = np.arange(-1, A)
    lo, i1, c = (np.repeat(lo, codes.size), np.repeat(i1, codes.size),
                 np.tile(codes, lo.size))
    return lo.astype(np.int32), (i1 - 1).astype(np.int32), c.astype(np.int32)


def _occ1_step(t, F, A, n, lo, hi, c, k):
    """lf_tables.cuh's occ1 step of one lane with the per-step toehold's k
    riding beside it: one load a rank (lo's on one thread of the pair, hi +
    1's on the other), BWT[hi] == c from occ1 at hi."""
    if not 0 <= c < A:
        return 1, 0, 0
    row = c * (n + 1)
    cb, ce = int(t["occ"][row + lo]), int(t["occ"][row + hi + 1])
    if ce - cb <= 0:
        return 1, 0, 0
    trivial = ce - int(t["occ"][row + hi]) == 1
    nk = (k - 1) % n if trivial else int(t["tk1"][c * n + hi])
    return int(F[c]) + cb, int(F[c]) + ce - 1, nk


@pytest.mark.parametrize("policy", ["dense", "occ1"])
def test_step_at_block_edges_matches_jax(step_index, policy):
    """One step of the kernel's dense model (DenseStep: DENSE_G parts a
    block, one fetch where lo and hi + 1 share it, BWT[hi] from a fetched
    block or one word) and of its occ1 step, at every block and part edge,
    == the JAX package's lf_step_dense, or lf_step_occ1 and
    lf_step_w_loc_occ1 (with k), and the port's plain steps; a code outside
    [0, A) (-1, and A for the model) empties the range."""
    idx, codes = step_index
    n, A = idx.n, idx.A
    dx = DeviceIndex.from_index(idx)
    tx = TorchIndex.from_index(idx, "cpu")
    if policy == "dense":
        tx = dataclasses.replace(tx, arrays={k: v for k, v in tx.arrays.items()
                                             if k not in ("occ1_flat", "tk1_flat")})
        dx = DeviceIndex({k: v for k, v in dx.arrays.items() if k not in ("occ1_flat", "tk1_flat")},
                         dx.n, dx.R, dx.A, dx.ma_wsize, dx.ftab_k, dx.acgt_codes)
    assert cuda_lf.table_policy(tx) == policy
    lo, hi, c = _step_lanes(n, A)
    k = np.random.default_rng(3).integers(0, n, lo.size).astype(np.int32)
    k[::7] = 0  # the trivial step's k wraps to n - 1
    F = tx.arrays["F"].numpy().astype(np.int64)
    policy_t, t = _tables_of(tx, toehold=policy == "occ1")
    events = {}
    if policy == "dense":
        step = DenseStep(t["bwt4"], t["occ"], F, n,
                         lambda key: events.__setitem__(key, events.get(key, 0) + 1))
        model = []
        for a, h, x in zip(lo.tolist(), hi.tolist(), c.tolist()):
            if not 0 <= x < A:
                model.append((1, 0))
                continue
            cb, ce, sym = step.step(a, h, x, toehold=True)
            assert sym == codes[h]  # BWT[hi]: the trivial test's symbol
            model.append((int(F[x]) + cb, int(F[x]) + ce - 1) if ce > cb else (1, 0))
        got = [np.array(v, np.int32) for v in zip(*model)]
        want = JR.lf_step_dense(dx, jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(c))
        port = TR.lf_step_dense(tx, *(torch.from_numpy(a) for a in (lo, hi, c)))
        for key in ("one_fetch", "two_fetches", "part_boundary", "hi_in_block1",
                    "hi_in_block0", "hi_word_load"):
            assert events.get(key, 0) > 0, key
        # hi + 1 = n, and lo and hi + 1 at offsets 0, 31, 32 and 127
        assert (hi + 1 == n).any() and {0, 31, 32, 127} <= set((lo & 127).tolist())
    else:
        model = [_occ1_step(t, F, A, n, a, h, x, kk)
                 for a, h, x, kk in zip(lo.tolist(), hi.tolist(), c.tolist(), k.tolist())]
        got = [np.array(v, np.int32) for v in zip(*model)]
        jl = [jnp.asarray(a) for a in (lo, hi, c)]
        want = JR.lf_step_w_loc_occ1(dx, *jl, jnp.asarray(k))
        _eq(got[:2], JR.lf_step_occ1(dx, *jl))
        port = TR.lf_step_w_loc_occ1(tx, *(torch.from_numpy(a) for a in (lo, hi, c, k)))
        _eq(got[:2], TR.lf_step_occ1(tx, *(torch.from_numpy(a) for a in (lo, hi, c))))
    _eq(got, want)
    _eq(got, port)
    out = c == -1
    assert out.any() and (got[0][out] == 1).all() and (got[1][out] == 0).all()


def test_dense_threads_are_the_kernels():
    """cuda_lf.lane_threads is csrc/lf_tables.cuh's: kDenseG threads a lane
    of the dense step, two of the run-space and occ1 steps (a pair, one
    rank each); the model holds each of a block's words on one thread."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(cuda_lf.__file__), "..", "csrc",
                            "lf_tables.cuh")).read()
    g = int(re.search(r"constexpr int kDenseG = (\d+);", src).group(1))
    assert {p: cuda_lf.lane_threads(p) for p in ("runs", "dense", "occ1")} == \
        {"runs": 2, "dense": g, "occ1": 2}
    step = DenseStep(np.zeros(16, np.int32), np.zeros(1, np.int32), [0, 1], 128)
    assert sorted(w for sub in range(DENSE_G) for w in step.parts(sub)) == list(range(16))


@pytest.mark.parametrize("policy,B,threads", [
    ("dense", 65_536, 512), ("dense", 16_384, 224), ("dense", 1_000, 32),
    ("occ1", 65_536, 512), ("occ1", 16_384, 224), ("runs", 65_536, 512)])
def test_launch_plan_of_each_policy(policy, B, threads):
    """The tables kernels' launch plan at lane_threads(policy) threads a
    lane on 132 SMs: the dense step's DENSE_G threads and the occ1 pair,
    up to 256 lanes (512 threads, the seeding kernel's Bounds) a block,
    fewer to give every SM a block; whole warps."""
    g = cuda_lf.lane_threads(policy)
    assert g == (DENSE_G if policy == "dense" else 2)
    got, staged = cuda_lf.launch_plan(B, 100, 132, group=g)
    assert (got, staged) == (threads, True)
    assert got % 32 == 0 and got <= 512


def _directory_cases():
    """{name: (run_start, n, shift)}: run starts whose directory reaches
    each edge of the search."""
    rng = np.random.default_rng(2)
    spread = np.sort(rng.choice(np.arange(1, 50_000), 4_000, replace=False))
    dense = np.concatenate([np.arange(0, 64), np.arange(64, 4_096, 37)])  # 64 runs of 1 first
    gaps = np.array([0, 5, 6, 900, 901, 902, 3_000])  # empty buckets between
    return {"one run": (np.array([0]), 1_000, None),
            "one run, n = 1": (np.array([0]), 1, None),
            "empty buckets": (gaps, 3_001, 4),
            "a full bucket of runs of length 1": (dense, 4_096, 6),
            "the default span": (np.concatenate([[0], spread]), 50_000, None),
            "one bucket": (np.concatenate([[0], spread]), 50_000, 62),
            "the last bucket": (np.concatenate([[0], spread, [49_999]]), 50_000, 3)}


@pytest.mark.parametrize("width", [np.int32, np.int64])
@pytest.mark.parametrize("name", list(_directory_cases()))
def test_directory_finds_every_run(name, width):
    """The run found through rs_off (run_directory; the kernel's search,
    run_of, and ops/rank.bucketed_lower_bound) is searchsorted(run_start, x,
    "right") - 1 for every x in [0, n), its start run_start of that run;
    the directory is bigindex.marker_buckets' at the default span and, at
    a bucket of 2^shift runs of length 1, its search takes every halving."""
    rs, n, shift = _directory_cases()[name]
    rs = rs.astype(width)
    off, (sh, iters) = run_directory(rs, n, shift)
    assert off.shape == ((n >> sh) + 2,) and off.dtype == np.int32
    if shift is None:
        want_off, want_bs = marker_buckets(rs, n, RUN_SEG)
        np.testing.assert_array_equal(off, want_off)
        assert (sh, iters) == want_bs
    x = np.arange(n)
    want = np.searchsorted(rs, x, side="right") - 1
    got = bucketed_lower_bound(torch.from_numpy(rs), torch.from_numpy(off), sh, iters,
                               torch.from_numpy(x + 1)).numpy() - 1
    np.testing.assert_array_equal(got, want)
    events = {}
    t = {"run_start": rs, "rs_off": off, "shift": sh, "iters": iters}
    found = [run_of(t, int(i), lambda k: events.__setitem__(k, events.get(k, 0) + 1))
             for i in x]
    np.testing.assert_array_equal([r for r, _ in found], want)
    np.testing.assert_array_equal([s for _, s in found], rs[want])
    if name == "a full bucket of runs of length 1":
        assert iters == 7 and events.get("iters_reached")  # 64 starts: 7 halvings
    if name == "empty buckets":
        assert (np.diff(off) == 0).any() and events.get("empty_bucket")
    if name == "one bucket":
        assert off.shape == (2,) and iters == int(np.ceil(np.log2(rs.shape[0] + 1)))
    assert events.get("last_bucket")


def test_run_records_hold_the_run_tables(cases):
    """The tables of the kernels' run-space step: built where the index
    goes to a CUDA device (none on the CPU, and stale leaves dropped), by
    with_run_tables: the directory, and where takes_run_records (at most 6
    codes, int32 lanes) the run records, run r's [run_start, run_head,
    occ[0..A)] zero-padded to 8 words; their bytes and seconds; records
    refused above 6 codes."""
    _, tx, idx, _, _ = _pair(cases, "nodense")
    cpu = TorchIndex.from_index(idx, "cpu")
    assert "rs_off" not in cpu.arrays and "run_rec" not in cpu.arrays and cpu.rs_bs == ()
    assert cpu.run_tables_bytes == 0 and cpu.run_tables_s == 0
    rec = tx.arrays["run_rec"].numpy().reshape(-1, 8)
    assert rec.shape == (tx.R, 8) and rec.dtype == np.int32
    np.testing.assert_array_equal(rec[:, 0], idx.run_start)
    np.testing.assert_array_equal(rec[:, 1], idx.run_head)
    np.testing.assert_array_equal(rec[:, 2:2 + tx.A].T.reshape(-1), tx.arrays["occ_flat"].numpy())
    assert not rec[:, 2 + tx.A:].any()
    # with pred_off, the walk's directory over pred_pos (no phi1 here)
    assert tx.run_tables_bytes == 4 * (tx.arrays["rs_off"].numel() + 8 * tx.R
                                       + tx.arrays["pred_off"].numel())
    assert tx.run_tables_s > 0
    assert "run_rec" not in _widened(cpu, True).with_run_tables().arrays  # int64 lanes
    stale = {k: v.numpy() for k, v in tx.arrays.items()}
    again = TorchIndex.from_arrays(stale, n=tx.n, R=tx.R, A=tx.A, ma_wsize=0, ftab_k=tx.ftab_k,
                                   acgt_codes=tx.acgt_codes, device="cpu")
    assert not {"rs_off", "run_rec", "pred_off"} & set(again.arrays)
    with pytest.raises(ValueError, match="run records hold at most 6 codes"):
        run_records(idx.run_start, idx.run_head, np.zeros(13 * tx.R), 13)


@pytest.mark.parametrize("A,lane,want", [(1, torch.int32, True), (6, torch.int32, True),
                                         (7, torch.int32, False), (13, torch.int32, False),
                                         (6, torch.int64, False), (0, torch.int32, False)])
def test_takes_run_records(A, lane, want):
    """The run records serve an alphabet of 1 to 6 codes with int32 lanes."""
    assert takes_run_records(A, lane) is want


# ---------------------------------------------------------------------------
# the launch path

def _tables_lib(calls, rc):
    """rbt_lf_tables as the model over the operands at the addresses and
    widths the wrapper passes; returns rc, writing nothing when rc != 0."""
    policies = {0: "runs", 1: "dense", 2: "occ1"}

    def rbt_lf_tables(policy, occ, occ_b, rs, rs_b, rh, rh_b, off, off_b, n_off, shift, iters,
                      rec, bwt4, nb, R, F, lane_b, A, n, q, lengths, B, L, ftab, ftab_b, kf, acgt,
                      tk1, tk1_b, ltk, ltk_b, sl, sl_b, lo, hi, k_out, threads, stage, stream):
        c = dict(policy=policies[policy], occ=(occ, occ_b),
                 rs=(rs, rs_b), rh=(rh, rh_b), off=(off, off_b, n_off, shift, iters), rec=rec,
                 bwt4=bwt4, nb=nb, R=R, lane=lane_b, A=A, n=n, q=q, B=B, L=L,
                 ftab=(ftab, ftab_b), kf=kf, acgt=acgt, tk1=(tk1, tk1_b), ltk=(ltk, ltk_b),
                 sl=(sl, sl_b), out=(lo, hi, k_out), threads=threads, stage=stage, stream=stream)
        calls.append(c)
        if rc or B == 0:
            return rc
        pol = c["policy"]
        size = {"runs": A * R, "dense": A * nb, "occ1": A * (n + 1)}[pol]
        t = {"occ": _ints(occ, size, occ_b)}
        resolve = k_out is not None and not tk1  # the toehold over ltk: its directory too
        if pol == "runs" or ltk:
            t["run_start"] = _ints(rs, R, rs_b)
        if pol == "runs" or resolve:
            t["rs_off"], t["shift"], t["iters"] = _ints(off, n_off, off_b), shift, iters
        else:
            assert off is None
        if pol == "runs":
            t["run_head"] = _ints(rh, R, rh_b)
            if rec:
                t["rec"] = _ints(rec, 8 * R, 4)
        else:
            assert rec is None
        if pol == "dense":
            t["bwt4"] = _ints(bwt4, 16 * nb, 4)
        if k_out:
            t["samples_last"] = _ints(sl, R, sl_b)
            if tk1:
                t["tk1"] = _ints(tk1, A * n, tk1_b)
            else:
                t["ltk"] = _ints(ltk, A * R, ltk_b)
        codes = [(acgt >> (8 * i)) & 0xFF for i in range(4)]
        codes = [x - 256 if x == 0xFF else x for x in codes]
        got = tables_model(pol, t, _ints(F, A + 1, lane_b), A, n, R,
                           _ints(q, B * L, 4).reshape(B, L), _ints(lengths, B, 4),
                           _ints(ftab, 2 * 4 ** kf, ftab_b).reshape(-1, 2) if kf else None, kf,
                           codes, k_out is not None)
        for ptr, v in zip((lo, hi, k_out), got):
            _ints(ptr, B, lane_b)[:] = v
        return rc

    return SimpleNamespace(rbt_lf_tables=rbt_lf_tables,
                           rbt_cuda_error_string=lambda code: b"invalid argument")


@pytest.fixture
def fake_tables(monkeypatch):
    rec = {"calls": [], "rc": 0}

    def install():
        monkeypatch.setattr(cuda_lf, "_LIB", _tables_lib(rec["calls"], rec["rc"]))

    monkeypatch.setattr(cuda_lf, "_raw_stream", lambda dev: 1000 + dev)
    monkeypatch.setattr(cuda_lf, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(cuda_lf.torch.cuda, "current_device", lambda: 0)
    for name in ("LAUNCHES", "LAUNCHES_TOE"):
        monkeypatch.setattr(cuda_lf, name, 0)
    for name in ("LAUNCHES_TAB", "LAUNCHES_TAB_TOE"):
        monkeypatch.setattr(cuda_lf, name, {"runs": 0, "dense": 0, "occ1": 0})
    rec["install"] = install
    return rec


def _widened(tx, lanes):
    """tx with its tables int64 (as TorchIndex.from_arrays widens u32
    tables), the bwt4 words kept int32; with `lanes` F too, so that the
    lanes are int64, and no run records (a load at int64 lanes builds
    none)."""
    keep = () if lanes else ("F",)
    return dataclasses.replace(tx, arrays={
        k: v.long() if k in TABLE_KEYS + ("F",) and k not in keep else v
        for k, v in tx.arrays.items() if not (lanes and k == "run_rec")})


def _all_cases():
    return ([(c, False) for c in COUNT_CASES] + [(c, True) for c in TOE_CASES])


def _launch_cases():
    """(case, toehold, width, records): every case at each width as loaded
    ("default": over the run-space tables with the run records at int32
    lanes, without at int64), and the run-space cases at int32 lanes
    without the records (the step of an index of more than 6 codes)."""
    out = [(c, t, w, "default") for c, t in _all_cases()
           for w in ("int32", "int64_tables", "int64_lanes")]
    runs = [(c, t) for c, t in _all_cases()
            if (TOE_CASES if t else COUNT_CASES)[c][2] == "runs"]
    return out + [(c, t, w, "no_records") for c, t in runs for w in ("int32", "int64_tables")]


@pytest.mark.parametrize("case,toehold,width,records", _launch_cases(),
                         ids=[f"{c}-{'toehold' if t else 'count'}-{w}-{r}"
                              for c, t, w, r in _launch_cases()])
def test_launch_path_equals_the_twin(cases, fake_tables, case, toehold, width, records):
    """launch_tables with the model behind its C entry == the plain twin,
    at each width of the tables and the lanes, over the run-space tables
    with the run records and without; the operands are the policy's tables
    at their own widths (the directory, and the run records where the
    index has them), the launch plan lane_threads threads a lane (two over
    the run-space tables), the ftab passed for the count search only."""
    src, drop = (TOE_CASES if toehold else COUNT_CASES)[case][:2]
    _, tx, idx, text, reads = _pair(cases, src, drop + (("kval",) if toehold else ()))
    if width != "int32":
        tx = _widened(tx, width == "int64_lanes")
    if records == "no_records":
        tx = dataclasses.replace(tx, arrays={k: v for k, v in tx.arrays.items() if k != "run_rec"})
    qc, lens = _lanes(idx, text, reads, 100)
    q, ln = torch.from_numpy(qc), torch.from_numpy(lens)
    if toehold:
        want = cuda_lf.find_ranges_toehold_plain(tx, q, ln)
    else:
        want = cuda_lf.find_ranges_plain(tx, q, ln)
    fake_tables["install"]()
    got = cuda_lf.launch_tables(tx, q, ln, use_ftab=True, toehold=toehold)
    _eq(got, [w.numpy() for w in want])
    policy = cuda_lf.table_policy(tx)
    counts = cuda_lf.LAUNCHES_TAB_TOE if toehold else cuda_lf.LAUNCHES_TAB
    assert counts == dict({"runs": 0, "dense": 0, "occ1": 0}, **{policy: 1})
    assert cuda_lf.LAUNCHES == cuda_lf.LAUNCHES_TOE == 0
    (c,) = fake_tables["calls"]
    wide = 8 if width != "int32" else 4
    assert (c["policy"], c["A"], c["n"], c["R"]) == (policy, tx.A, tx.n, tx.R)
    assert c["lane"] == (8 if width == "int64_lanes" else 4)
    assert c["occ"][1] == wide and c["q"] == q.data_ptr() and (c["B"], c["L"]) == qc.shape
    group = cuda_lf.lane_threads(policy)
    assert (c["threads"], bool(c["stage"])) == cuda_lf.launch_plan(*qc.shape, 132, group=group)
    assert c["threads"] % 32 == 0 and c["stream"] == 1000
    if policy == "runs":
        assert c["rs"][1] == c["rh"][1] == wide and c["bwt4"] is None
        off, off_b, n_off, shift, iters = c["off"]
        assert off == tx.arrays["rs_off"].data_ptr() and (shift, iters) == tx.rs_bs
        assert n_off == (tx.n >> shift) + 2 and off_b == tx.arrays["rs_off"].element_size()
        assert (c["rec"] is not None) == (records == "default" and width != "int64_lanes")
        if c["rec"] is not None:
            assert c["rec"] == tx.arrays["run_rec"].data_ptr()
    if policy == "dense":
        assert c["bwt4"] is not None and c["nb"] == tx.arrays["bwt4"].numel() // 16
    if toehold:
        assert c["kf"] == 0 and c["ftab"] == (None, 0) and c["sl"][1] == wide
        assert (c["tk1"][0] is None) == (cuda_lf.toehold_route(tx) == "ltk")
        assert len(set(c["out"])) == 3
        if cuda_lf.toehold_route(tx) == "ltk":  # the resolve's directory, under every policy
            off = tx.arrays["rs_off"]
            assert c["off"] == (off.data_ptr(), off.element_size(), off.numel(), *tx.rs_bs)
    else:
        assert c["kf"] == tx.ftab_k and c["ftab"][1] == wide and c["out"][2] is None


@pytest.mark.parametrize("width", ["int32", "int64_lanes"])
@pytest.mark.parametrize("toehold", [False, True], ids=["count", "toehold"])
def test_full_batch_block_is_its_lane_types(cases, fake_tables, width, toehold):
    """A batch that gives every SM full blocks launches blocks of 512
    threads at either lane type, within the bound csrc/lf.cu LfBounds builds
    the tables kernel's instances for (1024 threads with int32 lanes, 512
    with int64, which the kernel refuses to exceed)."""
    _, tx, idx, _, _ = _pair(cases, "nodense", ("kval",) if toehold else ())
    if width != "int32":
        tx = _widened(tx, True)
    fake_tables["rc"] = 1  # the call is recorded, the model not run
    fake_tables["install"]()
    B, L = 132 * 256, 31
    q, ln = torch.full((B, L), 2, dtype=torch.int32), torch.full((B,), L, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="LF kernel launch failed"):
        cuda_lf.launch_tables(tx, q, ln, use_ftab=False, toehold=toehold)
    (c,) = fake_tables["calls"]
    assert c["threads"] == 512 and c["stage"]


def test_launch_path_on_a_view_and_no_lanes(cases, fake_tables):
    """A view one row into a batch is passed as it is; no lanes launch
    nothing and count nothing."""
    _, tx, idx, text, reads = _pair(cases, "nodense")
    qc, lens = _lanes(idx, text, reads, 31)
    q, ln = torch.from_numpy(qc)[1:], torch.from_numpy(lens)[1:]
    fake_tables["install"]()
    _eq(cuda_lf.launch_tables(tx, q, ln, toehold=True),
        [w.numpy() for w in cuda_lf.find_ranges_toehold_plain(tx, q, ln)])
    assert fake_tables["calls"][0]["q"] == q.data_ptr()
    outs = cuda_lf.launch_tables(tx, q[:0], ln[:0])
    assert [o.shape for o in outs] == [(0,), (0,)]
    assert cuda_lf.LAUNCHES_TAB_TOE["runs"] == 1 and cuda_lf.LAUNCHES_TAB["runs"] == 0
    assert len(fake_tables["calls"]) == 2


def test_refused_launch_raises_and_counts_nothing(cases, fake_tables):
    _, tx, idx, text, reads = _pair(cases, "iupac")
    fake_tables["rc"] = 1
    fake_tables["install"]()
    qc, lens = _lanes(idx, text, reads, 31)
    with pytest.raises(RuntimeError, match="LF kernel launch failed: invalid argument"):
        cuda_lf.launch_tables(tx, torch.from_numpy(qc), torch.from_numpy(lens))
    assert cuda_lf.LAUNCHES_TAB["dense"] == 0 and len(fake_tables["calls"]) == 1


@pytest.mark.parametrize("fault,error,match", [
    ("float occ", TypeError, "occ_flat must be int32 or int64"),
    ("int64 bwt4", TypeError, "bwt4 must be int32"),
    ("int64 qcodes", TypeError, "qcodes must be int32"),
    ("float F", TypeError, "F must be int32 or int64"),
    ("no run_head", ValueError, "the runs tables kernel needs run_head"),
    ("short occ_flat", ValueError, "occ_flat of shape"),
    ("no samples_last", ValueError, "the runs tables kernel needs samples_last"),
    ("fused rows", ValueError, "the tables kernel is for an index without fused rows"),
    ("lengths shape", ValueError, "lengths must be"),
    ("misaligned bwt4", ValueError, "bwt4 is not 16-byte aligned"),
    ("17 codes", ValueError, "alphabet of 17 codes"),
    ("int32 lanes above 2^31", ValueError, "int32 lanes for n"),
    ("ftab shape", ValueError, "ftab of shape"),
    ("other device", ValueError, "is on meta"),
    ("no rs_off", ValueError, "the runs tables kernel needs rs_off; the index has none"),
    ("no rs_bs", ValueError, "needs rs_off's \\(shift, iters\\)"),
    ("short rs_off", ValueError, "rs_off of shape"),
    ("float rs_off", TypeError, "rs_off must be int32 or int64"),
    ("int64 run records", TypeError, "run_rec must be int32"),
    ("misaligned run records", ValueError, "or not 32-byte aligned"),
    ("run records with int64 lanes", ValueError, "run records over 6 codes with torch.int64"),
])
def test_launch_refuses(cases, fake_tables, fault, error, match):
    name = "iupac" if fault in ("int64 bwt4", "misaligned bwt4", "17 codes") else "nodense"
    _, tx, idx, text, reads = _pair(cases, name)
    fake_tables["install"]()
    qc, lens = _lanes(idx, text, reads, 31)
    q, ln = torch.from_numpy(qc), torch.from_numpy(lens)
    arrays, kw, toehold = dict(tx.arrays), {}, fault == "no samples_last"
    if fault == "float occ":
        arrays["occ_flat"] = arrays["occ_flat"].float()
    elif fault == "int64 bwt4":
        arrays["bwt4"] = arrays["bwt4"].long()
    elif fault == "int64 qcodes":
        q = q.long()
    elif fault == "float F":
        arrays["F"] = arrays["F"].float()
    elif fault == "no run_head":
        del arrays["run_head"]
    elif fault == "short occ_flat":
        arrays["occ_flat"] = arrays["occ_flat"][:-1]
    elif fault == "no samples_last":
        del arrays["samples_last"]
    elif fault == "fused rows":
        arrays["fblock64"] = torch.zeros((1, 16), dtype=torch.int32)
    elif fault == "lengths shape":
        ln = ln[:-1]
    elif fault == "misaligned bwt4":
        arrays["bwt4"] = torch.cat([arrays["bwt4"][:1], arrays["bwt4"]])[1:]
    elif fault == "17 codes":
        kw["A"] = 17
        arrays["F"] = torch.zeros(18, dtype=arrays["F"].dtype)
    elif fault == "int32 lanes above 2^31":
        kw["n"] = 1 << 31
    elif fault == "ftab shape":
        arrays["ftab"] = arrays["ftab"][:-1]
    elif fault == "other device":
        arrays["run_start"] = arrays["run_start"].to("meta")
    elif fault == "no rs_off":
        del arrays["rs_off"]
    elif fault == "no rs_bs":
        kw["rs_bs"] = ()
    elif fault == "short rs_off":
        arrays["rs_off"] = arrays["rs_off"][:-1]
    elif fault == "float rs_off":
        arrays["rs_off"] = arrays["rs_off"].float()
    elif fault == "int64 run records":
        arrays["run_rec"] = arrays["run_rec"].long()
    elif fault == "misaligned run records":
        arrays["run_rec"] = torch.cat([arrays["run_rec"][:1], arrays["run_rec"]])[1:]
    elif fault == "run records with int64 lanes":
        arrays["F"] = arrays["F"].long()
    with pytest.raises(error, match=match):
        cuda_lf.launch_tables(dataclasses.replace(tx, arrays=arrays, **kw), q, ln,
                              toehold=toehold)
    assert fake_tables["calls"] == [] and sum(cuda_lf.LAUNCHES_TAB.values()) == 0


@pytest.mark.parametrize("L,staged", [(100, True), (1500, True), (1501, False)])
def test_launch_plan_at_one_thread_a_lane(L, staged):
    """One thread a lane: whole warps of lanes, 256 lanes a block at full
    batches, fewer to give every SM a block, and the codes staged while one
    warp's lanes fit 47 KB (L up to 1,500)."""
    threads, st = cuda_lf.launch_plan(65_536, L, 132, group=1)
    assert st == staged and threads % 32 == 0
    assert threads == (256 if L == 100 else 32)
    assert cuda_lf.launch_plan(1_000, 100, 132, group=1) == (32, True)
    assert cuda_lf.launch_plan(65_536, 100, 132) == (512, True)  # K1: two threads a lane


@pytest.mark.parametrize("toehold", [False, True], ids=["count", "toehold"])
def test_wrapper_routes_an_index_without_rows_to_the_kernel(monkeypatch, toehold):
    """On a CUDA tensor find_ranges and find_ranges_toehold launch the tables
    kernel over an index without fused rows (the toehold from the full
    range, lengths as int32), K1 over one with them; CPU tensors take the
    plain twins; other devices raise."""
    calls = []
    monkeypatch.setattr(cuda_lf, "launch_tables",
                        lambda tx, q, ln, use_ftab=True, toehold=False:
                        calls.append(("tables", use_ftab, toehold, ln.dtype)) or "tab")
    for name in ("launch_k1", "launch_toehold", "find_ranges_plain",
                 "find_ranges_toehold_plain"):
        monkeypatch.setattr(cuda_lf, name, lambda *a, name=name, **k: calls.append(name) or name)
    ln = torch.zeros(4, dtype=torch.int64)
    cuda = SimpleNamespace(device=SimpleNamespace(type="cuda"), shape=(4, 8))
    cpu = SimpleNamespace(device=SimpleNamespace(type="cpu"), shape=(4, 8))
    fn = cuda_lf.find_ranges_toehold if toehold else cuda_lf.find_ranges
    for tables in ({"run_start": None}, {"bwt4": None}, {"occ1_flat": None}):
        tx = SimpleNamespace(arrays=tables, has_dense="bwt4" in tables)
        assert fn(tx, cuda, ln) == "tab"
        assert calls.pop() == ("tables", not toehold, toehold,
                               torch.int32 if toehold else torch.int64)
        assert fn(tx, cpu, ln) == ("find_ranges_toehold_plain" if toehold else
                                   "find_ranges_plain")
    tx = SimpleNamespace(arrays={"fblock64": None}, has_dense=False)
    assert fn(tx, cuda, ln) == ("launch_toehold" if toehold else "launch_k1")
    with pytest.raises(ValueError, match="no LF loop for device"):
        fn(tx, SimpleNamespace(device=SimpleNamespace(type="mps"), shape=(4, 8)), ln)


def test_table_policy_follows_lf_step_auto(cases):
    """occ1 ahead of the dense tables ahead of the run-space ones; None over
    fused rows (K1's)."""
    _, tx, *_ = _pair(cases, "raw13")
    assert cuda_lf.table_policy(tx) == "occ1"
    assert cuda_lf.table_policy(_pair(cases, "raw13", ("occ1_flat",))[1]) == "dense"
    assert cuda_lf.table_policy(_pair(cases, "raw13", ("occ1_flat", "bwt4"))[1]) == "runs"
    assert cuda_lf.table_policy(SimpleNamespace(arrays={"fblock64": None},
                                                has_dense=False)) is None


# ---------------------------------------------------------------------------
# on the card

@pytest.mark.gpu
def test_cuda_tables_kernel_matches_plain(cases):
    """The tables kernel == its plain twins on the card, every policy and
    instance, at each width.  Runs only where jax and CUDA are both
    installed; chip_smoke.py (phase parity) makes the same checks with torch
    alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the tables kernel has no CPU mode)")
    for case, toehold in _all_cases():
        src, drop = (TOE_CASES if toehold else COUNT_CASES)[case][:2]
        _, tx, idx, text, reads = _pair(cases, src, drop + (("kval",) if toehold else ()))
        tx = TorchIndex.from_arrays({k: v.numpy() for k, v in tx.arrays.items()}, n=tx.n,
                                    R=tx.R, A=tx.A, ma_wsize=0, ftab_k=tx.ftab_k,
                                    acgt_codes=tx.acgt_codes, device="cuda")
        for L in WIDTHS:
            qc, lens = _lanes(idx, text, reads, L)
            q, ln = torch.from_numpy(qc).cuda(), torch.from_numpy(lens).cuda()
            if toehold:
                got = cuda_lf.find_ranges_toehold(tx, q, ln)
                want = cuda_lf.find_ranges_toehold_plain(tx, q, ln)
            else:
                got, want = cuda_lf.find_ranges(tx, q, ln), cuda_lf.find_ranges_plain(tx, q, ln)
            torch.cuda.synchronize()
            _eq([g.cpu() for g in got], [w.cpu().numpy() for w in want])
