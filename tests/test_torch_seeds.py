"""The port's greedy seeding engines (rowbowt_tpu_torch.engine.seeds, torch on
the CPU) == the JAX package's (rowbowt_tpu.engine.seeds), buffer and dtype,
and == the port's scalar oracle (rowbowt_tpu_torch.engine.naive), on a
3-document panel built here: a reference and two haplotypes with SNPs, a
marker at every site of every document, an ftab of k = 6, and reads with
substitutions, an 'N', very short reads and length-0 pad lanes.  Every
output is an integer, so every comparison is exact.

build_panel is also the fixture source of the CLI tests
(test_torch_markers_cli.py, test_torch_locs_cli.py), and save_jax_big their
source of a BigIndex directory."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rowbowt_tpu.engine import seeds as JS
from rowbowt_tpu.engine.device import DeviceIndex
from rowbowt_tpu.index import RbtIndex as JaxRbtIndex
from rowbowt_tpu_torch.alphabet import SEP_BYTE, TERM_BYTE
from rowbowt_tpu_torch.construct.build import build_index
from rowbowt_tpu_torch.construct.panel import Marker
from rowbowt_tpu_torch.engine import naive
from rowbowt_tpu_torch.engine import seeds as TS
from rowbowt_tpu_torch.engine.batch import encode_batch
from rowbowt_tpu_torch.engine.device import TorchIndex
from rowbowt_tpu_torch.engine.filters import assemble_seeds
from rowbowt_tpu_torch.index import RbtIndex

ACGT = np.frombuffer(b"ACGT", np.uint8)
REF_LEN = 1500
SEP_LEN = 10


def build_panel(d, n_reads=36, seed=23):
    """Index directories under d and a FASTQ of n_reads reads.

    Returns (dirs, fastq path, reads as bytes).  dirs: "idx" (SA samples,
    markers with window 10, document list, ftab k = 6), "bare" (no markers,
    no document list), "no_sa" (markers, no SA samples), and "midx_txt", the
    text marker-position file of the markers (one "<text_pos> <seq> <pos>
    <allele>" line each).  The reads: substrings of the documents of 12-64
    bases, every third with one or two substitutions, one with an 'N', a
    2-base read, a 5-base read and a random read."""
    rng = np.random.default_rng(seed)
    ref = rng.choice(ACGT, size=REF_LEN)
    docs, sites = [ref], []
    for _ in range(2):
        hap = ref.copy()
        s = rng.choice(REF_LEN, size=40, replace=False)
        hap[s] = rng.choice(ACGT, size=40)
        docs.append(hap)
        sites.append(s)
    sites = np.unique(np.concatenate(sites))
    sep = np.full(SEP_LEN, SEP_BYTE, np.uint8)
    text = np.concatenate([x for doc in docs for x in (doc, sep)]
                          + [np.array([TERM_BYTE], np.uint8)])
    doc_starts = np.arange(3) * (REF_LEN + SEP_LEN)
    markers = [Marker(text_pos=int(doc_starts[k] + p), seq=k % 2, pos=int(p),
                      allele=int(docs[k][p] != ref[p]))
               for k in range(3) for p in sites]
    dirs = {name: os.path.join(str(d), name) for name in ("idx", "bare", "no_sa")}
    build_index(text, markers=markers, doc_starts=doc_starts, doc_names=["ref", "h0", "h1"],
                ftab_k=6).save(dirs["idx"])
    build_index(text).save(dirs["bare"])
    build_index(text, markers=markers, with_sa_samples=False).save(dirs["no_sa"])
    dirs["midx_txt"] = os.path.join(str(d), "markers.txt")
    with open(dirs["midx_txt"], "w") as f:
        f.writelines(f"{m.text_pos} {m.seq} {m.pos} {m.allele}\n" for m in markers)
    reads = []
    for q in range(n_reads - 5):
        L = int(rng.integers(12, 65))
        p = int(rng.integers(0, REF_LEN - L))
        r = docs[q % 3][p:p + L].copy()
        if q % 3 == 1:
            for _ in range(int(rng.integers(1, 3))):
                r[rng.integers(0, L)] = rng.choice(ACGT)
        reads.append(r.tobytes())
    reads[4] = reads[4][:5] + b"N" + reads[4][6:]
    reads += [ref[100:102].tobytes(), ref[300:305].tobytes(),
              rng.choice(ACGT, size=40).tobytes(), ref[700:764].tobytes(),
              docs[1][sites[3] - 20:sites[3] + 30].tobytes()]
    fq = os.path.join(str(d), "reads.fq")
    with open(fq, "wb") as f:
        for q, r in enumerate(reads):
            f.write(b"@read%d extra\n%s\n+\n%s\n" % (q, r, b"I" * len(r)))
    return dirs, fq, reads


def save_jax_big(idx_dir, out_dir, n_sup=3, with_markers=True):
    """The two-level BigIndex of the index saved at idx_dir, written by the
    JAX package's BigIndex.save to out_dir (its `<out_dir>.midx.npz` copied
    beside it when idx_dir has one): the same BWT, its locate tables from
    the index's full SA, its marker CSR, window and document list."""
    import shutil

    from rowbowt_tpu.bigindex import BigIndex as JaxBigIndex

    idx = JaxRbtIndex.load(idx_dir)
    codes = np.repeat(idx.run_head, np.diff(np.append(idx.run_start, idx.n))).astype(np.uint8)
    big = JaxBigIndex.from_codes(codes, idx.alpha, n_sup=n_sup)
    big.attach_locate(codes, np.asarray(idx.kval).astype(np.uint32))
    if with_markers and idx.ma_row is not None:
        big.ma_row, big.ma_val = idx.ma_row.astype(np.uint32), idx.ma_val.astype(np.int64)
        big.ma_wsize = idx.ma_wsize
    big.doc_starts, big.doc_names = idx.doc_starts, idx.doc_names
    big.save(out_dir)
    if os.path.exists(idx_dir + ".midx.npz"):
        shutil.copy(idx_dir + ".midx.npz", out_dir + ".midx.npz")
    return out_dir


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """(port RbtIndex, JAX DeviceIndex, port TorchIndex on the CPU, reads
    with their reverse complements, qcodes [B, 64], lengths) with 4 length-0
    pad lanes at the end."""
    from rowbowt_tpu_torch.alphabet import revcomp

    dirs, _, reads = build_panel(tmp_path_factory.mktemp("torch_seeds"))
    idx = RbtIndex.load(dirs["idx"])
    dx = DeviceIndex.from_index(JaxRbtIndex.load(dirs["idx"]))
    tx = TorchIndex.from_index(idx, "cpu")
    lanes = [s for r in reads for s in (r, revcomp(r).tobytes())] + [b""] * 4
    qc, lens = encode_batch(idx, lanes, pad_to=64)
    return idx, dx, tx, lanes, qc, lens


def _eq(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


def _codes(idx, r):
    return idx.alpha.encode(np.frombuffer(r, np.uint8)).astype(np.int64)


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("use_ftab,values,S,K", [
    (True, True, 8, 16), (False, True, 8, 16), (True, False, 8, 16), (False, False, 8, 16),
    (True, False, 2, 2), (False, True, 2, 2),
], ids=["ftab_values", "values", "ftab_ids", "ids", "ftab_ids_overflow", "values_overflow"])
def test_markers_greedy_seeding_matches_jax_and_naive(panel, use_ftab, values, S, K):
    """Buffer-equal to JAX; the seeds and their marker buffers (resolved from
    entry ids where values=False) equal the oracle's fn() calls; S = K = 2
    truncates seeds and markers."""
    idx, dx, tx, lanes, qc, lens = panel
    kw = dict(wsize=10, max_seeds=S, max_k=K, use_ftab=use_ftab, values=values)
    want = JS.markers_greedy_seeding(dx, jnp.asarray(qc), jnp.asarray(lens), **kw)
    got = TS.markers_greedy_seeding(tx, *_t(qc, lens), **kw)
    _eq(got, want)
    slo, shi, sqs, sqe, mv, mcnt, ns = (g.numpy() for g in got)
    if not values:
        mv = np.where(mv >= 0, idx.ma_val[np.clip(mv, 0, len(idx.ma_val) - 1)], -1)
    for b, r in enumerate(lanes):
        calls = []
        if r:
            naive.get_markers_greedy_seeding(
                idx, _codes(idx, r), 10, 1 << 62,
                lambda rn, q, mk: calls.append((tuple(rn), q, [int(x) for x in mk])),
                use_ftab=use_ftab)
        assert ns[b] == len(calls), b
        for s, (rn, (qs, qe), mk) in enumerate(calls[:S]):
            assert (slo[b, s], shi[b, s]) == rn, (b, s)
            assert sqs[b, s] == qs and sqe[b, s] == np.int32(qe), (b, s)
            assert mcnt[b, s] == len(mk), (b, s)
            assert mv[b, s, :min(len(mk), K)].tolist() == mk[:K], (b, s)
    assert (mcnt > 0).any() and (ns > 1).any()
    if S == 2:
        assert (ns > S).any() and (mcnt > K).any()


def test_greedy_seeds_assemble_like_the_oracle(panel):
    """The host assembly (engine/filters.assemble_seeds, the CLI's per-lane
    path) of the engine's buffers prints the lines that the oracle's fn()
    calls print through the same MarkerSeed."""
    from rowbowt_tpu_torch.engine.filters import MarkerSeed, _u64

    idx, _, tx, lanes, qc, lens = panel
    got = TS.markers_greedy_seeding(tx, *_t(qc, lens), wsize=10, max_seeds=16, max_k=32)
    got = [g.numpy() for g in got]
    for b, r in enumerate(lanes[:-4]):
        strand = "+-"[b % 2]
        lines = [ms.print_buf() for ms in assemble_seeds(
            "q", strand, len(r), *(a[b] for a in got), max_k=32)]
        want = []

        def fn(rn, q, mk):
            if rn[1] >= rn[0]:
                qs = q[0]
                want.append(MarkerSeed("q", strand, _u64(rn[1] - rn[0] + 1),
                                       len(r) - qs - 1 if strand == "-" else qs,
                                       _u64(q[1] - qs + 1),
                                       sorted({int(x) for x in mk})).print_buf())
        naive.get_markers_greedy_seeding(idx, _codes(idx, r), 10, 1 << 62, fn)
        assert lines == want, b


def test_markers_lmem_lanes_matches_jax_and_naive(panel):
    idx, dx, tx, _, _, _ = panel
    reads = [r for r in panel[3][:24:2] if r]
    lanes, owner, koff = TS.lmem_expand(reads)
    assert (lanes, owner, koff) == JS.lmem_expand(reads)
    qc, lens = encode_batch(idx, lanes, pad_to=64)
    kw = dict(wsize=10, max_range=200, max_k=4)
    want = JS.markers_lmem_lanes(dx, jnp.asarray(qc), jnp.asarray(lens), **kw)
    got = TS.markers_lmem_lanes(tx, *_t(qc, lens), **kw)
    _eq(got, want)
    elo, ehi, eqs, mv, mcnt = (g.numpy() for g in got)
    for rid, r in enumerate(reads):
        calls = []
        naive.get_markers_lmems(idx, _codes(idx, r), 10, 200,
                                lambda rn, q, mk: calls.append((tuple(rn), q, list(mk))))
        calls = [c for c in calls if c[0][1] >= c[0][0]]  # out_fn drops empty ranges
        mine = [((int(elo[j]), int(ehi[j])), (int(eqs[j]), len(lanes[j]) - 1),
                 mv[j, :min(int(mcnt[j]), 4)].tolist(), int(mcnt[j]))
                for j in range(len(lanes)) if owner[j] == rid and ehi[j] >= elo[j]]
        assert mine == [(rn, q, mk[:4], len(mk)) for rn, q, mk in calls], rid
    assert (mcnt > 4).any() and (mcnt > 0).mean() < 1


@pytest.mark.parametrize("min_length", [5, 0])
def test_seeds_greedy_w_sample_matches_jax_and_naive(panel, min_length):
    """min_length=0 keeps the documented deviation: degenerate full-range
    records report SA[n-1] (the JAX package does the same)."""
    idx, dx, tx, lanes, qc, lens = panel
    S = 4
    want = JS.seeds_greedy_w_sample(dx, jnp.asarray(qc), jnp.asarray(lens),
                                    min_length=min_length, max_seeds=S)
    got = TS.seeds_greedy_w_sample(tx, *_t(qc, lens), min_length=min_length, max_seeds=S)
    _eq(got, want)
    slo, shi, sqs, sqe, ssamp, ns = (g.numpy() for g in got)
    full = 0
    for b, r in enumerate(lanes):
        lfs = naive.get_seeds_greedy_w_sample(idx, _codes(idx, r), min_length)
        assert ns[b] == len(lfs), b
        for s, lfd in enumerate(lfs[:S]):
            assert (slo[b, s], shi[b, s], sqs[b, s], sqe[b, s]) == (*lfd.rn, lfd.qstart,
                                                                    lfd.qend), (b, s)
            if lfd.rn == (0, idx.n - 1):
                full += 1
                assert ssamp[b, s] == idx.kval[idx.n - 1]
            else:
                assert ssamp[b, s] == lfd.ssamp, (b, s)
    assert (ns > S).any() and (full > 0) == (min_length == 0)


def test_locate_from_longest_seed_matches_jax_and_naive(panel):
    idx, dx, tx, lanes, qc, lens = panel
    jres = JS.seeds_greedy_w_sample(dx, jnp.asarray(qc), jnp.asarray(lens), min_length=5)
    tres = TS.seeds_greedy_w_sample(tx, *_t(qc, lens), min_length=5)
    want = JS.locate_from_longest_seed(dx, *jres, max_hits=3)
    got = TS.locate_from_longest_seed(tx, *tres, max_hits=3)
    _eq(got, want)
    locs, cnt = (g.numpy() for g in got)
    for b, r in enumerate(lanes):
        lfs = naive.get_seeds_greedy_w_sample(idx, _codes(idx, r), 5)
        assert locs[b, :cnt[b]].tolist() == naive.locate_from_longest_seed(idx, 3, lfs), b
    assert (cnt == 3).any() and (cnt == 1).any() and (cnt == 0).any()


def test_ftab_k_above_wsize_plus_one_raises(panel):
    """The reference refuses a window shorter than the ftab's k - 1
    (rowbowt.hpp:350-353, 423-426); --lmem needs the ftab."""
    _, _, tx, _, qc, lens = panel
    q, ln = _t(qc, lens)
    with pytest.raises(ValueError, match="wsize cannot be less than ftab k-1"):
        TS.markers_greedy_seeding(tx, q, ln, wsize=4, use_ftab=True)
    TS.markers_greedy_seeding(tx, q[:2], ln[:2], wsize=4, use_ftab=False)
    with pytest.raises(ValueError, match="wsize cannot be less than ftab k-1"):
        TS.markers_lmem_lanes(tx, q, ln, wsize=4)
    no_ft = TorchIndex({k: v for k, v in tx.arrays.items() if k != "ftab"}, tx.n, tx.R,
                       tx.A, tx.ma_wsize, tx.ftab_k, tx.acgt_codes, tx.device)
    with pytest.raises(ValueError, match="ftab must be enabled"):
        TS.markers_lmem_lanes(no_ft, q, ln, wsize=10)


def test_toehold_without_kval_names_roadmap(panel):
    _, _, tx, _, qc, lens = panel
    q, ln = _t(qc[:2], lens[:2])
    bare = TorchIndex({k: v for k, v in tx.arrays.items() if k != "kval"}, tx.n, tx.R,
                      tx.A, tx.ma_wsize, tx.ftab_k, tx.acgt_codes, tx.device)
    # without kval the toehold rides through the loop (run-space LF_w_loc):
    # the JAX package's per-step branch, and the kval route's toeholds
    dx = panel[1]
    dxb = DeviceIndex({k: v for k, v in dx.arrays.items() if k != "kval"}, dx.n, dx.R, dx.A,
                      dx.ma_wsize, dx.ftab_k, dx.acgt_codes)
    q, ln = _t(qc, lens)
    got = TS.seeds_greedy_w_sample(bare, q, ln, min_length=5)
    _eq(got, JS.seeds_greedy_w_sample(dxb, jnp.asarray(qc), jnp.asarray(lens), min_length=5))
    for g, w in zip(got, TS.seeds_greedy_w_sample(tx, q, ln, min_length=5)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    # a big index (no kval) resolves each seed's toehold from its trajectory
    # over the O(R) run tables: the same seeds and toeholds as kval gives
    from rowbowt_tpu_torch.bigindex import BigIndex

    idx = panel[0]
    codes = np.repeat(idx.run_head, np.diff(np.append(idx.run_start, idx.n))).astype(np.uint8)
    big = BigIndex.from_codes(codes, idx.alpha, n_sup=3)
    big.attach_locate(codes, idx.kval.astype(np.uint32))
    q, ln = _t(qc, lens)
    got = TS.seeds_greedy_w_sample(TorchIndex.from_big(big, "cpu"), q, ln, min_length=5)
    want = TS.seeds_greedy_w_sample(tx, q, ln, min_length=5)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), w.numpy())

