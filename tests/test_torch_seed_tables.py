"""The seeding state machines of rbt_markers and rbt_locs over every index
in one kernel launch a batch: over the occ1, dense and run-space tables of
an index without fused rows (csrc/seeds.cu seed_tables_kernel, C entry
rbt_seed_machine_tables), and the sampled machine's per-step toehold on an
index without kval, over those tables and over fused rows (the TOE
instances).

A numpy model of the kernel (one lane at a time: the ranks and BWT[hi]
from the tables the kernel reads, the dense ranks as the dense step counts
them, a block split over the lane's threads and fetched once for both
ends where they share it; the greedy, L-MEM and sampled machines of
test_torch_seed_kernel.machine_model over them; for the per-step toehold
the current run's last non-trivial step with its trivial steps, copied
after every successful step and resolved once a seed from tk1 or ltk, with
the reference's per-step recurrence riding beside it and agreeing) sits
behind fake C entries that read the addresses and widths the wrapper
passes.  Through the public engines (markers_greedy_seeding,
markers_lmem_lanes, seeds_greedy_w_sample) it equals the JAX package's
functions buffer for buffer, and so do the port's plain twins, on the panel
built --no-dense (run-space tables, ltk), the panel of 13 codes (dense
tables, kval), its raw build (occ1 + tk1; without them the dense tables
with ltk) and the 6-code panel's raw build (fused rows with tk1 and with
ltk; without its rows occ1 + tk1), at L = 1, 31 and 100, with the ftab on
and off.  At capacities that overflow the model's records equal the twins';
the lanes reach every edge the model counts.  Every output is an integer,
so every check is exact."""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rowbowt_tpu.engine import seeds as JS
from rowbowt_tpu.engine.device import DeviceIndex
from rowbowt_tpu_torch.construct import build as TB
from rowbowt_tpu_torch.construct import panel as TP
from rowbowt_tpu_torch.construct import rawio as TRAW
from rowbowt_tpu_torch.engine import seeds as TS
from rowbowt_tpu_torch.engine.device import TorchIndex
from rowbowt_tpu_torch.io.fastq import read_seqs
from rowbowt_tpu_torch.ops import cuda_lf, cuda_seeds
from test_torch_build import write_inputs
from test_torch_lf_tables import DenseStep, _nibbles
from test_torch_seed_kernel import _eq, _model_lib, machine_model, rank_table
from test_torch_toehold import ACGT, _ints, _lanes, _symbols, _text_reads, resolve_run

WIDTHS = (1, 31, 100)
WSIZE = 10
ZERO = dict.fromkeys(cuda_seeds.LAUNCHES_SEED, 0)
ROWS = ("fblock", "fblock64")
TOE_TABLES = ("occ1_flat", "tk1_flat")
# (index, tables dropped from it, the step's route (a rank policy or the
# rows), the per-step toehold's table (None: kval))
CASES = {"nodense": ("nodense", (), "runs", "ltk"), "iupac": ("iupac", (), "dense", None),
         "raw13": ("raw13", (), "occ1", "tk1"),
         "raw13_dense": ("raw13", TOE_TABLES, "dense", "ltk"),
         "raw6": ("raw6", (), "fblock64", "tk1"), "raw6_ltk": ("raw6", TOE_TABLES, "fblock64", "ltk"),
         "raw6_occ1": ("raw6", ROWS, "occ1", "tk1")}
# the random text's case, for the records alone
EDGE_CASES = dict(CASES, random=("random", (), "runs", "ltk"))
# (mode, options): greedy from the ftab and from the full range at small
# capacities, lmem, and sample at min_length 19 (rbt_locs) and 0
CONFIGS = {
    "greedy_ftab": ("greedy", dict(max_seeds=2, max_k=2, max_range=40, values=False)),
    "greedy_full": ("greedy", dict(use_ftab=False, max_seeds=3, max_k=4, max_range=200)),
    "lmem": ("lmem", dict(max_range=200, max_k=4)),
    "sample": ("sample", dict(min_length=19, max_seeds=4)),
    "sample_min0": ("sample", dict(min_length=0, max_seeds=2)),
}


# ---------------------------------------------------------------------------
# the fixtures

def _with_markers(raw, full):
    """A raw build with the marker tables of the index it was written from
    (the same BWT: the same marker rows)."""
    return dataclasses.replace(raw, ma_row=full.ma_row, ma_val=full.ma_val,
                               ma_start1=full.ma_start1, ma_wsize=full.ma_wsize)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """{name: (RbtIndex, text, reads)}: the in-repo panel built --no-dense
    (ftab k = 6); the panel of 13 codes (bwt4/occ_blk and kval, ftab k = 6);
    the raw builds (ftab k = 4, no kval, the markers of the index written)
    of that panel (occ1 + tk1, no rows) and of the 6-code panel built with
    its rows (fused rows, occ1 + tk1); and a random text of one document
    built --no-dense (no markers: its prefixes take the toehold to 0 and
    wrap it)."""
    d = tmp_path_factory.mktemp("torch_seed_tables")
    rng = np.random.default_rng(17)
    out = {}
    for name, iupac in (("nodense", False), ("iupac", True)):
        (d / name).mkdir()
        inp = write_inputs(d / name, iupac=iupac)
        panel = TP.build_panel(inp["fa"], inp["vcf"])
        reads = [s for _, s, _ in read_seqs(inp["fq"])] + _text_reads(panel.text, rng, 40, 100)
        idx = TB.build_index_from_panel(panel, ftab_k=6, dense=iupac)
        full = idx if iupac else TB.build_index_from_panel(panel, ftab_k=6)
        prefix = str(d / name / "raw")
        TRAW.write_raw(full, prefix)
        raw = _with_markers(TRAW.build_index_from_raw(prefix, ftab_k=4), full)
        out[name] = (idx, panel.text, reads)
        out["raw13" if iupac else "raw6"] = (raw, panel.text, reads)
    text = np.concatenate([rng.choice(ACGT, size=1500), np.array([1], np.uint8)])
    out["random"] = (TB.build_index(text, dense=False, ftab_k=4), text,
                     _text_reads(text, rng, 60, 100))
    return out


def _pair(built, case):
    """(JAX DeviceIndex, port TorchIndex on the CPU, RbtIndex, text, reads)
    of `case` with its tables dropped from both; the TorchIndex also holds
    the tables a load on the card builds for the kernels
    (with_card_tables)."""
    src, drop, _, _ = EDGE_CASES[case]
    idx, text, reads = built[src]
    dx = DeviceIndex.from_index(idx)
    dx = DeviceIndex({k: v for k, v in dx.arrays.items() if k not in drop}, dx.n, dx.R, dx.A,
                     dx.ma_wsize, dx.ftab_k, dx.acgt_codes)
    tx = TorchIndex.from_index(idx, "cpu")
    tx = dataclasses.replace(tx, arrays={k: v for k, v in tx.arrays.items() if k not in drop})
    return dx, tx.with_card_tables(), idx, text, reads


def test_fixtures_have_the_tables_each_case_names(built):
    for case, (_, _, route, toe) in CASES.items():
        tx = _pair(built, case)[1]
        assert (cuda_lf.row_layout(tx) or cuda_lf.table_policy(tx)) == route, case
        assert tx.has_ftab and "ma_val" in tx.arrays, case
        assert ("kval" in tx.arrays) == (toe is None), case
        if toe:
            assert cuda_lf.toehold_route(tx) == toe, case


def _lanes_of(idx, text, reads, mode, L):
    """The [B, L] codes and lengths of `mode`: the reads and the edge lanes,
    or for lmem every prefix of a few of them (lmem_expand)."""
    if mode == "lmem":
        reads = TS.lmem_expand(reads[:4] + reads[-8:-2])[0]
    return _lanes(idx, text, reads, L)


# ---------------------------------------------------------------------------
# the numpy model of the kernel

def directory_runs(t, x):
    """The run of each position of x as the run-space step finds it: x +
    1's bucket of the directory t["rs_off"] (shift t["shift"]), then at most
    t["iters"] halvings of the run starts in it (lf_tables.cuh run_of, lane
    by lane in test_torch_lf_tables.run_of)."""
    rs, off = np.asarray(t["run_start"], np.int64), np.asarray(t["rs_off"], np.int64)
    q = x + 1
    b = np.minimum(q >> t["shift"], off.shape[0] - 2)
    lo, hi = off[b], off[b + 1]
    for _ in range(t["iters"]):
        live = lo < hi
        mid = (lo + hi) >> 1
        below = live & (rs[np.minimum(mid, rs.shape[0] - 1)] < q)
        lo = np.where(below, mid + 1, lo)
        hi = np.where(live & ~below, mid, hi)
    assert (lo == hi).all()
    return lo - 1


class DenseRanks:
    """rank(i, c) = ranks[i, c] as the seeding kernel's dense step reads it
    (test_torch_lf_tables.DenseStep: i's block split over the lane's
    threads, each counting its symbols below the offset, the shares summed,
    plus the checkpoint); a step asks for one end's rank and then the
    other's, so the block fetched for the first serves the second where
    both lie in it (one fetch), and is then let go.  At i = n the code's
    total count."""

    def __init__(self, step):
        self.step, self.held = step, None

    def __getitem__(self, key):
        i, c = (int(x) for x in key)
        st = self.step
        if i >= st.n:
            return int(st.F[c + 1] - st.F[c])
        blk = i >> 7
        if self.held is not None and self.held[0] == blk:
            st.bump("one_fetch")
            block, self.held = self.held[1], None
        else:
            block = st.fetch(blk)
            self.held = (blk, block)
        return int(st.occ[c * st.nb + blk]) + sum(st.shares(block, c, i & 127))


def table_ranks(policy, t, F, A, n, R, bump=lambda key: None):
    """([n + 1, A] rank(i, c), [n] BWT symbols) as the tables kernel's step
    reads them from the `policy` tables t (numpy: occ; run_start and
    run_head with the directory rs_off and its shift and iters, or the run
    records rec where the index has them (runs); bwt4 (dense), whose ranks
    DenseRanks computes as the dense step does, `bump` counting its
    edges); at i = n the code's total count."""
    F = np.asarray(F, np.int64)
    i = np.arange(n)
    total = (F[1:A + 1] - F[:A])[None]
    if policy == "occ1":
        rk = np.asarray(t["occ"], np.int64).reshape(A, n + 1).T
        return rk, np.argmax(rk[1:] - rk[:-1], axis=1)
    if policy == "dense":
        return DenseRanks(DenseStep(t["bwt4"], t["occ"], F, n, bump)), \
            _nibbles(t["bwt4"]).reshape(-1)[:n]
    r = directory_runs(t, i)
    if "rec" in t:
        rec = np.asarray(t["rec"], np.int64).reshape(R, 8)[r]
        rs, head, occ = rec[:, 0], rec[:, 1], rec[:, 2:2 + A]
    else:
        rs = np.asarray(t["run_start"], np.int64)[r]
        head = np.asarray(t["run_head"], np.int64)[r]
        occ = np.asarray(t["occ"], np.int64).reshape(A, R)[:, r].T
    rk = occ + (head[:, None] == np.arange(A)) * (i - rs)[:, None]
    return np.vstack([rk, total]), head


def toehold_table(t, n, R):
    """The resolve's table lookup of the last non-trivial step (code c,
    pre-step hi): tk1[c, hi], or ltk at hi's run (ops/rank.py
    lf_step_w_loc's r_hi) found through the directory over run_start
    (test_torch_toehold.resolve_run)."""
    def table(c, hi):
        if "tk1" in t:
            return int(t["tk1"][c * n + hi])
        return int(t["ltk"][c * R + resolve_run(t, n, hi)])
    return table


def sample_toe_model(rk, sym, F, A, n, q, lens, min_length, S, table, k0, events=None):
    """The sampled machine's TOE instance, lane by lane: {slo, shi, sqs,
    sqe, ssamp [S, B], ns [B]} int32.  The current run's (tc, thi, triv)
    and its copy after every successful step; a seed resolves the copy (-1
    before any successful step).  The reference's per-step recurrence
    (lf_step_w_loc's nk) rides beside it and must agree."""
    ev = events if events is not None else {}
    F = [int(x) for x in F]
    B, L = q.shape

    def bump(key):
        ev[key] = ev.get(key, 0) + 1

    def resolve(tc, thi, triv):
        return ((k0 if tc < 0 else table(tc, thi)) - triv) % n

    out = {key: np.zeros((S, B), np.int64) for key in ("slo", "shi", "sqs", "sqe", "ssamp")}
    out["slo"][:] = 1
    out["ns"] = np.zeros(B, np.int64)
    for b in range(B):
        m = int(lens[b])
        lo, hi, plo, phi, ei, ns = 0, n - 1, 0, n - 1, m, 0
        tc, thi, triv, copy, run_ok = -1, 0, 0, None, False
        kstep, pk = k0, -1

        def seed(qs, qe):
            nonlocal ns
            if ns < S:
                got = -1 if copy is None else resolve(*copy)
                assert got == pk, (b, got, pk)
                if copy is None:
                    bump("sample_minus_one")
                elif not run_ok:
                    bump("sample_stale")
                for key, v in zip(("slo", "shi", "sqs", "sqe", "ssamp"),
                                  (plo, phi, qs, qe, got)):
                    out[key][ns, b] = v
            else:
                bump("s_overflow")
            ns += 1

        for j in range(min(m, L)):
            c = int(q[b, L - 1 - j])
            ok = 0 <= c < A and rk[hi + 1, c] > rk[lo, c]
            if ok:
                cb, ce = int(rk[lo, c]), int(rk[hi + 1, c])
                if sym[hi] == c:
                    bump("trivial")
                    if kstep == 0:
                        bump("k_wraps")
                    triv, kstep = triv + 1, (kstep - 1) % n
                else:
                    bump("nontrivial")
                    tc, thi, triv = c, hi, 0
                    kstep = table(c, hi)
                copy, pk, run_ok = (tc, thi, triv), kstep, True
                lo = plo = F[c] + cb
                hi = phi = lo + ce - cb - 1
            else:
                bump("fail_first_step" if j == 0 else "restart")
                if ei - (m - j) >= min_length:
                    seed(m - j, ei)
                lo, hi, plo, phi, ei = 0, n - 1, 0, n - 1, m - j - 1
                tc, triv, kstep, run_ok = -1, 0, k0, False
        if ei >= min_length:
            seed(0, ei)
        out["ns"][b] = ns
    return {key: v.astype(np.int32) for key, v in out.items()}


def _acgt(acgt):
    codes = [(acgt >> (8 * i)) & 0xFF for i in range(4)]
    return [x - 256 if x == 0xFF else x for x in codes]


def _toe_tables(n, A, R, tk1, tk1_b, ltk, ltk_b, rs, rs_b, sl, sl_b, directory):
    """The resolve's tables at the addresses and widths given: tk1, or ltk,
    run_start and the directory (rs_off, its width, n_off, shift, iters),
    and samples_last."""
    t = {"samples_last": _ints(sl, R, sl_b)}
    if tk1:
        t["tk1"] = _ints(tk1, A * n, tk1_b)
    else:
        off, off_b, n_off, shift, iters = directory
        assert n_off == (n >> shift) + 2
        t.update(ltk=_ints(ltk, A * R, ltk_b), run_start=_ints(rs, R, rs_b),
                 rs_off=_ints(off, n_off, off_b), shift=shift, iters=iters)
    return t


def _run_model(name, rk, sym, Fn, A, n, R, q, lens, k, ftab, acgt, wsize, max_range,
               min_length, W, S, toe, events):
    if toe is None:
        return machine_model(name, rk, Fn, A, n, q, lens, k=k, ftab=ftab, acgt=_acgt(acgt),
                             wsize=wsize, max_range=max_range, min_length=min_length, W=W, S=S,
                             lane_bytes=4, events=events)
    k0 = (int(toe["samples_last"][R - 1]) + 1) % n
    return sample_toe_model(rk, sym, Fn, A, n, q, lens, min_length, S, toehold_table(toe, n, R),
                            k0, events)


def _write(got, lane_b, outs):
    for key, v in got.items():
        _ints(outs[key], v.size, lane_b)[:] = v.reshape(-1)


def _model_libs(tx, calls, rc, events=None):
    """rbt_seed_machine_tables as the model over the tables at the
    addresses and widths the wrapper passes, and rbt_seed_machine: with
    ssamp the TOE instance over the fused rows, else test_torch_seed_kernel's
    model; each returns rc, writing nothing when rc != 0."""
    rows_lib = _model_lib(tx, calls, rc, events) if cuda_lf.row_layout(tx) else None

    def bump(key):
        if events is not None:
            events[key] = events.get(key, 0) + 1

    def tables(mode, policy, occ, occ_b, rs, rs_b, rh, rh_b, off, off_b, n_off, shift,
               iters, rec, bwt4, nb, R, F, A, n, q, lengths, B, L, ftab, ftab_b, k, acgt, wsize,
               max_range, min_length, W, rlo, rhi, rseed, nrec, S, slo, shi, sqs, sqe, ns, tk1,
               tk1_b, ltk, ltk_b, sl, sl_b, ssamp, threads, stage, stream):
        name = {0: "greedy", 1: "lmem", 2: "sample"}[mode]
        pol = {0: "runs", 1: "dense", 2: "occ1"}[policy]
        calls.append(dict(entry="tables", mode=name, policy=pol, A=A,
                          n=n, R=R, B=B, L=L, k=k, ftab=(ftab, ftab_b),
                          widths=(occ_b, rs_b, rh_b, tk1_b, ltk_b, sl_b),
                          tables=(occ, rs, rh, bwt4, nb), directory=(off, off_b, n_off, shift,
                                                                      iters), rec=rec,
                          toe=(tk1, ltk, sl, ssamp), wsize=wsize, max_range=max_range,
                          min_length=min_length, W=W, S=S, threads=threads, stage=stage,
                          stream=stream))
        if rc or B == 0:
            return rc
        size = {"runs": A * R, "dense": A * nb, "occ1": A * (n + 1)}[pol]
        t = {"occ": _ints(occ, size, occ_b)}
        if pol == "runs":
            t["run_start"], t["run_head"] = _ints(rs, R, rs_b), _ints(rh, R, rh_b)
            t["rs_off"], t["shift"], t["iters"] = _ints(off, n_off, off_b), shift, iters
            if rec:
                t["rec"] = _ints(rec, 8 * R, 4)
        else:
            # the directory only for the per-step toehold over ltk
            assert rec is None and (off is not None) == (ssamp is not None and not tk1)
        if pol == "dense":
            t["bwt4"] = _ints(bwt4, 16 * nb, 4)
        Fn = _ints(F, A + 1, 4)
        rk, sym = table_ranks(pol, t, Fn, A, n, R, bump)
        toe = _toe_tables(n, A, R, tk1, tk1_b, ltk, ltk_b, rs, rs_b, sl, sl_b,
                          (off, off_b, n_off, shift, iters)) if ssamp else None
        got = _run_model(name, rk, sym, Fn, A, n, R, _ints(q, B * L, 4).reshape(B, L),
                         _ints(lengths, B, 4), k,
                         _ints(ftab, 2 * 4 ** k, ftab_b).reshape(-1, 2) if k else None, acgt,
                         wsize, max_range, min_length, W, S, toe, events)
        _write(got, 4, {"wlo": rlo, "whi": rhi, "wseed": rseed, "nrec": nrec, "slo": slo,
                        "shi": shi, "sqs": sqs, "sqe": sqe, "ns": ns, "elo": slo, "ehi": shi,
                        "eqs": sqs, "ssamp": ssamp})
        return rc

    def rows(mode, fb, syms, F, base, blk_mul, blk_shift, A, n, lane_b, q, lengths, B, L, ftab,
             ftab_b, k,
             acgt, wsize, max_range, min_length, W, rlo, rhi, rseed, nrec, S, slo, shi, sqs, sqe,
             ns, hi_rec, tk1, tk1_b, ltk, ltk_b, rs, rs_b, off, off_b, n_off, shift, iters, sl,
             sl_b, R, ssamp, threads, stage, stream):
        if ssamp is None:
            args = locals().copy()
            return rows_lib.rbt_seed_machine(*(args[a] for a in (
                "mode", "fb", "syms", "F", "base", "blk_mul", "blk_shift", "A", "n", "lane_b",
                "q", "lengths",
                "B", "L", "ftab", "ftab_b", "k", "acgt", "wsize", "max_range", "min_length", "W",
                "rlo", "rhi", "rseed", "nrec", "S", "slo", "shi", "sqs", "sqe", "ns", "hi_rec",
                "tk1", "tk1_b", "ltk", "ltk_b", "rs", "rs_b", "off", "off_b", "n_off", "shift",
                "iters", "sl", "sl_b", "R", "ssamp",
                "threads", "stage", "stream")))
        calls.append(dict(entry="rows", mode=mode, syms=syms, lane=lane_b, B=B, L=L, k=k,
                          widths=(tk1_b, ltk_b, rs_b, sl_b), toe=(tk1, ltk, rs, sl, ssamp),
                          directory=(off, off_b, n_off, shift, iters),
                          hi_rec=hi_rec, threads=threads, stage=stage))
        if rc or B == 0:
            return rc
        key = cuda_lf.row_layout(tx)
        rows = cuda_lf.rows_of(tx, key)
        fbn = _ints(fb, rows.numel(), 4).reshape(rows.shape)
        Fn = _ints(F, A + 1, 4)
        rk = rank_table(fbn, syms, Fn, A, n)
        sym = _symbols(fbn, syms)[0].reshape(-1)[:n]
        toe = _toe_tables(n, A, R, tk1, tk1_b, ltk, ltk_b, rs, rs_b, sl, sl_b,
                          (off, off_b, n_off, shift, iters))
        got = _run_model("sample", rk, sym, Fn, A, n, R, _ints(q, B * L, 4).reshape(B, L),
                         _ints(lengths, B, 4), k, None, acgt, wsize, max_range, min_length, W, S,
                         toe, events)
        _write(got, 4, {"slo": slo, "shi": shi, "sqs": sqs, "sqe": sqe, "ns": ns,
                        "ssamp": ssamp})
        return rc

    return SimpleNamespace(rbt_seed_machine=rows, rbt_seed_machine_tables=tables,
                           rbt_cuda_error_string=lambda code: b"invalid argument")


@pytest.fixture
def fake(monkeypatch):
    """Installs the model behind the C entries (install(tx, events)), with
    the counters at 0; `kernel()` then makes the engines take the kernel
    route on CPU tensors."""
    rec = {"calls": [], "rc": 0}

    def install(tx, events=None):
        monkeypatch.setattr(cuda_seeds, "_LIB", _model_libs(tx, rec["calls"], rec["rc"], events))

    def kernel():
        monkeypatch.setattr(TS, "_machine", lambda q, ln, plain, launch:
                            launch(q.to(torch.int32), ln.to(torch.int32)))

    monkeypatch.setattr(cuda_seeds, "_raw_stream", lambda dev: 1000 + dev)
    monkeypatch.setattr(cuda_seeds, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(cuda_seeds.torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(cuda_seeds, "LAUNCHES_SEED", dict(ZERO))
    rec["install"], rec["kernel"] = install, kernel
    return rec


# ---------------------------------------------------------------------------
# the engines against JAX: the plain twins, and the model through the launch

def _run(mode, jax_side, tx, qc, lens, opt):
    if jax_side:
        q, ln, mod = jnp.asarray(qc), jnp.asarray(lens), JS
    else:
        q, ln, mod = torch.from_numpy(qc), torch.from_numpy(lens), TS
    if mode == "greedy":
        return mod.markers_greedy_seeding(tx, q, ln, wsize=WSIZE, **opt)
    if mode == "lmem":
        return mod.markers_lmem_lanes(tx, q, ln, wsize=WSIZE, **opt)
    return mod.seeds_greedy_w_sample(tx, q, ln, **opt)


def _route_of(tx, mode):
    """The LAUNCHES_SEED key of `mode` on tx."""
    name = "sample_toe" if mode == "sample" and "kval" not in tx.arrays else mode
    policy = cuda_lf.table_policy(tx) if cuda_lf.row_layout(tx) is None else None
    return f"{name}_{policy}" if policy else name


# the engine cases: every policy and toehold table once (raw6_occ1 repeats
# raw13's occ1 + tk1 over another alphabet; the records tests take it)
ENGINE_CASES = [c for c in CASES if c != "raw6_occ1"]
POLICY_CASES = ("nodense", "iupac", "raw13")  # runs, dense, occ1, each with its ftab


def _held_to_jax(case, config, L):
    """Whether the twin of (case, config, L) is also run against JAX: the
    sampled machine at min_length 0 at every width and at 19 at L = 31 on
    every case; greedy and lmem once a policy (from the ftab and L-MEM at L
    = 31, from the full range at L = 100).  The other runs hold the model to
    the twin alone: the twins equal JAX over each backend in
    test_torch_backends.py, and over fused rows in test_torch_seed_kernel.py,
    and every JAX compile costs seconds."""
    if config == "sample_min0":
        return True
    if config == "sample":
        return L == 31
    if case not in POLICY_CASES:
        return False
    return L == (100 if config == "greedy_full" else 31)


@pytest.mark.parametrize("L", WIDTHS)
@pytest.mark.parametrize("case", ENGINE_CASES)
def test_model_and_twins_match_jax(built, fake, case, L):
    """Each config (greedy with the ftab and without, lmem, sample at
    min_length 19 and 0): the engine with the model behind the C entry ==
    the engine with its plain twin, every output buffer and dtype, and both
    == JAX where _held_to_jax says; one launch a call, on the case's
    route."""
    dx, tx, idx, text, reads = _pair(built, case)
    fake["install"](tx)
    fake["kernel"]()
    jax_runs = 0
    for config, (mode, opt) in CONFIGS.items():
        qc, lens = _lanes_of(idx, text, reads, mode, L)
        real = TS._machine
        TS._machine = lambda q, ln, plain, launch: plain(q, ln)
        try:
            want = _run(mode, False, tx, qc, lens, opt)
        finally:
            TS._machine = real
        if _held_to_jax(case, config, L):
            _eq(want, _run(mode, True, dx, qc, lens, opt), f"{config} plain")
            jax_runs += 1
        cuda_seeds.LAUNCHES_SEED.update(ZERO)
        _eq(_run(mode, False, tx, qc, lens, opt), [w.numpy() for w in want], f"{config} model")
        assert cuda_seeds.LAUNCHES_SEED == dict(ZERO, **{_route_of(tx, mode): 1}), config
    assert jax_runs >= 1


# ---------------------------------------------------------------------------
# the records: the model against the twins, at capacities that overflow

def _records(tx, mode, qc, lens, opt):
    """(twin's records, launch_machine's) of `mode` on tx, on its device."""
    q, ln = torch.from_numpy(qc).to(tx.device), torch.from_numpy(lens).to(tx.device)
    mr = min(opt.get("max_range", 1 << 62), torch.iinfo(tx.idx_dtype).max)
    if mode == "greedy":
        want = TS.markers_greedy_records_plain(tx, q, ln, WSIZE, mr, opt["S"], opt["k"],
                                               opt["W"])
        got = cuda_seeds.launch_machine(tx, "greedy", q, ln, k=opt["k"], wsize=WSIZE,
                                        max_range=mr, W=opt["W"], S=opt["S"])
    elif mode == "lmem":
        want = TS.markers_lmem_records_plain(tx, q, ln, WSIZE, mr, opt["k"], opt["W"])
        got = cuda_seeds.launch_machine(tx, "lmem", q, ln, k=opt["k"], wsize=WSIZE,
                                        max_range=mr, W=opt["W"], S=1)
    else:
        toe = "kval" not in tx.arrays
        want = TS.seeds_sample_records_plain(tx, q, ln, opt["min_length"], opt["S"],
                                             "per_step" if toe else "kval")
        got = cuda_seeds.launch_machine(tx, "sample", q, ln, min_length=opt["min_length"],
                                        S=opt["S"])
    return want, got


def _same_records(want, got):
    assert sorted(want) == sorted(got)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(), err_msg=key)


RECORD_CASES = {
    "greedy_ftab_w2": ("greedy", dict(k="ftab", W=2, S=2, max_range=30)),
    "greedy_full_w3": ("greedy", dict(k=0, W=3, S=1)),
    "lmem_w1": ("lmem", dict(k="ftab", W=1)),
    "lmem_w2_k0": ("lmem", dict(k=0, W=2, max_range=30)),
    "sample_s1": ("sample", dict(min_length=0, S=1)),
    "sample_s3": ("sample", dict(min_length=5, S=3)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_model_records_equal_the_twins_at_overflow(built, fake, case):
    """The launch path with the model behind its C entries writes the
    twins' record tables (the seeds' per-step toeholds included), buffer
    for buffer, with the record and seed capacities overflowing; the
    greedy machine from the ftab meets a replay."""
    _, tx, idx, text, reads = _pair(built, case)
    qc, lens = _lanes(idx, text, reads, 100)
    events = {}
    fake["install"](tx, events)
    for mode, opt in RECORD_CASES.values():
        opt = dict(opt, k=tx.ftab_k if opt.get("k") == "ftab" else opt.get("k", 0))
        _same_records(*_records(tx, mode, qc, lens, opt))
    assert events.get("w_overflow") and events.get("s_overflow")
    assert events.get("restart_replay")


def test_model_reaches_every_edge(built, fake):
    """Over every case at L = 31 and 100 the lanes reach every edge the
    model counts (the greedy replay, the held replay, the restart to the
    full range, a failure at the first step, record and seed overflow, a
    probe cut by max_range, an empty lane; for the per-step toehold trivial
    and non-trivial steps, k wrapping at 0, a restart, the stale toehold
    of a degenerate seed and the -1 of a seed before any good step; over
    the dense tables one fetch serving both ranks of a step), and the model
    still writes the twins' records."""
    events = {}
    for case in EDGE_CASES:
        _, tx, idx, text, reads = _pair(built, case)
        fake["install"](tx, events)
        for L in (31, 100):
            qc, lens = _lanes(idx, text, reads, L)
            for mode, opt in (("greedy", dict(k=tx.ftab_k, W=2, S=2, max_range=30)),
                              ("sample", dict(min_length=0, S=2))):
                _same_records(*_records(tx, mode, qc, lens, opt))
    want = ("restart_replay", "replay_held", "restart_to_full", "fail_first_step",
            "w_overflow", "s_overflow", "max_range_cut", "length_0", "trivial", "nontrivial",
            "k_wraps", "restart", "sample_stale", "sample_minus_one", "hi1_is_n", "one_fetch")
    assert all(events.get(e, 0) > 0 for e in want), [e for e in want if e not in events]


# ---------------------------------------------------------------------------
# the launch path

@pytest.mark.parametrize("case", ["nodense", "iupac", "raw13", "raw13_dense", "raw6_ltk"])
def test_launch_passes_the_tables_and_the_toehold(built, fake, case):
    """What the wrapper hands the C entries: the tables entry with the
    case's policy, its tables at their widths, int32 F and lanes, the
    ftab for greedy, cuda_lf.lane_threads threads a lane (two over the
    run-space tables, with the directory and the run records); the rows
    entry with the toehold's tables (tk1, or ltk with run_start, and
    samples_last) and ssamp for the per-step toehold, two threads a lane."""
    _, tx, idx, text, reads = _pair(built, case)
    qc, lens = _lanes(idx, text, reads, 100)
    q, ln = torch.from_numpy(qc), torch.from_numpy(lens)
    fake["install"](tx)
    rows = cuda_lf.row_layout(tx) is not None
    toe = "kval" not in tx.arrays
    if not rows:
        out = cuda_seeds.launch_machine(tx, "greedy", q, ln, k=tx.ftab_k, wsize=WSIZE,
                                        max_range=100, W=24, S=8)
        c = fake["calls"][-1]
        policy = cuda_lf.table_policy(tx)
        assert c["entry"] == "tables" and c["policy"] == policy and c["k"] == tx.ftab_k
        assert c["ftab"][1] == tx.arrays["ftab"].element_size()
        occ = {"runs": "occ_flat", "dense": "occ_blk_flat", "occ1": "occ1_flat"}[policy]
        assert c["tables"][0] == tx.arrays[occ].data_ptr()
        assert c["widths"][0] == tx.arrays[occ].element_size()
        assert (c["tables"][3] is not None) == (policy == "dense")
        group = cuda_lf.lane_threads(policy)
        assert (c["threads"], bool(c["stage"])) == cuda_lf.launch_plan(*qc.shape, 132,
                                                                        group=group)
        assert c["toe"] == (None, None, None, None) and c["stream"] == 1000
        assert (c["rec"] is not None) == (policy == "runs")
        if policy == "runs":
            assert c["rec"] == tx.arrays["run_rec"].data_ptr()
        if policy == "runs":
            assert c["directory"][0] == tx.arrays["rs_off"].data_ptr()
            assert c["directory"][2:] == ((tx.n >> tx.rs_bs[0]) + 2, *tx.rs_bs)
        else:
            assert c["directory"] == (None, 0, 0, 0, 0)
        assert all(t.dtype == torch.int32 for t in out.values())
    out = cuda_seeds.launch_machine(tx, "sample", q, ln, min_length=19, S=8)
    c = fake["calls"][-1]
    assert c["entry"] == ("rows" if rows else "tables")
    assert ("ssamp" in out) == toe
    if toe:
        route = cuda_lf.toehold_route(tx)
        tk1, ltk = c["toe"][0], c["toe"][1]
        assert (tk1 is not None) == (route == "tk1") and (ltk is not None) == (route == "ltk")
        off = tx.arrays["rs_off"] if route == "ltk" else None  # the resolve's directory
        assert c["directory"] == ((off.data_ptr(), off.element_size(), off.numel(), *tx.rs_bs)
                                  if off is not None else (None, 0, 0, 0, 0))
        if rows:
            assert (c["threads"], bool(c["stage"])) == cuda_lf.launch_plan(*qc.shape, 132)
    want = TS.seeds_sample_records_plain(tx, q, ln, 19, 8, "per_step" if toe else "kval")
    _same_records(want, out)
    assert sum(cuda_seeds.LAUNCHES_SEED.values()) == (1 if rows else 2)


@pytest.mark.parametrize("records", [True, False], ids=["records", "no_records"])
def test_run_designs_write_the_twins_records(built, fake, records):
    """Every machine over the run-space tables, through the run records and
    without them (the step of an index of more than 6 codes), writes the
    twins' records, at capacities that overflow; two threads a lane."""
    _, tx, idx, text, reads = _pair(built, "nodense")
    assert "run_rec" in tx.arrays
    if not records:
        tx = dataclasses.replace(tx, arrays={k: v for k, v in tx.arrays.items() if k != "run_rec"})
    qc, lens = _lanes(idx, text, reads, 100)
    q, ln = torch.from_numpy(qc), torch.from_numpy(lens)
    fake["install"](tx)
    for mode, opt in RECORD_CASES.values():
        opt = dict(opt, k=tx.ftab_k if opt.get("k") == "ftab" else opt.get("k", 0))
        want = _records(tx, mode, qc, lens, opt)[0]
        kw = (dict(min_length=opt["min_length"], S=opt["S"]) if mode == "sample" else
              dict(k=opt["k"], wsize=WSIZE, W=opt["W"], S=1 if mode == "lmem" else opt["S"],
                   max_range=min(opt.get("max_range", 1 << 62), (1 << 31) - 1)))
        _same_records(want, cuda_seeds.launch_machine(tx, mode, q, ln, **kw))
        c = fake["calls"][-1]
        assert (c["rec"] is not None) == records
        assert c["threads"] == cuda_lf.launch_plan(*qc.shape, 132, group=2)[0]


def test_launch_on_a_view_and_no_lanes(built, fake):
    """A view one row into a batch is passed as it is; no lanes launch
    nothing and count nothing."""
    _, tx, idx, text, reads = _pair(built, "nodense")
    qc, lens = _lanes(idx, text, reads, 31)
    q, ln = torch.from_numpy(qc)[1:], torch.from_numpy(lens)[1:]
    fake["install"](tx)
    got = cuda_seeds.launch_machine(tx, "sample", q, ln, min_length=0, S=3)
    _same_records(TS.seeds_sample_records_plain(tx, q, ln, 0, 3, "per_step"), got)
    out = cuda_seeds.launch_machine(tx, "sample", q[:0], ln[:0], min_length=0, S=3)
    assert out["ssamp"].shape == (3, 0)
    assert cuda_seeds.LAUNCHES_SEED == dict(ZERO, sample_toe_runs=1) and len(fake["calls"]) == 2


def test_refused_launch_raises_and_counts_nothing(built, fake):
    _, tx, idx, text, reads = _pair(built, "raw13")
    fake["rc"] = 1
    fake["install"](tx)
    qc, lens = _lanes(idx, text, reads, 31)
    with pytest.raises(RuntimeError, match="seeding kernel launch failed: invalid argument"):
        cuda_seeds.launch_machine(tx, "sample", torch.from_numpy(qc), torch.from_numpy(lens),
                                  min_length=19, S=8)
    assert cuda_seeds.LAUNCHES_SEED == ZERO and len(fake["calls"]) == 1


@pytest.mark.parametrize("fault,error,match", [
    ("no samples_last", ValueError, "needs samples_last"),
    ("no run_head", ValueError, "needs run_head"),
    ("int64 lanes", TypeError, "F must be int32"),
    ("int64 qcodes", TypeError, "qcodes must be int32"),
    ("alphabet", ValueError, "the dense tables take 1..16"),
    ("other device", ValueError, "is on meta"),
    ("no rs_off", ValueError, "needs rs_off"),
    ("int64 run records", TypeError, "run_rec must be int32"),
    ("misaligned run records", ValueError, "or not 32-byte aligned"),
])
def test_launch_refuses(built, fake, fault, error, match):
    case = {"no run_head": "nodense", "alphabet": "iupac", "no rs_off": "nodense",
            "int64 run records": "nodense", "misaligned run records": "nodense"}
    _, tx, idx, text, reads = _pair(built, case.get(fault, "raw13"))
    fake["install"](tx)
    qc, lens = _lanes(idx, text, reads, 31)
    q, ln = torch.from_numpy(qc), torch.from_numpy(lens)
    arrays = dict(tx.arrays)
    mode, kw = "sample", dict(min_length=19, S=4)
    t = tx
    if fault == "no samples_last":
        arrays.pop("samples_last")
    elif fault == "no run_head":
        arrays.pop("run_head")
    elif fault == "int64 lanes":
        arrays["F"] = arrays["F"].long()
    elif fault == "int64 qcodes":
        q = q.long()
    elif fault == "alphabet":
        t = dataclasses.replace(tx, A=17)
    elif fault == "other device":
        arrays["samples_last"] = arrays["samples_last"].to("meta")
    elif fault == "no rs_off":
        arrays.pop("rs_off")
    elif fault == "int64 run records":
        arrays["run_rec"] = arrays["run_rec"].long()
    elif fault == "misaligned run records":
        arrays["run_rec"] = torch.cat([arrays["run_rec"][:1], arrays["run_rec"]])[1:]
    if t is tx:
        t = dataclasses.replace(tx, arrays=arrays)
    with pytest.raises(error, match=match):
        cuda_seeds.launch_machine(t, mode, q, ln, **kw)
    assert fake["calls"] == [] and cuda_seeds.LAUNCHES_SEED == ZERO


# (case, mode, row layout shown to the wrapper or None, the toehold carried)
TOEHOLD_CASES = {"greedy without kval": ("raw13", "greedy", None, False),
                 "sample without kval": ("raw13", "sample", None, True),
                 "sample over rows without kval": ("raw6", "sample", None, True),
                 "sample with kval": ("iupac", "sample", None, False),
                 "sample over two-level rows": ("raw6", "sample", "fb2_64", False)}


@pytest.mark.parametrize("name", list(TOEHOLD_CASES))
def test_launch_carries_the_toehold_where_the_index_has_no_kval(built, fake, name):
    """The wrapper gives the sampled machine the per-step toehold (the
    toehold's tables and ssamp handed to the entry, ssamp returned) exactly
    on an index without kval whose rows are not two-level; greedy and lmem
    never carry it."""
    case, mode, layout, want = TOEHOLD_CASES[name]
    _, tx, idx, text, reads = _pair(built, case)
    if layout is not None:
        assert "kval" not in tx.arrays
        assert _with_layout(tx, layout, lambda: cuda_seeds.carries_toehold(tx, mode)) is want
        return
    assert cuda_seeds.carries_toehold(tx, mode) is want
    fake["install"](tx)
    qc, lens = _lanes(idx, text, reads, 31)
    kw = (dict(k=0, wsize=WSIZE, max_range=100, W=10, S=4) if mode == "greedy"
          else dict(min_length=19, S=4))
    out = cuda_seeds.launch_machine(tx, mode, torch.from_numpy(qc), torch.from_numpy(lens), **kw)
    assert ("ssamp" in out) is want
    assert (fake["calls"][-1]["toe"][-1] is not None) is want


def _with_layout(tx, key, fn):
    """fn() while cuda_lf.row_layout names `key` for tx."""
    real = cuda_lf.row_layout
    cuda_lf.row_layout = lambda t: key if t is tx else real(t)
    try:
        return fn()
    finally:
        cuda_lf.row_layout = real


# ---------------------------------------------------------------------------
# on the card

@pytest.mark.gpu
def test_cuda_seed_tables_match_plain(built):
    """The kernel == its plain twins on the card, every case and record
    config.  Runs only where jax and CUDA are both installed; chip_smoke.py
    (phase parity, seeds_parity) makes the same checks with torch alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the seeding kernel has no CPU mode)")
    for case in CASES:
        _, tx, idx, text, reads = _pair(built, case)
        tc = TorchIndex.from_arrays({k: v.numpy() for k, v in tx.arrays.items()}, n=tx.n,
                                    R=tx.R, A=tx.A, ma_wsize=tx.ma_wsize, ftab_k=tx.ftab_k,
                                    acgt_codes=tx.acgt_codes, device="cuda")
        for L in WIDTHS:
            qc, lens = _lanes(idx, text, reads, L)
            for mode, opt in RECORD_CASES.values():
                k = tx.ftab_k if opt.get("k") == "ftab" and L >= tx.ftab_k else 0
                want, got = _records(tc, mode, qc, lens, dict(opt, k=k))
                torch.cuda.synchronize()
                _same_records({k_: v.cpu() for k_, v in want.items()},
                              {k_: v.cpu() for k_, v in got.items()})
