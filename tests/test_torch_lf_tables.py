"""The search over the rank tables of an index without fused rows
(ops/cuda_lf.launch_tables, csrc/lf.cu lf_tables_kernel): the count search
of rbt_align count and -m and the per-step toehold search of -s, one
launch a batch, in three rank policies chosen in lf_step_auto's order
(occ1, dense, run-space).

A numpy model of the kernel's arithmetic (one lane at a time: the ftab
start, each policy's two ranks a step with the run-space search of hi + 1
confined to its window after lo's run, the trivial test from the policy's
own tables, the last non-trivial step carried with a count of the trivial
steps after it and resolved once from tk1 or ltk) equals the JAX package's
find_ranges and find_ranges_w_toehold buffer for buffer, and so does the
port's path on the CPU, on the small panel built --no-dense, on the panel of
13 codes (bwt4/occ_blk) and on that panel's raw build (occ1 + tk1; and
without them, the dense tables with ltk), at L = 1, 31 and 100, on batches
that reach every edge the model counts.  The launch path, with its C entry
replaced by that model reading the addresses and widths the wrapper passes,
equals the plain twins; refused launches raise and count nothing; the
routes follow the tables.  Every output is an integer, so every check is
exact."""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rowbowt_tpu.engine import count as JC
from rowbowt_tpu.engine.device import DeviceIndex
from rowbowt_tpu_torch.construct import build as TB
from rowbowt_tpu_torch.construct import panel as TP
from rowbowt_tpu_torch.construct import rawio as TRAW
from rowbowt_tpu_torch.engine import count as TC
from rowbowt_tpu_torch.engine import locate as TL
from rowbowt_tpu_torch.engine.device import TorchIndex
from rowbowt_tpu_torch.io.fastq import read_seqs
from rowbowt_tpu_torch.ops import cuda_lf
from test_torch_build import write_inputs
from test_torch_toehold import ACGT, _eq, _ints, _jax, _lanes, _text_reads

WIDTHS = (1, 31, 100)
# (index, tables dropped from it, rank policy): the count cases
COUNT_CASES = {"nodense": ("nodense", (), "runs"), "iupac": ("iupac", (), "dense"),
               "raw13": ("raw13", (), "occ1"),
               "raw13_dense": ("raw13", ("occ1_flat", "tk1_flat"), "dense")}
# the toehold cases (indexes without kval) and their toehold table
TOE_CASES = {"nodense": ("nodense", (), "runs", "ltk"), "random": ("random", (), "runs", "ltk"),
             "raw13": ("raw13", (), "occ1", "tk1"),
             "raw13_dense": ("raw13", ("occ1_flat", "tk1_flat"), "dense", "ltk")}
TABLE_KEYS = ("occ_flat", "run_start", "run_head", "occ_blk_flat", "occ1_flat", "tk1_flat",
              "ltk", "samples_last", "ftab")


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
    of case `name` with the tables `drop` taken from both."""
    idx, text, reads = cases[name]
    dx = DeviceIndex.from_index(idx)
    dx = DeviceIndex({k: v for k, v in dx.arrays.items() if k not in drop}, dx.n, dx.R, dx.A,
                     dx.ma_wsize, dx.ftab_k, dx.acgt_codes)
    tx = TorchIndex.from_index(idx, "cpu")
    tx = dataclasses.replace(tx, arrays={k: v for k, v in tx.arrays.items() if k not in drop})
    return dx, tx, idx, text, reads


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


def tables_model(policy, t, F, A, n, R, q, lens, ftab=None, k=0, acgt=(), toehold=False,
                 events=None):
    """(lo, hi) or with `toehold` (lo, hi, k) [B] as lf_tables_kernel
    computes them over the `policy` tables `t` (numpy: occ, and run_start
    and run_head (runs), bwt4 (dense); tk1 or ltk with run_start, and
    samples_last for the toehold).  `events`, a dict, counts the edges the
    lanes reached.  A per-step toehold (the JAX step's recurrence) rides
    beside the carried one and must agree."""
    ev = events if events is not None else {}
    F = np.asarray(F).astype(np.int64)
    sym = _nibbles(t["bwt4"]) if policy == "dense" else None

    def bump(key):
        ev[key] = ev.get(key, 0) + 1

    def run_search(x, r, last, start):
        end = last + 1
        while end - r > 1:
            mid = r + ((end - r) >> 1)
            v = int(t["run_start"][mid])
            if v <= x:
                r, start = mid, v
            else:
                end = mid
        return r, start

    def rank(i, c):
        if policy == "occ1":
            return int(t["occ"][c * (n + 1) + i])
        if i >= n:
            return int(F[c + 1] - F[c])
        blk = i >> 7
        nb = t["bwt4"].shape[0] // 16
        return int(t["occ"][c * nb + blk]) + int(np.count_nonzero(sym[blk, :i & 127] == c))

    def table(c, hi):
        if toehold and "tk1" in t:
            return int(t["tk1"][c * n + hi])
        x = min(hi + 1, n - 1)
        r = int(np.searchsorted(t["run_start"], x, side="right")) - 1
        if hi + 1 < n and t["run_start"][r] == hi + 1:
            r -= 1
        return int(t["ltk"][c * R + r])

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
                r0, s0 = run_search(lo, 0, R - 1, int(t["run_start"][0]))
                cb = int(t["occ"][c * R + r0]) + (lo - s0 if t["run_head"][r0] == c else 0)
                if i1 < n:
                    last = min(R - 1, r0 + (i1 - s0))
                    if last < R - 1:
                        bump("window_search")
                    r1, s1 = run_search(i1, r0, last, s0)
                    ce = int(t["occ"][c * R + r1]) + (i1 - s1 if t["run_head"][r1] == c else 0)
                    if s1 == i1:
                        bump("hi1_starts_run")
                    s = int(t["run_head"][r1 - 1 if s1 == i1 else r1])
                else:
                    ce = int(F[c + 1] - F[c])
                    s = int(t["run_head"][R - 1])
            else:
                cb, ce = rank(lo, c), rank(i1, c)
                if policy == "occ1":
                    s = c if ce - rank(hi, c) == 1 else -1
                else:
                    s = int(sym[hi >> 7, hi & 127])
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
    operand names."""
    policy = cuda_lf.table_policy(tx)
    t = {key: tx.arrays[name].numpy()
         for key, name in (("run_start", "run_start"), ("run_head", "run_head"),
                           ("samples_last", "samples_last"), ("ltk", "ltk"))
         if name in tx.arrays}
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
    counts (hi + 1 == n, hi + 1 starting a run, a run search in its window,
    absent codes, a failure at the first step and later, length-0 lanes,
    lanes started from the ftab, trivial and non-trivial steps, k == 0
    wrapping to n - 1, lanes without a non-trivial step) and still equal
    JAX."""
    events = {}
    for src, drop, _ in COUNT_CASES.values():
        dx, tx, idx, text, reads = _pair(cases, src, drop)
        qc, lens = _lanes(idx, text, reads, 100)
        _eq(_model_on(tx, qc, lens, events=events), _jax_count(dx, qc, lens, True))
    for src, drop, _, _ in TOE_CASES.values():
        dx, tx, idx, text, reads = _pair(cases, src, drop + ("kval",))
        qc, lens = _lanes(idx, text, reads, 100)
        _eq(_model_on(tx, qc, lens, toehold=True, events=events), _jax(dx, qc, lens))
    want = ("hi1_is_n", "hi1_starts_run", "window_search", "absent_code", "fail_first_step",
            "fail_later", "length_0", "ftab_start", "trivial", "nontrivial", "k_wraps",
            "no_nontrivial_step")
    assert all(events.get(e, 0) > 0 for e in want), [e for e in want if e not in events]


def test_runs_window_holds_hi1s_run(cases):
    """The window of hi + 1's run search, [lo's run, lo's run + hi + 1 -
    run_start[lo's run]], holds hi + 1's run for every lo <= hi + 1 < n of
    the --no-dense panel: a run holds at least one position."""
    idx = cases["nodense"][0]
    rs = np.asarray(idx.run_start).astype(np.int64)
    rng = np.random.default_rng(2)
    lo = rng.integers(0, idx.n - 1, 20_000)
    i1 = np.minimum(lo + rng.integers(0, 64, lo.shape[0]), idx.n - 1)
    r0 = np.searchsorted(rs, lo, side="right") - 1
    r1 = np.searchsorted(rs, i1, side="right") - 1
    assert ((r1 >= r0) & (r1 <= np.minimum(r0 + (i1 - rs[r0]), idx.R - 1))).all()


# ---------------------------------------------------------------------------
# the launch path

def _tables_lib(calls, rc):
    """rbt_lf_tables as the model over the operands at the addresses and
    widths the wrapper passes; returns rc, writing nothing when rc != 0."""
    policies = {0: "runs", 1: "dense", 2: "occ1"}

    def rbt_lf_tables(policy, occ, occ_b, rs, rs_b, rh, rh_b, bwt4, nb, R, F, lane_b, A, n, q,
                      lengths, B, L, ftab, ftab_b, kf, acgt, tk1, tk1_b, ltk, ltk_b, sl, sl_b,
                      lo, hi, k_out, threads, stage, stream):
        c = dict(policy=policies[policy], occ=(occ, occ_b), rs=(rs, rs_b), rh=(rh, rh_b),
                 bwt4=bwt4, nb=nb, R=R, lane=lane_b, A=A, n=n, q=q, B=B, L=L,
                 ftab=(ftab, ftab_b), kf=kf, acgt=acgt, tk1=(tk1, tk1_b), ltk=(ltk, ltk_b),
                 sl=(sl, sl_b), out=(lo, hi, k_out), threads=threads, stage=stage, stream=stream)
        calls.append(c)
        if rc or B == 0:
            return rc
        pol = c["policy"]
        size = {"runs": A * R, "dense": A * nb, "occ1": A * (n + 1)}[pol]
        t = {"occ": _ints(occ, size, occ_b)}
        if pol == "runs" or ltk:
            t["run_start"] = _ints(rs, R, rs_b)
        if pol == "runs":
            t["run_head"] = _ints(rh, R, rh_b)
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
    lanes are int64."""
    keep = () if lanes else ("F",)
    return dataclasses.replace(tx, arrays={
        k: v.long() if k in TABLE_KEYS + ("F",) and k not in keep else v
        for k, v in tx.arrays.items()})


def _all_cases():
    return ([(c, False) for c in COUNT_CASES] + [(c, True) for c in TOE_CASES])


@pytest.mark.parametrize("width", ["int32", "int64_tables", "int64_lanes"])
@pytest.mark.parametrize("case,toehold", _all_cases(),
                         ids=[f"{c}-{'toehold' if t else 'count'}" for c, t in _all_cases()])
def test_launch_path_equals_the_twin(cases, fake_tables, case, toehold, width):
    """launch_tables with the model behind its C entry == the plain twin,
    at each width of the tables and the lanes; the operands are the
    policy's tables at their own widths, the launch plan one thread a lane,
    the ftab passed for the count search only."""
    src, drop = (TOE_CASES if toehold else COUNT_CASES)[case][:2]
    _, tx, idx, text, reads = _pair(cases, src, drop + (("kval",) if toehold else ()))
    if width != "int32":
        tx = _widened(tx, width == "int64_lanes")
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
    assert (c["threads"], bool(c["stage"])) == cuda_lf.launch_plan(*qc.shape, 132, group=1)
    assert c["threads"] % 32 == 0 and c["stream"] == 1000
    if policy == "runs":
        assert c["rs"][1] == c["rh"][1] == wide and c["bwt4"] is None
    if policy == "dense":
        assert c["bwt4"] is not None and c["nb"] == tx.arrays["bwt4"].numel() // 16
    if toehold:
        assert c["kf"] == 0 and c["ftab"] == (None, 0) and c["sl"][1] == wide
        assert (c["tk1"][0] is None) == (cuda_lf.toehold_route(tx) == "ltk")
        assert len(set(c["out"])) == 3
    else:
        assert c["kf"] == tx.ftab_k and c["ftab"][1] == wide and c["out"][2] is None


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
