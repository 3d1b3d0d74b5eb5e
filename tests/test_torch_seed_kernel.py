"""The seeding state machines of rbt_markers and rbt_locs in one kernel
launch a batch (ops/cuda_seeds.launch_machine, csrc/seeds.cu).

A numpy model of the kernel's per-lane machine (one lane at a time, in any
order, with real control flow: K1's LF step from the ranks of the fused rows; GREEDY's
ftab start, window and seed-final probes, seeds, and the ftab restart as a
k-step replay that holds the full range after an empty step; LMEM's one
search to its failure; SAMPLE's seeds of at least min_length codes and its
step record; the clamped record slots and the fill of the slots a lane
leaves unwritten) sits behind a fake C entry that reads the addresses and
widths the wrapper passes.  Through the public engines
(markers_greedy_seeding, markers_lmem_lanes, seeds_greedy_w_sample) it
equals the JAX package's functions buffer for buffer, and so do the port's
plain twins (the `*_records_plain` torch loops and the torch tail), on the
3-document panel of test_torch_seeds.py (fblock64 and fblock rows, int32
lanes) and on its BigIndex view (fb2_64 rows, int64 lanes), at L = 1, 31
and 100, with the ftab on and off, on lanes that reach every edge the model
counts.  The records of the model equal the twins' at record capacities
small enough to overflow; refused launches raise and count nothing; the
route follows the tables.  Every output is an integer, so every check is
exact."""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rowbowt_tpu.bigindex import BigIndex as JaxBigIndex
from rowbowt_tpu.engine import seeds as JS
from rowbowt_tpu.engine.device import DeviceIndex
from rowbowt_tpu.index import RbtIndex as JaxRbtIndex
from rowbowt_tpu_torch.alphabet import revcomp
from rowbowt_tpu_torch.bigindex import BigIndex
from rowbowt_tpu_torch.engine import seeds as TS
from rowbowt_tpu_torch.engine.device import TorchIndex, nibbles_of_planes
from rowbowt_tpu_torch.index import RbtIndex
from rowbowt_tpu_torch.ops import cuda_lf, cuda_seeds
from rowbowt_tpu_torch.ops import rank as R
from test_torch_seeds import build_panel, save_jax_big
from test_torch_toehold import _ints, _symbols

ACGT = np.frombuffer(b"ACGT", np.uint8)
WIDTHS = (1, 31, 100)
WSIZE = 10
MODES = ("greedy", "lmem", "sample")
ZERO = dict.fromkeys(cuda_seeds.LAUNCHES_SEED, 0)


# ---------------------------------------------------------------------------
# the fixtures

@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """{"dense": (JAX DeviceIndex, port TorchIndex, port RbtIndex), "big":
    the same over the panel's BigIndex directory (fb2_64 rows, no ftab),
    "reads": the reads, their reverse complements and the edge reads}."""
    d = tmp_path_factory.mktemp("seed_kernel")
    dirs, _, reads = build_panel(d)
    idx = RbtIndex.load(dirs["idx"])
    dx = DeviceIndex.from_index(JaxRbtIndex.load(dirs["idx"]))
    big = save_jax_big(dirs["idx"], str(d / "big"))
    jbx = JaxBigIndex.load(big).device_index()
    tbx = TorchIndex.from_big(BigIndex.load(big), "cpu")
    edge = _edge_reads(reads, np.random.default_rng(3))
    lanes = [s for r in reads for s in (r, revcomp(r).tobytes())] + edge
    return {"dense": (dx, TorchIndex.from_index(idx, "cpu"), idx), "big": (jbx, tbx, idx),
            "reads": lanes}


def _edge_reads(reads, rng):
    """Reads the panel's do not reach often: random ones (a failure every
    few codes: restarts, replays that meet an empty step, seeds past S),
    random ones with an N in every few codes (restart windows holding a
    code other than A, C, G, T), an N as the last code (a failure at the
    first step, an ftab miss), an N inside (a replay over it), a repeat of
    one read (long seeds, few failures), and the empty read."""
    out = [rng.choice(ACGT, size=int(m)).tobytes() for m in (100, 64, 40, 17, 8)]
    acgtn = np.frombuffer(b"ACGTACGTACGTN", np.uint8)
    out += [rng.choice(acgtn, size=int(m)).tobytes() for m in (100, 77)]
    long = reads[0] + reads[1]
    out += [long[:99] + b"N", b"N" + reads[2], reads[3][:20] + b"N" + reads[3][21:],
            (reads[4] * 4)[:100], long[:100], b"A", b""]
    return out


def _lanes(idx, reads, L):
    """[B, L] int32 codes (each read's last L codes, right-aligned, -1 pad)
    and lengths; B odd."""
    enc = [idx.alpha.encode(np.frombuffer(r, np.uint8)).astype(np.int64)[-L:] if r else
           np.zeros(0, np.int64) for r in reads]
    if len(enc) % 2 == 0:
        enc.append(np.zeros(0, np.int64))
    qc = np.full((len(enc), L), -1, np.int32)
    lens = np.zeros(len(enc), np.int32)
    for b, e in enumerate(enc):
        if len(e):
            qc[b, L - len(e):] = e
        lens[b] = len(e)
    return qc, lens


# ---------------------------------------------------------------------------
# the numpy model of the kernel

def rank_table(fb, syms, F, A, n, base=None, sup=(0, 0)):
    """[n + 1, A] rank(i, c) as the kernel computes it from the fused rows:
    the row's checkpoint of c (on the two-level rows, given `base`, their
    bit planes, plus the base of the row's superblock (row * mul) >> shift,
    sup = (mul, shift)) and the count of c among the row's first i mod syms
    symbols; at i = n the code's total count."""
    shift = {64: 6, 128: 7, 256: 8}[syms]
    if base is not None:
        fb = nibbles_of_planes(torch.from_numpy(fb), syms, n).numpy()
    sym, ck = _symbols(fb, syms)
    onehot = (sym[:, :, None] == np.arange(A)).astype(np.int64)
    pre = np.concatenate([np.zeros((fb.shape[0], 1, A), np.int64),
                          np.cumsum(onehot, axis=1)[:, :-1]], axis=1)
    i = np.arange(n)
    r, off = i >> shift, i & (syms - 1)
    tab = ck[r, :A] + pre[r, off]
    if base is not None:
        tab = tab + np.asarray(base, np.int64)[(r.astype(np.int64) * sup[0]) >> sup[1], :A]
    F = np.asarray(F, np.int64)
    return np.vstack([tab, (F[1:A + 1] - F[:A])[None]])


def machine_model(mode, rk, F, A, n, q, lens, *, k=0, ftab=None, acgt=(), wsize=0,
                  max_range=0, min_length=0, W=0, S=0, record=False, lane_bytes=4,
                  events=None, order=None):
    """The tables seed_machine_kernel<MODE> writes, as numpy [rows, B] and
    [B] arrays of lane_bytes integers (keys as launch_machine's), lane by
    lane in `order` (0 .. B - 1 by default); rk is rank_table's.  `events`,
    a dict, counts the edges the lanes reached."""
    ev = events if events is not None else {}
    F = [int(x) for x in F]
    B, L = q.shape
    n1 = n - 1

    def bump(key):
        ev[key] = ev.get(key, 0) + 1

    def step(lo, hi, c):
        if not 0 <= c < A:
            return 1, 0
        if hi + 1 == n:
            bump("hi1_is_n")
        cb, ce = int(rk[lo, c]), int(rk[hi + 1, c])
        if ce - cb <= 0:
            return 1, 0
        return F[c] + cb, F[c] + ce - 1

    def ftab_range(b):
        kc = 0
        for col in range(L - k, L):
            two = [x for x in range(4) if acgt[x] == q[b, col]]
            if not two:
                return None
            kc = (kc << 2) | two[-1]
        if ftab[kc, 0] < 0:
            return None
        return int(ftab[kc, 0]), int(ftab[kc, 1])

    out = {}
    if mode in ("greedy", "lmem"):
        out.update(wlo=np.ones((W, B)), whi=np.zeros((W, B)), nrec=np.zeros(B))
    if mode == "greedy":
        out["wseed"] = np.zeros((W, B))
    if mode in ("greedy", "sample"):
        out.update(slo=np.ones((S, B)), shi=np.zeros((S, B)), sqs=np.zeros((S, B)),
                   sqe=np.zeros((S, B)), ns=np.zeros(B))
    if mode == "lmem":
        out.update(elo=np.zeros(B), ehi=np.zeros(B), eqs=np.zeros(B))
    if record:
        out["hi_rec"] = np.zeros((L, B))
    out = {key: v.astype(object) for key, v in out.items()}

    for b in range(B) if order is None else (int(x) for x in order):
        m = int(lens[b])
        nrec = ns = 0
        if m == 0:
            bump("length_0")

        def rec(tlo, thi, owner):
            nonlocal nrec
            if thi - tlo + 1 > max_range:
                bump("max_range_cut")
                return
            slot = min(nrec, W - 1)
            if nrec >= W:
                bump("w_overflow")
            out["wlo"][slot, b], out["whi"][slot, b] = tlo, thi
            if mode == "greedy":
                out["wseed"][slot, b] = owner
                if owner >= S:
                    bump("owner_past_s")
            nrec += 1

        def put(lo, hi, qs, qe):
            nonlocal ns
            if ns < S:
                for key, v in zip(("slo", "shi", "sqs", "sqe"), (lo, hi, qs, qe)):
                    out[key][ns, b] = v
            else:
                bump("s_overflow")
            ns += 1

        if mode == "greedy":
            lo, hi, i = 0, n1, 0
            if k and m >= k:
                got = ftab_range(b)
                bump("ftab_start" if got else "ftab_miss")
                if got:
                    (lo, hi), i = got, k
            plo, phi, seed_ei, window_ei = lo, hi, m, m
            rp, rpmiss = 0, False
            t = 0
            while t < L and i < m:
                c = int(q[b, min(max(L - 1 - i, 0), L - 1)])
                normal = rp == 0
                if normal or not rpmiss:
                    nlo, nhi = step(lo, hi, c)
                    ne = nlo <= nhi
                else:
                    nlo, nhi, ne = lo, hi, False
                ok, fail = normal and ne, normal and not ne
                if fail and t == 0:
                    bump("fail_first_step")
                mi = m - i
                w_trigger = ok and window_ei - (mi - 1) >= wsize
                f_probe = fail and seed_ei - mi >= wsize
                if w_trigger or f_probe:
                    bump("window_probe" if w_trigger else "seed_final_probe")
                    rec(*((plo, phi) if fail else (nlo, nhi)), ns)
                if w_trigger:
                    window_ei = mi - 1
                if fail:
                    put(plo, phi, mi, seed_ei - 1)
                    plo, phi, seed_ei, window_ei = 0, n1, mi - 1, mi - 1
                if k:
                    hit = fail and mi - 1 >= k
                    rstep = rp > 0
                    held = rpmiss or (rstep and not ne)
                    if rstep and held and not rpmiss:
                        bump("replay_held")
                    if ok:
                        lo, hi, plo, phi = nlo, nhi, nlo, nhi
                    elif fail:
                        bump("restart_replay" if hit else "restart_to_full")
                        window = q[b, max(L - 1 - i - k, 0):L - 1 - i]
                        if hit and any(int(x) not in acgt for x in window):
                            bump("replay_window_not_acgt")
                        lo, hi = 0, n1
                    elif rstep:
                        lo, hi = (0, n1) if held else (nlo, nhi)
                        plo, phi = lo, hi
                        if rp == 1 and not held:
                            bump("replay_nonempty")
                    rpmiss = False if hit else held
                    rp = k if hit else rp - 1 if rstep else rp
                elif ok:
                    lo, hi, plo, phi = nlo, nhi, nlo, nhi
                elif fail:
                    lo, hi = 0, n1
                i += 1
                t += 1
            if hi >= lo and seed_ei - (m - i) >= wsize:
                bump("final_probe")
                rec(lo, hi, ns)
            if m > 0:
                put(lo, hi, m - i, seed_ei - 1)
        elif mode == "lmem":
            lo, hi, i = 0, n1, 0
            if k and m >= k:
                got = ftab_range(b)
                bump("ftab_start" if got else "ftab_miss")
                if got:
                    lo, hi = got
                i = k
            window_ei, done = m, False
            elo, ehi, eqs = 1, 0, 0
            t = 0
            while t < L and i < m:
                c = int(q[b, min(max(L - 1 - i, 0), L - 1)])
                nlo, nhi = step(lo, hi, c)
                ok = nlo <= nhi
                mi = m - i
                f_probe = not ok and i >= wsize
                w_trigger = ok and window_ei - (mi - 1) >= wsize
                if f_probe or w_trigger:
                    rec(*((nlo, nhi) if ok else (lo, hi)), 0)
                if w_trigger:
                    window_ei = mi - 1
                if not ok:
                    bump("fail_first_step" if t == 0 else "lmem_fail")
                    elo, ehi, eqs, done = lo, hi, mi, True
                    break
                lo, hi = nlo, nhi
                i += 1
                t += 1
            if not done:
                bump("lmem_complete")
                if hi >= lo and i >= wsize and m > 0:
                    rec(lo, hi, 0)
                elo, ehi, eqs = lo, hi, m - i
            out["elo"][b], out["ehi"][b], out["eqs"][b] = elo, ehi, eqs
        else:
            lo, hi, plo, phi, ei = 0, n1, 0, n1, m
            jend = min(m, L)
            for j in range(L):
                if record:
                    out["hi_rec"][j, b] = hi
                if j >= jend:
                    continue
                nlo, nhi = step(lo, hi, int(q[b, L - 1 - j]))
                if nlo <= nhi:
                    lo, hi, plo, phi = nlo, nhi, nlo, nhi
                else:
                    if j == 0:
                        bump("fail_first_step")
                    if ei - (m - j) >= min_length:
                        if ei - (m - j) == 0:
                            bump("sample_degenerate")
                        put(plo, phi, m - j, ei)
                    lo, hi, plo, phi, ei = 0, n1, 0, n1, m - j - 1
            if ei >= min_length:
                put(plo, phi, 0, ei)
        if "nrec" in out:
            out["nrec"][b] = nrec
        if "ns" in out:
            out["ns"][b] = ns
    dt = np.int64 if lane_bytes == 8 else np.int32
    return {key: v.astype(np.int64).astype(dt) for key, v in out.items()}


def _model_lib(tx, calls, rc, events=None):
    """rbt_seed_machine as machine_model over the operands at the addresses
    and widths the wrapper passes; returns rc, writing nothing when rc != 0."""
    key = cuda_lf.row_layout(tx)
    rows = cuda_lf.rows_of(tx, key).shape
    n_sup = tx.arrays["fb2_base"].shape[0] if key in R.FB2_KEYS else 0

    def rbt_seed_machine(mode, fb, syms, F, base, blk_mul, blk_shift, A, n, lane_b, q, lengths,
                         B, L,
                         ftab, ftab_b, k, acgt, wsize, max_range, min_length, W, rlo, rhi,
                         rseed, nrec, S, slo, shi, sqs, sqe, ns, hi_rec, tk1, tk1_b, ltk, ltk_b,
                         run_start, rs_b, rs_off, off_b, n_off, shift, iters, samples_last, sl_b,
                         R_, ssamp, threads, stage, stream):
        name = {0: "greedy", 1: "lmem", 2: "sample"}[mode]
        c = dict(mode=name, syms=syms, blk=(blk_mul, blk_shift), A=A, n=n, lane=lane_b, q=q, B=B,
                 L=L,
                 ftab=(ftab, ftab_b), k=k, acgt=acgt, wsize=wsize, max_range=max_range,
                 min_length=min_length, W=W, S=S, base=base, hi_rec=hi_rec,
                 outs=(rlo, rhi, rseed, nrec, slo, shi, sqs, sqe, ns),
                 toe=(tk1, ltk, run_start, samples_last, ssamp),
                 directory=(rs_off, off_b, n_off, shift, iters),
                 threads=threads, stage=stage, stream=stream)
        calls.append(c)
        assert ssamp is None, "the per-step toehold's model is test_torch_seed_tables.py's"
        if rc or B == 0:
            return rc
        fbn = _ints(fb, rows[0] * rows[1], 4).reshape(rows)
        Fn = _ints(F, A + 1, lane_b)
        bn = _ints(base, n_sup * 8, 8).reshape(-1, 8) if base else None
        rk = rank_table(fbn, syms, Fn, A, n, bn, (blk_mul, blk_shift))
        codes = [(acgt >> (8 * i)) & 0xFF for i in range(4)]
        codes = [x - 256 if x == 0xFF else x for x in codes]
        got = machine_model(
            name, rk, Fn, A, n, _ints(q, B * L, 4).reshape(B, L), _ints(lengths, B, 4), k=k,
            ftab=_ints(ftab, 2 * 4 ** k, ftab_b).reshape(-1, 2) if k else None, acgt=codes,
            wsize=wsize, max_range=max_range, min_length=min_length, W=W, S=S,
            record=bool(hi_rec), lane_bytes=lane_b, events=events)
        names = {"wlo": rlo, "whi": rhi, "wseed": rseed, "nrec": nrec, "slo": slo, "shi": shi,
                 "sqs": sqs, "sqe": sqe, "ns": ns, "elo": slo, "ehi": shi, "eqs": sqs,
                 "hi_rec": hi_rec}
        for key, v in got.items():
            _ints(names[key], v.size, lane_b)[:] = v.reshape(-1)
        return rc

    return SimpleNamespace(rbt_seed_machine=rbt_seed_machine,
                           rbt_cuda_error_string=lambda code: b"invalid argument")


@pytest.fixture
def fake(monkeypatch):
    """Installs the model behind the C entry (install(tx, events)), with
    the counters at 0; `kernel()` then makes the engines take the kernel
    route on CPU tensors."""
    rec = {"calls": [], "rc": 0}

    def install(tx, events=None):
        monkeypatch.setattr(cuda_seeds, "_LIB", _model_lib(tx, rec["calls"], rec["rc"], events))

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

def _eq(got, want, what=""):
    for j, (g, w) in enumerate(zip(got, want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype, (what, j, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} output {j}")


def _run(mode, jax_side, tx, qc, lens, opt):
    """(JAX's outputs, or the port's for tx) of `mode` with options opt."""
    if jax_side:
        q, ln, mod = jnp.asarray(qc), jnp.asarray(lens), JS
    else:
        q, ln, mod = torch.from_numpy(qc), torch.from_numpy(lens), TS
    if mode == "greedy":
        return mod.markers_greedy_seeding(tx, q, ln, wsize=WSIZE, **opt)
    if mode == "lmem":
        return mod.markers_lmem_lanes(tx, q, ln, wsize=WSIZE, **opt)
    return mod.seeds_greedy_w_sample(tx, q, ln, **opt)


# (mode, options): greedy with the ftab and without, small S and K and a
# small max_range against the defaults; lmem (it needs the ftab); sample at
# min_length 19 (rbt_locs) and 0 (degenerate records)
CASES = {
    "greedy_ftab": ("greedy", dict(max_seeds=2, max_k=2, max_range=40, values=False)),
    "greedy_ftab_defaults": ("greedy", dict()),
    "greedy_full": ("greedy", dict(use_ftab=False, max_seeds=3, max_k=4, max_range=200)),
    "lmem": ("lmem", dict(max_range=200, max_k=4)),
    "sample": ("sample", dict(min_length=19, max_seeds=4)),
    "sample_min0": ("sample", dict(min_length=0, max_seeds=2)),
}


def _lmem_reads(reads):
    """The L-MEM lanes (every prefix of a read) of a few reads and edge
    reads, as rbt_markers --lmem expands them."""
    return TS.lmem_expand(reads[:6:2] + reads[-12:-3])[0]


@pytest.mark.parametrize("L", WIDTHS)
@pytest.mark.parametrize("case", list(CASES))
def test_dense_model_and_twins_match_jax(panel, fake, case, L):
    """On the dense panel (fblock64 rows, int32 lanes): the engine with its
    plain twin == JAX, and with the model behind the C entry == JAX, every
    output buffer and dtype; the model's records == the twin's."""
    mode, opt = CASES[case]
    dx, tx, idx = panel["dense"]
    reads = _lmem_reads(panel["reads"]) if mode == "lmem" else panel["reads"]
    qc, lens = _lanes(idx, reads, L)
    want = _run(mode, True, dx, qc, lens, opt)
    _eq(_run(mode, False, tx, qc, lens, opt), want, "plain")
    fake["install"](tx)
    fake["kernel"]()
    _eq(_run(mode, False, tx, qc, lens, opt), want, "model")
    assert cuda_seeds.LAUNCHES_SEED == dict(ZERO, **{mode: 1})
    (c,) = fake["calls"]
    assert c["toe"] == (None,) * 5  # kval: no per-step toehold


@pytest.mark.parametrize("L", WIDTHS)
@pytest.mark.parametrize("case", ["greedy_full", "sample", "sample_min0"])
def test_big_model_and_twins_match_jax(panel, fake, case, L):
    """On the panel's BigIndex view (fb2_64 rows, int64 lanes, no ftab):
    the same, the sampled machine writing its step record (the trajectory
    toehold's)."""
    mode, opt = CASES[case]
    jbx, tbx, idx = panel["big"]
    assert cuda_lf.row_layout(tbx) == "fb2_64" and tbx.idx_dtype == torch.int64
    qc, lens = _lanes(idx, panel["reads"], L)
    want = _run(mode, True, jbx, qc, lens, opt)
    _eq(_run(mode, False, tbx, qc, lens, opt), want, "plain")
    fake["install"](tbx)
    fake["kernel"]()
    _eq(_run(mode, False, tbx, qc, lens, opt), want, "model")
    assert cuda_seeds.LAUNCHES_SEED == dict(ZERO, **{"sample_rec" if mode == "sample" else
                                                     mode: 1})
    (c,) = fake["calls"]
    assert c["lane"] == 8 and c["base"] is not None and (c["hi_rec"] is not None) == (
        mode == "sample")


# ---------------------------------------------------------------------------
# the records: the model against the twins, at capacities that overflow

def _records(tx, mode, qc, lens, opt):
    """(twin's records, launch_machine's) of `mode` on tx, on its device."""
    q, ln = torch.from_numpy(qc).to(tx.device), torch.from_numpy(lens).to(tx.device)
    two = cuda_lf.row_layout(tx) in R.FB2_KEYS
    dt = tx.idx_dtype
    mr = min(opt.get("max_range", 1 << 62), torch.iinfo(dt).max)
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
        want = TS.seeds_sample_records_plain(tx, q, ln, opt["min_length"], opt["S"],
                                             "trajectory" if two else "kval")
        got = cuda_seeds.launch_machine(tx, "sample", q, ln, min_length=opt["min_length"],
                                        S=opt["S"], record=two)
    return want, got


def _same_records(want, got):
    assert sorted(want) == sorted(got)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(), err_msg=key)


# (mode, options) at capacities W and S the engines' own never take, so
# that records overflow: the last slot overwritten, owners and counts past
# the capacity
RECORD_CASES = {
    "greedy_ftab_w2": ("greedy", dict(k=6, W=2, S=2)),
    "greedy_full_w3": ("greedy", dict(k=0, W=3, S=1, max_range=30)),
    "lmem_w1": ("lmem", dict(k=6, W=1)),
    "lmem_w2_k0": ("lmem", dict(k=0, W=2, max_range=30)),
    "sample_s1": ("sample", dict(min_length=0, S=1)),
}


# big artifacts carry no ftab: the two-level rows take the cases without one
RECORD_RUNS = [(case, index) for case, (_, opt) in RECORD_CASES.items()
               for index in ("fblock64", "fblock", "fb2_64")
               if not (index == "fb2_64" and opt.get("k"))]


@pytest.mark.parametrize("case,index", RECORD_RUNS, ids=[f"{c}-{i}" for c, i in RECORD_RUNS])
def test_model_records_equal_the_twins_at_overflow(panel, fake, case, index):
    """The launch path with the model behind its C entry writes the twins'
    record tables, buffer for buffer, at int32 lanes (fblock64 and the
    96 B fblock rows) and int64 lanes (fb2_64), with the record and seed
    capacities overflowing."""
    mode, opt = RECORD_CASES[case]
    if index == "fb2_64":
        tx, idx = panel["big"][1], panel["big"][2]
    else:
        idx = panel["dense"][2]
        tx = TorchIndex.from_index(idx, "cpu", fb64=index == "fblock64")
    assert cuda_lf.row_layout(tx) == index
    qc, lens = _lanes(idx, panel["reads"], 100)
    events = {}
    fake["install"](tx, events)
    want, got = _records(tx, mode, qc, lens, opt)
    _same_records(want, got)
    if mode == "greedy":
        assert events.get("w_overflow") and events.get("s_overflow")
        assert events.get("owner_past_s")
    if mode == "lmem":
        assert events.get("w_overflow")


def test_model_reaches_every_edge(panel, fake):
    """Over the record cases at L = 100, L = 31 and the engines' own
    capacities, the lanes reach every edge the model counts, and the model
    still writes the twins' records."""
    events = {}
    dx, tx, idx = panel["dense"]
    tbx = panel["big"][1]
    for L in (31, 100):
        qc, lens = _lanes(idx, panel["reads"], L)
        for mode, opt in list(RECORD_CASES.values()) + [
                ("greedy", dict(k=6, W=2 * (L // WSIZE) + 4, S=8, max_range=20)),
                ("lmem", dict(k=6, W=L // WSIZE + 2)),
                ("sample", dict(min_length=19, S=8))]:
            for t in (tx, tbx):
                if t is tbx and opt.get("k"):
                    continue
                fake["install"](t, events)
                _same_records(*_records(t, mode, qc, lens, opt))
        fake["install"](tx, events)
        lq, ll = _lanes(idx, _lmem_reads(panel["reads"]), L)
        _same_records(*_records(tx, "lmem", lq, ll, dict(k=6, W=L // WSIZE + 2)))
    want = ("hi1_is_n", "length_0", "ftab_start", "ftab_miss", "fail_first_step",
            "window_probe", "seed_final_probe", "final_probe", "max_range_cut",
            "restart_replay", "replay_nonempty", "restart_to_full", "replay_held",
            "w_overflow", "s_overflow",
            "owner_past_s", "lmem_fail", "lmem_complete", "sample_degenerate")
    assert all(events.get(e, 0) > 0 for e in want), [e for e in want if e not in events]


# ---------------------------------------------------------------------------
# the launch path

# --lmem needs the ftab, which big artifacts do not carry
LAUNCH_RUNS = [(m, i) for i in ("fblock64", "fb2_64") for m in MODES
               if not (i == "fb2_64" and m == "lmem")]


@pytest.mark.parametrize("mode,index", LAUNCH_RUNS, ids=[f"{m}-{i}" for m, i in LAUNCH_RUNS])
def test_launch_passes_the_rows_lanes_and_capacities(panel, fake, mode, index):
    """What the wrapper hands the C entry: the layout's rows and symbols,
    int32 or int64 lanes (with fb2_base and its per_blk on the two-level
    rows), the ftab for greedy and lmem only (with its width), max_range
    clamped to the lane type, K1's launch plan, and the outputs the mode
    writes (LMEM's seed in the seed slots, its seed slot and sqe absent)."""
    tx, idx = (panel["big"][1], panel["big"][2]) if index == "fb2_64" else panel["dense"][1:]
    qc, lens = _lanes(idx, panel["reads"], 100)
    q, ln = torch.from_numpy(qc), torch.from_numpy(lens)
    fake["install"](tx)
    two = index == "fb2_64"
    k = 0 if two or mode == "sample" else tx.ftab_k
    lane_max = (1 << 63) - 1 if two else (1 << 31) - 1
    kw = dict(greedy=dict(k=k, wsize=WSIZE, max_range=lane_max, W=24, S=8),
              lmem=dict(k=k, wsize=WSIZE, max_range=lane_max, W=12, S=1),
              sample=dict(min_length=19, S=8, record=two))[mode]
    out = cuda_seeds.launch_machine(tx, mode, q, ln, **kw)
    (c,) = fake["calls"]
    assert c["mode"] == mode and c["syms"] == 64 and c["lane"] == (8 if two else 4)
    assert (c["base"] is not None) == two and c["n"] == tx.n and (c["B"], c["L"]) == qc.shape
    assert c["blk"] == (R.superblock_magic(tx.arrays["pl2_64"].shape[0]
                                           // tx.arrays["fb2_base"].shape[0]) if two else (0, 0))
    assert c["k"] == k and (c["ftab"][0] is not None) == bool(k)
    assert c["ftab"][1] == (tx.arrays["ftab"].element_size() if k else 0)
    assert c["max_range"] == kw.get("max_range", 0)
    most = cuda_seeds.BLOCK_LANES[torch.int64 if two else torch.int32]
    assert (c["threads"], bool(c["stage"])) == cuda_lf.launch_plan(*qc.shape, 132, most=most)
    assert c["stream"] == 1000
    rlo, rhi, rseed, nrec, slo, shi, sqs, sqe, ns = c["outs"]
    assert (rseed is None) == (mode != "greedy") and (sqe is None) == (mode == "lmem")
    assert (rlo is None) == (mode == "sample") and (ns is None) == (mode == "lmem")
    assert all(t.dtype == (torch.int64 if two else torch.int32) for t in out.values())
    assert cuda_seeds.LAUNCHES_SEED == dict(ZERO, **{"sample_rec" if two and mode == "sample"
                                                     else mode: 1})


@pytest.mark.parametrize("index,threads", [("fblock64", 512), ("fb2_64", 256)])
def test_full_batch_block_is_its_instance_familys(panel, fake, index, threads):
    """A batch that gives every SM full blocks launches blocks of the size
    csrc/seeds.cu Bounds builds the instance family for (512 threads over
    int32 lanes, 256 over int64), the kernel refusing larger ones."""
    tx = panel["big"][1] if index == "fb2_64" else panel["dense"][1]
    B, L = 132 * 256, 31
    fake["rc"] = 1  # the call is recorded, the model not run
    fake["install"](tx)
    q, ln = torch.full((B, L), 2, dtype=torch.int32), torch.full((B,), L, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="seeding kernel launch failed"):
        cuda_seeds.launch_machine(tx, "sample", q, ln, min_length=19, S=8)
    (c,) = fake["calls"]
    assert c["threads"] == threads and c["stage"]


def test_launch_on_a_view_and_no_lanes(panel, fake):
    """A view one row into a batch is passed as it is; no lanes launch
    nothing and count nothing."""
    tx, idx = panel["dense"][1:]
    qc, lens = _lanes(idx, panel["reads"], 31)
    q, ln = torch.from_numpy(qc)[1:], torch.from_numpy(lens)[1:]
    fake["install"](tx)
    kw = dict(k=tx.ftab_k, wsize=WSIZE, max_range=1000, W=10, S=4)
    got = cuda_seeds.launch_machine(tx, "greedy", q, ln, **kw)
    want = TS.markers_greedy_records_plain(tx, q, ln, WSIZE, 1000, 4, tx.ftab_k, 10)
    _same_records(want, got)
    assert fake["calls"][0]["q"] == q.data_ptr()
    out = cuda_seeds.launch_machine(tx, "greedy", q[:0], ln[:0], **kw)
    assert out["wlo"].shape == (10, 0) and out["ns"].shape == (0,)
    assert cuda_seeds.LAUNCHES_SEED == dict(ZERO, greedy=1) and len(fake["calls"]) == 2


def test_refused_launch_raises_and_counts_nothing(panel, fake):
    tx, idx = panel["dense"][1:]
    fake["rc"] = 1
    fake["install"](tx)
    qc, lens = _lanes(idx, panel["reads"], 31)
    with pytest.raises(RuntimeError, match="seeding kernel launch failed: invalid argument"):
        cuda_seeds.launch_machine(tx, "sample", torch.from_numpy(qc), torch.from_numpy(lens),
                                  min_length=19, S=8)
    assert cuda_seeds.LAUNCHES_SEED == ZERO and len(fake["calls"]) == 1


@pytest.mark.parametrize("fault,error,match", [
    ("no rows", ValueError, "the seeding kernel reads fused-block rows"),
    ("unknown mode", ValueError, "no seeding machine"),
    ("record over single-level rows", ValueError, "the step record is the sampled machine's"),
    ("ftab for sample", ValueError, "the sampled machine takes no ftab start"),
    ("capacities", ValueError, "capacities W = 0"),
    ("ftab wider than L", ValueError, "an ftab start of k = 6 over codes of width 4"),
    ("int64 qcodes", TypeError, "qcodes must be int32"),
    ("int64 F", TypeError, "F must be int32"),
    ("lengths shape", ValueError, "lengths must be"),
    ("ftab shape", ValueError, "ftab of shape"),
    ("other device", ValueError, "is on meta"),
])
def test_launch_refuses(panel, fake, fault, error, match):
    tx, idx = panel["dense"][1:]
    fake["install"](tx)
    qc, lens = _lanes(idx, panel["reads"], 31)
    q, ln = torch.from_numpy(qc), torch.from_numpy(lens)
    arrays = dict(tx.arrays)
    mode, kw = "greedy", dict(k=tx.ftab_k, wsize=WSIZE, max_range=100, W=10, S=4)
    if fault == "no rows":
        for name in ("fblock64", "fblock", "occ1_flat", "bwt4", "run_start"):
            arrays.pop(name, None)
    elif fault == "unknown mode":
        mode = "tables"
    elif fault == "record over single-level rows":
        mode, kw = "sample", dict(min_length=19, S=4, record=True)
    elif fault == "ftab for sample":
        mode, kw = "sample", dict(min_length=19, S=4, k=tx.ftab_k)
    elif fault == "capacities":
        kw["W"] = 0
    elif fault == "ftab wider than L":
        q, ln = q[:, -4:].contiguous(), torch.clamp(ln, max=4)
    elif fault == "int64 qcodes":
        q = q.long()
    elif fault == "int64 F":
        arrays["F"] = arrays["F"].long()
    elif fault == "lengths shape":
        ln = ln[:-1]
    elif fault == "ftab shape":
        arrays["ftab"] = arrays["ftab"][:-1]
    elif fault == "other device":
        arrays["ftab"] = arrays["ftab"].to("meta")
    with pytest.raises(error, match=match):
        cuda_seeds.launch_machine(dataclasses.replace(tx, arrays=arrays), mode, q, ln, **kw)
    assert fake["calls"] == [] and cuda_seeds.LAUNCHES_SEED == ZERO


def test_build_failure_raises_and_runs_no_torch_loop(panel, monkeypatch):
    """With the kernel library missing, a CUDA-tensor call raises; it never
    gives way to the torch loop."""
    from rowbowt_tpu_torch import _native

    def refuse(stem):
        raise _native.BuildError("nvcc not found on PATH")

    monkeypatch.setattr(_native, "build_cuda_library", refuse)
    monkeypatch.setattr(cuda_seeds, "_LIB", None)
    monkeypatch.setattr(cuda_seeds, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(cuda_seeds.torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(cuda_seeds, "LAUNCHES_SEED", dict(ZERO))
    plain = []
    monkeypatch.setattr(TS, "markers_greedy_records_plain", lambda *a, **k: plain.append(1))
    tx, idx = panel["dense"][1:]
    qc, lens = _lanes(idx, panel["reads"], 31)
    q, ln = torch.from_numpy(qc), torch.from_numpy(lens)
    with pytest.raises(_native.BuildError, match="nvcc not found"):
        TS._machine(SimpleNamespace(device=SimpleNamespace(type="cuda"), to=lambda dt: q), ln,
                    lambda *a: TS.markers_greedy_records_plain(),
                    lambda qq, ll: cuda_seeds.launch_machine(tx, "greedy", qq, ll, k=0,
                                                             wsize=WSIZE, max_range=100,
                                                             W=10, S=4))
    assert plain == [] and cuda_seeds.LAUNCHES_SEED == ZERO


# ---------------------------------------------------------------------------
# the routes

def _fake_tensor(kind):
    return SimpleNamespace(device=SimpleNamespace(type=kind), to=lambda dt: (kind, dt))


@pytest.mark.parametrize("tables", [
    {"fblock64": None}, {"fb2_64": None}, {"run_start": None}, {"occ1_flat": None},
    {"fblock64": None, "samples_last": None}])
def test_machine_route_follows_the_tables(monkeypatch, tables):
    """CPU tensors take the plain twin; CUDA tensors the kernel (int32
    codes and lengths) over every index's tables, fused rows or not, with
    or without kval; other devices raise.  No torch loop runs on the card."""
    plain = lambda q, ln: ("plain", q.device.type)  # noqa: E731
    launch = lambda q, ln: ("kernel", q, ln)  # noqa: E731
    cpu, cuda = _fake_tensor("cpu"), _fake_tensor("cuda")
    assert TS._machine(cpu, cpu, plain, launch) == ("plain", "cpu")
    got = TS._machine(cuda, cuda, plain, launch)
    assert got == ("kernel", ("cuda", torch.int32), ("cuda", torch.int32))
    assert not hasattr(cuda_seeds, "LAUNCHES_SEED_TORCH")
    with pytest.raises(ValueError, match="no seeding loop for device"):
        TS._machine(_fake_tensor("mps"), cpu, plain, launch)


def test_engines_name_their_routes(panel, fake, monkeypatch):
    """Each engine hands its kernel launch the machine and its options: the
    sampled machine the per-step toehold on an index without kval and the
    step record on a big index; nothing is left to torch on the card."""
    seen = []

    def spy(q, ln, plain, launch):
        seen.append(launch)
        return plain(q, ln)

    calls = []
    monkeypatch.setattr(TS, "_machine", spy)
    monkeypatch.setattr(cuda_seeds, "launch_machine",
                        lambda tx, mode, q, ln, **kw: calls.append(
                            (mode, kw.get("record", False), cuda_seeds.carries_toehold(tx, mode))))
    dx, tx, idx = panel["dense"]
    qc, lens = _lanes(idx, panel["reads"][:6], 31)
    q, ln = torch.from_numpy(qc), torch.from_numpy(lens)
    TS.markers_greedy_seeding(tx, q, ln, wsize=WSIZE)
    TS.markers_lmem_lanes(tx, q, ln, wsize=WSIZE)
    TS.seeds_greedy_w_sample(tx, q, ln, min_length=19)
    bare = dataclasses.replace(tx, arrays={k: v for k, v in tx.arrays.items() if k != "kval"})
    TS.seeds_greedy_w_sample(bare, q, ln, min_length=19)
    TS.seeds_greedy_w_sample(panel["big"][1], q, ln, min_length=19)
    for launch in seen:
        launch(q, ln)
    assert calls == [("greedy", False, False), ("lmem", False, False), ("sample", False, False),
                     ("sample", False, True), ("sample", True, False)]


# ---------------------------------------------------------------------------
# on the card

@pytest.mark.gpu
def test_cuda_seed_kernel_matches_plain(panel):
    """The kernel == its plain twins on the card in every mode, over the
    dense panel's fblock64 rows and its BigIndex view's fb2_64 rows.  Runs
    only where jax and CUDA are both installed; chip_smoke.py (phase
    parity, seeds_parity) makes the same checks with torch alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the seeding kernel has no CPU mode)")
    for tx, idx in ((panel["dense"][1], panel["dense"][2]), (panel["big"][1], panel["big"][2])):
        tc = TorchIndex.from_arrays({k: v.numpy() for k, v in tx.arrays.items()}, n=tx.n,
                                    R=tx.R, A=tx.A, ma_wsize=tx.ma_wsize, ftab_k=tx.ftab_k,
                                    acgt_codes=tx.acgt_codes, device="cuda", ma_bs=tx.ma_bs,
                                    pp_bs=tx.pp_bs, ma_rp=tx.ma_rp)
        for L in WIDTHS:
            qc, lens = _lanes(idx, panel["reads"], L)
            for mode, opt in RECORD_CASES.values():
                if opt.get("k") and not tc.has_ftab:
                    continue
                if opt.get("k") and L < opt["k"]:
                    opt = dict(opt, k=0)
                want, got = _records(tc, mode, qc, lens, opt)
                torch.cuda.synchronize()
                _same_records({k: v.cpu() for k, v in want.items()},
                              {k: v.cpu() for k, v in got.items()})
