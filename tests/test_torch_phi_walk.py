"""The phi walk of `rbt_align -s` (ops/cuda_phi.py): its plain twin, in the
ragged (engine/locate.locate_ragged) and dense (engine/locate.locate) forms
the CPU runs, == the JAX package's locate_ragged and locate on the dense
pairs of tests/test_torch_locate.py and the BigIndex pairs of
tests/test_torch_bigindex.py (phi_rows at n_sup 4, phi_at at n_sup 3), with
max_hits None, 1 and a cap below the widest range, empty and size-1 ranges,
every lane empty, a permuted lane order, int32 and int64 lanes.  Then the
wrapper: its route choice and launch counts, its refusals, and its launch
path with the C entries replaced by a numpy model of the kernel (a refused
launch raises and counts nothing); over the breakpoint table (phi_at, a
BigIndex with its phi rows withheld) the model's walk equals the JAX
package's locate.  The kval route (an index whose kval is the full SA, the
caller's hi handed): its plain twin and a numpy model of its kernel through
locate_ragged == the JAX package's locate_ragged on the dense pairs, capped
and uncapped; the route is taken only where hi is handed and kval is the
full SA, and the chain is kept for arbitrary toeholds (locate).  Every
output is an integer, so every check is exact."""

import ctypes
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rowbowt_tpu.engine import locate as JL
from rowbowt_tpu_torch.engine import locate as TL
from rowbowt_tpu_torch.ops import cuda_phi
from test_bigindex import _reads_of
from test_torch_bigindex import _batch, marker_panel, phi_case  # noqa: F401 (fixtures)
from test_torch_locate import _eq, _toeholds, pair  # noqa: F401 (fixture)


def _lanes(got, dtype):
    return tuple(t.to(dtype) for t in got)


def _cases(lo, hi):
    """{name: lane index array}: all lanes, a permutation of them, the empty
    ranges alone, the size-1 ranges with a few others."""
    size = np.where(hi >= lo, hi - lo + 1, 0)
    rng = np.random.default_rng(11)
    empty, one = np.flatnonzero(size == 0), np.flatnonzero(size == 1)
    assert empty.size and one.size and (size > 3).any()
    return {"all": np.arange(lo.shape[0]), "permuted": rng.permutation(lo.shape[0]),
            "every_lane_empty": empty,
            "size_1": np.concatenate([one, np.flatnonzero(size > 1)[:3]])}


def _held(dx, runs, want, caps, eq):
    """The ragged and dense forms of the port's walk on each lane case ==
    the JAX package's, at max_hits None (ragged only), 1 and each cap, for
    every (tx, port lanes) of `runs`; the JAX package runs each case once."""
    wlo, whi, _ = (np.asarray(t) for t in want)
    for name, sel in _cases(wlo, whi).items():
        w = tuple(jnp.asarray(np.asarray(t)[sel]) for t in want)
        for max_hits in (None, 1, *caps):
            wr = JL.locate_ragged(dx, *w, max_hits=max_hits)
            if name == "every_lane_empty":
                assert wr[0].size == 0 and not wr[1].any()
            wd = JL.locate(dx, *w, max_hits=max_hits) if max_hits is not None else None
            for tx, got in runs:
                g = tuple(t[torch.from_numpy(sel)] for t in got)
                eq(TL.locate_ragged(tx, *g, max_hits=max_hits), wr, f"ragged {name} {max_hits}")
                if wd is not None:
                    eq(TL.locate(tx, *g, max_hits=max_hits), wd, f"dense {name} {max_hits}")


def test_twin_matches_jax_dense(pair):
    """int32 and int64 lanes.  The JAX package walks a dense index's int32
    lanes only (its loop carry is phi1's int32): the port's int64 lanes give
    the same values, the dense form in int64."""
    dx, tx = pair[:2]
    want, got = _toeholds(pair)
    assert got[0].dtype == torch.int32
    size = (got[1] - got[0] + 1).clamp(min=0)
    widest = int(size.max())
    assert widest == tx.n  # the pad lanes: the whole BWT
    launches = cuda_phi.LAUNCHES

    def eq(g, w, what):
        wide = isinstance(g[0], torch.Tensor) and g[0].dtype == torch.int64
        _eq(g, [np.asarray(x).astype(np.int64) if wide and np.asarray(x).dtype == np.int32
                else x for x in w])

    _held(dx, [(tx, got), (tx, _lanes(got, torch.int64))], want, (3, widest), eq)
    assert cuda_phi.LAUNCHES == launches  # CPU: the twin


def test_twin_matches_jax_big(phi_case):
    from test_torch_bigindex import _eq as eq

    idx, dx, txs, text = phi_case
    qc, lens, q, ln = _batch(idx, _reads_of(text, np.random.default_rng(7)) + [b"", b"AC"])
    want = JL.find_ranges_w_toehold(dx, jnp.asarray(qc), jnp.asarray(lens))
    runs = [(tx, TL.find_ranges_w_toehold(tx, q, ln)) for tx in txs]
    for tx, got in runs:
        assert got[0].dtype == torch.int64
        assert int((got[1] - got[0] + 1).clamp(min=0).max()) == tx.n
    _held(dx, runs, want, (2, 40), eq)


# ---------------------------------------------------------------------------
# the wrapper

def _walk_model(tx, lib_calls, rc):
    """A numpy model of the kernels behind fake C entries: each entry reads
    its operands from the addresses the wrapper passes, walks every lane as
    csrc/phi_walk.cu does (lane t on thread t) and writes out; the kval
    entry runs each warp's 32 lanes as one run of positions, each
    position's lane found by the binary search of the running sums that
    kval_walk_kernel makes; returns rc."""
    def ints(ptr, count, dtype):
        ct = ctypes.c_int64 if dtype == np.int64 else ctypes.c_int32
        return np.ctypeslib.as_array((ct * count).from_address(ptr)) if count else \
            np.zeros(0, dtype)

    def walk(step, n, k, size, off, out, B, threads):
        k, size, off = (ints(p, B, np.int64) for p in (k, size, off))
        flat = ints(out, int((off + size).max(initial=0)), np.int64)
        for b in range(B):
            i = int(k[b])
            for j in range(int(size[b])):
                if j:
                    i = step(i)
                flat[off[b] + j] = i
        return rc

    def phi1(tab, nbytes, n, *lanes):
        lib_calls.append(("phi1", nbytes, n, lanes[-3:-1]))
        t = ints(tab, n, np.int32 if nbytes == 4 else np.int64)
        return walk(lambda i: int(t[min(max(i, 0), n - 1)]), n, *lanes[:-1])

    def rows(rows_ptr, delta_ptr, n, *lanes):
        lib_calls.append(("phi_rows", 16, n, lanes[-3:-1]))
        r = ints(rows_ptr, tx.arrays["phi_rows"].numel(), np.int32).reshape(-1, 16)
        d = ints(delta_ptr, tx.arrays["phi_delta"].numel(), np.int64)

        def step(i):
            blk, off = divmod(i, 480)
            q, low = off >> 5, (1 << ((off & 31) + 1)) - 1
            w = r[blk, 1:].view(np.uint32).astype(np.int64)
            cnt = sum(bin(int(w[j]) & (0xFFFFFFFF if j < q else low if j == q else 0))
                      .count("1") for j in range(15))
            return (i + int(d[max(int(r[blk, 0]) + cnt - 1, 0)])) % n

        return walk(step, n, *lanes[:-1])

    def phi_at(pp_ptr, pp_b, at_ptr, at_b, M, off_ptr, off_b, n_off, shift, iters, n, *lanes):
        lib_calls.append(("phi_at", (pp_b, at_b, off_b, shift, iters), n, lanes[-3:-1]))
        width = {4: np.int32, 8: np.int64}
        pp, at = ints(pp_ptr, M, width[pp_b]), ints(at_ptr, M, width[at_b])
        off = ints(off_ptr, n_off, width[off_b])

        def step(i):
            # csrc/phi_walk.cu PhiAt: the bucketed lower bound of i + 1
            q = i + 1
            b = min(max(q >> shift, 0), n_off - 2)
            lo, hi = int(off[b]), int(off[b + 1])
            for _ in range(iters):
                mid = (lo + hi) >> 1
                take = int(pp[min(max(mid, 0), M - 1)]) < q and lo < hi
                hi = hi if take or lo >= hi else mid
                lo = mid + 1 if take else lo
            rk = lo - 1 if lo >= 1 else lo - 1 + M
            return (int(at[rk]) + i - int(pp[rk])) % n

        return walk(step, n, *lanes[:-1])

    def kval(tab, nbytes, n, hi, size, off, out, B, threads, stream):
        lib_calls.append(("kval", nbytes, n, (B, threads)))
        t = ints(tab, n, np.int32 if nbytes == 4 else np.int64)
        hi, size, off = (ints(p, B, np.int64) for p in (hi, size, off))
        flat = ints(out, int((off + size).max(initial=0)), np.int64)
        for w0 in range(0, B, 32):  # a warp: its 32 lanes, those past B of size 0
            s = np.zeros(32, np.int64)
            s[:min(32, B - w0)] = np.maximum(size[w0:w0 + 32], 0)
            end = np.cumsum(s)
            lanes = np.zeros(32, np.int64)
            lanes[:min(32, B - w0)] = np.arange(w0, min(w0 + 32, B))
            for v in range(int(end[-1])):
                lane = 0
                for step in (16, 8, 4, 2, 1):
                    lane += step if end[lane + step - 1] <= v else 0
                b, j = lanes[lane], v - int(end[lane] - s[lane])
                assert 0 <= j < s[lane]
                flat[off[b] + j] = t[hi[b] - j]
        return rc

    return SimpleNamespace(rbt_phi_walk_phi1=phi1, rbt_phi_walk_rows=rows,
                           rbt_phi_walk_phi_at=phi_at, rbt_phi_walk_kval=kval,
                           rbt_phi_walk_error_string=lambda code: b"invalid argument")


@pytest.fixture
def fake_lib(monkeypatch):
    """The launch path with its C library, stream, SM count and current
    device replaced: CPU tensors reach the (modelled) kernel as a CUDA call's
    would."""
    rec = {"calls": [], "rc": 0}

    def install(tx):
        monkeypatch.setattr(cuda_phi, "_LIB", _walk_model(tx, rec["calls"], rec["rc"]))

    monkeypatch.setattr(cuda_phi, "_raw_stream", lambda dev: 1000 + dev)
    monkeypatch.setattr(cuda_phi, "_sm_count", lambda dev: 2)
    monkeypatch.setattr(cuda_phi.torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(cuda_phi, "LAUNCHES", 0)
    monkeypatch.setattr(cuda_phi, "LAUNCHES_KVAL", 0)
    rec["install"] = install
    return rec


def _walk_args(tx, lo, hi, k, max_hits=None):
    size = torch.clamp(hi - lo + 1, min=0).to(torch.int64)
    if max_hits is not None:
        size = size.clamp(max=max_hits)
    off = torch.cumsum(size, 0) - size
    return k, size, off, torch.full((int(size.sum()),), -7, dtype=torch.int64)


def test_launch_path_walks_like_the_twin_dense(pair, fake_lib):
    tx = pair[1]
    _, got = _toeholds(pair)
    fake_lib["install"](tx)
    for lanes, max_hits in ((torch.int32, None), (torch.int64, 5)):
        k, size, off, out = _walk_args(tx, *_lanes(got, lanes), max_hits)
        want = cuda_phi.phi_walk_plain(tx, k, size, off, out.clone())
        assert cuda_phi.launch_walk(tx, k, size, off, out) is out
        assert torch.equal(out, want) and (out >= 0).all()
    B = got[0].shape[0]
    assert [c[:3] for c in fake_lib["calls"]] == [("phi1", 4, tx.n)] * 2
    assert all(c[3] == (B, cuda_phi.launch_plan(B, 2)) for c in fake_lib["calls"])
    assert cuda_phi.LAUNCHES == 2


def test_launch_path_walks_like_the_twin_big(phi_case, fake_lib):
    """Over the phi rows and over the breakpoint table (its tables' widths
    and pp_bs passed as they are) the modelled launch == the twin."""
    idx, dx, txs, text = phi_case
    _, _, q, ln = _batch(idx, _reads_of(text, np.random.default_rng(7)) + [b""])
    tx = txs[1]
    got = TL.find_ranges_w_toehold(tx, q, ln)
    args = _walk_args(tx, *got)
    fake_lib["install"](tx)
    want = cuda_phi.phi_walk_plain(tx, *args[:3], args[3].clone())
    cuda_phi.launch_walk(tx, *args)
    assert torch.equal(args[3], want)
    route = cuda_phi.walk_route(tx)
    widths = (16 if route == "phi_rows" else
              (8, 8, 8, *tx.pp_bs))  # u32 tables widen to int64 on the device
    assert [c[:3] for c in fake_lib["calls"]] == [(route, widths, tx.n)]
    assert cuda_phi.LAUNCHES == 1


def test_phi_at_model_matches_jax(phi_case, fake_lib):
    """The modelled kernel's walk (through phi_walk on a CUDA-like call,
    locate_ragged and locate) == the JAX package's locate_ragged and locate,
    on the BigIndex with its phi rows withheld (the breakpoint table of a
    panel above 2^31 breakpoints) and with them, at max_hits None and 6."""
    from test_torch_bigindex import _eq as eq

    idx, dx, txs, text = phi_case
    qc, lens, q, ln = _batch(idx, _reads_of(text, np.random.default_rng(9)) + [b"", b"AC"])
    want = JL.find_ranges_w_toehold(dx, jnp.asarray(qc), jnp.asarray(lens))
    tx = txs[1]
    got = TL.find_ranges_w_toehold(tx, q, ln)
    fake_lib["install"](tx)
    real = cuda_phi.phi_walk
    cuda_phi.phi_walk = lambda tx_, k, size, off, out, hi=None: cuda_phi.launch_walk(
        tx_, k, size, off, out, hi)
    try:
        eq(TL.locate_ragged(tx, *got), JL.locate_ragged(dx, *want), "ragged")
        eq(TL.locate(tx, *got, max_hits=6), JL.locate(dx, *want, max_hits=6), "dense")
    finally:
        cuda_phi.phi_walk = real
    assert cuda_phi.LAUNCHES == 2
    assert {c[0] for c in fake_lib["calls"]} == {cuda_phi.walk_route(tx)}


def test_refused_launch_raises_and_counts_nothing(pair, fake_lib):
    tx = pair[1]
    fake_lib["rc"] = 1
    fake_lib["install"](tx)
    _, got = _toeholds(pair)
    with pytest.raises(RuntimeError, match="phi walk kernel launch failed: invalid argument"):
        cuda_phi.launch_walk(tx, *_walk_args(tx, *got, 2))
    assert cuda_phi.LAUNCHES == 0 and len(fake_lib["calls"]) == 1
    # no lanes: the entry launches nothing, and nothing is counted
    fake_lib["rc"] = 0
    fake_lib["install"](tx)
    empty = torch.zeros(0, dtype=torch.int64)
    cuda_phi.launch_walk(tx, empty, empty, empty, empty)
    assert cuda_phi.LAUNCHES == 0


def test_wrapper_refuses_mixed_devices_and_wrong_dtypes(pair):
    tx = pair[1]
    k, size, off, out = _walk_args(tx, *_toeholds(pair)[1], 2)
    meta = torch.empty(out.shape, dtype=torch.int64, device="meta")
    for args, error, match in (
            ((k, size, off, meta), ValueError, "out is on meta"),
            ((k.float(), size, off, out), TypeError, "k must be int32 or int64"),
            ((k, size.int(), off, out), TypeError, "size must be int64"),
            ((k, size, off, out.int()), TypeError, "out must be int64"),
            ((k, size, off[:-1], out), ValueError, "must be \\[B\\]"),
            ((k, size, off, out.view(-1, 1)), ValueError, "out flat")):
        with pytest.raises(error, match=match):
            cuda_phi.launch_walk(tx, *args)
    bad = dict(tx.arrays, phi1=tx.arrays["phi1"].float())
    with pytest.raises(TypeError, match="phi1 must be int32 or int64"):
        cuda_phi.launch_walk(SimpleNamespace(arrays=bad, n=tx.n), k, size, off, out)


@pytest.mark.parametrize("route", ["phi1", "phi_rows", "phi_at", "pred"])
def test_route_is_chosen_by_the_tables(monkeypatch, route):
    """On a CUDA tensor phi_walk launches the kernel on every route: phi1,
    the phi rows, the breakpoint table phi_at and the run-start samples
    alone (the predecessor search); no torch walk runs on the card."""
    tables = {"phi1": ("phi1",), "phi_rows": ("phi_rows", "phi_delta"),
              "phi_at": ("pred_pos", "phi_at", "pp_off"), "pred": ("pred_pos", "pred_to_run")}
    tx = SimpleNamespace(arrays=dict.fromkeys(tables[route]))
    calls = []
    monkeypatch.setattr(cuda_phi, "launch_walk", lambda *a: calls.append("kernel"))
    monkeypatch.setattr(cuda_phi, "phi_walk_plain", lambda *a: calls.append("torch"))
    k = SimpleNamespace(device=SimpleNamespace(type="cuda"), shape=(4,))
    cuda_phi.phi_walk(tx, k, None, None, None)
    assert calls == ["kernel"]
    assert cuda_phi.walk_route(tx) == route
    assert not hasattr(cuda_phi, "LAUNCHES_TORCH")
    with pytest.raises(ValueError, match="no phi walk for device"):
        cuda_phi.phi_walk(tx, SimpleNamespace(device=SimpleNamespace(type="mps")),
                          None, None, None)


@pytest.mark.parametrize("B,sms,threads", [
    (65_536, 132, 256), (16_384, 132, 128), (3_392, 132, 32), (1, 132, 32), (0, 132, 32),
    (33_792, 132, 256), (33_791, 132, 256), (8_448, 132, 64), (8_449, 132, 96),
])
def test_launch_plan(B, sms, threads):
    assert cuda_phi.launch_plan(B, sms) == threads
    assert threads == 256 or -(-B // threads) <= sms


# ---------------------------------------------------------------------------
# the kval route

def _kval_walk(monkeypatch):
    """phi_walk on CPU tensors through the modelled launch (hi passed on)."""
    monkeypatch.setattr(cuda_phi, "phi_walk", lambda tx_, k, size, off, out, hi=None:
                        cuda_phi.launch_walk(tx_, k, size, off, out, hi))


@pytest.mark.parametrize("lanes", [torch.int32, torch.int64])
def test_kval_model_matches_jax_dense(pair, fake_lib, monkeypatch, lanes):
    """The modelled kval kernel through locate_ragged (each lane's hi handed)
    == the JAX package's locate_ragged on the dense pair's toeholds, at
    max_hits None, 1, 3 and the widest range, every lane's walk a kval
    launch (no chain), on every lane and on a permutation of them; warps
    hold lanes of size 0 and a last warp past B."""
    dx, tx = pair[:2]
    want, got = _toeholds(pair)
    got = _lanes(got, lanes)
    size = (got[1] - got[0] + 1).clamp(min=0)
    widest = int(size.max())
    assert (size == 0).any() and got[0].shape[0] % 32
    fake_lib["install"](tx)
    _kval_walk(monkeypatch)
    perm = np.random.default_rng(3).permutation(got[0].shape[0])
    for sel in (np.arange(got[0].shape[0]), perm):
        w = tuple(jnp.asarray(np.asarray(t)[sel]) for t in want)
        g = tuple(t[torch.from_numpy(sel)] for t in got)
        for max_hits in (None, 1, 3, widest):
            _eq(TL.locate_ragged(tx, *g, max_hits=max_hits),
                JL.locate_ragged(dx, *w, max_hits=max_hits))
    assert {c[0] for c in fake_lib["calls"]} == {"kval"}
    assert cuda_phi.LAUNCHES_KVAL == len(fake_lib["calls"]) == 8 and cuda_phi.LAUNCHES == 0
    B = got[0].shape[0]
    assert all(c[1:] == (tx.arrays["kval"].element_size(), tx.n, (B, cuda_phi.launch_plan(B, 2)))
               for c in fake_lib["calls"])


@pytest.mark.parametrize("max_hits", [None, 1, 5])
def test_kval_twin_matches_the_chain(pair, max_hits):
    """kval_walk_plain on the toeholds' hi == phi_walk_plain, the chain over
    phi1 from the toeholds, on every lane."""
    tx = pair[1]
    lo, hi, k = _toeholds(pair)[1]
    k, size, off, out = _walk_args(tx, lo, hi, k, max_hits)
    want = cuda_phi.phi_walk_plain(tx, k, size, off, out.clone())
    got = cuda_phi.kval_walk_plain(tx, hi, size, off, out.clone())
    assert torch.equal(got, want) and (got >= 0).all()


def test_kval_route_needs_hi_and_the_full_sa(monkeypatch):
    """The kval route is walk_route's only where hi is handed and kval holds
    n entries; phi_walk takes the kval twin on the CPU and hands hi on to
    the launch on a CUDA tensor only then, else the chain."""
    n = 10
    full = SimpleNamespace(arrays={"kval": torch.arange(n), "phi1": torch.arange(n)}, n=n)
    part = SimpleNamespace(arrays={"kval": torch.arange(n - 1), "phi1": torch.arange(n)}, n=n)
    bare = SimpleNamespace(arrays={"phi1": torch.arange(n)}, n=n)
    assert cuda_phi.walk_route(full, by_hi=True) == "kval"
    assert cuda_phi.walk_route(full) == "phi1"
    assert cuda_phi.walk_route(part, by_hi=True) == "phi1"
    assert cuda_phi.walk_route(bare, by_hi=True) == "phi1"
    calls = []
    monkeypatch.setattr(cuda_phi, "kval_walk_plain", lambda *a: calls.append("kval"))
    monkeypatch.setattr(cuda_phi, "phi_walk_plain", lambda *a: calls.append("chain"))
    monkeypatch.setattr(cuda_phi, "launch_walk", lambda *a: calls.append(("kernel", len(a))))
    k = torch.zeros(2, dtype=torch.int64)
    for tx, hi, want in ((full, k, "kval"), (full, None, "chain"), (part, k, "chain"),
                         (bare, k, "chain")):
        cuda_phi.phi_walk(tx, k, None, None, None, hi)
        assert calls.pop() == want
    cuda_k = SimpleNamespace(device=SimpleNamespace(type="cuda"), shape=(2,))
    cuda_phi.phi_walk(full, cuda_k, None, None, None, k)
    cuda_phi.phi_walk(full, cuda_k, None, None, None)
    assert calls == [("kernel", 6), ("kernel", 6)]


def test_chain_kept_for_arbitrary_toeholds(pair, fake_lib, monkeypatch):
    """locate with toeholds that are not kval[hi] (whole-BWT ranges from
    random positions, and the real toeholds) walks the chain over phi1 (the
    modelled launch, no kval launch) and equals the JAX package's locate;
    locate_ragged on an index without kval walks the chain though it hands
    hi."""
    dx, tx = pair[:2]
    B = 37
    rng = np.random.default_rng(4)
    k = rng.integers(0, tx.n, B).astype(np.int32)
    lo, hi = np.zeros(B, np.int32), np.full(B, tx.n - 1, np.int32)
    fake_lib["install"](tx)
    _kval_walk(monkeypatch)
    _eq(TL.locate(tx, *(torch.from_numpy(a) for a in (lo, hi, k)), max_hits=9),
        JL.locate(dx, *(jnp.asarray(a) for a in (lo, hi, k)), max_hits=9))
    want, got = _toeholds(pair)
    _eq(TL.locate(tx, *got, max_hits=4), JL.locate(dx, *want, max_hits=4))
    assert {c[0] for c in fake_lib["calls"]} == {"phi1"}
    assert cuda_phi.LAUNCHES == 2 and cuda_phi.LAUNCHES_KVAL == 0
    bare = SimpleNamespace(arrays={k_: v for k_, v in tx.arrays.items() if k_ != "kval"},
                           n=tx.n, R=tx.R)
    fake_lib["calls"].clear()
    _eq(TL.locate_ragged(bare, *got, max_hits=4), JL.locate_ragged(dx, *want, max_hits=4))
    assert [c[0] for c in fake_lib["calls"]] == ["phi1"] and cuda_phi.LAUNCHES_KVAL == 0
