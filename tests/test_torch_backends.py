"""The M5 backends of rowbowt_tpu_torch.ops.rank (run-space, occ1, dense, the
per-step toehold, the predecessor phi and the ma_row marker bounds) and the
engines over them == the JAX package's, on indexes of the same panel built
the ways rbt_build builds them: --no-dense (run-space), raw with occ1 + tk1,
raw above a patched OCC1_MAX_N (fused rows + ltk), and an alphabet of 13
codes (dense bwt4/occ_blk).  Every output is an integer, so equality is
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rowbowt_tpu.engine import count as JC
from rowbowt_tpu.engine import locate as JL
from rowbowt_tpu.engine import seeds as JS
from rowbowt_tpu.engine.device import DeviceIndex
from rowbowt_tpu.ops import rank as JR
from rowbowt_tpu_torch.construct import build as TB
from rowbowt_tpu_torch.construct import panel as TP
from rowbowt_tpu_torch.construct import rawio as TRAW
from rowbowt_tpu_torch.engine import count as TC
from rowbowt_tpu_torch.engine import locate as TL
from rowbowt_tpu_torch.engine import seeds as TS
from rowbowt_tpu_torch.engine.batch import encode_batch
from rowbowt_tpu_torch.engine.device import TorchIndex
from rowbowt_tpu_torch.io.fastq import read_seqs
from rowbowt_tpu_torch.ops import rank as TR
from test_torch_build import write_inputs

BACKENDS = ["run", "occ1", "fused_ltk", "dense"]
FUSED = ("fblock", "fblock64")


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """{backend: (RbtIndex, reads)}: the panel index the way each backend's
    build makes it."""
    d = tmp_path_factory.mktemp("torch_backends")
    inp = write_inputs(d)
    panel = TP.build_panel(inp["fa"], inp["vcf"])
    full = TB.build_index_from_panel(panel, ftab_k=6)
    ssa = np.empty(full.R, dtype=np.int64)
    ssa[full.pred_to_run] = full.pred_pos
    codes = np.repeat(full.run_head, full.run_lengths()).astype(np.int64)
    bwt = full.alpha.decode(codes)
    raw = dict(ssa=ssa, esa=full.samples_last, doc_names=full.doc_names,
               doc_starts=full.doc_starts, ma_row=full.ma_row, ma_val=full.ma_val, ftab_k=6)
    out = {"run": TB.build_index_from_panel(panel, ftab_k=6, dense=False),
           "occ1": TRAW.build_index_from_bwt(bwt, **raw)}
    saved = TRAW.OCC1_MAX_N
    TRAW.OCC1_MAX_N = 1000
    try:
        out["fused_ltk"] = TRAW.build_index_from_bwt(bwt, **raw)
    finally:
        TRAW.OCC1_MAX_N = saved
    iu_dir = d / "iupac"
    iu_dir.mkdir()
    iu = write_inputs(iu_dir, seed=8, iupac=True)
    out["dense"] = TB.build_index_from_panel(TP.build_panel(iu["fa"], iu["vcf"]), ftab_k=6)
    reads = {k: [s for _, s, _ in read_seqs(inp["fq"]) if len(s) <= 64] for k in out}
    reads["dense"] = [s for _, s, _ in read_seqs(iu["fq"]) if len(s) <= 64]
    return {k: (out[k], reads[k]) for k in out}


def _pair(indexes, backend, drop=()):
    """(JAX DeviceIndex, port TorchIndex, qcodes [B, 64], lengths) with the
    tables in `drop` removed from both; the occ1 backend drops the fused rows
    so that its LF step is occ1's."""
    idx, reads = indexes[backend]
    drop = set(drop) | (set(FUSED) if backend == "occ1" else set())
    dx = DeviceIndex.from_index(idx)
    dx = DeviceIndex({k: v for k, v in dx.arrays.items() if k not in drop}, dx.n, dx.R, dx.A,
                     dx.ma_wsize, dx.ftab_k, dx.acgt_codes)
    tx = TorchIndex.from_index(idx, "cpu")
    tx = TorchIndex({k: v for k, v in tx.arrays.items() if k not in drop}, tx.n, tx.R, tx.A,
                    tx.ma_wsize, tx.ftab_k, tx.acgt_codes, tx.device)
    qc, lens = encode_batch(idx, list(reads) + [b""] * 3, pad_to=64)
    return dx, tx, qc, lens


def _eq(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


def test_backend_tables(indexes):
    """Each backend's index carries the tables that select its route."""
    want = {"run": ("run_start", "ltk"), "occ1": ("occ1_flat", "tk1_flat"),
            "fused_ltk": ("fblock64", "ltk"), "dense": ("bwt4", "occ_blk_flat", "kval")}
    for b, keys in want.items():
        tx = _pair(indexes, b)[1]
        assert all(k in tx.arrays for k in keys), b
        assert "kval" not in tx.arrays or b == "dense"
        step = TR.lf_step_auto(tx)
        assert step is {"run": TR.lf_step, "occ1": TR.lf_step_occ1,
                        "fused_ltk": TR.lf_step_fblock64, "dense": TR.lf_step_dense}[b]
    tx = _pair(indexes, "dense")[1]
    assert tx.has_dense and tx.arrays["bwt4"].dtype == torch.int32 and tx.A == 13


def _lanes(tx, rng, size=2048):
    """Random i in [0, n] and c in [-1, A), with i = 0, i = n and c = -1 lanes."""
    i = rng.integers(0, tx.n + 1, size=size).astype(np.int32)
    c = rng.integers(-1, tx.A, size=size).astype(np.int32)
    i[:32], i[32:64], c[64:96] = 0, tx.n, -1
    return i, c


@pytest.mark.parametrize("backend,fn", [("run", "rank"), ("occ1", "rank_occ1"),
                                        ("dense", "rank_dense")])
def test_rank_matches_jax(indexes, backend, fn):
    dx, tx = _pair(indexes, backend)[:2]
    i, c = _lanes(tx, np.random.default_rng(1))
    want = getattr(JR, fn)(dx, jnp.asarray(i), jnp.asarray(c))
    got = getattr(TR, fn)(tx, torch.from_numpy(i), torch.from_numpy(c))
    _eq([got], [want])
    # and the count itself, from the BWT codes
    idx = indexes[backend][0]
    codes = np.repeat(idx.run_head, idx.run_lengths()).astype(np.int64)
    cum = np.zeros((tx.A, tx.n + 1), np.int64)
    for a in range(tx.A):
        np.cumsum(codes == a, out=cum[a, 1:])
    np.testing.assert_array_equal(got.numpy(), np.where(c < 0, 0, cum[np.maximum(c, 0), i]))


def test_run_of_and_rank_at_run_match_jax(indexes):
    dx, tx = _pair(indexes, "run")[:2]
    i, c = _lanes(tx, np.random.default_rng(2))
    ic = np.minimum(i, tx.n - 1)
    r = TR.run_of(tx, torch.from_numpy(ic))
    _eq([r], [JR.run_of(dx, jnp.asarray(ic))])
    _eq([TR.rank_at_run(tx, torch.from_numpy(i), torch.from_numpy(c), r)],
        [JR.rank_at_run(dx, jnp.asarray(i), jnp.asarray(c), jnp.asarray(r.numpy()))])


def _ranges(tx, idx, rng, size=2048):
    """Random nonempty ranges, the full range (hi + 1 = n), empty (1, 0)
    ranges and ranges whose hi + 1 starts a run."""
    a, b = rng.integers(0, tx.n, size=(2, size))
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    lo[:16], hi[:16] = 0, tx.n - 1
    lo[16:32], hi[16:32] = 1, 0
    starts = idx.run_start[1:]
    hi[32:256] = rng.choice(starts, size=224) - 1
    lo[32:256] = np.maximum(hi[32:256] - rng.integers(0, 5, size=224), 0)
    c = rng.integers(-1, tx.A, size=size)
    k = rng.integers(0, tx.n, size=size)
    k[::7] = 0
    return [x.astype(np.int32) for x in (lo, hi, c, k)]


@pytest.mark.parametrize("backend", BACKENDS)
def test_lf_step_matches_jax(indexes, backend):
    dx, tx = _pair(indexes, backend)[:2]
    lo, hi, c, _ = _ranges(tx, indexes[backend][0], np.random.default_rng(3))
    jstep, tstep = JR.lf_step_auto(dx), TR.lf_step_auto(tx)
    assert tstep.__name__ == jstep.__name__
    want = jstep(dx, *(jnp.asarray(x) for x in (lo, hi, c)))
    got = tstep(tx, *(torch.from_numpy(x) for x in (lo, hi, c)))
    _eq(got, want)
    # every backend's step equals the run-space step on the same index
    for g, w in zip(got, TR.lf_step(tx, *(torch.from_numpy(x) for x in (lo, hi, c)))):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("backend,fn", [("run", "lf_step_w_loc"), ("fused_ltk", "lf_step_w_loc"),
                                        ("occ1", "lf_step_w_loc_occ1")])
def test_lf_step_w_loc_matches_jax(indexes, backend, fn):
    """Including k = 0, hi + 1 at a run start and at n, and empty ranges."""
    dx, tx = _pair(indexes, backend)[:2]
    lo, hi, c, k = _ranges(tx, indexes[backend][0], np.random.default_rng(4))
    want = getattr(JR, fn)(dx, *(jnp.asarray(x) for x in (lo, hi, c, k)))
    got = getattr(TR, fn)(tx, *(torch.from_numpy(x) for x in (lo, hi, c, k)))
    _eq(got, want)
    assert (got[2].numpy() == tx.n - 1).any()  # the k = 0 wrap of a trivial step


@pytest.mark.parametrize("backend", ["run", "fused_ltk"])
def test_phi_and_marker_bounds_without_dense_tables_match_jax(indexes, backend):
    """Predecessor phi (no phi1) at every position, and the ma_row binary
    search (no ma_start1) on random and empty ranges."""
    dx, tx = _pair(indexes, backend, drop=("phi1", "ma_start1"))[:2]
    i = np.arange(tx.n, dtype=np.int32)
    got = TR.phi_step(tx, torch.from_numpy(i))
    _eq([got], [JR.phi_step(dx, jnp.asarray(i))])
    np.testing.assert_array_equal(np.sort(got.numpy()), i)  # phi is a permutation
    lo, hi, _, _ = _ranges(tx, indexes[backend][0], np.random.default_rng(5))
    _eq(TR.markers_bounds(tx, torch.from_numpy(lo), torch.from_numpy(hi)),
        JR.markers_bounds(dx, jnp.asarray(lo), jnp.asarray(hi)))


def _args(qc, lens):
    return (torch.from_numpy(qc), torch.from_numpy(lens)), (jnp.asarray(qc), jnp.asarray(lens))


@pytest.mark.parametrize("backend", BACKENDS)
def test_count_and_toehold_engines_match_jax(indexes, backend):
    """find_ranges (with and without the ftab), find_ranges_w_toehold and
    find_locs; the dense index also without kval (the per-step toehold over
    run-space)."""
    for drop in ((), ("kval",)) if backend == "dense" else ((),):
        dx, tx, qc, lens = _pair(indexes, backend, drop)
        t, j = _args(qc, lens)
        for use_ftab in (True, False):
            _eq(TC.find_ranges(tx, *t, use_ftab=use_ftab),
                JC.find_ranges(dx, *j, use_ftab=use_ftab))
        got = TL.find_ranges_w_toehold(tx, *t)
        _eq(got, JL.find_ranges_w_toehold(dx, *j))
        lo, hi, k = (g.numpy() for g in got)
        assert ((hi >= lo) & (k > 0)).any() and ((hi < lo) & (k == 0)).any()
        _eq(TL.find_locs(tx, *t, max_hits=4), JL.find_locs(dx, *j, max_hits=4))


@pytest.mark.parametrize("backend", BACKENDS)
def test_chkpnts_and_sample_seeds_match_jax(indexes, backend):
    dx, tx, qc, lens = _pair(indexes, backend)
    t, j = _args(qc, lens)
    got = TL.find_ranges_w_toehold_chkpnts(tx, *t, wsize=5)
    _eq(got, JL.find_ranges_w_toehold_chkpnts(dx, *j, wsize=5))
    assert (got[5].numpy() > 1).any()
    got = TS.seeds_greedy_w_sample(tx, *t, min_length=5, max_seeds=4)
    _eq(got, JS.seeds_greedy_w_sample(dx, *j, min_length=5, max_seeds=4))
    assert (got[5].numpy() > 1).any()


@pytest.mark.parametrize("backend", BACKENDS)
def test_marker_seeding_engines_match_jax(indexes, backend):
    """markers_greedy_seeding (with and without the ftab restart) and
    markers_lmem_lanes over each LF backend and marker-bound branch."""
    drop = ("ma_start1",) if backend == "fused_ltk" else ()
    dx, tx, qc, lens = _pair(indexes, backend, drop)
    t, j = _args(qc, lens)
    for use_ftab in (True, False):
        kw = dict(wsize=10, max_seeds=8, max_k=16, use_ftab=use_ftab)
        got = TS.markers_greedy_seeding(tx, *t, **kw)
        _eq(got, JS.markers_greedy_seeding(dx, *j, **kw))
        assert (got[5].numpy() > 0).any()
    kw = dict(wsize=10, max_range=200, max_k=4)
    _eq(TS.markers_lmem_lanes(tx, *t, **kw), JS.markers_lmem_lanes(dx, *j, **kw))


@pytest.mark.parametrize("backend", BACKENDS)
def test_cuda_route_is_chosen_by_the_tables(indexes, monkeypatch, backend):
    """On a CUDA tensor find_ranges launches K1 exactly when the index has
    fused-block rows, and otherwise the tables kernel in the backend's rank
    policy, never the torch loop; the choice is made before any launch
    (K1's wrapper is never entered for an index without rows, and refuses
    one)."""
    from types import SimpleNamespace

    from rowbowt_tpu_torch.ops import cuda_lf

    tx = _pair(indexes, backend)[1]
    calls = []
    monkeypatch.setattr(cuda_lf, "launch_k1", lambda *a, **k: calls.append("k1"))
    monkeypatch.setattr(cuda_lf, "launch_tables", lambda *a, **k: calls.append("tables"))
    monkeypatch.setattr(cuda_lf, "find_ranges_plain", lambda *a, **k: calls.append("torch"))
    q = SimpleNamespace(device=SimpleNamespace(type="cuda"), shape=(4, 8))
    cuda_lf.find_ranges(tx, q, None)
    fused = backend == "fused_ltk"
    assert calls == ["k1" if fused else "tables"]
    assert cuda_lf.table_policy(tx) == {"run": "runs", "occ1": "occ1", "fused_ltk": None,
                                        "dense": "dense"}[backend]
    assert (cuda_lf.row_layout(tx) is None) == (not fused)
    if not fused:
        monkeypatch.undo()
        with pytest.raises(ValueError, match="K1 reads fused-block rows"):
            cuda_lf.launch_k1(tx, torch.zeros((4, 8), dtype=torch.int32),
                              torch.zeros(4, dtype=torch.int32))
