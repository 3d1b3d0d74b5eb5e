"""The port's mesh layer (rowbowt_tpu_torch.parallel: mesh, multihost,
sharded) == the JAX package's (rowbowt_tpu.parallel), on the CPU.

Build parity: ShardedIndex.build, ShardedDenseIndex.build (and
fb3_from_codes) and BigIndex.sharded_index give the JAX package's tables,
array for array, on conftest's random-text index and its two-level view
(n_sup = 2, locate tables, two markers) as the dry run builds them.

Engine parity: a world of dp x idx port ranks (gloo over localhost, one CPU
process each) runs tools/dryrun_multichip over the same index and seeded
reads, once per (dp, idx) in {(1, 2), (2, 2), (1, 4)}, in a subprocess with
its own timeout, and dumps every gathered buffer to an .npz; the
parametrised tests hold each buffer to the JAX engine's on conftest's
8-device CPU mesh at the same (dp, idx), with tolerance 0 (every output is
an integer).  This file holds the dp-replicated path (all dp x idx ranks
over dp, the index replicated) and the R-sharded engines;
test_torch_sharded_dense.py holds the position-sharded and big layouts.
The dry run itself also holds every sharded output to the single-device
port engines, lane for lane, and fails on a mismatch.

Also: the mesh and multihost helpers in one process without a group."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import rowbowt_tpu.parallel.mesh as JM
import rowbowt_tpu.parallel.sharded as JS
import rowbowt_tpu.parallel.sharded_dense as JSD
from rowbowt_tpu.bigindex import BigIndex as JaxBigIndex
from rowbowt_tpu.engine.batch import encode_batch
from rowbowt_tpu.engine.count import find_ranges as j_find_ranges
from rowbowt_tpu.engine.device import DeviceIndex
from rowbowt_tpu.engine.locate import find_ranges_w_toehold as j_toehold
from rowbowt_tpu.engine.locate import locate as j_locate
from rowbowt_tpu.engine.markers import find_ranges_w_markers as j_markers
from rowbowt_tpu.index import pack_marker as j_pack_marker
from rowbowt_tpu_torch.bigindex import BigIndex
from rowbowt_tpu_torch.index import RbtIndex
from rowbowt_tpu_torch.parallel import mesh as TM
from rowbowt_tpu_torch.parallel import multihost as MH
from rowbowt_tpu_torch.parallel import sharded as TS
from rowbowt_tpu_torch.parallel import sharded_dense as TSD
from rowbowt_tpu_torch.tools import dryrun_multichip as DR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = [(1, 2), (2, 2), (1, 4)]
ENGINE_KEYS = {
    "count": ("lo", "hi"),
    "toehold": ("tlo", "thi", "k"),
    "locate": ("locs", "nocc"),
    "markers": ("mlo", "mhi", "buf", "used", "ovf"),
    "greedy": ("slo", "shi", "sqs", "sqe", "mvals", "mcnt", "ns"),
}


def reads_of(idx, text, n=24, seed=11):
    """(qc, lens) of n reads of 4-47 codes copied from the text, every third
    with one substitution, plus one empty lane; JAX's encode_batch."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    reads = []
    for t in range(n):
        L = int(rng.integers(4, 48))
        p = int(rng.integers(0, len(text) - L))
        r = np.array(text[p:p + L])
        if t % 3 == 0:
            r[int(rng.integers(0, L))] = rng.choice(acgt)
        reads.append(bytes(r))
    reads.append(b"")
    return encode_batch(idx, reads)


def start_world(d, idx, qc, lens, n_dp, n_idx, paths, timeout=240):
    """Start tools/dryrun_multichip on n_dp * n_idx CPU ranks over the
    JAX-saved index and these reads, in the background (the JAX references
    are computed meanwhile); finish_world waits for it."""
    pre = os.path.join(d, "idx")
    idx.save(pre)
    reads = os.path.join(d, "reads.npz")
    np.savez(reads, qc=qc, lens=lens)
    out = os.path.join(d, "out.npz")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "rowbowt_tpu_torch.tools.dryrun_multichip", str(n_dp * n_idx),
         "--n-idx", str(n_idx), "--device", "cpu", "--index", pre, "--reads", reads,
         "--dump", out, "--paths", ",".join(paths), "--timeout", str(timeout)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, out, timeout + 30


def finish_world(started):
    """The started world's gathered buffers by "path/name"."""
    proc, out, timeout = started
    try:
        _, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def jax_dp(idx, qc, lens, world):
    """Path 1 on the JAX mesh (world, 1): reads over dp, index replicated."""
    mesh = JM.make_mesh(n_dp=world, n_idx=1)
    dx = JM.replicate_index(mesh, DeviceIndex.from_index(idx))
    q, ln = JM.shard_queries(mesh, *JM.pad_batch_to(qc, lens, world)[:2])
    lo, hi = j_find_ranges(dx, q, ln)
    tlo, thi, k = j_toehold(dx, q, ln)
    locs, nocc = j_locate(dx, tlo, thi, k, max_hits=DR.MAX_HITS)
    mk = j_markers(dx, q, ln, wsize=DR.WSIZE, max_k=DR.MAX_K)
    names = ("lo", "hi", "tlo", "thi", "k", "locs", "nocc", "mlo", "mhi", "buf", "used", "ovf")
    return {f"dp/{n}": np.asarray(v) for n, v in zip(names, (lo, hi, tlo, thi, k, locs, nocc)
                                                      + tuple(mk))}


def jax_r_sharded(idx, qc, lens, n_dp, n_idx):
    mesh = JM.make_mesh(n_dp=n_dp, n_idx=n_idx)
    sidx = JS.ShardedIndex.build(idx, n_idx=n_idx)
    tables = sidx.device_put(mesh)
    q, ln, _ = JM.pad_batch_to(qc, lens, n_dp)
    lo, hi = JS.find_ranges_sharded(mesh, sidx, tables, q, ln)
    tlo, thi, k = JS.find_ranges_w_toehold_sharded(mesh, sidx, tables, q, ln)
    locs, nocc = JS.locate_sharded(mesh, sidx, tables, tlo, thi, k, max_hits=DR.MAX_HITS)
    names = ("lo", "hi", "tlo", "thi", "k", "locs", "nocc")
    return {f"r_sharded/{n}": np.asarray(v)
            for n, v in zip(names, (lo, hi, tlo, thi, k, locs, nocc))}


def assert_engine(port: dict, want: dict, path: str, engine: str):
    for key in ENGINE_KEYS[engine]:
        name = f"{path}/{key}"
        assert name in port, sorted(port)
        np.testing.assert_array_equal(port[name], want[name], err_msg=name)


@pytest.fixture(scope="module")
def reads(rand_index):
    idx, text = rand_index
    return reads_of(idx, text)


@pytest.fixture(scope="module", params=CONFIGS, ids=[f"dp{d}_idx{i}" for d, i in CONFIGS])
def world(request, rand_index, reads, tmp_path_factory):
    """(port buffers, JAX buffers) of the dp and R-sharded paths at one (dp, idx)."""
    n_dp, n_idx = request.param
    idx, _ = rand_index
    qc, lens = reads
    d = tmp_path_factory.mktemp(f"world_{n_dp}x{n_idx}")
    started = start_world(str(d), idx, qc, lens, n_dp, n_idx, ("dp", "r_sharded"))
    want = jax_dp(idx, qc, lens, n_dp * n_idx)
    want.update(jax_r_sharded(idx, qc, lens, n_dp, n_idx))
    return finish_world(started), want


@pytest.mark.parametrize("engine", ["count", "toehold", "locate", "markers"])
def test_dp_replicated_parity(world, engine):
    port, want = world
    assert_engine(port, want, "dp", engine)


@pytest.mark.parametrize("engine", ["count", "toehold", "locate"])
def test_r_sharded_parity(world, engine):
    port, want = world
    assert_engine(port, want, "r_sharded", engine)


# ---------------- build parity ----------------

def _port_index(idx, tmp_path):
    idx.save(str(tmp_path / "idx"))
    return RbtIndex.load(str(tmp_path / "idx"))


def _assert_fields_equal(got, want, fields):
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, np.ndarray) or isinstance(g, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=f)
            assert np.asarray(g).dtype == np.asarray(w).dtype, f
        else:
            assert g == w, f


@pytest.mark.parametrize("n_idx", [2, 3, 4])
def test_sharded_index_build_parity(rand_index, tmp_path, n_idx):
    idx, _ = rand_index
    got = TS.ShardedIndex.build(_port_index(idx, tmp_path), n_idx)
    want = JS.ShardedIndex.build(idx, n_idx)
    _assert_fields_equal(got, want, [f.name for f in dataclasses.fields(JS.ShardedIndex)])


@pytest.mark.parametrize("n_idx", [2, 3, 4])
def test_sharded_dense_build_parity(rand_index, tmp_path, n_idx):
    idx, _ = rand_index
    got = TSD.ShardedDenseIndex.build(_port_index(idx, tmp_path), n_idx)
    want = JSD.ShardedDenseIndex.build(idx, n_idx)
    _assert_fields_equal(got, want, [f.name for f in dataclasses.fields(JSD.ShardedDenseIndex)])


def test_fb3_from_codes_parity(rand_index):
    """ShardedDenseIndex.fb3_from_codes is construct/build.py's, and gives the
    JAX package's (fb3, base, per_blk)."""
    idx, _ = rand_index
    codes = np.repeat(idx.run_head.astype(np.int64), np.diff(np.append(idx.run_start, idx.n)))
    got = TSD.ShardedDenseIndex.fb3_from_codes(codes, idx.A, 4)
    want = JSD.ShardedDenseIndex.fb3_from_codes(codes, idx.A, 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def jax_big_views(idx, n_idx):
    """The JAX BigIndex views of tools/dryrun_multichip.big_views: the same
    BWT at n_sup = n_idx, its locate tables and two markers; the 256-symbol
    rows taken from the port's from_codes (the JAX one builds 128)."""
    codes = np.repeat(idx.run_head.astype(np.uint8), np.diff(np.append(idx.run_start, idx.n)))
    sa32 = np.asarray(idx.kval).astype(np.uint32)
    out = {}
    for name, block in (("big", 128), ("giant", 256)):
        big = JaxBigIndex.from_codes(codes, idx.alpha, n_sup=n_idx)
        if block != 128:
            port = BigIndex.from_codes(codes, idx.alpha, n_sup=n_idx, block=block)
            big.fb2, big.base, big.per_blk = port.fb2, port.base, port.per_blk
        big.attach_locate(codes, sa32)
        big.attach_markers(sa32, [5, idx.n // 2], [j_pack_marker(0, 5, 1), j_pack_marker(0, 7, 0)],
                           wsize=DR.BIG_WSIZE)
        out[name] = big
    return out


@pytest.mark.parametrize("n_sup", [2, 4])
@pytest.mark.parametrize("view", ["big", "giant"])
def test_big_sharded_index_parity(rand_index, tmp_path, n_sup, view):
    """BigIndex.sharded_index: the same shards, base, replicated big_*
    tables and bucket parameters as the JAX package's."""
    idx, _ = rand_index
    got = DR.big_views(_port_index(idx, tmp_path), n_sup)[view].sharded_index()
    want = jax_big_views(idx, n_sup)[view].sharded_index()
    _assert_fields_equal(got, want, ["fb3", "base", "F", "n", "A", "n_idx", "per_blk", "k0",
                                     "R", "ma_wsize", "ma_bs", "pp_bs", "kval2", "ms2"])
    assert sorted(got.big_tables) == sorted(want.big_tables)
    for k, v in want.big_tables.items():
        np.testing.assert_array_equal(got.big_tables[k], v, err_msg=k)
        assert got.big_tables[k].dtype == v.dtype, k


# ---------------- one process, no group ----------------

def test_pad_batch_to():
    qc = np.arange(10, dtype=np.int32).reshape(5, 2)
    lens = np.full(5, 2, np.int32)
    q, ln, B = TM.pad_batch_to(qc, lens, 4)
    jq, jln, jB = JM.pad_batch_to(qc, lens, 4)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(ln, jln)
    assert B == jB == 5 and q.shape == (8, 2) and (q[5:] == -1).all() and (ln[5:] == 0).all()
    assert TM.pad_batch_to(q, ln, 4)[2] == 8


def test_single_process_mesh_and_helpers(rand_index, reads):
    """Without a process group: a 1 x 1 mesh, every row on this rank, the
    sums over idx and the gathers are the identity, and the backend and
    device defaults."""
    idx, _ = rand_index
    qc, lens = reads
    dev = MH.init(None, 1, 0, device="cpu")
    assert dev == torch.device("cpu") and not torch.distributed.is_initialized()
    mesh = MH.global_mesh(dev)
    assert mesh.shape == {"dp": 1, "idx": 1} and (mesh.dp, mesh.idx) == (0, 0)
    q, ln = TM.shard_queries(mesh, qc, lens)
    np.testing.assert_array_equal(q.numpy(), qc)
    x = torch.arange(4)
    assert mesh.psum_idx(x) is x and mesh.allreduces == 0
    np.testing.assert_array_equal(MH.my_rows(mesh, q, qc.shape[0]), qc)
    np.testing.assert_array_equal(MH.host_batch_to_global(mesh, qc).numpy(), qc)
    assert MH.agree_batch(mesh, qc, 0) == qc.shape[1] and MH.agree_batch(mesh, None, 1) is None
    assert MH.is_host0()
    assert MH.default_backend("cpu") == "gloo" and MH.default_backend("cuda:0") == "nccl"
    assert MH.rank_device("cpu", 3) == torch.device("cpu")
    assert MH.rank_device("cuda:1", 3) == torch.device("cuda", 1)
    with pytest.raises(ValueError, match="does not cover"):
        TM.make_mesh("cpu", n_dp=2, n_idx=1)
    with pytest.raises(ValueError, match="coordinator"):
        MH.init(None, 2, 0, device="cpu")


@pytest.mark.parametrize("layout", ["r_sharded", "pos_sharded"])
def test_single_rank_engines(rand_index, reads, tmp_path, layout):
    """The sharded engines on one rank (n_idx = 1, no collective) give the
    JAX engines' buffers on a 1 x 1 JAX mesh."""
    idx, _ = rand_index
    qc, lens = reads
    pidx = _port_index(idx, tmp_path)
    mesh = TM.make_mesh("cpu")
    q, ln = TM.shard_queries(mesh, qc, lens)
    jmesh = JM.make_mesh(n_dp=1, n_idx=1)
    if layout == "r_sharded":
        sidx = TS.ShardedIndex.build(pidx, 1)
        tb = sidx.device_put(mesh)
        got = TS.find_ranges_w_toehold_sharded(mesh, sidx, tb, q, ln)
        got = got + TS.locate_sharded(mesh, sidx, tb, *got, max_hits=5)
        js = JS.ShardedIndex.build(idx, 1)
        jt = js.device_put(jmesh)
        want = JS.find_ranges_w_toehold_sharded(jmesh, js, jt, qc, lens)
        want = want + JS.locate_sharded(jmesh, js, jt, *want, max_hits=5)
    else:
        sdx = TSD.ShardedDenseIndex.build(pidx, 1)
        tb = sdx.device_put(mesh)
        got = TSD.find_ranges_w_markers_sharded_dense(mesh, sdx, tb, q, ln, wsize=7, max_k=6)
        jd = JSD.ShardedDenseIndex.build(idx, 1)
        jt = jd.device_put(jmesh)
        want = JSD.find_ranges_w_markers_sharded_dense(jmesh, jd, jt, qc, lens, wsize=7, max_k=6)
    assert mesh.allreduces == 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_jax_mesh_has_eight_devices():
    """The JAX references above run on conftest's 8-device CPU mesh."""
    assert len(jax.devices()) == 8
