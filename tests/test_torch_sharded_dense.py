"""The port's position-sharded engines (rowbowt_tpu_torch.parallel.
sharded_dense) == the JAX package's (rowbowt_tpu.parallel.sharded_dense),
on the CPU, buffer for buffer (tolerance 0: every output is an integer).

A world of dp x idx port ranks (gloo over localhost, one CPU process each)
runs tools/dryrun_multichip's position-sharded path (count, toehold, locate,
window markers, greedy seeding) over conftest's random-text index, and its
big path through BigIndex.sharded_index with 128-symbol rows and with
256-symbol rows (count, the trajectory toehold, the breakpoint phi walk,
greedy seeding over the replicated marker CSR), once per (dp, idx) in
{(1, 2), (2, 2), (1, 4)}, in a subprocess with its own timeout; the
parametrised tests hold each gathered buffer to the JAX engine's on
conftest's 8-device CPU mesh at the same (dp, idx) and on the same JAX-built
tables.  Also, in one process: the int64 lane widening of the sharded rank
past 2^31 and the placed row layouts of device_put."""

import numpy as np
import pytest
import torch

import rowbowt_tpu.parallel.mesh as JM
import rowbowt_tpu.parallel.sharded_dense as JSD
from rowbowt_tpu_torch.parallel import mesh as TM
from rowbowt_tpu_torch.parallel import sharded_dense as TSD
from rowbowt_tpu_torch.tools import dryrun_multichip as DR
from test_torch_parallel import (
    CONFIGS, _port_index, assert_engine, finish_world, jax_big_views, start_world,
)

DENSE = ("lo", "hi", "tlo", "thi", "k", "locs", "nocc", "mlo", "mhi", "buf", "used", "ovf",
         "slo", "shi", "sqs", "sqe", "mvals", "mcnt", "ns")
BIG = ("lo", "hi", "tlo", "thi", "k", "locs", "nocc", "slo", "shi", "sqs", "sqe", "mvals",
       "mcnt", "ns")


def jax_sharded(mesh, sdx, qc, lens, wsize, markers: bool):
    """Every position-sharded engine on the JAX mesh, as the dry run calls them."""
    tables = sdx.device_put(mesh)
    lo, hi = JSD.find_ranges_sharded_dense(mesh, sdx, tables, qc, lens)
    tlo, thi, k = JSD.find_ranges_w_toehold_sharded_dense(mesh, sdx, tables, qc, lens)
    locs, nocc = JSD.locate_sharded_dense(mesh, sdx, tables, tlo, thi, k, max_hits=DR.MAX_HITS)
    out = (lo, hi, tlo, thi, k, locs, nocc)
    if markers:
        out += tuple(JSD.find_ranges_w_markers_sharded_dense(mesh, sdx, tables, qc, lens,
                                                             wsize=wsize, max_k=DR.MAX_K))
    out += tuple(JSD.markers_greedy_seeding_sharded_dense(
        mesh, sdx, tables, qc, lens, wsize=wsize, max_range=DR.MAX_RANGE,
        max_seeds=DR.MAX_SEEDS, max_k=DR.MAX_K))
    return [np.asarray(v) for v in out]


@pytest.fixture(scope="module")
def reads(rand_index):
    from test_torch_parallel import reads_of

    idx, text = rand_index
    return reads_of(idx, text)


@pytest.fixture(scope="module", params=CONFIGS, ids=[f"dp{d}_idx{i}" for d, i in CONFIGS])
def world(request, rand_index, reads, tmp_path_factory):
    """(port buffers, JAX buffers) of the position-sharded and big paths."""
    n_dp, n_idx = request.param
    idx, _ = rand_index
    qc, lens = reads
    d = tmp_path_factory.mktemp(f"dense_{n_dp}x{n_idx}")
    started = start_world(str(d), idx, qc, lens, n_dp, n_idx, ("pos_sharded", "big", "giant"))
    mesh = JM.make_mesh(n_dp=n_dp, n_idx=n_idx)
    q, ln, _ = JM.pad_batch_to(qc, lens, n_dp)
    want = {}
    got = jax_sharded(mesh, JSD.ShardedDenseIndex.build(idx, n_idx), q, ln, DR.WSIZE, True)
    want.update({f"pos_sharded/{n}": v for n, v in zip(DENSE, got)})
    for name, big in jax_big_views(idx, n_idx).items():
        got = jax_sharded(mesh, big.sharded_index(), q, ln, DR.BIG_WSIZE, False)
        want.update({f"{name}/{n}": v for n, v in zip(BIG, got)})
    return finish_world(started), want


@pytest.mark.parametrize("engine", ["count", "toehold", "locate", "markers", "greedy"])
def test_pos_sharded_parity(world, engine):
    port, want = world
    assert_engine(port, want, "pos_sharded", engine)


@pytest.mark.parametrize("engine", ["count", "toehold", "locate", "greedy"])
@pytest.mark.parametrize("view", ["big", "giant"])
def test_big_sharded_parity(world, view, engine):
    port, want = world
    assert_engine(port, want, view, engine)


def test_sharded_rank_int64_base(rand_index, tmp_path):
    """Global sharded ranks ride the int64 LANE dtype when the per-shard base
    offsets exceed 2^31 (the 1000G regime): with every base shifted by
    3 * 2^31, the rank is the true count plus the shift, as int64."""
    idx, _ = rand_index
    sdx = TSD.ShardedDenseIndex.build(_port_index(idx, tmp_path), n_idx=1)
    BIG = np.int64(3) << 31
    sdx.base = sdx.base + BIG
    mesh = TM.make_mesh("cpu")
    rank = TSD._mk_rank(mesh, sdx, sdx.device_put(mesh))
    rng = np.random.default_rng(7)
    i = rng.integers(0, idx.n, size=16).astype(np.int64)
    c = rng.integers(0, idx.A, size=16).astype(np.int64)
    got = rank(torch.from_numpy(i), torch.from_numpy(c)).numpy()
    assert got.dtype == np.int64
    codes = np.repeat(idx.run_head.astype(np.int64), np.diff(np.append(idx.run_start, idx.n)))
    want = np.array([int((codes[: i[j]] == c[j]).sum()) + int(BIG) for j in range(16)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fb64", [True, False])
def test_device_put_rows(rand_index, tmp_path, fb64):
    """Each rank's placed rows are its shard of the JAX package's placed
    table: the 64-symbol/64B repack by default, the 96B rows with
    fb64=False."""
    idx, _ = rand_index
    sdx = TSD.ShardedDenseIndex.build(_port_index(idx, tmp_path), n_idx=4)
    jmesh = JM.make_mesh(n_dp=2, n_idx=4)
    want = np.asarray(JSD.ShardedDenseIndex.build(idx, 4).device_put(jmesh, fb64=fb64)["fb3"])
    for s in range(4):
        mesh = TM.Mesh(n_dp=1, n_idx=4, rank=s, device=torch.device("cpu"))
        got = sdx.device_put(mesh, fb64=fb64)["fb3"].numpy()
        np.testing.assert_array_equal(got, want[s])
    assert want.shape[-1] == (16 if fb64 else 24)
