"""Multi-rank dry run of every mesh path, over a synthetic index.

The port's dryrun_multichip(n) (the JAX package's is __graft_entry__.py:64):
on a world of n ranks, one device each, it runs

  1. dp: reads split over all n ranks, the index replicated
     (mesh.replicate_index), the single-device engines on every rank: count
     (K1 on a CUDA device), toehold, locate and window markers;
  2. the R-sharded run tables (parallel/sharded.py) at (n / n_idx, n_idx):
     count, toehold, locate;
  3. the position-sharded layout (parallel/sharded_dense.py) at the same
     mesh: count, toehold, locate, window markers and greedy seeding;
  4. the two-level big layout through BigIndex.sharded_index (n_sup =
     n_idx), with 128-symbol rows and with 256-symbol rows: count, toehold,
     locate, greedy seeding;

and holds every sharded output, lane for lane, to the single-device port
engines on the same lanes (the replicated index, or the BigIndex's own
device view).  Any mismatch raises.

The index is built in the repository from a seeded random panel (three
documents with SNPs and markers), so the run needs no outside data;
--index and --reads take a saved RbtIndex and an .npz of (qc, lens)
instead, and --dump writes every gathered output buffer to an .npz.

    python -m rowbowt_tpu_torch.tools.dryrun_multichip 4 --device cuda
    python -m rowbowt_tpu_torch.tools.dryrun_multichip 4 --device cpu

Started outside a process group it spawns its own n ranks on this host
(gloo by default: several ranks may share one card); with --coordinator,
--num-processes and --process-id it is one rank of a group started by
another launcher (for example one rank per card, --backend nccl).  Rank 0
prints one JSON line with the seconds and all-reduce counts of each path.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

MAX_HITS = 4
WSIZE = 10  # window of the dense paths' markers and greedy seeding
BIG_WSIZE = 4  # marker window of the big layout's two synthetic markers
MAX_K = 8
MAX_SEEDS = 4
MAX_RANGE = 1000


def synthetic_index(seed: int = 0):
    """A reference and two haplotypes of 2,000 bp with 40 SNPs each, markers
    at every site of every document, window WSIZE, the full SA."""
    from rowbowt_tpu_torch.alphabet import SEP_BYTE, TERM_BYTE
    from rowbowt_tpu_torch.construct.build import build_index
    from rowbowt_tpu_torch.construct.panel import Marker

    rng = np.random.default_rng(seed)
    L = 2_000
    ref = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=L)
    sites = np.sort(rng.choice(L, 40, replace=False))
    docs = [ref]
    for _ in range(2):
        hap = ref.copy()
        alt = rng.random(sites.size) < 0.5
        hap[sites[alt]] = np.where(ref[sites[alt]] == ord("A"), ord("C"), ord("A"))
        docs.append(hap)
    parts, starts, markers, pos = [], [], [], 0
    for d, seq in enumerate(docs):
        starts.append(pos)
        markers += [Marker(text_pos=pos + int(p), seq=0, pos=int(p),
                           allele=int(seq[p] != ref[p])) for p in sites]
        parts += [seq, np.full(WSIZE, SEP_BYTE, np.uint8)]
        pos += L + WSIZE
    parts.append(np.array([TERM_BYTE], np.uint8))
    text = np.concatenate(parts)
    idx = build_index(text, markers=markers, doc_starts=np.array(starts, np.int64),
                      doc_names=[f"doc{d}" for d in range(3)], ma_wsize=WSIZE)
    return idx, text


def synthetic_reads(idx, text: np.ndarray, n: int = 64, seed: int = 1):
    """n reads of 12-48 bp: copies of the text, a third with one changed
    base, every eighth random, one empty."""
    from rowbowt_tpu_torch.engine.batch import encode_batch

    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    body = text[:-1]
    reads = []
    for r in range(n):
        m = int(rng.integers(12, 49))
        if r % 8 == 7:
            s = rng.choice(acgt, size=m)
        else:
            p = int(rng.integers(0, body.size - m))
            s = np.array(body[p:p + m])
            s[~np.isin(s, acgt)] = ord("A")
            if r % 3 == 0:
                s[int(rng.integers(0, m))] = rng.choice(acgt)
        reads.append(b"" if r == n - 1 else s.tobytes())
    return encode_batch(idx, reads)


def big_views(idx, n_idx: int) -> dict:
    """The index's BWT as BigIndex directories' tables with n_sup = n_idx:
    128-symbol rows and 256-symbol rows, each with the locate tables and
    two synthetic markers at window BIG_WSIZE (as the JAX dry run builds
    them)."""
    from rowbowt_tpu_torch.bigindex import BigIndex
    from rowbowt_tpu_torch.index import pack_marker

    codes = np.repeat(idx.run_head.astype(np.uint8), idx.run_lengths())
    sa32 = np.asarray(idx.kval).astype(np.uint32)
    out = {}
    for name, block in (("big", 128), ("giant", 256)):
        big = BigIndex.from_codes(codes, idx.alpha, n_sup=n_idx, block=block)
        big.attach_locate(codes, sa32)
        big.attach_markers(sa32, [5, idx.n // 2], [pack_marker(0, 5, 1), pack_marker(0, 7, 0)],
                           wsize=BIG_WSIZE)
        out[name] = big
    return out


def _same(path: str, names, got, want) -> None:
    for name, a, b in zip(names, got, want):
        a, b = a.cpu(), b.cpu()
        if a.shape != b.shape or not bool((a == b).all()):
            raise RuntimeError(f"dryrun {path}: {name} != the single-device engine's")


PATHS = ("dp", "r_sharded", "pos_sharded", "big", "giant")


def run_paths(device, n_idx: int = 2, index: str | None = None, reads: str | None = None,
              dump: str | None = None, paths: tuple = PATHS) -> dict:
    """The named paths (PATHS: 1, 2, 3 and 4 with both row widths) on this
    rank of the running process group (or alone)."""
    import torch
    import torch.distributed as dist

    from rowbowt_tpu_torch.engine.count import find_ranges
    from rowbowt_tpu_torch.engine.device import TorchIndex
    from rowbowt_tpu_torch.engine.locate import find_ranges_w_toehold, locate
    from rowbowt_tpu_torch.engine.markers import find_ranges_w_markers
    from rowbowt_tpu_torch.engine.seeds import markers_greedy_seeding
    from rowbowt_tpu_torch.index import RbtIndex
    from rowbowt_tpu_torch.ops import cuda_lf
    from rowbowt_tpu_torch.parallel import multihost as mh
    from rowbowt_tpu_torch.parallel import sharded as S
    from rowbowt_tpu_torch.parallel import sharded_dense as SD
    from rowbowt_tpu_torch.parallel.mesh import (
        make_mesh, pad_batch_to, replicate_index, shard_queries,
    )

    device = torch.device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    t0 = time.perf_counter()
    if index is None:
        idx, text = synthetic_index()
        qc, lens = synthetic_reads(idx, text)
    else:
        idx = RbtIndex.load(index)
        z = np.load(reads)
        qc, lens = z["qc"], z["lens"]
    want = set(paths)
    if want - set(PATHS):
        raise ValueError(f"unknown paths {sorted(want - set(PATHS))}; known: {PATHS}")
    paths = {"load": {"s": time.perf_counter() - t0}}
    out = {}

    def keep(prefix, mesh, names, tensors):
        for name, t in zip(names, tensors):
            out[f"{prefix}/{name}"] = mh.gather_to_host0(mesh, t)

    def timed(name, mesh, fn):
        if mesh is not None:
            mesh.reset_counts()
        t = time.perf_counter()
        res = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        paths[name] = {"s": time.perf_counter() - t,
                       "allreduces": mesh.allreduces if mesh is not None else 0}
        return res

    # --- path 1: reads split over dp, index replicated
    mesh1 = make_mesh(device, n_dp=world, n_idx=1)
    dx = replicate_index(mesh1, idx)
    if "dp" in want:
        q1, l1 = shard_queries(mesh1, *pad_batch_to(qc, lens, world)[:2])
        launches = cuda_lf.LAUNCHES

        def path1():
            lo, hi = find_ranges(dx, q1, l1)
            tlo, thi, k = find_ranges_w_toehold(dx, q1, l1)
            locs, nocc = locate(dx, tlo, thi, k, max_hits=MAX_HITS)
            mk = find_ranges_w_markers(dx, q1, l1, wsize=WSIZE, max_k=MAX_K)
            return (lo, hi, tlo, thi, k, locs, nocc) + tuple(mk)

        p1 = timed("dp", mesh1, path1)
        if device.type == "cuda" and cuda_lf.LAUNCHES == launches:
            raise RuntimeError(f"dryrun dp: rank {mesh1.rank} launched no K1")
        paths["dp"]["k1_launches"] = cuda_lf.LAUNCHES - launches
        keep("dp", mesh1, ("lo", "hi", "tlo", "thi", "k", "locs", "nocc",
                           "mlo", "mhi", "buf", "used", "ovf"), p1)

    # paths 2-4 need a world to shard over (n_idx = 1 shards nothing)
    sharded = world >= 2 and bool(want - {"dp"})
    if sharded:
        if world % n_idx:
            raise ValueError(f"--n-idx {n_idx} does not divide {world} ranks")
        n_dp = world // n_idx
        mesh = make_mesh(device, n_dp=n_dp, n_idx=n_idx)
        q2, l2, _ = pad_batch_to(qc, lens, n_dp)
        qs, ls = shard_queries(mesh, q2, l2)
        # the single-device engines on this rank's lanes: the references
        rlo, rhi = find_ranges(dx, qs, ls)
        rtlo, rthi, rk = find_ranges_w_toehold(dx, qs, ls)
        rlocs, rnocc = locate(dx, rtlo, rthi, rk, max_hits=MAX_HITS)

    if sharded and "r_sharded" in want:
        # --- path 2: the run tables sharded along R, all-reduces per LF step
        sidx = S.ShardedIndex.build(idx, n_idx=n_idx)
        tables = sidx.device_put(mesh)

        def path2():
            lo, hi = S.find_ranges_sharded(mesh, sidx, tables, qs, ls)
            tlo, thi, k = S.find_ranges_w_toehold_sharded(mesh, sidx, tables, qs, ls)
            locs, nocc = S.locate_sharded(mesh, sidx, tables, tlo, thi, k, max_hits=MAX_HITS)
            return lo, hi, tlo, thi, k, locs, nocc

        p2 = timed("r_sharded", mesh, path2)
        names = ("lo", "hi", "tlo", "thi", "k", "locs", "nocc")
        _same("r_sharded", names, p2, (rlo, rhi, rtlo, rthi, rk, rlocs, rnocc))
        keep("r_sharded", mesh, names, p2)

    if sharded and "pos_sharded" in want:
        # --- path 3: every dense table sharded along BWT position
        rmk = find_ranges_w_markers(dx, qs, ls, wsize=WSIZE, max_k=MAX_K)
        rg = markers_greedy_seeding(dx, qs, ls, wsize=WSIZE, max_range=MAX_RANGE,
                                    max_seeds=MAX_SEEDS, max_k=MAX_K, use_ftab=False)
        sdx = SD.ShardedDenseIndex.build(idx, n_idx=n_idx)
        dtables = sdx.device_put(mesh)

        def path3():
            lo, hi = SD.find_ranges_sharded_dense(mesh, sdx, dtables, qs, ls)
            tlo, thi, k = SD.find_ranges_w_toehold_sharded_dense(mesh, sdx, dtables, qs, ls)
            locs, nocc = SD.locate_sharded_dense(mesh, sdx, dtables, tlo, thi, k,
                                                 max_hits=MAX_HITS)
            mk = SD.find_ranges_w_markers_sharded_dense(mesh, sdx, dtables, qs, ls,
                                                        wsize=WSIZE, max_k=MAX_K)
            g = SD.markers_greedy_seeding_sharded_dense(
                mesh, sdx, dtables, qs, ls, wsize=WSIZE, max_range=MAX_RANGE,
                max_seeds=MAX_SEEDS, max_k=MAX_K)
            return (lo, hi, tlo, thi, k, locs, nocc) + tuple(mk) + tuple(g)

        p3 = timed("pos_sharded", mesh, path3)
        names = ("lo", "hi", "tlo", "thi", "k", "locs", "nocc", "mlo", "mhi", "buf", "used",
                 "ovf", "slo", "shi", "sqs", "sqe", "mvals", "mcnt", "ns")
        _same("pos_sharded", names, p3,
              (rlo, rhi, rtlo, rthi, rk, rlocs, rnocc) + tuple(rmk) + tuple(rg))
        keep("pos_sharded", mesh, names, p3)

    # --- path 4: the two-level big layout, its O(R)/O(M) tables replicated
    for name, big in big_views(idx, n_idx).items() if sharded else ():
        if name in want:
            sbx = big.sharded_index()
            btables = sbx.device_put(mesh)
            bdx = TorchIndex.from_big(big, device)

            def path4():
                lo, hi = SD.find_ranges_sharded_dense(mesh, sbx, btables, qs, ls)
                tlo, thi, k = SD.find_ranges_w_toehold_sharded_dense(mesh, sbx, btables, qs, ls)
                locs, nocc = SD.locate_sharded_dense(mesh, sbx, btables, tlo, thi, k,
                                                     max_hits=MAX_HITS)
                g = SD.markers_greedy_seeding_sharded_dense(
                    mesh, sbx, btables, qs, ls, wsize=BIG_WSIZE, max_range=MAX_RANGE,
                    max_seeds=MAX_SEEDS, max_k=MAX_K)
                return (lo, hi, tlo, thi, k, locs, nocc) + tuple(g)

            p4 = timed(name, mesh, path4)
            blo, bhi = find_ranges(bdx, qs, ls)
            btlo, bthi, bk = find_ranges_w_toehold(bdx, qs, ls)
            blocs, bnocc = locate(bdx, btlo, bthi, bk, max_hits=MAX_HITS)
            bg = markers_greedy_seeding(bdx, qs, ls, wsize=BIG_WSIZE, max_range=MAX_RANGE,
                                        max_seeds=MAX_SEEDS, max_k=MAX_K, use_ftab=False)
            names = ("lo", "hi", "tlo", "thi", "k", "locs", "nocc",
                     "slo", "shi", "sqs", "sqe", "mvals", "mcnt", "ns")
            _same(name, names, p4, (blo, bhi, btlo, bthi, bk, blocs, bnocc) + tuple(bg))
            _same(name, ("lo", "hi"), p4[:2], (rlo, rhi))
            keep(name, mesh, names, p4)

    if dump is not None and mh.is_host0():
        np.savez(dump, **out)
    return {"world": world, "n_idx": n_idx, "device": str(device),
            "backend": dist.get_backend() if dist.is_initialized() else None,
            "n": idx.n, "lanes": int(qc.shape[0]), "paths": paths}


def _rank(device, n_idx, index, reads, dump, paths):
    return run_paths(device, n_idx, index, reads, dump, paths)


def dryrun_multichip(n_devices: int, device="cuda", backend: str = "gloo", n_idx: int = 2,
                     index: str | None = None, reads: str | None = None,
                     dump: str | None = None, paths: tuple = PATHS,
                     timeout_s: float = 900.0) -> list[dict]:
    """Paths 1-4 on n_devices ranks.  Inside a process group of n_devices
    ranks this is the calling rank's share; otherwise n_devices ranks are
    spawned on this host over `backend`.  Returns each rank's summary (this
    rank's alone inside a group)."""
    import torch.distributed as dist

    from rowbowt_tpu_torch.parallel import multihost as mh

    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"dryrun of {n_devices} ranks in a world of "
                             f"{dist.get_world_size()}")
        return [run_paths(device, n_idx, index, reads, dump, paths)]
    return mh.run_local(_rank, n_devices, backend=backend, device=device,
                        args=(n_idx, index, reads, dump, paths), timeout_s=timeout_s)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("n", type=int, nargs="?", default=4, help="ranks (default 4)")
    p.add_argument("--n-idx", type=int, default=2, help="idx size of paths 2-4 (default 2)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                   help="default: gloo when spawning ranks, else nccl on cuda, gloo on cpu")
    p.add_argument("--index", default=None, help="a saved RbtIndex prefix instead of the "
                   "synthetic one (needs --reads)")
    p.add_argument("--reads", default=None, help=".npz with qc [B, L] and lens [B]")
    p.add_argument("--dump", default=None, help="write every gathered output to this .npz")
    p.add_argument("--paths", default=",".join(PATHS),
                   help=f"comma-separated subset of {','.join(PATHS)} (default all)")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--timeout", type=float, default=900.0, help="seconds (default 900)")
    args = p.parse_args(argv)
    if (args.index is None) != (args.reads is None):
        p.error("--index and --reads go together")

    from rowbowt_tpu_torch.parallel import multihost as mh

    paths = tuple(args.paths.split(","))
    if args.coordinator is not None:
        device = mh.init(args.coordinator, args.num_processes or args.n, args.process_id,
                         backend=args.backend, device=args.device)
        try:
            res = dryrun_multichip(args.n, device, n_idx=args.n_idx, index=args.index,
                                   reads=args.reads, dump=args.dump, paths=paths)
        finally:
            mh.shutdown()
        if args.process_id != 0:
            return 0
    else:
        res = dryrun_multichip(args.n, args.device, backend=args.backend or "gloo",
                               n_idx=args.n_idx, index=args.index, reads=args.reads,
                               dump=args.dump, paths=paths, timeout_s=args.timeout)
    print(json.dumps({"dryrun_multichip": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
