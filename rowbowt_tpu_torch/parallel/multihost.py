"""Multi-process orchestration: N processes, one device each, one process group.

The counterpart of rowbowt_tpu/parallel/multihost.py.  Each process streams
its own read shard (there is no cross-process data path for inputs), the
index is replicated or sharded over the mesh's 'idx' axis, and results come
back in read order:

    from rowbowt_tpu_torch.parallel import multihost as mh
    device = mh.init("host0:1234", num_processes=N, process_id=i,
                     backend="nccl", device="cuda")
    mesh = mh.global_mesh(device, n_idx=1)
    tx = replicate_index(mesh, idx)
    for qc, lens in my_shard_batches:             # this process's reads
        gqc = mh.host_batch_to_global(mesh, qc)   # this rank's dp rows
        glen = mh.host_batch_to_global(mesh, lens)
        lo, hi = find_ranges(tx, gqc, glen)
        mine = mh.my_rows(mesh, lo, qc.shape[0])  # this process's own reads

A torch process holds only its own dp rows, so the global batch (the
processes' local rows concatenated in rank order) is an all-gather followed
by this rank's dp slice, and a result comes back to the host by an
all-gather over the dp axis.  The backend is explicit: NCCL wants one rank
per card; gloo runs several ranks on one card (the engines' all_reduce takes
CUDA tensors there) and every rank on the CPU.  The host gathers move CPU
tensors under gloo, which gathers no CUDA tensor.  Nothing falls back: a
collective that fails or outlasts the process group's timeout raises.
`run_local` starts a world of ranks on this host, each in a fresh process,
around a coordinator store that it hosts itself (`host_store`), so that no
concurrent world can take the store's port between its choice and its use.
"""

from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import os
import pickle
import socket
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0


def default_backend(device) -> str:
    """nccl on a CUDA device, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device, process_id: int) -> torch.device:
    """The device of rank `process_id`: a bare "cuda" is card
    process_id % cards (every rank on card 0 when there is one); a device
    with an index, or the CPU, is taken as it is."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda asked for, but torch.cuda.is_available() is False")
        return torch.device("cuda", process_id % torch.cuda.device_count())
    return dev


def init(coordinator: str | None = None, num_processes: int = 1, process_id: int = 0,
         backend: str | None = None, device="cuda",
         timeout_s: float = DEFAULT_TIMEOUT_S, hosted: bool = False) -> torch.device:
    """init_process_group over tcp://coordinator with a finite timeout, so
    that ranks that disagree raise instead of hanging; returns this rank's
    device.  A single process without a coordinator starts no group (the
    engines then run with no collective); with a coordinator, a world of one
    rank runs a real group of one.  Rank 0 hosts the coordinator's store,
    unless `hosted`: then the store at `coordinator` is the caller's
    (host_store) and every rank joins it as a client."""
    dev = rank_device(device, process_id)
    if backend is None:
        backend = default_backend(dev)
    if num_processes <= 1 and coordinator is None:
        return dev
    if coordinator is None:
        raise ValueError(f"{num_processes} processes need a --coordinator host:port")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    if hosted:
        host, port = coordinator.rsplit(":", 1)
        store = dist.TCPStore(host, int(port), num_processes, False, timeout=timeout)
        dist.init_process_group(backend, store=store, world_size=num_processes,
                                rank=process_id, timeout=timeout)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id, timeout=timeout)
    return dev


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def global_mesh(device, n_idx: int = 1):
    """The (dp, idx) mesh over every rank of the group."""
    from rowbowt_tpu_torch.parallel.mesh import make_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % n_idx:
        raise ValueError(f"--n-idx {n_idx} does not divide a world of {world} ranks")
    return make_mesh(device, n_dp=world // n_idx, n_idx=n_idx)


def _wire(t: torch.Tensor, mesh) -> torch.Tensor:
    """t where the group's gathers take it: on the rank's card under NCCL,
    on the CPU under gloo (bool as uint8)."""
    t = t.to(torch.uint8) if t.dtype == torch.bool else t
    nccl = dist.get_backend() == "nccl"
    return t.to(mesh.device if nccl else "cpu").contiguous()


def all_gather_ints(mesh, values) -> np.ndarray:
    """[world, len(values)]: every rank's ints, in rank order."""
    t = torch.tensor(list(values), dtype=torch.int64)
    if not dist.is_initialized():
        return t.numpy()[None]
    t = _wire(t, mesh)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts).cpu().numpy()


def host_batch_to_global(mesh, local_batch: np.ndarray) -> torch.Tensor:
    """This rank's dp rows of the global batch, on its device.

    Every process passes its OWN local rows; the global batch is their
    concatenation in rank order (jax.make_array_from_process_local_data).
    Processes that pass batches of different shapes raise, naming them."""
    local = torch.from_numpy(np.ascontiguousarray(local_batch))
    if dist.is_initialized():
        shapes = all_gather_ints(mesh, local.shape)
        if (shapes != shapes[0]).any():
            raise ValueError("host_batch_to_global: the processes' local batches differ in "
                             f"shape, by rank {[tuple(s) for s in shapes.tolist()]}; every "
                             "process must pass the same shape")
        t = _wire(local, mesh)
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, t)
        local = torch.cat(parts).to(local.dtype)
    per = local.shape[0] // mesh.n_dp
    return local[mesh.dp * per:(mesh.dp + 1) * per].to(mesh.device)


def gather_to_host0(mesh, local: torch.Tensor) -> np.ndarray:
    """A dp-sharded result gathered to every rank (row order = dp order, so
    = rank order of the global batch); rank 0 writes output, others may
    discard it."""
    if mesh.n_dp == 1:
        return local.cpu().numpy()
    t = _wire(local, mesh)
    parts = [torch.empty_like(t) for _ in range(mesh.n_dp)]
    dist.all_gather(parts, t, group=mesh.dp_group)
    return torch.cat(parts).to(local.dtype).cpu().numpy()


def my_rows(mesh, local: torch.Tensor, rows_per_process: int) -> np.ndarray:
    """This process's slice of a dp-sharded result of a batch built with
    host_batch_to_global (global row order = rank order), so each process
    can emit its OWN shard's output with no exchange of read names."""
    full = gather_to_host0(mesh, local)
    off = (dist.get_rank() if dist.is_initialized() else 0) * rows_per_process
    return full[off: off + rows_per_process]


def is_host0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def agree_batch(mesh, qcodes: np.ndarray | None, step: int) -> int | None:
    """One step of a stream in which every process reads its own shard:
    None once every process has run out of batches, else the code width
    every process pads its batch to (the widest; left padding with -1 keeps
    the codes right-aligned).  Processes that stream different numbers of
    batches, or batches of different lane counts, raise on every rank,
    naming them, instead of leaving a collective waiting."""
    has = qcodes is not None
    B, L = qcodes.shape if has else (0, 0)
    got = all_gather_ints(mesh, (int(has), B, L))
    if (got[:, 0] != got[0, 0]).any():
        done = [r for r in range(got.shape[0]) if not got[r, 0]]
        raise RuntimeError(f"processes {done} ran out of reads at batch {step} while the "
                           "others still stream: every process must stream the same "
                           "number of batches")
    if not has:
        return None
    if (got[:, 1] != B).any():
        raise ValueError(f"batch {step} has {got[:, 1].tolist()} lanes by rank: every "
                         "process must use the same batch size")
    return int(got[:, 2].max())


def free_port() -> int:
    """A port that was free when this returned.  Another process may take it
    before a rank binds it (any outgoing connection can); a world that must
    not race takes its store from host_store instead."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def host_store(host: str = "localhost",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> dist.TCPStore:
    """A world's coordinator store, listening on a port that the OS picks as
    it binds (port 0), so that the port is held from its choice to the
    world's end: no other process can take it.  The ranks join it with
    init(f"{host}:{store.port}", ..., hosted=True) while the caller keeps
    the store."""
    return dist.TCPStore(host, 0, None, True, timeout=datetime.timedelta(seconds=timeout_s),
                         wait_for_workers=False)


def _rank_main(target, coordinator, world, rank, backend, device, args, out_dir, timeout_s):
    dev = init(coordinator, world, rank, backend=backend, device=device, timeout_s=timeout_s,
               hosted=True)
    try:
        res = target(dev, *args)
    finally:
        shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def run_local(target, world: int, *, backend: str | None = None, device="cuda", args=(),
              timeout_s: float = 900.0) -> list:
    """target(device, *args) on `world` fresh processes of this host, ranks
    0..world-1 of one process group over localhost; returns each rank's
    result in rank order.  target is a module-level function (it is
    pickled by import path).  A rank that fails stops the others at once,
    and the whole world is stopped and raises after timeout_s."""
    ctx = multiprocessing.get_context("spawn")
    store = host_store(timeout_s=min(timeout_s, DEFAULT_TIMEOUT_S))
    coordinator = f"localhost:{store.port}"
    with tempfile.TemporaryDirectory(prefix="rbt_ranks_") as out_dir:
        procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                             args=(target, coordinator, world, r, backend, device, args,
                                   out_dir, min(timeout_s, DEFAULT_TIMEOUT_S)))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + timeout_s
            pending = list(procs)
            while pending:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{[p.name for p in pending]} still run after "
                                       f"{timeout_s} s")
                multiprocessing.connection.wait([p.sentinel for p in pending], timeout=left)
                for p in [p for p in pending if not p.is_alive()]:
                    p.join()
                    if p.exitcode != 0:
                        raise RuntimeError(f"{p.name} of {world} exited with code {p.exitcode}")
                    pending.remove(p)
            out = []
            for r in range(world):
                with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
