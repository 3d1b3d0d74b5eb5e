"""The (dp, idx) process mesh of the query engines, on torch.distributed.

The counterpart of rowbowt_tpu/parallel/mesh.py.  Two axes:
  'dp'  — reads are data-parallel across ranks;
  'idx' — for indexes too big for one device, the tables shard along R
          (parallel/sharded.py) or along BWT position
          (parallel/sharded_dense.py); size 1 replicates the index.

A JAX mesh is a grid of devices driven by one program; here it is a grid of
processes, one device each.  Rank r sits at dp = r // n_idx, idx = r % n_idx
(the reshape(n_dp, n_idx) of the JAX file).  Each process holds only its own
dp rows: the engines take this rank's rows and return this rank's results,
and the JAX psum over 'idx' is an all_reduce(SUM) over the rank's idx
subgroup (Mesh.psum_idx).  With the index replicated the engines run as they
are on every rank, with no collective until the results are gathered
(multihost.gather_to_host0), which keeps read order.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass
class Mesh:
    """This process's place in an n_dp x n_idx grid of ranks, its device,
    and the subgroups of its two axes (None where an axis has size 1 or no
    process group runs).  `allreduces` and `allreduce_s` count the idx
    all-reduces this rank made and the host seconds spent in them; with
    `sync` set each one is bracketed by a device synchronize, so that the
    seconds hold the collective and not just its enqueue."""

    n_dp: int
    n_idx: int
    rank: int
    device: torch.device
    idx_group: object = None
    dp_group: object = None
    sync: bool = False
    allreduces: int = 0
    allreduce_s: float = 0.0

    @property
    def dp(self) -> int:
        return self.rank // self.n_idx

    @property
    def idx(self) -> int:
        return self.rank % self.n_idx

    @property
    def shape(self) -> dict:
        return {"dp": self.n_dp, "idx": self.n_idx}

    def psum_idx(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of x over the idx axis (jax.lax.psum(x, "idx")), in x's
        dtype.  all_reduce works IN PLACE: x is overwritten and returned, so
        a caller passes a tensor it does not read again (the owner-pick's
        torch.where result).  Size 1 returns x untouched."""
        if self.n_idx == 1:
            return x
        sync = self.sync and self.device.type == "cuda"
        if sync:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.idx_group)
        if sync:
            torch.cuda.synchronize(self.device)
        self.allreduce_s += time.perf_counter() - t0
        self.allreduces += 1
        return x

    def reset_counts(self) -> None:
        self.allreduces = 0
        self.allreduce_s = 0.0


def _groups(n_dp: int, n_idx: int, rank: int):
    """(idx group, dp group) of `rank`.  Every rank creates every group, in
    the same order, including the groups it is not in: new_group is a
    collective over the whole world, and a rank that skips one leaves the
    others waiting at their first collective."""
    idx_group = dp_group = None
    if n_idx > 1:
        for d in range(n_dp):
            g = dist.new_group([d * n_idx + i for i in range(n_idx)])
            if d == rank // n_idx:
                idx_group = g
    if n_dp > 1:
        for i in range(n_idx):
            g = dist.new_group([d * n_idx + i for d in range(n_dp)])
            if i == rank % n_idx:
                dp_group = g
    return idx_group, dp_group


def make_mesh(device, n_dp: int | None = None, n_idx: int = 1) -> Mesh:
    """The (dp, idx) mesh over every rank of the process group (one rank
    when none runs).  n_dp defaults to world // n_idx; n_dp * n_idx must be
    the world size.  Every rank must call this with the same sizes."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_dp is None:
        n_dp = world // n_idx
    if n_dp < 1 or n_idx < 1 or n_dp * n_idx != world:
        raise ValueError(f"mesh {n_dp} x {n_idx} does not cover a world of {world} ranks")
    idx_group, dp_group = _groups(n_dp, n_idx, rank) if world > 1 else (None, None)
    return Mesh(n_dp=n_dp, n_idx=n_idx, rank=rank, device=torch.device(device),
                idx_group=idx_group, dp_group=dp_group)


def shard_queries(mesh: Mesh, qcodes, lengths):
    """This rank's dp rows of a global [B, L] batch, on the mesh's device
    (B must divide by the dp size)."""
    B = qcodes.shape[0]
    if B % mesh.n_dp:
        raise ValueError(f"batch of {B} rows does not divide over dp = {mesh.n_dp}")
    per = B // mesh.n_dp
    rows = slice(mesh.dp * per, (mesh.dp + 1) * per)
    return (torch.as_tensor(np.ascontiguousarray(qcodes[rows])).to(mesh.device),
            torch.as_tensor(np.ascontiguousarray(lengths[rows])).to(mesh.device))


def replicate_index(mesh: Mesh, idx, fb64: bool | None = None):
    """Every index table on this rank's device: TorchIndex.from_index of an
    RbtIndex, or TorchIndex.from_big of a BigIndex."""
    from rowbowt_tpu_torch.bigindex import BigIndex
    from rowbowt_tpu_torch.engine.device import TorchIndex

    if isinstance(idx, BigIndex):
        return TorchIndex.from_big(idx, mesh.device, fb64=fb64 is not False)
    return TorchIndex.from_index(idx, mesh.device, fb64=fb64)


def pad_batch_to(qcodes: np.ndarray, lengths: np.ndarray, multiple: int):
    """Pad the batch dim so it divides the dp axis (padded lanes have length 0)."""
    B = qcodes.shape[0]
    rem = (-B) % multiple
    if rem == 0:
        return qcodes, lengths, B
    qpad = np.full((rem, qcodes.shape[1]), -1, dtype=qcodes.dtype)
    lpad = np.zeros(rem, dtype=lengths.dtype)
    return (
        np.concatenate([qcodes, qpad]),
        np.concatenate([lengths, lpad]),
        B,
    )
