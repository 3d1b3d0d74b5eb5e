"""TorchIndex: the device-resident view of an RbtIndex or a BigIndex.

The counterpart of rowbowt_tpu/engine/device.py:DeviceIndex and of
rowbowt_tpu/bigindex.py:BigIndex.device_index.  Its tensors are the flat
sorted tables of `RbtIndex.device_arrays()` (same names, same dtypes), or the
two-level tables a BigIndex puts on the device, all on one explicit
`device`; the static metadata (sizes, ftab k, window size, the codes of
A/C/G/T, the bucket parameters of the big layout's searches) rides beside
them as plain ints.

Torch's uint32 tensors lack searchsorted and most comparisons, so the u32
tables of the big layout (run starts, samples, breakpoints, bucket
directories) are widened to int64 at load; every value they hold is below
2^32, so each search and gather gives what the JAX package's u32 version
gives.  The dense backend's packed words (`bwt4`, uint32) are kept as int32
bit patterns instead, as the fused rows' words are: 4 bytes a word, not 8.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from rowbowt_tpu_torch.index import RbtIndex


# run starts a bucket of the run-space directory aims at: a bucket of 2^shift
# positions, shift = round(log2(n / R * RUN_SEG)) (bigindex.marker_buckets)
RUN_SEG = 16


def run_directory(run_start: np.ndarray, n: int, shift: int | None = None):
    """(rs_off, (shift, iters)): the bucket directory over the sorted
    run_start that ops/rank.bucketed_lower_bound searches, rs_off[b] the
    first run starting at or after b << shift, n_off = (n >> shift) + 2
    entries (int32 below 2^31 runs, else int64), iters the halvings that
    the fullest bucket needs.  The run of x is bucketed_lower_bound(
    run_start, rs_off, shift, iters, x + 1) - 1.  By default it is
    bigindex.marker_buckets(run_start, n, RUN_SEG); `shift` forces the
    bucket span (62 and above: one bucket, a binary search over every
    run)."""
    from rowbowt_tpu_torch.bigindex import marker_buckets

    rs = np.asarray(run_start)
    R = int(rs.shape[0])
    if shift is None:
        off, (shift, iters) = marker_buckets(rs, n, RUN_SEG)
    else:
        bounds = np.arange((n >> shift) + 2, dtype=np.int64) << shift
        off = np.searchsorted(rs, np.minimum(bounds, np.iinfo(rs.dtype).max).astype(rs.dtype),
                              side="left")
        iters = max(1, int(np.ceil(np.log2(int(np.diff(off).max()) + 1))))
    return np.asarray(off).astype(np.int32 if R < (1 << 31) else np.int64), (shift, iters)


# codes a run record holds: run_start, run_head and occ[0..6) fill its 8
# int32 words
RUN_RECORD_CODES = 6


def takes_run_records(A: int, lane_dtype: torch.dtype) -> bool:
    """Whether the run-space step over an index of A codes with lanes of
    lane_dtype reads the run records (run_records): at most
    RUN_RECORD_CODES codes, and int32 lanes, as a record's words are."""
    return 1 <= A <= RUN_RECORD_CODES and lane_dtype == torch.int32


def run_records(run_start: np.ndarray, run_head: np.ndarray, occ_flat: np.ndarray, A: int):
    """The run records the tables kernels read over the run-space tables of
    an alphabet of at most RUN_RECORD_CODES codes: int32 [R * 8], run r's 8
    words [run_start, run_head, occ[0..A)] zero-padded, so that a run's
    start, code and count of c share one 32-byte sector."""
    R = int(run_start.shape[0])
    if not 1 <= A <= RUN_RECORD_CODES:
        raise ValueError(f"run records hold at most {RUN_RECORD_CODES} codes, not {A}")
    rec = np.zeros((R, 8), np.int32)
    rec[:, 0] = run_start
    rec[:, 1] = run_head
    rec[:, 2:2 + A] = np.asarray(occ_flat).reshape(A, R).T
    return rec.reshape(-1)


# The two-level rows of a big index as the view holds them: each nibble
# layout (the artifact's fb2, its 64-symbol repack fb2_64, the 256-symbol
# fb2_256) becomes bit-plane rows under a key of its own (bit_planes).
PLANE_KEYS = {"fb2_64": "pl2_64", "fb2": "pl2", "fb2_256": "pl2_256"}
PLANE_SYMS = {"fb2_64": 64, "fb2": 128, "fb2_256": 256}
# int32 words of a plane row: 8 checkpoints and three planes of SYMS / 32
# words, each thread's share padded to whole 16-byte parts
PLANE_ROW = {64: 16, 128: 24, 256: 32}
PLANE_CHUNK = 1 << 18  # rows repacked at a time


def plane_columns(syms: int) -> np.ndarray:
    """int64 [3, syms / 32]: the int32 column of plane p's 32-symbol word g
    in a plane row (csrc/lf_rank.cuh Planes).  Thread t of a lane's two
    holds checkpoints 4t..4t+3 (columns 4t..4t+3: checkpoint c at column c)
    and all three planes of symbols [t * syms / 2, (t + 1) * syms / 2):
    its flat word j = p * W + w (W = syms / 64 words a plane) in 16-byte
    part 2 * (1 + j // 4) + t, lane j % 4, the rest of its last part zero."""
    W, G = syms // 64, syms // 32
    col = np.zeros((3, G), np.int64)
    for p in range(3):
        for g in range(G):
            t, w = divmod(g, W)
            j = p * W + w
            col[p, g] = 4 * (2 * (1 + j // 4) + t) + j % 4
    return col


def bit_planes(rows: np.ndarray, syms: int, device) -> torch.Tensor:
    """The bit-plane rows (int32 [nrows, PLANE_ROW[syms]], on `device`) of
    the nibble rows int32 [nrows, 8 + syms / 8] of a two-level table: the 8
    checkpoints as they are, then bit p of symbol 32g + i at bit i of plane
    p's word g (plane_columns).  A code is below 8, so three planes carry
    it; the pad nibble 15 past n becomes 7, which no rank reaches (a rank
    at i < n counts only positions below i, and rank(n, c) is F's).  Torch
    ops, PLANE_CHUNK rows at a time on the device."""
    rows = np.asarray(rows)
    nrows = rows.shape[0]
    if rows.ndim != 2 or rows.shape[1] != 8 + syms // 8 or rows.dtype != np.int32:
        raise ValueError(f"nibble rows of shape {rows.shape} ({rows.dtype}) for {syms} symbols")
    device = torch.device(device)
    out = torch.zeros((nrows, PLANE_ROW[syms]), dtype=torch.int32, device=device)
    col = torch.from_numpy(plane_columns(syms)).to(device)
    for r0 in range(0, nrows, PLANE_CHUNK):
        part = rows[r0:r0 + PLANE_CHUNK]
        part = torch.from_numpy(np.require(part, requirements=["C", "W"])).to(device)
        out[r0:r0 + part.shape[0], :8] = part[:, :8]
        # four nibble words make a 32-symbol word
        w = (part[:, 8:].to(torch.int64) & 0xFFFFFFFF).view(part.shape[0], syms // 32, 4)
        for p in range(3):
            # bit p of each nibble, gathered into one byte a nibble word
            x = (w >> p) & 0x11111111
            x = (x | (x >> 3)) & 0x03030303
            x = (x | (x >> 6)) & 0x000F000F
            x = (x | (x >> 12)) & 0xFF
            word = x[..., 0] | x[..., 1] << 8 | x[..., 2] << 16 | x[..., 3] << 24
            word = word - ((word >> 31) << 32)  # the uint32 bits as an int32
            out[r0:r0 + part.shape[0], col[p]] = word.to(torch.int32)
    return out


def nibbles_of_planes(planes: torch.Tensor, syms: int, n: int) -> torch.Tensor:
    """The nibble rows (int32 [nrows, 8 + syms / 8], on planes' device) whose
    bit_planes are `planes`, nibble 15 at every position from n on: the
    inverse of bit_planes over a table of n positions."""
    nrows = planes.shape[0]
    out = torch.empty((nrows, 8 + syms // 8), dtype=torch.int32, device=planes.device)
    col = torch.from_numpy(plane_columns(syms)).to(planes.device)
    bit = torch.arange(32, device=planes.device)
    for r0 in range(0, nrows, PLANE_CHUNK):
        part = planes[r0:r0 + PLANE_CHUNK]
        m = part.shape[0]
        P = part[:, col].to(torch.int64) & 0xFFFFFFFF  # [m, 3, G]
        sym = sum(((P[:, p, :, None] >> bit) & 1) << p for p in range(3))  # [m, G, 32]
        pos = ((r0 + torch.arange(m, device=planes.device)) * syms)[:, None] + \
            torch.arange(syms, device=planes.device)[None, :]
        sym = torch.where(pos >= n, 15, sym.reshape(m, syms)).view(m, syms // 8, 8)
        word = (sym << (4 * torch.arange(8, device=planes.device))).sum(dim=2)
        out[r0:r0 + m, :8] = part[:, :8]
        out[r0:r0 + m, 8:] = (word - ((word >> 31) << 32)).to(torch.int32)
    return out


@dataclasses.dataclass
class TorchIndex:
    arrays: dict[str, torch.Tensor]
    n: int
    R: int
    A: int
    ma_wsize: int
    ftab_k: int
    acgt_codes: tuple  # index codes of A,C,G,T (-1 entries when absent)
    device: torch.device
    # (shift, iters) of the bucketed lower bounds over the big layout's sorted
    # tables (ops/rank.bucketed_lower_bound): ma_bs for the marker CSR, pp_bs
    # for the phi breakpoint table; () where another table serves
    ma_bs: tuple = ()
    pp_bs: tuple = ()
    # (bucket shift, sd16 rows a probe reads) of the marker run-pack rank
    # (bigindex.marker_run_pack, ops/rank._ms_runs); 0 = no run-pack tables
    ma_rp: tuple | int = 0
    # (shift, iters) of rs_off, the bucket directory over run_start that the
    # run-space step of the tables kernels and the toehold's resolve over ltk
    # search (run_directory); () where no directory was built
    # (with_run_tables)
    rs_bs: tuple = ()
    # (shift, iters) of pred_off, the bucket directory over pred_pos that the
    # walk kernel's predecessor route searches; () where none was built
    # (with_pred_directory)
    pred_bs: tuple = ()
    # host seconds with_run_tables and with_pred_directory took to build
    # rs_off, run_rec and pred_off and put them on the device
    run_tables_s: float = 0.0
    # seconds (host clock, synchronized) and device bytes of the two-level
    # rows' repack into bit planes (bit_planes); 0 where the view has none
    planes_s: float = 0.0
    planes_bytes: int = 0

    @property
    def idx_dtype(self) -> torch.dtype:
        return self.arrays["F"].dtype

    @property
    def has_sa(self) -> bool:
        return "samples_last" in self.arrays

    @property
    def has_ma(self) -> bool:
        return "ma_val" in self.arrays

    @property
    def has_ftab(self) -> bool:
        return "ftab" in self.arrays

    @property
    def has_dense(self) -> bool:
        return "bwt4" in self.arrays

    # run-space tables shadowed by the dense fast paths (the JAX package's
    # DeviceIndex._LEAN_DROP): occ and ltk are A x R each
    _LEAN_DROP = ("occ_flat", "cruns_flat", "cruns_off", "ltk",
                  "pred_pos", "pred_to_run")

    def lean(self) -> "TorchIndex":
        """A view without the run-space rank and toehold tables
        (rowbowt_tpu/engine/device.py DeviceIndex.lean).  Valid when a dense
        LF backend (occ1, fblock, fblock64 or bwt4) plus kval and phi1 cover
        every engine path; keeps run_start and samples_last (R-sized)."""
        assert ("occ1_flat" in self.arrays or "fblock" in self.arrays
                or "fblock64" in self.arrays or "bwt4" in self.arrays)
        arrs = {k: v for k, v in self.arrays.items() if k not in self._LEAN_DROP}
        return dataclasses.replace(self, arrays=arrs)

    def with_run_tables(self, shift: int | None = None, host: dict | None = None
                        ) -> "TorchIndex":
        """This view with the run-space searches' tables: the bucket
        directory rs_off and rs_bs over run_start (run_directory; `shift`
        forces the bucket span), which the tables kernels' run-space step
        and the toehold's resolve over ltk read, and, where the view's LF
        step is the run-space one (ops/rank.lf_step_auto) and
        takes_run_records, the run records `run_rec` (kept where the view
        has them).  `host` holds numpy run_start, run_head and occ_flat
        where the caller has them; else they are read back from the device.
        run_tables_s adds the seconds it took."""
        from rowbowt_tpu_torch.ops import rank as R_

        t = time.perf_counter()

        def table(k):
            return np.asarray(host[k]) if host is not None else self.arrays[k].cpu().numpy()

        off, bs = run_directory(table("run_start"), self.n, shift)
        arrs = dict(self.arrays, rs_off=torch.from_numpy(off).to(self.device))
        if ("run_rec" not in arrs and takes_run_records(self.A, self.idx_dtype)
                and R_.lf_step_auto(self) is R_.lf_step):
            rec = run_records(table("run_start"), table("run_head"), table("occ_flat"), self.A)
            # torch's own allocation: the kernels read a record as two
            # 16-byte vectors of one 32-byte sector
            arrs["run_rec"] = torch.empty(rec.shape, dtype=torch.int32, device=self.device)
            arrs["run_rec"].copy_(torch.from_numpy(rec))
        return dataclasses.replace(self, arrays=arrs, rs_bs=bs,
                                   run_tables_s=self.run_tables_s + time.perf_counter() - t)

    def with_pred_directory(self, shift: int | None = None, host: dict | None = None
                            ) -> "TorchIndex":
        """This view with pred_off and pred_bs, the bucket directory over
        pred_pos (run_directory; `shift` forces the bucket span) that the
        walk kernel's predecessor route searches.  `host` holds a numpy
        pred_pos where the caller has one; else it is read back from the
        device.  run_tables_s adds the seconds it took."""
        t = time.perf_counter()
        pp = np.asarray(host["pred_pos"]) if host is not None else \
            self.arrays["pred_pos"].cpu().numpy()
        off, bs = run_directory(pp, self.n, shift)
        arrs = dict(self.arrays, pred_off=torch.from_numpy(off).to(self.device))
        return dataclasses.replace(self, arrays=arrs, pred_bs=bs,
                                   run_tables_s=self.run_tables_s + time.perf_counter() - t)

    def with_card_tables(self, host: dict | None = None) -> "TorchIndex":
        """This view with the bucket directories a load on a CUDA device
        builds for the kernels: rs_off (with_run_tables) where the LF step
        is the run-space one (ops/rank.lf_step_auto), with the run records,
        or where the toehold resolves over ltk (an index without kval or
        tk1: ops/cuda_lf.toehold_route), alone; pred_off
        (with_pred_directory) where the walk takes the predecessor route
        (ops/cuda_phi.walk_route).  `host` as with_run_tables takes it."""
        from rowbowt_tpu_torch.ops import cuda_lf, cuda_phi
        from rowbowt_tpu_torch.ops import rank as R_

        tx, arr = self, self.arrays
        ltk = "ltk" in arr and "kval" not in arr and cuda_lf.toehold_route(self) == "ltk"
        if "run_start" in arr and (ltk or R_.lf_step_auto(self) is R_.lf_step):
            tx = tx.with_run_tables(host=host)
        if "pred_pos" in arr and cuda_phi.walk_route(self) == "pred":
            tx = tx.with_pred_directory(host=host)
        return tx

    # the tables with_run_tables and with_pred_directory build
    _CARD_TABLES = ("rs_off", "run_rec", "pred_off")

    @property
    def run_tables_bytes(self) -> int:
        """Bytes of rs_off, run_rec and pred_off on the device (0 where not
        built)."""
        return sum(self.arrays[k].numel() * self.arrays[k].element_size()
                   for k in self._CARD_TABLES if k in self.arrays)

    @property
    def directories(self) -> dict:
        """{name: {"shift", "iters", "bytes"}} of the bucket directories
        built (rs_off, pred_off)."""
        return {k: dict(shift=bs[0], iters=bs[1],
                        bytes=self.arrays[k].numel() * self.arrays[k].element_size())
                for k, bs in (("rs_off", self.rs_bs), ("pred_off", self.pred_bs)) if bs}

    @staticmethod
    def from_arrays(arrays: dict[str, np.ndarray], *, n: int, R: int, A: int,
                    ma_wsize: int, ftab_k: int, acgt_codes, device, ma_bs: tuple = (),
                    pp_bs: tuple = (), ma_rp: tuple | int = 0) -> "TorchIndex":
        """Tensors on `device` from numpy leaves, keeping each leaf's dtype
        except uint32, which widens to int64 — e.g. a JAX DeviceIndex's
        `{k: np.asarray(v) for k, v in dx.arrays.items()}` with its ma_bs,
        pp_bs and ma_rp.  The packed words of `bwt4` are the exception: they
        stay 4 bytes, as int32 bit patterns like the fused rows' words, and
        ops/rank.rank_dense masks each nibble after its shift.  The nibble
        rows of a two-level table (fb2_64, fb2, fb2_256) become their bit
        planes under PLANE_KEYS on every device (bit_planes), the only
        layout the two-level readers take.  On a CUDA device the kernels'
        bucket directories are built here, beside the other tables
        (with_card_tables); any of those tables among the leaves is
        dropped."""
        device = torch.device(device)
        tensors = {}
        planes_s, planes_bytes = 0.0, 0
        for k, v in arrays.items():
            if k in TorchIndex._CARD_TABLES:
                continue
            if k in PLANE_KEYS:
                t = time.perf_counter()
                tensors[PLANE_KEYS[k]] = bit_planes(v, PLANE_SYMS[k], device)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                planes_s += time.perf_counter() - t
                planes_bytes += tensors[PLANE_KEYS[k]].numel() * 4
                continue
            v = np.asarray(v)
            if v.dtype == np.uint32:
                v = v.view(np.int32) if k == "bwt4" else v.astype(np.int64)
            tensors[k] = torch.from_numpy(np.require(v, requirements=["C", "W"])).to(device)
        tx = TorchIndex(
            arrays=tensors,
            n=int(n),
            R=int(R),
            A=int(A),
            ma_wsize=int(ma_wsize),
            ftab_k=int(ftab_k),
            acgt_codes=tuple(int(c) for c in acgt_codes),
            device=device,
            ma_bs=tuple(int(x) for x in ma_bs),
            pp_bs=tuple(int(x) for x in pp_bs),
            ma_rp=tuple(int(x) for x in ma_rp) if ma_rp else 0,
            planes_s=planes_s,
            planes_bytes=planes_bytes,
        )
        return tx.with_card_tables(host=arrays) if device.type == "cuda" else tx

    @staticmethod
    def from_index(idx: RbtIndex, device, fb64: bool | None = None) -> "TorchIndex":
        """fb64=None or True repacks the 96B fblock rows into the 64-symbol/64B
        rows (`fblock64`), the count path's default layout; the on-disk
        artifact always stores the 96B rows, so the repack is load-time only.
        fb64=False keeps the 96B rows.  Only one layout is ever resident."""
        arrs_np = dict(idx.device_arrays())
        if fb64 is not False and "fblock" in arrs_np:
            from rowbowt_tpu_torch.construct.build import fblock_to_fb64

            arrs_np["fblock64"] = fblock_to_fb64(arrs_np.pop("fblock"), idx.n)
        acgt_np = idx.alpha.encode(np.frombuffer(b"ACGT", dtype=np.uint8))
        return TorchIndex.from_arrays(
            arrs_np,
            n=idx.n,
            R=idx.R,
            A=idx.A,
            ma_wsize=idx.ma_wsize,
            ftab_k=idx.ftab_k,
            acgt_codes=acgt_np,
            device=device,
        )

    @staticmethod
    def from_big(big, device, fb64: bool = True, with_locate: bool | None = None,
                 with_markers: bool | None = None) -> "TorchIndex":
        """The device view of a BigIndex (bigindex.py), with the tables
        rowbowt_tpu/bigindex.py BigIndex.device_index chooses: count over
        ops/rank.lf_step_fblock2.

        fb64=True (default) repacks 128-symbol fb2 rows to the 64-symbol/64B
        rows (`fb2_64`, disk-cached next to a loaded artifact); fb64=False
        keeps them (`fb2`); 40-lane rows are the 256-symbol layout
        (`fb2_256`) and are never repacked.  The view holds the chosen
        rows as bit planes (from_arrays: PLANE_KEYS, 64, 96 or 128 B a
        row), not as nibbles.  with_locate / with_markers
        (default: whatever the artifact carries) add the O(R) toehold and phi
        tables and the O(M) marker tables: the flag-gated partial load of
        the reference (rowbowt_io.hpp:146-189).  The marker bounds come from
        the run pack, else from the bucketed CSR."""
        from rowbowt_tpu_torch.bigindex import marker_buckets

        if with_locate is None:
            with_locate = big.has_locate
        if with_markers is None:
            with_markers = big.has_markers
        lanes = int(big.fb2.shape[1])
        if fb64 and lanes == 24:
            key, fb = "fb2_64", big._fb2_64()
        else:
            key, fb = {24: "fb2", 40: "fb2_256"}[lanes], big.fb2
        arrs = {key: fb, "fb2_base": big.base, "F": np.asarray(big.F).astype(np.int64)}
        R = 0
        pp_bs = ()
        if with_locate:
            assert big.has_locate, "artifact stores no locate tables"
            R = big.R
            # big_run_start, NOT run_start: the run-space engines (ops/rank.rank)
            # key off "run_start"; the big engines read big_run_start
            arrs["big_run_start"] = big.run_start
            arrs["samples_last"] = big.samples_last
            arrs["cruns_keys"] = big.cruns_keys
            pr, pd = big._phi_pack()
            if pr is not None:
                # bitmap-rank phi: 2 dependent gathers per hop
                arrs["phi_rows"] = pr
                arrs["phi_delta"] = pd
            else:
                arrs["pred_pos"] = big.pred_pos
                arrs["phi_at"] = big.phi_at
                arrs["pp_off"], pp_bs = marker_buckets(np.asarray(big.pred_pos), big.n)
        ma_bs = ()
        ma_rp = 0
        if with_markers:
            assert big.has_markers, "artifact stores no marker tables"
            arrs["ma_val"] = big.ma_val
            rp = big._ma_runpack()
            if rp is not None:
                # run-pack rank: its small tables replace the device ma_row
                arrs["ma_roff"], arrs["ma_sd16"], arrs["ma_rec"], ma_rp = rp
            else:  # degenerate run structure: the bucketed bound serves
                arrs["ma_row"] = big.ma_row
                arrs["ma_off"], ma_bs = marker_buckets(big.ma_row, big.n)
        if big.doc_starts is not None:
            arrs["doc_starts"] = np.asarray(big.doc_starts).astype(np.int64)
        acgt = big.alpha.encode(np.frombuffer(b"ACGT", dtype=np.uint8))
        return TorchIndex.from_arrays(arrs, n=big.n, R=R, A=big.A, ma_wsize=big.ma_wsize,
                                      ftab_k=0, acgt_codes=acgt, device=device,
                                      ma_bs=ma_bs, pp_bs=pp_bs, ma_rp=ma_rp)
