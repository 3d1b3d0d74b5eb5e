"""K1: the count path (ftab start and LF loop) as one hand-written CUDA kernel.

Replaces rowbowt_tpu/ops/pallas_lf.py:find_ranges_pallas and computes what
rowbowt_tpu/engine/count.py:find_ranges computes.  The kernel (csrc/lf.cu,
built with nvcc for sm_90a on first use and bound with ctypes) reads the
row-major [B, L] codes as they are, stages each block's codes in shared
memory, starts each lane from the ftab itself and writes (lo, hi); two
threads share a lane, each loading its share of a rank row's 16-byte parts.
Either row layout works (`fblock64`, the default, or the 96 B `fblock`).
On a big (n >= 2^31) index a kernel of its own (lf_count2_kernel) runs over
the two-level rows (made from `fb2_64`, the default, `fb2` or `fb2_256`),
held as three bit planes a row (engine/device.bit_planes), with int64
lanes, F and base, the row's superblock by a multiplier and a shift
(ops/rank.superblock_magic) and no ftab (C entry rbt_lf_count_fb2): the
counterpart of
rowbowt_tpu/engine/count.py:find_ranges over rowbowt_tpu/ops/rank.py
lf_step_fblock2, which the JAX package runs as XLA gathers.  Given a record
buffer (the entry's `hi_rec`, null otherwise) it also writes each lane's
pre-step hi of every step, the int64 [L, B] step record of a big index's trajectory
toehold (engine/locate._toehold_trajectory), which the JAX package runs as
an XLA fori_loop (rowbowt_tpu/engine/locate.py:120).

`find_ranges` is the wrapper: for CUDA tensors it launches the kernel (and
adds one to LAUNCHES, or to LAUNCHES_FB2 over the two-level rows) or raises;
for CPU tensors it runs `find_ranges_plain`, the torch version over
ops/rank.py (`lf_start`, then `lf_loop_plain`), which is also what the kernel
is held against on the card.  An index without fused-block rows (a
`--no-dense` build, an alphabet of more than 8 codes) takes the tables
kernel instead (csrc/lf.cu lf_tables_kernel, C entry rbt_lf_tables, the
ftab start in the kernel): the same search over the rank tables of the
occ1, dense or run-space step (ops/rank.lf_step_auto's choice,
TABLE_POLICIES), one launch a batch, counted per policy in LAUNCHES_TAB.
The run-space step finds a run through the bucket directory rs_off over
run_start, on two threads a lane, and reads the run records run_rec where
the index has them (engine/device.TorchIndex.with_run_tables, built where
the index is put on a CUDA device); a launch over an index without the
directory raises.  The dense step splits each 64 B block over two threads
a lane and fetches it once where lo and hi + 1 share it; the occ1 step
ranks lo and hi + 1 on two threads a lane, one load each; both read F from
shared memory (an alphabet of at most 16 codes).  The JAX package runs those searches as XLA
loops of rowbowt_tpu/ops/rank.py lf_step_occ1, lf_step_dense and lf_step.

`find_ranges_record` is the record mode's wrapper: for CUDA tensors the
record launch (adding one to LAUNCHES_REC) or an error, never the torch
loop; for CPU tensors `find_ranges_record_plain`, `lf_loop_plain` from
the full range writing its record, which is also what the kernel is held against on the card (each of
its runs adds one to RECORDS_PLAIN).

`find_ranges_toehold` is the wrapper of the toehold launch (C entry
rbt_lf_toehold), the search of `rbt_align -s` on an index built from run
samples alone (no kval: raw, serialized): RowBowt::LF_w_loc, which the JAX
package runs as an XLA fori_loop of ops/rank.py lf_step_w_loc or
lf_step_w_loc_occ1 (rowbowt_tpu/engine/locate.py:50-67).  One launch of K1
from the full range carries each lane's last non-trivial step and the
trivial steps after it, and resolves the toehold from tk1 (where resident)
or ltk after the loop, the run of hi through the bucket directory rs_off
over run_start (engine/device.TorchIndex.with_run_tables, built where an
index that resolves over ltk goes to the card; a launch over ltk without it
raises).  For CUDA tensors over fused rows it launches (adding
one to LAUNCHES_TOE) or raises; over an index without fused rows
(`--no-dense`, an alphabet of more than 8 codes) it launches the tables
kernel's toehold instance (adding one to LAUNCHES_TAB_TOE[policy]) or
raises; for CPU tensors it runs `find_ranges_toehold_plain`, the torch loop
of lf_step_w_loc_occ1 or lf_step_w_loc, which is also what both kernels
are held against on the card.  No wrapper runs a torch loop on the card.
"""

from __future__ import annotations

import ctypes

import torch

from rowbowt_tpu_torch import _native
from rowbowt_tpu_torch.engine.device import PLANE_KEYS, PLANE_ROW, TorchIndex, takes_run_records
from rowbowt_tpu_torch.ops import rank as R
from rowbowt_tpu_torch.ops.cuda_gather import _raw_stream, _sm_count

# kernel launches made by find_ranges since the last reset (a run sets them
# to 0): over the single-level rows, and over the two-level rows
LAUNCHES = 0
LAUNCHES_FB2 = 0
# record launches (the two-level search that writes its step record), and
# runs of its torch twin on any device
LAUNCHES_REC = 0
RECORDS_PLAIN = 0
# toehold launches (the per-step toehold search of an index without kval)
LAUNCHES_TOE = 0
# launches of the tables kernel (an index without fused rows) by rank
# policy: the count search (find_ranges), and the toehold search
# (find_ranges_toehold)
LAUNCHES_TAB = {"runs": 0, "dense": 0, "occ1": 0}
LAUNCHES_TAB_TOE = {"runs": 0, "dense": 0, "occ1": 0}
# the tables kernel's rank policy of each step lf_step_auto may choose
# without fused rows, and its code in csrc/lf.cu (enum Policy)
TABLE_POLICIES = {R.lf_step: "runs", R.lf_step_dense: "dense", R.lf_step_occ1: "occ1"}
_POLICY_CODE = {"runs": 0, "dense": 1, "occ1": 2}


def lane_threads(policy: str) -> int:
    """Threads a lane of the tables kernels over the `policy` tables
    (csrc/lf_tables.cuh lane_threads; the C entry rbt_lane_threads): two for
    the run-space and occ1 steps, whose ranks of lo and hi + 1 take one
    thread each, and kDenseG = 2 for the dense step, each thread holding
    two 16-byte parts of a 64 B block."""
    return {"runs": 2, "dense": 2, "occ1": 2}[policy]


GROUP = 2  # threads per lane (csrc/lf.cu kG): two 16-byte parts of a 64 B row each
LANES_PER_BLOCK = 256  # lanes per block at full batches (PERF.md §6)
MAX_STAGED_BYTES = 47 * 1024  # csrc/lf.cu kMaxStagedBytes

_LIB = None
BUILD_LOG = ""  # nvcc's output (-Xptxas -v register/spill report) of the build

_SYMS_PER_ROW = {"fblock64": 64, "fblock": 128, "fb2_64": 64, "fb2": 128, "fb2_256": 256}


def build():
    """Compile csrc/lf.cu (once per process) and bind its C entry points:
    rbt_lf_count (K1), rbt_lf_count_fb2 (K1 over the two-level rows, with
    the step record when its hi_rec is not null), rbt_lf_toehold (K1 with
    the per-step toehold), rbt_lf_tables (the search over the rank tables of
    an index without fused rows, count or toehold) and rbt_lane_threads
    (the tables steps' threads a lane, which chip_smoke.py holds to
    lane_threads)."""
    global _LIB, BUILD_LOG
    if _LIB is not None:
        return _LIB
    path, BUILD_LOG = _native.build_cuda_library("lf")
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rbt_lf_count.argtypes = [vp, ci, vp, ci, ci, vp, vp, ci, ci, vp, ci, ci, vp, vp,
                                 ci, ci, vp]
    lib.rbt_lf_count_fb2.argtypes = [vp, ci, vp, vp, ctypes.c_uint, ci, ci, ctypes.c_longlong,
                                      vp, vp, ci, ci, vp, vp, vp, ci, ci, vp]
    ll = ctypes.c_longlong
    lib.rbt_lf_toehold.argtypes = [vp, ci, vp, ci, ci, vp, vp, ci, ci, vp, ci, vp, ci, vp, ci,
                                   vp, ci, ll, ci, ci, vp, ci, ci, vp, vp, vp, ci, ci, vp]
    lib.rbt_lf_tables.argtypes = [ci, vp, ci, vp, ci, vp, ci, vp, ci, ll, ci, ci, vp, vp, ll,
                                  ci, vp, ci, ci, ll, vp, vp, ci, ci, vp, ci, ci, ci, vp, ci, vp,
                                  ci, vp, ci, vp, vp, vp, ci, ci, vp]
    lib.rbt_lf_count.restype = ci
    lib.rbt_lf_count_fb2.restype = lib.rbt_lf_toehold.restype = lib.rbt_lf_tables.restype = ci
    lib.rbt_cuda_error_string.argtypes = [ci]
    lib.rbt_cuda_error_string.restype = ctypes.c_char_p
    lib.rbt_lane_threads.argtypes = [ci]
    lib.rbt_lane_threads.restype = ci
    _LIB = lib
    return lib


def staged_stride(L: int) -> int:
    """Shared-memory bytes a lane's codes take (csrc/lf.cu staged_stride): L
    rounded up to whole words, an odd number of them."""
    return ((L + 3) & ~3) | 4


def launch_plan(B: int, L: int, sms: int, group: int = GROUP,
                most: int = LANES_PER_BLOCK) -> tuple[int, bool]:
    """(threads a block, staged) of a K1 launch over B lanes of width L on a
    card of `sms` SMs, `group` threads a lane (lane_threads(policy) for the
    tables kernels).  A block takes `most` lanes (the seeding kernel's
    int64 instances are built for fewer), fewer when the batch is too small
    to give every SM a block, and fewer again when their codes would not
    fit the staging limit; a block holds whole warps.  `staged` is False
    only when not even one warp's lanes fit (L over 1,500 at one thread a
    lane, 3,000 at two): the kernel then reads each code from global
    memory."""
    unit = 32 // group  # lanes of one warp
    lanes = min(most, -(-max(B, 1) // sms))
    fit = MAX_STAGED_BYTES // staged_stride(L)
    lanes = max(unit, min(lanes, fit) // unit * unit)
    return lanes * group, lanes * staged_stride(L) <= MAX_STAGED_BYTES


def lf_start(tx: TorchIndex, qcodes, lengths, use_ftab: bool = True):
    """Per-lane start (lo, hi, startj): the full range at step 0, or the ftab
    range of the read's last k codes at step k (rowbowt_tpu/engine/count.py:
    29-40).  Misses, reads shorter than k and length-0 lanes start full."""
    B, L = qcodes.shape
    dt = tx.idx_dtype
    dev = qcodes.device
    lengths = lengths.to(dt)
    lo = torch.zeros(B, dtype=dt, device=dev)
    hi = torch.full((B,), tx.n - 1, dtype=dt, device=dev)
    startj = torch.zeros(B, dtype=dt, device=dev)
    if use_ftab and tx.has_ftab and L >= tx.ftab_k > 0:
        k = tx.ftab_k
        kc = R.kmer_codes(tx, qcodes[:, L - k:])
        flo, fhi, hit = R.ftab_lookup(tx, kc)
        hit = hit & (lengths >= k)
        lo = torch.where(hit, flo.to(dt), lo)
        hi = torch.where(hit, fhi.to(dt), hi)
        startj = torch.where(hit, k, 0).to(dt)
    return lo, hi, startj


def lf_loop_plain(tx: TorchIndex, qcodes, lengths, lo, hi, startj, hi_rec=None):
    """L lockstep LF steps in torch, with done-masks (engine/count.py:42-56),
    in lo's dtype.  With `hi_rec` ([L, B]) each lane's hi before step j is
    written into hi_rec[j]: the step record of rowbowt_tpu/engine/locate.py
    _toehold_trajectory."""
    B, L = qcodes.shape
    dt = lo.dtype
    lengths = lengths.to(dt)
    done = torch.zeros(B, dtype=torch.bool, device=qcodes.device)
    step = R.lf_step_auto(tx)
    for j in range(L):
        c = qcodes[:, L - 1 - j].to(dt)
        active = (~done) & (j >= startj) & (j < lengths)
        if hi_rec is not None:
            hi_rec[j] = hi
        nlo, nhi = step(tx, lo, hi, c)
        lo = torch.where(active, nlo, lo)
        hi = torch.where(active, nhi, hi)
        done = done | (active & (nlo > nhi))
    return lo, hi


def find_ranges_plain(tx: TorchIndex, qcodes, lengths, use_ftab: bool = True):
    """The plain count path on any device: ftab start, then the torch loop."""
    lo, hi, startj = lf_start(tx, qcodes, lengths, use_ftab)
    return lf_loop_plain(tx, qcodes, lengths, lo, hi, startj)


def find_ranges(tx: TorchIndex, qcodes, lengths, use_ftab: bool = True):
    """(lo, hi) of each lane of the right-aligned [B, L] codes: for CUDA
    tensors K1 when the index has fused-block rows, else the tables kernel
    over its occ1, dense or run-space tables; the plain torch path for CPU
    tensors; an error for any other device."""
    if qcodes.device.type == "cpu":
        return find_ranges_plain(tx, qcodes, lengths, use_ftab)
    if qcodes.device.type != "cuda":
        raise ValueError(f"no LF loop for device {qcodes.device}")
    if row_layout(tx) is not None:
        return launch_k1(tx, qcodes, lengths, use_ftab)
    return launch_tables(tx, qcodes, lengths, use_ftab)


def find_ranges_record_plain(tx: TorchIndex, qcodes, lengths):
    """(lo, hi, hi_rec) of the right-aligned [B, L] codes in torch, on any
    device: lf_loop_plain from the full range in int64, recording each
    lane's hi before every step (hi_rec int64 [L, B]; once a lane's range is
    empty its hi is 0, past its length the final hi)."""
    global RECORDS_PLAIN
    RECORDS_PLAIN += 1
    B, L = qcodes.shape
    dev = qcodes.device
    lo = torch.zeros(B, dtype=torch.int64, device=dev)
    hi = torch.full((B,), tx.n - 1, dtype=torch.int64, device=dev)
    hi_rec = torch.zeros((L, B), dtype=torch.int64, device=dev)
    lo, hi = lf_loop_plain(tx, qcodes, lengths, lo, hi, torch.zeros_like(lo), hi_rec)
    return lo, hi, hi_rec


def find_ranges_record(tx: TorchIndex, qcodes, lengths):
    """(lo, hi, hi_rec) with the step record of every lane: the record
    launch for CUDA tensors (two-level rows only; anything else raises), the
    plain torch loop for CPU tensors, an error for any other device."""
    if qcodes.device.type == "cpu":
        return find_ranges_record_plain(tx, qcodes, lengths)
    if qcodes.device.type != "cuda":
        raise ValueError(f"no LF loop for device {qcodes.device}")
    return launch_k1(tx, qcodes, lengths.to(torch.int32), use_ftab=False, record=True)


def row_layout(tx: TorchIndex) -> str | None:
    """The key of the fused-block rows the LF loop reads, lf_step_auto's
    choice, or None for an index without them (the occ1, dense and run-space
    steps, which the tables kernel takes)."""
    step = R.lf_step_auto(tx)
    if step is R.lf_step_fblock2:
        return R._fb2_key(tx)[0]
    return {R.lf_step_fblock64: "fblock64", R.lf_step_fblock: "fblock"}.get(step)


def _check_types(named, dev, what: str) -> None:
    """Refuse an operand of `named` ((name, tensor, dtypes)) that is not on
    `dev`, the codes' device, or not of one of its dtypes (for `what`)."""
    for name, t, want in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, qcodes on {dev}")
        if t.dtype not in want:
            raise TypeError(f"{name} must be {' or '.join(str(w)[6:] for w in want)} for "
                            f"{what}, got {t.dtype}")


def _packed_acgt(tx: TorchIndex, k: int, ftab) -> int:
    """The codes of A, C, G and T one byte each for an ftab start of k-mers
    (0xFF for a base absent from the alphabet, as the kernels stage -1);
    refuses an ftab that is not [4^k, 2] and contiguous, and codes outside
    [-1, A)."""
    if k > 15 or ftab.shape != (4 ** k, 2) or not ftab.is_contiguous():
        raise ValueError(f"ftab of shape {tuple(ftab.shape)} for k = {k}")
    acgt = 0
    for i, c in enumerate(tx.acgt_codes):
        if not -1 <= c < tx.A:
            raise ValueError(f"ACGT codes {tx.acgt_codes} outside [-1, {tx.A})")
        acgt |= (c & 0xFF) << (8 * i)
    return acgt


def rows_of(tx: TorchIndex, key: str) -> torch.Tensor:
    """The rows K1 reads for row_layout `key`: the single-level rows, or the
    bit planes made from the two-level layout `key` (engine/device.
    PLANE_KEYS)."""
    return tx.arrays[PLANE_KEYS.get(key, key)]


def _check_operands(tx: TorchIndex, key: str, qcodes, lengths, named, lane) -> None:
    """Refuse what a K1 launch over tx's `key` rows does not take: an
    operand of `named` ((name, tensor, dtypes)), the rows, F (of dtype
    `lane`), the codes or the lengths on another device than the codes or
    of another dtype; rows that are not whole, contiguous and 16-byte
    aligned (the bit planes of the two-level layouts 128-byte aligned); an
    alphabet outside 1..8; lengths that are not [B]."""
    fb, F = rows_of(tx, key), tx.arrays["F"]
    _check_types((("table", fb, (torch.int32,)), ("F", F, (lane,)),
                  ("qcodes", qcodes, (torch.int32,)), ("lengths", lengths, (torch.int32,)))
                 + named, qcodes.device, f"{key} rows")
    syms = _SYMS_PER_ROW[key]
    width = PLANE_ROW[syms] if key in PLANE_KEYS else 8 + syms // 8
    align = 128 if key in PLANE_KEYS and fb.device.type == "cuda" else 16
    if fb.dim() != 2 or fb.shape[1] != width:
        raise ValueError(f"{key} rows have shape {tuple(fb.shape)}")
    if not fb.is_contiguous() or fb.data_ptr() % align:
        raise ValueError(f"row table is not contiguous and {align}-byte aligned")
    if not 1 <= tx.A <= 8 or F.numel() < tx.A + 1:
        raise ValueError(f"alphabet of {tx.A} codes; the kernel takes 1..8")
    if lengths.shape != (qcodes.shape[0],):
        raise ValueError(f"lengths must be [B] for qcodes [B, L], got {tuple(lengths.shape)}")


def superblock_args(fb, base) -> tuple[int, int]:
    """(mul, shift) of the two-level rows fb's superblocks (ops/rank.
    superblock_magic of per_blk, the layout's own rows a superblock: twice
    the BigIndex's per_blk for the 64-symbol repack); refuses a base that
    is not [n_sup, 8], contiguous, for 1..rows superblocks."""
    if (base.shape != (base.shape[0], 8) or not base.is_contiguous()
            or not 1 <= base.shape[0] <= fb.shape[0]):
        raise ValueError(f"fb2_base of shape {tuple(base.shape)} for {fb.shape[0]} rows")
    return R.superblock_magic(fb.shape[0] // base.shape[0])


def launch_k1(tx: TorchIndex, qcodes, lengths, use_ftab: bool = True, record: bool = False,
              lib=None):
    """Launch K1 on CUDA tensors, shaped by launch_plan: (lo, hi), or with
    `record` (two-level rows only) (lo, hi, hi_rec) with the int64 [L, B]
    step record.  The rows, codes and lengths are int32 on every layout; F
    (and the ftab) int32 on the single-level rows, F and fb2_base int64 on
    the two-level ones, whose lanes come out int64.  `lib` as launch_tables
    takes it."""
    global LAUNCHES, LAUNCHES_FB2, LAUNCHES_REC
    key = row_layout(tx)
    if key is None:
        raise ValueError("K1 reads fused-block rows; this index has none "
                         "(find_ranges takes the tables kernel for it)")
    two_level = key in R.FB2_KEYS
    if record and not two_level:
        raise ValueError(f"the step record is the two-level search's; {key} rows are "
                         "single-level")
    lane = torch.int64 if two_level else torch.int32
    fb, F = rows_of(tx, key), tx.arrays["F"]
    B, L = qcodes.shape
    dev = qcodes.device
    k = tx.ftab_k if use_ftab and tx.has_ftab and L >= tx.ftab_k > 0 else 0
    if k and two_level:
        raise ValueError(f"{key} rows take no ftab start (big artifacts carry none)")
    ftab = tx.arrays["ftab"] if k else None
    base = tx.arrays["fb2_base"] if two_level else None
    named = (("ftab", ftab, (torch.int32,)),) if k else ()
    if two_level:
        named += (("fb2_base", base, (torch.int64,)),)
    _check_operands(tx, key, qcodes, lengths, named, lane)
    blk = superblock_args(fb, base) if two_level else None
    acgt = _packed_acgt(tx, k, ftab) if k else 0
    F, qcodes, lengths = F.contiguous(), qcodes.contiguous(), lengths.contiguous()
    lo = torch.empty(B, dtype=lane, device=dev)
    hi = torch.empty(B, dtype=lane, device=dev)
    hi_rec = torch.empty((L, B), dtype=lane, device=dev) if record else None
    d = dev.index if dev.index is not None else torch.cuda.current_device()
    threads, staged = launch_plan(B, L, _sm_count(d))
    lib = lib or _LIB or build()
    if two_level:
        entry = lib.rbt_lf_count_fb2
        args = (fb.data_ptr(), _SYMS_PER_ROW[key], F.data_ptr(), base.data_ptr(), *blk,
                tx.A, tx.n, qcodes.data_ptr(), lengths.data_ptr(),
                B, L, lo.data_ptr(), hi.data_ptr(), hi_rec.data_ptr() if record else None,
                threads, int(staged))
    else:
        entry = lib.rbt_lf_count
        args = (fb.data_ptr(), _SYMS_PER_ROW[key], F.data_ptr(), tx.A, tx.n, qcodes.data_ptr(),
                lengths.data_ptr(), B, L, ftab.data_ptr() if k else None, k, acgt,
                lo.data_ptr(), hi.data_ptr(), threads, int(staged))
    if d == torch.cuda.current_device():
        rc = entry(*args, _raw_stream(d))
    else:
        with torch.cuda.device(d):
            rc = entry(*args, _raw_stream(d))
    if rc != 0:
        raise RuntimeError(f"LF kernel launch failed: {lib.rbt_cuda_error_string(rc).decode()}")
    if B and record:
        LAUNCHES_REC += 1
    elif B and two_level:
        LAUNCHES_FB2 += 1
    elif B:
        LAUNCHES += 1
    return (lo, hi, hi_rec) if record else (lo, hi)


def find_ranges_toehold_plain(tx: TorchIndex, qcodes, lengths):
    """(lo, hi, k) of the right-aligned [B, L] codes on an index without
    kval, in torch on any device: the full range and k0 =
    (samples_last[R - 1] + 1) mod n (get_last_run_sample,
    toehold_sa.hpp:97-99), then L lockstep steps of lf_step_w_loc_occ1 (tk1
    resident) or lf_step_w_loc (ltk), the toehold riding along; a failed
    search gives (1, 0, 0) (rowbowt.hpp:177-180).  In the index's lane
    type."""
    step = R.lf_step_w_loc_occ1 if toehold_route(tx) == "tk1" else R.lf_step_w_loc
    B, L = qcodes.shape
    dt = tx.idx_dtype
    dev = qcodes.device
    lengths = lengths.to(dt)
    lo = torch.zeros(B, dtype=dt, device=dev)
    hi = torch.full((B,), tx.n - 1, dtype=dt, device=dev)
    k0 = ((tx.arrays["samples_last"][tx.R - 1] + 1) % tx.n).to(dt)
    k = k0.expand(B).clone()
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for j in range(L):
        c = qcodes[:, L - 1 - j].to(dt)
        active = (~done) & (j < lengths)
        nlo, nhi, nk = step(tx, lo, hi, c, k)
        lo = torch.where(active, nlo, lo)
        hi = torch.where(active, nhi, hi)
        k = torch.where(active, nk, k)
        done = done | (active & (nlo > nhi))
    return lo, hi, torch.where(hi < lo, 0, k)


def find_ranges_toehold(tx: TorchIndex, qcodes, lengths):
    """(lo, hi, k) with the per-step toehold of an index without kval: for
    CUDA tensors the toehold launch over fused rows, else the tables
    kernel's toehold instance; the plain loop for CPU tensors; an error for
    any other device."""
    if qcodes.device.type == "cpu":
        return find_ranges_toehold_plain(tx, qcodes, lengths)
    if qcodes.device.type != "cuda":
        raise ValueError(f"no LF loop for device {qcodes.device}")
    if row_layout(tx) is not None:
        return launch_toehold(tx, qcodes, lengths.to(torch.int32))
    return launch_tables(tx, qcodes, lengths.to(torch.int32), use_ftab=False, toehold=True)


def toehold_route(tx: TorchIndex) -> str:
    """The table the toehold's resolve reads: "tk1" where tk1 is resident
    (lf_step_w_loc_occ1's), else "ltk" (lf_step_w_loc's)."""
    return "tk1" if "tk1_flat" in tx.arrays else "ltk"


def launch_toehold(tx: TorchIndex, qcodes, lengths, lib=None):
    """Launch K1's toehold instance on CUDA tensors, shaped by launch_plan:
    (lo, hi, k), int32 [B] each, over the single-level fused rows from the
    full range (no ftab start).  The rows, F, codes and lengths are int32;
    the toehold's tables (tk1, or ltk, run_start and its directory rs_off,
    and samples_last) int32 or int64 as the index holds them.  `lib` as
    launch_tables takes it."""
    global LAUNCHES_TOE
    key = row_layout(tx)
    if key is None:
        raise ValueError("K1 reads fused-block rows; this index has none "
                         "(find_ranges_toehold takes the tables kernel for it)")
    if key in R.FB2_KEYS:
        raise ValueError(f"the per-step toehold is the single-level search's; {key} rows are "
                         "two-level (a big index's toehold is the trajectory resolve)")
    fb, F = tx.arrays[key], tx.arrays["F"]
    B, L = qcodes.shape
    dev = qcodes.device
    ops = _table_operands(tx, None, toehold=True)
    _check_operands(tx, key, qcodes, lengths,
                    tuple((name, t, (torch.int32, torch.int64)) for name, t in ops.values()),
                    torch.int32)
    F, qcodes, lengths = F.contiguous(), qcodes.contiguous(), lengths.contiguous()
    lo, hi, k = (torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3))

    def ptr(arg):
        t = ops[arg][1] if arg in ops else None
        return (t.data_ptr(), t.element_size()) if t is not None else (None, 0)

    d = dev.index if dev.index is not None else torch.cuda.current_device()
    threads, staged = launch_plan(B, L, _sm_count(d))
    lib = lib or _LIB or build()
    args = (fb.data_ptr(), _SYMS_PER_ROW[key], F.data_ptr(), tx.A, tx.n, qcodes.data_ptr(),
            lengths.data_ptr(), B, L, *ptr("tk1"), *ptr("ltk"), *ptr("run_start"),
            *toe_directory(tx, ops), *ptr("samples_last"), tx.R, lo.data_ptr(), hi.data_ptr(),
            k.data_ptr(), threads, int(staged))
    if d == torch.cuda.current_device():
        rc = lib.rbt_lf_toehold(*args, _raw_stream(d))
    else:
        with torch.cuda.device(d):
            rc = lib.rbt_lf_toehold(*args, _raw_stream(d))
    if rc != 0:
        raise RuntimeError(f"LF kernel launch failed: {lib.rbt_cuda_error_string(rc).decode()}")
    if B:
        LAUNCHES_TOE += 1
    return lo, hi, k


def table_policy(tx: TorchIndex) -> str | None:
    """The rank policy of the tables kernel: "occ1", "dense" or "runs" as
    lf_step_auto chooses among those steps, or None over fused rows."""
    return TABLE_POLICIES.get(R.lf_step_auto(tx))


def _table_operands(tx: TorchIndex, policy: str | None, toehold: bool) -> dict:
    """{argument: (table name, tensor)} of a tables launch: the rank tables
    of `policy` (none for None: a launch over fused rows; for "runs" the
    bucket directory rs_off, and the run records `run_rec` where the index
    has them) and, for the toehold, tk1 (where resident) or ltk, run_start
    and rs_off, and samples_last."""
    n, A, R_ = tx.n, tx.A, tx.R
    arr = tx.arrays
    ltk = toehold and toehold_route(tx) == "ltk"
    if (policy == "runs" or ltk) and len(tx.rs_bs) != 2:
        what = f"the {policy} tables kernel" if policy == "runs" else "the toehold over ltk"
        raise ValueError(f"{what} needs rs_off's (shift, iters); the index has none "
                         "(TorchIndex.with_run_tables builds them)")
    directory = {"run_start": ("run_start", R_), "rs_off": ("rs_off", (n >> tx.rs_bs[0]) + 2)
                 } if policy == "runs" or ltk else {}
    if policy is None:
        ops = {}
    elif policy == "runs":
        ops = {"occ": ("occ_flat", A * R_), **directory, "run_head": ("run_head", R_)}
        if "run_rec" in arr:
            ops["rec"] = ("run_rec", 8 * R_)
    elif policy == "dense":
        nb = arr["bwt4"].numel() // 16 if "bwt4" in arr else 0
        ops = {"occ": ("occ_blk_flat", A * nb), "bwt4": ("bwt4", 16 * nb)}
    else:
        ops = {"occ": ("occ1_flat", A * (n + 1))}
    if toehold:
        if ltk:
            ops.update(ltk=("ltk", A * R_), **directory)
        else:
            ops["tk1"] = ("tk1_flat", A * n)
        ops["samples_last"] = ("samples_last", R_)
    for name, size in ops.values():
        if name not in arr:
            what = f"the {policy} tables kernel" if policy else "the toehold"
            raise ValueError(f"{what} needs {name}; the index has none")
        t = arr[name]
        if t.dim() != 1 or t.numel() != size or not t.is_contiguous():
            raise ValueError(f"{name} of shape {tuple(t.shape)}: need [{size}], contiguous")
    return {key: (name, arr[name]) for key, (name, _) in ops.items()}


def _check_tables(tx: TorchIndex, policy: str, toehold: bool, qcodes, lengths, named,
                  lanes: tuple, what: str) -> dict:
    """Refuse what a launch of `what` over tx's `policy` tables (and, with
    `toehold`, the toehold's) does not take: an alphabet outside 1..16
    (dense and occ1, whose steps read F from shared memory) or 1..254; a
    table missing or misshapen (_table_operands); F
    not of a dtype of `lanes`, the codes, lengths or run records not int32,
    or they, a table or an operand of `named` ((name, tensor, dtypes)) on
    another device than the codes; int32 lanes for n >= 2^31 - 1; lengths
    that are not [B]; a bwt4 that is not 16-byte aligned or holds too few
    blocks; run records over an index that does not take them
    (engine/device.takes_run_records) or not 32-byte aligned.  Returns the
    operands, {argument: (table name, tensor)}."""
    F = tx.arrays["F"]
    amax = 254 if policy == "runs" else 16
    if not 1 <= tx.A <= amax or F.numel() < tx.A + 1:
        raise ValueError(f"alphabet of {tx.A} codes; the {policy} tables take 1..{amax}")
    if F.dtype == torch.int32 and tx.n >= (1 << 31) - 1:
        raise ValueError(f"int32 lanes for n = {tx.n}")
    ops = _table_operands(tx, policy, toehold)
    _check_types((("F", F, lanes), ("qcodes", qcodes, (torch.int32,)),
                  ("lengths", lengths, (torch.int32,)), *named,
                  *((name, t, (torch.int32,) if key in ("bwt4", "rec") else
                     (torch.int32, torch.int64))
                    for key, (name, t) in ops.items())), qcodes.device, what)
    if "rec" in ops and (not takes_run_records(tx.A, F.dtype) or ops["rec"][1].data_ptr() % 32):
        raise ValueError(f"run records over {tx.A} codes with {F.dtype} lanes, or not 32-byte "
                         "aligned")
    if lengths.shape != (qcodes.shape[0],):
        raise ValueError(f"lengths must be [B] for qcodes [B, L], got {tuple(lengths.shape)}")
    bwt4 = ops["bwt4"][1] if policy == "dense" else None
    if bwt4 is not None and (bwt4.data_ptr() % 16 or bwt4.numel() < 16 * -(-tx.n // 128)):
        raise ValueError("bwt4 is not 16-byte aligned or holds fewer blocks than n needs")
    return ops


def toe_directory(tx: TorchIndex, ops: dict) -> tuple:
    """The directory arguments of rbt_lf_toehold and rbt_seed_machine: rs_off
    (a pointer and its width), its entries and (shift, iters), or nulls and
    zeros where the toehold reads tk1 (no rs_off among `ops`)."""
    if "rs_off" not in ops:
        return None, 0, 0, 0, 0
    off = ops["rs_off"][1]
    return off.data_ptr(), off.element_size(), off.numel(), *tx.rs_bs


def table_args(tx: TorchIndex, policy: str, ops: dict) -> tuple:
    """The tables' arguments of rbt_lf_tables and rbt_seed_machine_tables,
    from `policy` to R: the policy's code, occ, run_start, run_head and
    rs_off (each a pointer and its width), rs_off's entries and (shift,
    iters), the run records, bwt4 and its blocks, R."""
    def ptr(key):
        t = ops[key][1] if key in ops else None
        return (t.data_ptr(), t.element_size()) if t is not None else (None, 0)

    off = ops.get("rs_off", (None, None))[1]
    rec = ops.get("rec", (None, None))[1]
    bwt4 = ops.get("bwt4", (None, None))[1]
    return (_POLICY_CODE[policy], *ptr("occ"),
            *ptr("run_start"), *ptr("run_head"), *ptr("rs_off"),
            off.numel() if off is not None else 0, *(tx.rs_bs if off is not None else (0, 0)),
            rec.data_ptr() if rec is not None else None,
            bwt4.data_ptr() if bwt4 is not None else None,
            bwt4.numel() // 16 if bwt4 is not None else 0, tx.R)


def launch_tables(tx: TorchIndex, qcodes, lengths, use_ftab: bool = True,
                  toehold: bool = False, lib=None):
    """Launch the tables kernel (csrc/lf.cu lf_tables_kernel) on CUDA tensors
    over an index without fused rows, shaped by launch_plan at
    lane_threads(policy) threads a lane (two: over the run-space tables,
    through the bucket directory rs_off and the run records where the index
    has them; over the dense blocks; over occ1): (lo, hi), the
    count search from the ftab start where the index has an ftab and
    `use_ftab`; or with `toehold` (lo, hi, k), the per-step toehold search
    from the full range.  Lanes, F and the outputs are in the index's lane
    type (F's dtype, int32 or int64); the codes and lengths int32; each
    table int32 or int64 as the index holds it (`bwt4` int32 bit patterns,
    16-byte aligned; the run records int32, 32-byte aligned).  `lib` is
    the library to launch on, build()'s by default (tools/seed_turns.py
    passes earlier designs' libraries)."""
    policy = table_policy(tx)
    if policy is None:
        raise ValueError("the tables kernel is for an index without fused rows; this one has "
                         f"{row_layout(tx)} rows (K1 takes it)")
    B, L = qcodes.shape
    dev = qcodes.device
    F = tx.arrays["F"]
    lane = F.dtype
    k = tx.ftab_k if use_ftab and not toehold and tx.has_ftab and L >= tx.ftab_k > 0 else 0
    ftab = tx.arrays["ftab"] if k else None
    ops = _check_tables(tx, policy, toehold, qcodes, lengths,
                        (("ftab", ftab, (torch.int32, torch.int64)),) if k else (),
                        (torch.int32, torch.int64), "the tables kernel")
    acgt = _packed_acgt(tx, k, ftab) if k else 0
    F, qcodes, lengths = F.contiguous(), qcodes.contiguous(), lengths.contiguous()
    outs = [torch.empty(B, dtype=lane, device=dev) for _ in range(3 if toehold else 2)]

    def ptr(key):
        t = ftab if key == "ftab" else ops[key][1] if key in ops else None
        return (t.data_ptr(), t.element_size()) if t is not None else (None, 0)

    d = dev.index if dev.index is not None else torch.cuda.current_device()
    threads, staged = launch_plan(B, L, _sm_count(d), group=lane_threads(policy))
    lib = lib or _LIB or build()
    args = (*table_args(tx, policy, ops), F.data_ptr(), F.element_size(), tx.A, tx.n,
            qcodes.data_ptr(), lengths.data_ptr(), B, L, *ptr("ftab"), k, acgt, *ptr("tk1"),
            *ptr("ltk"), *ptr("samples_last"), outs[0].data_ptr(), outs[1].data_ptr(),
            outs[2].data_ptr() if toehold else None, threads, int(staged))
    if d == torch.cuda.current_device():
        rc = lib.rbt_lf_tables(*args, _raw_stream(d))
    else:
        with torch.cuda.device(d):
            rc = lib.rbt_lf_tables(*args, _raw_stream(d))
    if rc != 0:
        raise RuntimeError(f"LF kernel launch failed: {lib.rbt_cuda_error_string(rc).decode()}")
    if B:
        (LAUNCHES_TAB_TOE if toehold else LAUNCHES_TAB)[policy] += 1
    return tuple(outs)
