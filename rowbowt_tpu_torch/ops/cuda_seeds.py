"""The seeding state machines of rbt_markers and rbt_locs as one hand-written
CUDA kernel, one launch a batch.

csrc/seeds.cu (built with nvcc for sm_90a on first use and bound with
ctypes, as ops/cuda_lf.py binds K1) runs each lane's whole seeding loop: the
greedy machine of markers_greedy_seeding (`rbt_markers`, `-f`,
`--heuristic`), the L-MEM machine of markers_lmem_lanes (`--lmem`) and the
sampled machine of seeds_greedy_w_sample (`rbt_locs`), which the JAX
package runs as XLA fori_loops (rowbowt_tpu/engine/seeds.py:348, :500,
:112-117) and the port's engine/seeds.py as L-step torch loops (its
*_records_plain functions, the kernel's plain twins).  The machine steps on
K1's LF step over fused rows (C entry rbt_seed_machine: single-level rows
with int32 lanes, a big index's two-level rows with int64 lanes), or on the
tables kernel's step over the occ1, dense or run-space tables of an index
without fused rows (C entry rbt_seed_machine_tables, int32 lanes; the
run-space step through the bucket directory rs_off, on two threads a
lane, over the run records where the index has them; the dense and occ1
steps on two threads a lane too).  On an index without kval the sampled
machine also carries the per-step toehold
(RowBowt::LF_w_loc) and writes each seed's toehold.  Greedy's ftab restart
replays the next k codes as the torch loop does; in the greedy and sampled
machines each warp takes the lanes of one strand of rbt_markers -f, and
L-MEM's lanes run in their order (csrc/seeds.cu says why).  The kernel
writes the machines' records; the bulk marker probe, the expansion and the
kval or trajectory toeholds stay torch code (engine/seeds.py).

`launch_machine` launches it on CUDA tensors and adds one to
LAUNCHES_SEED[route], or raises: nothing gives way to a torch loop when the
build or the launch fails, and no wrapper runs a seeding loop in torch on
the card.  The route is the mode over fused rows ("sample_rec" for the
sampled machine with its step record, "sample_toe" with the per-step
toehold), or "<mode>_<policy>" over the tables ("sample_toe_<policy>" with
the per-step toehold).
"""

from __future__ import annotations

import ctypes

import torch

from rowbowt_tpu_torch import _native
from rowbowt_tpu_torch.engine.device import TorchIndex
from rowbowt_tpu_torch.ops import cuda_lf
from rowbowt_tpu_torch.ops import rank as R
from rowbowt_tpu_torch.ops.cuda_gather import _raw_stream, _sm_count

# kernel launches since the last reset (a run sets them to 0), by route:
# the machine over fused rows ("sample_rec": with the step record of a big
# index; "sample_toe": with the per-step toehold), and over the tables of
# each rank policy
LAUNCHES_SEED = dict.fromkeys(
    ("greedy", "lmem", "sample", "sample_rec", "sample_toe")
    + tuple(f"{m}_{p}" for p in ("runs", "dense", "occ1")
            for m in ("greedy", "lmem", "sample", "sample_toe")), 0)
MODES = {"greedy": 0, "lmem": 1, "sample": 2}  # csrc/seeds.cu enum Mode
# lanes a block at most, by lane type: csrc/seeds.cu Bounds builds the int32
# instances for 512 threads a block and the int64 ones for 256
BLOCK_LANES = {torch.int32: cuda_lf.LANES_PER_BLOCK, torch.int64: cuda_lf.LANES_PER_BLOCK // 2}

_LIB = None
BUILD_LOG = ""  # nvcc's output (-Xptxas -v register/spill report) of the build


def build():
    """Compile csrc/seeds.cu (once per process) and bind its C entries
    rbt_seed_machine (fused rows) and rbt_seed_machine_tables (the tables of
    an index without them)."""
    global _LIB, BUILD_LOG
    if _LIB is not None:
        return _LIB
    path, BUILD_LOG = _native.build_cuda_library("seeds")
    lib = ctypes.CDLL(path)
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # tk1, ltk, run_start, rs_off with n_off, shift and iters, samples_last, R, ssamp
    toe = [vp, ci, vp, ci, vp, ci, vp, ci, ll, ci, ci, vp, ci, ci, vp]
    lib.rbt_seed_machine.argtypes = ([ci, vp, ci, vp, vp, ctypes.c_uint, ci, ci, ll, ci, vp, vp,
                                      ci, ci, vp, ci, ci, ci, ci, ll, ci, ci, vp, vp, vp, vp, ci,
                                      vp, vp, vp, vp, vp, vp] + toe + [ci, ci, vp])
    lib.rbt_seed_machine_tables.argtypes = [
        ci, ci, vp, ci, vp, ci, vp, ci, vp, ci, ll, ci, ci, vp, vp, ll, ci, vp, ci, ll, vp, vp,
        ci, ci, vp, ci, ci, ci, ci, ll, ci, ci, vp, vp, vp, vp, ci, vp, vp, vp, vp, vp, vp, ci, vp,
        ci, vp, ci, vp, ci, ci, vp]
    lib.rbt_seed_machine.restype = lib.rbt_seed_machine_tables.restype = ci
    lib.rbt_cuda_error_string.argtypes = [ci]
    lib.rbt_cuda_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def carries_toehold(tx: TorchIndex, mode: str) -> bool:
    """Whether the `mode` machine carries the per-step toehold on tx: the
    sampled machine on an index without kval whose rows are not two-level
    (those take the step record and its trajectory resolve)."""
    return (mode == "sample" and "kval" not in tx.arrays
            and cuda_lf.row_layout(tx) not in R.FB2_KEYS)


def launch_machine(tx: TorchIndex, mode: str, qcodes, lengths, *, k: int = 0, wsize: int = 0,
                   max_range: int = 0, min_length: int = 0, W: int = 0, S: int = 0,
                   record: bool = False, lib=None) -> dict:
    """Launch the `mode` machine ("greedy", "lmem" or "sample") on CUDA
    tensors, shaped by cuda_lf.launch_plan within the block its instance
    family is built for (BLOCK_LANES): over fused rows (two threads a
    lane), else over the tables of cuda_lf.table_policy (cuda_lf.lane_threads
    threads a lane, two).  `lib` is the library
    to launch on, build()'s by default (tools/seed_turns.py passes earlier
    designs' libraries).
    k is the ftab start's k-mer length (0 for none; the caller decides as
    the torch loop does), W and S the record and seed capacities.  Returns
    the machine's tables in the index's lane type (int32 over single-level
    rows and the tables, int64 over two-level rows): greedy {wlo, whi, wseed
    [W, B], nrec [B], slo, shi, sqs, sqe [S, B], ns [B]}; lmem {wlo, whi [W,
    B], nrec, elo, ehi, eqs [B]}; sample {slo, shi, sqs, sqe [S, B], ns},
    with `record` (two-level rows only) hi_rec [L, B], and where it carries
    the per-step toehold (carries_toehold) ssamp [S, B], each seed's toehold
    (-1 before a lane's first successful step).  The rows, codes and lengths
    are int32; F (and fb2_base) in the lane type; the ftab and the other
    tables int32 or int64."""
    if mode not in MODES:
        raise ValueError(f"no seeding machine {mode!r}; the kernel runs {sorted(MODES)}")
    key = cuda_lf.row_layout(tx)
    policy = cuda_lf.table_policy(tx) if key is None else None
    two_level = key in R.FB2_KEYS
    toehold = carries_toehold(tx, mode)
    if record and (mode != "sample" or not two_level):
        raise ValueError(f"the step record is the sampled machine's over two-level rows; "
                         f"asked of {mode} over {key or policy} {'rows' if key else 'tables'}")
    if mode == "sample" and k:
        raise ValueError("the sampled machine takes no ftab start")
    if (mode == "sample") != (W == 0) or W < 0 or S < 1 or (mode == "lmem" and S != 1):
        raise ValueError(f"capacities W = {W}, S = {S} for the {mode} machine")
    lane = torch.int64 if two_level else torch.int32
    F = tx.arrays["F"]
    B, L = qcodes.shape
    dev = qcodes.device
    if k and not (L >= k and tx.has_ftab and k == tx.ftab_k):
        raise ValueError(f"an ftab start of k = {k} over codes of width {L} (ftab k = "
                         f"{tx.ftab_k if tx.has_ftab else None})")
    ftab = tx.arrays["ftab"] if k else None
    named = (("ftab", ftab, (torch.int32, torch.int64)),) if k else ()
    try:
        if key is None:
            ops = cuda_lf._check_tables(tx, policy, toehold, qcodes, lengths, named, (lane,),
                                        f"the seeding machine over the {policy} tables")
        else:
            ops = cuda_lf._table_operands(tx, None, toehold) if toehold else {}
    except ValueError as e:
        where = f"{key} rows" if key else f"the {policy} tables"
        raise ValueError(f"the seeding kernel reads fused-block rows or the occ1, dense or "
                         f"run-space tables, and the toehold's tables where it carries one; "
                         f"over {where}: {e}") from None
    if key is not None:
        fb = cuda_lf.rows_of(tx, key)
        base = tx.arrays["fb2_base"] if two_level else None
        named += tuple((name, t, (torch.int32, torch.int64)) for name, t in ops.values())
        if two_level:
            named += (("fb2_base", base, (torch.int64,)),)
        cuda_lf._check_operands(tx, key, qcodes, lengths, named, lane)
        blk = cuda_lf.superblock_args(fb, base) if two_level else (0, 0)
    acgt = cuda_lf._packed_acgt(tx, k, ftab) if k else 0
    F, qcodes, lengths = F.contiguous(), qcodes.contiguous(), lengths.contiguous()

    def table(rows):
        return torch.empty((rows, B), dtype=lane, device=dev)

    def vec():
        return torch.empty(B, dtype=lane, device=dev)

    if mode == "greedy":
        out = dict(wlo=table(W), whi=table(W), wseed=table(W), nrec=vec(), slo=table(S),
                   shi=table(S), sqs=table(S), sqe=table(S), ns=vec())
    elif mode == "lmem":
        out = dict(wlo=table(W), whi=table(W), nrec=vec(), elo=vec(), ehi=vec(), eqs=vec())
    else:
        out = dict(slo=table(S), shi=table(S), sqs=table(S), sqe=table(S), ns=vec())
        if record:
            out["hi_rec"] = table(L)
        if toehold:
            out["ssamp"] = table(S)

    def ptr(name):
        t = out.get(name)
        return t.data_ptr() if t is not None else None

    def tab(name):
        t = ftab if name == "ftab" else ops[name][1] if name in ops else None
        return (t.data_ptr(), t.element_size()) if t is not None else (None, 0)

    d = dev.index if dev.index is not None else torch.cuda.current_device()
    threads, staged = cuda_lf.launch_plan(B, L, _sm_count(d),
                                          group=2 if key else cuda_lf.lane_threads(policy),
                                          most=BLOCK_LANES[lane])
    lib = lib or _LIB or build()
    lmem = mode == "lmem"
    lanes = (qcodes.data_ptr(), lengths.data_ptr(), B, L, *tab("ftab"), k, acgt, wsize,
             max_range, min_length, W, ptr("wlo"), ptr("whi"), ptr("wseed"), ptr("nrec"), S,
             ptr("elo" if lmem else "slo"), ptr("ehi" if lmem else "shi"),
             ptr("eqs" if lmem else "sqs"), ptr("sqe"), ptr("ns"))
    if key is not None:
        entry = lib.rbt_seed_machine
        args = (MODES[mode], fb.data_ptr(), cuda_lf._SYMS_PER_ROW[key], F.data_ptr(),
                base.data_ptr() if two_level else None, *blk, tx.A, tx.n,
                8 if two_level else 4, *lanes, ptr("hi_rec"), *tab("tk1"), *tab("ltk"),
                *tab("run_start"), *cuda_lf.toe_directory(tx, ops), *tab("samples_last"), tx.R,
                ptr("ssamp"), threads, int(staged))
    else:
        entry = lib.rbt_seed_machine_tables
        args = (MODES[mode], *cuda_lf.table_args(tx, policy, ops), F.data_ptr(), tx.A,
                tx.n, *lanes, *tab("tk1"), *tab("ltk"), *tab("samples_last"), ptr("ssamp"),
                threads, int(staged))
    if d == torch.cuda.current_device():
        rc = entry(*args, _raw_stream(d))
    else:
        with torch.cuda.device(d):
            rc = entry(*args, _raw_stream(d))
    if rc != 0:
        raise RuntimeError(f"seeding kernel launch failed: "
                           f"{lib.rbt_cuda_error_string(rc).decode()}")
    if B:
        name = "sample_rec" if record else "sample_toe" if toehold else mode
        LAUNCHES_SEED[name if key else f"{name}_{policy}"] += 1
    return out
