"""The seeding state machines of rbt_markers and rbt_locs as one hand-written
CUDA kernel, one launch a batch.

csrc/seeds.cu (built with nvcc for sm_90a on first use and bound with
ctypes, as ops/cuda_lf.py binds K1) runs each lane's whole seeding loop on
K1's LF step over the fused-block rows: the greedy machine of
markers_greedy_seeding (`rbt_markers`, `-f`, `--heuristic`), the L-MEM
machine of markers_lmem_lanes (`--lmem`) and the sampled machine of
seeds_greedy_w_sample (`rbt_locs`), which the JAX package runs as XLA
fori_loops (rowbowt_tpu/engine/seeds.py:348, :500, :112-117) and the port's
engine/seeds.py as L-step torch loops (its *_records_plain functions, the
kernel's plain twins).  The kernel writes the machines' records; the bulk
marker probe, the expansion and the toeholds stay torch code
(engine/seeds.py).

`launch_machine` launches it on CUDA tensors over an index with fused rows
(single-level rows with int32 lanes, a big index's two-level rows with
int64 lanes) and adds one to LAUNCHES_SEED[mode] ("sample_rec" for the
sampled machine with its step record), or raises: nothing gives way to a
torch loop when the build or the launch fails.  engine/seeds.py routes the
machines: the plain twin on CPU tensors, this kernel on CUDA tensors over
fused rows, and the torch loop on the card only where the index's tables
leave no kernel: an index without fused rows (the tables of a `--no-dense`
build) and the per-step toehold of the sampled machine on an index without
kval; each such run adds one to LAUNCHES_SEED_TORCH.
"""

from __future__ import annotations

import ctypes

import torch

from rowbowt_tpu_torch import _native
from rowbowt_tpu_torch.engine.device import TorchIndex
from rowbowt_tpu_torch.ops import cuda_lf
from rowbowt_tpu_torch.ops import rank as R
from rowbowt_tpu_torch.ops.cuda_gather import _raw_stream, _sm_count

# kernel launches since the last reset (a run sets them to 0), by machine;
# "sample_rec" is the sampled machine writing its step record (a big index)
LAUNCHES_SEED = {"greedy": 0, "lmem": 0, "sample": 0, "sample_rec": 0}
# runs of the torch loops on the card, where the index leaves no kernel: the
# three machines over an index without fused rows, and the sampled machine's
# per-step toehold (an index without kval)
LAUNCHES_SEED_TORCH = {"greedy": 0, "lmem": 0, "sample": 0, "sample_per_step": 0}
MODES = {"greedy": 0, "lmem": 1, "sample": 2}  # csrc/seeds.cu enum Mode

_LIB = None
BUILD_LOG = ""  # nvcc's output (-Xptxas -v register/spill report) of the build


def build():
    """Compile csrc/seeds.cu (once per process) and bind its C entry
    rbt_seed_machine."""
    global _LIB, BUILD_LOG
    if _LIB is not None:
        return _LIB
    path, BUILD_LOG = _native.build_cuda_library("seeds")
    lib = ctypes.CDLL(path)
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rbt_seed_machine.argtypes = [ci, vp, ci, vp, vp, ci, ci, ll, ci, vp, vp, ci, ci, vp, ci,
                                     ci, ci, ci, ll, ci, ci, vp, vp, vp, vp, ci, vp, vp, vp, vp,
                                     vp, vp, ci, ci, vp]
    lib.rbt_seed_machine.restype = ci
    lib.rbt_cuda_error_string.argtypes = [ci]
    lib.rbt_cuda_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def launch_machine(tx: TorchIndex, mode: str, qcodes, lengths, *, k: int = 0, wsize: int = 0,
                   max_range: int = 0, min_length: int = 0, W: int = 0, S: int = 0,
                   record: bool = False) -> dict:
    """Launch the `mode` machine ("greedy", "lmem" or "sample") on CUDA
    tensors, shaped by cuda_lf.launch_plan (two threads a lane).  k is the
    ftab start's k-mer length (0 for none; the caller decides as the torch
    loop does), W and S the record and seed capacities.  Returns the
    machine's tables in the index's lane type (int32 over single-level rows,
    int64 over two-level ones): greedy {wlo, whi, wseed [W, B], nrec [B],
    slo, shi, sqs, sqe [S, B], ns [B]}; lmem {wlo, whi [W, B], nrec, elo,
    ehi, eqs [B]}; sample {slo, shi, sqs, sqe [S, B], ns} and with `record`
    (two-level rows only) hi_rec [L, B].  The rows, codes and lengths are
    int32; F (and fb2_base) in the lane type; the ftab int32 or int64."""
    if mode not in MODES:
        raise ValueError(f"no seeding machine {mode!r}; the kernel runs {sorted(MODES)}")
    key = cuda_lf.row_layout(tx)
    if key is None:
        raise ValueError("the seeding kernel reads fused-block rows; this index has none "
                         "(the machines run as torch loops on it)")
    two_level = key in R.FB2_KEYS
    if record and (mode != "sample" or not two_level):
        raise ValueError(f"the step record is the sampled machine's over two-level rows; "
                         f"asked of {mode} over {key} rows")
    if mode == "sample" and k:
        raise ValueError("the sampled machine takes no ftab start")
    if (mode == "sample") != (W == 0) or W < 0 or S < 1 or (mode == "lmem" and S != 1):
        raise ValueError(f"capacities W = {W}, S = {S} for the {mode} machine")
    lane = torch.int64 if two_level else torch.int32
    fb, F = tx.arrays[key], tx.arrays["F"]
    B, L = qcodes.shape
    dev = qcodes.device
    if k and not (L >= k and tx.has_ftab and k == tx.ftab_k):
        raise ValueError(f"an ftab start of k = {k} over codes of width {L} (ftab k = "
                         f"{tx.ftab_k if tx.has_ftab else None})")
    ftab = tx.arrays["ftab"] if k else None
    base = tx.arrays["fb2_base"] if two_level else None
    named = (("ftab", ftab, (torch.int32, torch.int64)),) if k else ()
    if two_level:
        named += (("fb2_base", base, (torch.int64,)),)
    cuda_lf._check_operands(tx, key, qcodes, lengths, named, lane)
    if two_level and (base.shape != (base.shape[0], 8) or not base.is_contiguous()
                      or not 1 <= base.shape[0] <= fb.shape[0]):
        raise ValueError(f"fb2_base of shape {tuple(base.shape)} for {fb.shape[0]} rows")
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

    def ptr(name):
        t = out.get(name)
        return t.data_ptr() if t is not None else None

    d = dev.index if dev.index is not None else torch.cuda.current_device()
    threads, staged = cuda_lf.launch_plan(B, L, _sm_count(d))
    lib = _LIB or build()
    lmem = mode == "lmem"
    args = (MODES[mode], fb.data_ptr(), cuda_lf._SYMS_PER_ROW[key], F.data_ptr(),
            base.data_ptr() if two_level else None,
            fb.shape[0] // base.shape[0] if two_level else 0, tx.A, tx.n, 8 if two_level else 4,
            qcodes.data_ptr(), lengths.data_ptr(), B, L, ftab.data_ptr() if k else None,
            ftab.element_size() if k else 0, k, acgt, wsize, max_range, min_length, W,
            ptr("wlo"), ptr("whi"), ptr("wseed"), ptr("nrec"), S,
            ptr("elo" if lmem else "slo"), ptr("ehi" if lmem else "shi"),
            ptr("eqs" if lmem else "sqs"), ptr("sqe"), ptr("ns"), ptr("hi_rec"), threads,
            int(staged))
    if d == torch.cuda.current_device():
        rc = lib.rbt_seed_machine(*args, _raw_stream(d))
    else:
        with torch.cuda.device(d):
            rc = lib.rbt_seed_machine(*args, _raw_stream(d))
    if rc != 0:
        raise RuntimeError(f"seeding kernel launch failed: "
                           f"{lib.rbt_cuda_error_string(rc).decode()}")
    if B:
        LAUNCHES_SEED["sample_rec" if record else mode] += 1
    return out
