"""The phi walk of `rbt_align -s` as one hand-written CUDA kernel a batch.

The kernel (csrc/phi_walk.cu, built with nvcc for sm_90a on first use and
bound with ctypes) is P3's chained gather (csrc/gather_probe.cu) carrying
the walk: lane b writes out[off[b] + j] for j < size[b], the toehold k[b]
first, then each phi of the one before (ToeholdSA::locate_range,
toehold_sa.hpp:37-49), one thread a lane with the step loop inside it.  It
takes the four phi routes of ops/rank.phi_step, in its order: the dense
`phi1` table, a BigIndex's bitmap rows (`phi_rows` + `phi_delta`), the
breakpoint table of a BigIndex with 2^31 or more breakpoints (`pred_pos`,
`phi_at`, searched through its bucket table `pp_off`), and the predecessor
search over the run-start samples (`pred_pos`, `pred_to_run`,
`samples_last`) of an index with none of those (`--no-dense`), searched the
same way through `pred_off`, the bucket directory over pred_pos that
engine/device.TorchIndex.with_pred_directory builds where such an index
goes to the card (a launch without it raises).

A fifth route needs no chain: where the index's `kval` is the full SA
(kval.numel() == n, every dense build) and the caller hands each lane's
`hi`, its toehold being kval[hi] (engine/locate.locate_ragged on the
toeholds of find_ranges_w_toehold, as `rbt_align -s` walks), phi(SA[i]) =
SA[i - 1] makes lane b's walk kval[hi[b] - j] for j < size[b]: the kval
kernel (csrc/phi_walk.cu kval_walk_kernel, counted in LAUNCHES_KVAL), whose
plain twin is `kval_walk_plain`.  Without hi, or where kval is not the
full SA, the walk keeps its chain.

`phi_walk` is the wrapper: for CUDA tensors it launches the kernel (and adds
one to LAUNCHES, or to LAUNCHES_KVAL) or raises, never a torch walk; for CPU
tensors it runs the plain twin, `phi_walk_plain` (the torch walk over
ops/rank.phi_step) or `kval_walk_plain`, which is also what the kernel is
held against on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from rowbowt_tpu_torch import _native
from rowbowt_tpu_torch.engine.device import TorchIndex
from rowbowt_tpu_torch.ops import rank as R
from rowbowt_tpu_torch.ops.cuda_gather import _raw_stream, _sm_count

# walk kernel launches since the last reset (a run sets them to 0): the
# chain's, on any of the four phi routes, and the kval kernel's
LAUNCHES = 0
LAUNCHES_KVAL = 0

_LIB = None
BUILD_LOG = ""  # nvcc's output (-Xptxas -v register/spill report) of the build


def build():
    """Compile csrc/phi_walk.cu (once per process) and bind its C entries:
    rbt_phi_walk_phi1, rbt_phi_walk_rows, rbt_phi_walk_phi_at,
    rbt_phi_walk_pred, rbt_phi_walk_kval and rbt_phi_walk_empty (an empty
    kernel in a walk's grid, which chip_smoke.py times as its method's
    floor)."""
    global _LIB, BUILD_LOG
    if _LIB is not None:
        return _LIB
    path, BUILD_LOG = _native.build_cuda_library("phi_walk")
    lib = ctypes.CDLL(path)
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rbt_phi_walk_phi1.argtypes = [vp, ci, ll, vp, vp, vp, vp, ci, ci, vp]
    lib.rbt_phi_walk_rows.argtypes = [vp, vp, ll, vp, vp, vp, vp, ci, ci, vp]
    lib.rbt_phi_walk_pred.argtypes = [vp, vp, vp, ci, ll, vp, ci, ll, ci, ci, ll, vp, vp, vp,
                                      vp, ci, ci, vp]
    lib.rbt_phi_walk_phi_at.argtypes = [vp, ci, vp, ci, ll, vp, ci, ll, ci, ci, ll, vp, vp, vp,
                                        vp, ci, ci, vp]
    lib.rbt_phi_walk_kval.argtypes = [vp, ci, ll, vp, vp, vp, vp, ci, ci, vp]
    lib.rbt_phi_walk_empty.argtypes = [ci, ci, vp]
    lib.rbt_phi_walk_phi1.restype = lib.rbt_phi_walk_rows.restype = ci
    lib.rbt_phi_walk_pred.restype = lib.rbt_phi_walk_phi_at.restype = ci
    lib.rbt_phi_walk_kval.restype = lib.rbt_phi_walk_empty.restype = ci
    lib.rbt_phi_walk_error_string.argtypes = [ci]
    lib.rbt_phi_walk_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


PRED_TABLES = ("pred_pos", "pred_to_run", "samples_last", "pred_off")
PHI_AT_TABLES = ("pred_pos", "phi_at", "pp_off")


def walk_route(tx: TorchIndex, by_hi: bool = False) -> str:
    """The tables the walk kernel reads: "kval" where the caller hands each
    lane's hi (`by_hi`) and tx's kval is the full SA, else phi_step's
    choice, "phi1", "phi_rows", "phi_at" (the breakpoint table) or "pred"
    (the predecessor search)."""
    kval = tx.arrays.get("kval")
    if by_hi and kval is not None and kval.numel() == tx.n:
        return "kval"
    if "phi1" in tx.arrays:
        return "phi1"
    if "phi_rows" in tx.arrays:
        return "phi_rows"
    if "phi_at" in tx.arrays:
        return "phi_at"
    return "pred"


def launch_plan(B: int, sms: int) -> int:
    """Threads a block of a walk over B lanes on a card of `sms` SMs: the
    least multiple of 32 (up to 256) with which one block on each SM covers
    the lanes."""
    return max(32, min(256, -(-B // (32 * sms)) * 32))


def phi_walk_plain(tx: TorchIndex, k, size, off, out):
    """The torch walk: lane b's toehold k[b] and its phi chain, size[b]
    positions in all, into out[off[b]:off[b] + size[b]], one ops/rank.
    phi_step of every unfinished lane per step.  The lanes are taken in
    descending size order, so the unfinished ones are a prefix.  Returns
    out."""
    order = torch.argsort(size, descending=True)
    s = size[order].cpu().numpy()
    live = int(np.count_nonzero(s > 0))
    if not live:
        return out
    lanes = order[:live]
    o = off[lanes]
    cur = k[lanes]
    out[o] = cur.to(out.dtype)
    neg = -s[:live]  # ascending: lanes with size > j are the first searchsorted(neg, -j)
    for j in range(1, int(s[0])):
        m = int(np.searchsorted(neg, -j, side="left"))
        cur = R.phi_step(tx, cur[:m])
        out[o[:m] + j] = cur.to(out.dtype)
    return out


def kval_walk_plain(tx: TorchIndex, hi, size, off, out):
    """The walk of the kval route in torch: out[off[b] + j] = kval[hi[b] -
    j] for j < size[b].  Returns out."""
    live = size > 0
    s = size[live]
    total = int(s.sum())
    if not total:
        return out
    lane = torch.repeat_interleave(torch.arange(s.numel(), device=s.device), s)
    j = torch.arange(total, device=s.device) - (torch.cumsum(s, 0) - s)[lane]
    out[off[live][lane] + j] = tx.arrays["kval"][hi[live].long()[lane] - j].to(out.dtype)
    return out


def phi_walk(tx: TorchIndex, k, size, off, out, hi=None):
    """Fill out[off[b] + j] for j < size[b] with lane b's toehold and phi
    chain: the walk kernel for CUDA tensors (walk_route's tables), the plain
    walk for CPU tensors, an error for any other device.  `hi`, each lane's
    hi where k[b] is its range's toehold (engine/locate.find_ranges_w_toehold's:
    on an index with kval, kval[hi[b]]), takes the kval route where tx's
    kval is the full SA.  Returns out."""
    if k.device.type == "cpu":
        if walk_route(tx, hi is not None) == "kval":
            return kval_walk_plain(tx, hi, size, off, out)
        return phi_walk_plain(tx, k, size, off, out)
    if k.device.type != "cuda":
        raise ValueError(f"no phi walk for device {k.device}")
    return launch_walk(tx, k, size, off, out, hi)


def launch_walk(tx: TorchIndex, k, size, off, out, hi=None, lib=None):
    """Launch the walk kernel on CUDA tensors: k int32 or int64 [B] (widened
    to int64), size and off int64 [B], out int64.  With `hi` (int32 or int64
    [B], each lane's hi where k[b] == kval[hi[b]]) on an index whose kval is
    the full SA, the kval kernel (walk_route), which reads hi and not k;
    else the chain over phi_step's tables, lane t on thread t.  `lib` is
    the library to launch on, build()'s by default (tools/seed_turns.py
    passes earlier designs' libraries).  Every k[b] with size[b] > 0 must
    lie in [0, n), every hi[b] - size[b] + 1 at least 0, and out must hold
    every off[b] + size[b]."""
    global LAUNCHES, LAUNCHES_KVAL
    route = walk_route(tx, hi is not None)
    ints = (torch.int32, torch.int64)
    if route == "kval":
        tabs = (("kval", tx.arrays["kval"], ints),)
    elif route == "phi1":
        tabs = (("phi1", tx.arrays["phi1"], ints),)
    elif route == "phi_rows":
        tabs = (("phi_rows", tx.arrays["phi_rows"], (torch.int32,)),
                ("phi_delta", tx.arrays["phi_delta"], (torch.int64,)))
    else:
        names = PHI_AT_TABLES if route == "phi_at" else PRED_TABLES
        what = "breakpoint" if route == "phi_at" else "predecessor"
        for name in names:
            if name not in tx.arrays:
                raise ValueError(f"the {what} walk needs {name}; the index has none")
        tabs = tuple((name, tx.arrays[name], ints) for name in names)
    named = (("k", k, (torch.int32, torch.int64)), ("size", size, (torch.int64,)),
             ("off", off, (torch.int64,)), ("out", out, (torch.int64,))) + tabs
    if route == "kval":
        named += (("hi", hi, ints),)
    dev = k.device
    for name, t, want in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, k on {dev}")
        if t.dtype not in want:
            raise TypeError(f"{name} must be {' or '.join(str(w)[6:] for w in want)}, "
                            f"got {t.dtype}")
    B = k.shape[0]
    if k.dim() != 1 or size.shape != (B,) or off.shape != (B,) or out.dim() != 1:
        raise ValueError(f"k, size and off must be [B] and out flat: k {tuple(k.shape)}, "
                         f"size {tuple(size.shape)}, off {tuple(off.shape)}, "
                         f"out {tuple(out.shape)}")
    if route == "kval" and hi.shape != (B,):
        raise ValueError(f"hi must be [B]: hi {tuple(hi.shape)}, k {tuple(k.shape)}")
    if B >= 1 << 31:
        raise ValueError("2^31 or more lanes are not supported")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    for name, t, _ in tabs:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if route == "pred":
        samples, pred_off = tabs[:3], tabs[3][1]
        if len({t.dtype for _, t, _ in samples}) != 1:
            raise TypeError("pred_pos, pred_to_run and samples_last must share a dtype, got "
                            + ", ".join(str(t.dtype)[6:] for _, t, _ in samples))
        if any(t.shape != (tx.R,) for _, t, _ in samples):
            raise ValueError(f"pred_pos, pred_to_run and samples_last must be [R = {tx.R}]")
        if len(tx.pred_bs) != 2 or pred_off.shape != ((tx.n >> tx.pred_bs[0]) + 2,):
            raise ValueError(f"pred_off {tuple(pred_off.shape)} and pred_bs {tx.pred_bs}: need "
                             "[(n >> shift) + 2] and (shift, iters) "
                             "(TorchIndex.with_pred_directory builds them)")
    if route == "phi_at":
        pp, at, pp_off = (t for _, t, _ in tabs)
        if (pp.dim() != 1 or at.shape != pp.shape or pp_off.dim() != 1 or pp_off.shape[0] < 2
                or len(tx.pp_bs) != 2):
            raise ValueError(f"pred_pos {tuple(pp.shape)}, phi_at {tuple(at.shape)}, pp_off "
                             f"{tuple(pp_off.shape)} and pp_bs {tx.pp_bs}: need [M], [M], "
                             "[>= 2] and (shift, iters)")
    if route == "phi_rows":
        rows = tx.arrays["phi_rows"]
        if rows.dim() != 2 or rows.shape[1] != 16 or rows.data_ptr() % 16:
            raise ValueError(f"phi_rows of shape {tuple(rows.shape)}: need [nb, 16], "
                             "16-byte aligned")
    size, off = size.contiguous(), off.contiguous()
    d = dev.index if dev.index is not None else torch.cuda.current_device()
    threads = launch_plan(B, _sm_count(d))
    lib = lib or _LIB or build()
    # the kval kernel reads each lane's hi, the chain its toehold
    first = (hi if route == "kval" else k).to(torch.int64).contiguous()
    lanes = (first.data_ptr(), size.data_ptr(), off.data_ptr(), out.data_ptr(), B, threads)
    if route == "kval":
        kval = tx.arrays["kval"]
        entry, args = lib.rbt_phi_walk_kval, (kval.data_ptr(), kval.element_size(), tx.n)
    elif route == "phi1":
        phi1 = tx.arrays["phi1"]
        entry, args = lib.rbt_phi_walk_phi1, (phi1.data_ptr(), phi1.element_size(), tx.n)
    elif route == "phi_rows":
        entry = lib.rbt_phi_walk_rows
        args = (tx.arrays["phi_rows"].data_ptr(), tx.arrays["phi_delta"].data_ptr(), tx.n)
    elif route == "phi_at":
        entry = lib.rbt_phi_walk_phi_at
        args = (pp.data_ptr(), pp.element_size(), at.data_ptr(), at.element_size(),
                pp.shape[0], pp_off.data_ptr(), pp_off.element_size(), pp_off.shape[0],
                *tx.pp_bs, tx.n)
    else:
        entry = lib.rbt_phi_walk_pred
        args = (*(t.data_ptr() for _, t, _ in samples), samples[0][1].element_size(), tx.R,
                pred_off.data_ptr(), pred_off.element_size(), pred_off.shape[0], *tx.pred_bs,
                tx.n)
    if d == torch.cuda.current_device():
        rc = entry(*args, *lanes, _raw_stream(d))
    else:
        with torch.cuda.device(d):
            rc = entry(*args, *lanes, _raw_stream(d))
    if rc != 0:
        raise RuntimeError(f"phi walk kernel launch failed: "
                           f"{lib.rbt_phi_walk_error_string(rc).decode()}")
    if B and route == "kval":
        LAUNCHES_KVAL += 1
    elif B:
        LAUNCHES += 1
    return out
