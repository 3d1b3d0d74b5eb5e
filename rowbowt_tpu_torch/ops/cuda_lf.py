"""K1: the count path's LF loop as one hand-written CUDA kernel.

Replaces rowbowt_tpu/ops/pallas_lf.py:find_ranges_pallas.  The kernel
(csrc/lf.cu, built with nvcc for sm_90a on first use and bound with ctypes)
runs one thread per read with the whole L loop inside, over either row
layout (`fblock64`, the default, or the 96B `fblock`).  Around it, in torch:
the per-lane start from the ftab (`lf_start`), the [L, B] transpose that
makes the per-step code loads coalesced, and the argument checks.

`lf_loop` is the wrapper: for CUDA tensors it launches the kernel (and adds
one to LAUNCHES) or raises; for CPU tensors it runs `lf_loop_plain`, the
torch version over ops/rank.py.  `find_ranges_plain` is the whole plain count
path on any device, the reference the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes

import torch

from rowbowt_tpu_torch import _native
from rowbowt_tpu_torch.engine.device import TorchIndex
from rowbowt_tpu_torch.ops import rank as R

# kernel launches made by lf_loop since the last reset (a run sets it to 0)
LAUNCHES = 0

_LIB = None
BUILD_LOG = ""  # nvcc's output (-Xptxas -v register/spill report) of the build

_SYMS_PER_ROW = {"fblock64": 64, "fblock": 128}


def build():
    """Compile csrc/lf.cu (once per process) and bind its C entry points."""
    global _LIB, BUILD_LOG
    if _LIB is not None:
        return _LIB
    path, BUILD_LOG = _native.build_cuda_library("lf")
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rbt_lf_count.argtypes = [vp, ci, vp, ci, ci, vp, vp, vp, ci, ci, vp, vp, vp]
    lib.rbt_lf_count.restype = ci
    lib.rbt_cuda_error_string.argtypes = [ci]
    lib.rbt_cuda_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


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


def lf_loop_plain(tx: TorchIndex, qcodes, lengths, lo, hi, startj):
    """L lockstep LF steps in torch, with done-masks (engine/count.py:42-56)."""
    B, L = qcodes.shape
    dt = tx.idx_dtype
    lengths = lengths.to(dt)
    done = torch.zeros(B, dtype=torch.bool, device=qcodes.device)
    step = R.lf_step_auto(tx)
    for j in range(L):
        c = qcodes[:, L - 1 - j].to(dt)
        active = (~done) & (j >= startj) & (j < lengths)
        nlo, nhi = step(tx, lo, hi, c)
        lo = torch.where(active, nlo, lo)
        hi = torch.where(active, nhi, hi)
        done = done | (active & (nlo > nhi))
    return lo, hi


def find_ranges_plain(tx: TorchIndex, qcodes, lengths, use_ftab: bool = True):
    """The plain count path on any device: ftab start, then the torch loop."""
    lo, hi, startj = lf_start(tx, qcodes, lengths, use_ftab)
    return lf_loop_plain(tx, qcodes, lengths, lo, hi, startj)


def lf_loop(tx: TorchIndex, qcodes, lengths, lo, hi, startj):
    """The LF loop from the given starts: K1 for CUDA tensors, the plain torch
    loop for CPU tensors, an error for any other device."""
    if qcodes.device.type == "cpu":
        return lf_loop_plain(tx, qcodes, lengths, lo, hi, startj)
    if qcodes.device.type != "cuda":
        raise ValueError(f"no LF loop for device {qcodes.device}")
    return _lf_loop_cuda(tx, qcodes, lengths, lo, hi, startj)


def _lf_loop_cuda(tx: TorchIndex, qcodes, lengths, lo, hi, startj):
    global LAUNCHES
    # the row layout is lf_step_auto's choice (it raises, naming the ROADMAP
    # item, for an index without fused-block rows)
    key = "fblock64" if R.lf_step_auto(tx) is R.lf_step_fblock64 else "fblock"
    fb, F = tx.arrays[key], tx.arrays["F"]
    B, L = qcodes.shape
    dev = qcodes.device
    for name, t in (("table", fb), ("F", F), ("qcodes", qcodes), ("lengths", lengths),
                    ("lo", lo), ("hi", hi), ("startj", startj)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, qcodes on {dev}")
        if t.dtype != torch.int32:
            # int64 lanes are the two-level n >= 2^31 layouts (ROADMAP M6)
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if fb.dim() != 2 or fb.shape[1] != 8 + _SYMS_PER_ROW[key] // 8:
        raise ValueError(f"{key} rows have shape {tuple(fb.shape)}")
    if not 1 <= tx.A <= 8 or F.numel() < tx.A + 1:
        raise ValueError(f"alphabet of {tx.A} codes; the kernel takes 1..8")
    if lengths.shape != (B,) or lo.shape != (B,) or hi.shape != (B,) or startj.shape != (B,):
        raise ValueError("lengths/lo/hi/startj must be [B] for qcodes [B, L]")
    fb = fb.contiguous()
    if fb.data_ptr() % 16:
        raise ValueError("row table is not 16-byte aligned")
    F = F.contiguous()
    qT = qcodes.t().contiguous()  # [L, B]: a warp's step-j codes are adjacent
    lengths = lengths.contiguous()
    startj = startj.contiguous()
    lo = lo.clone(memory_format=torch.contiguous_format)  # updated in place
    hi = hi.clone(memory_format=torch.contiguous_format)
    lib = build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rbt_lf_count(fb.data_ptr(), _SYMS_PER_ROW[key], F.data_ptr(), tx.A,
                              tx.n, qT.data_ptr(), lengths.data_ptr(), startj.data_ptr(),
                              B, L, lo.data_ptr(), hi.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"LF kernel launch failed: {lib.rbt_cuda_error_string(rc).decode()}")
    LAUNCHES += 1
    return lo, hi
