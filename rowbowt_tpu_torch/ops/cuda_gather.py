"""P1-P3: the gather probes of tools/vmem_gather_probe.py as CUDA kernels.

The kernels (csrc/gather_probe.cu, built with nvcc for sm_90a on first use
and bound with ctypes) are one thread per output element:

  gather_rows  (P1)  out[b] = tab[idx[b] >> 7, idx[b] & 127], the flat element
                     tab[idx[b]] of a contiguous table of any shape
  gather_cols  (P2)  out[k, l] = tab[idx[k, l], l]
  gather_chain (P3)  `steps` dependent gathers i <- tab[i] per lane

Each wrapper launches its kernel for CUDA tensors (and adds one to
LAUNCHES[name]) or raises; for CPU tensors it runs its `*_plain` twin, the
torch version the kernel is held against on the card.  Indices are not
clamped, as the TPU kernels do not clamp them: they must lie in the table.
`check_indices` is the one range check, for callers that build the indices.
"""

from __future__ import annotations

import ctypes

import torch

from rowbowt_tpu_torch import _native

# kernel launches per wrapper since the last reset (a run sets them to 0)
LAUNCHES = {"gather_rows": 0, "gather_cols": 0, "gather_chain": 0}

_LIB = None
BUILD_LOG = ""  # nvcc's output (-Xptxas -v register/spill report) of the build


def build():
    """Compile csrc/gather_probe.cu (once per process) and bind its C entries."""
    global _LIB, BUILD_LOG
    if _LIB is not None:
        return _LIB
    path, BUILD_LOG = _native.build_cuda_library("gather_probe")
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rbt_gather_rows.argtypes = [vp, vp, vp, ci, vp]
    lib.rbt_gather_cols.argtypes = [vp, vp, vp, ci, ci, vp]
    lib.rbt_gather_chain.argtypes = [vp, vp, vp, ci, ci, vp]
    for fn in (lib.rbt_gather_rows, lib.rbt_gather_cols, lib.rbt_gather_chain):
        fn.restype = ci
    lib.rbt_gather_error_string.argtypes = [ci]
    lib.rbt_gather_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def check_indices(idx: torch.Tensor, bound: int) -> None:
    """Raise unless every index lies in [0, bound): one reduction."""
    if idx.numel() and not bool(((idx >= 0) & (idx < bound)).all()):
        raise ValueError(f"an index lies outside [0, {bound})")


def gather_rows_plain(tab, idx):
    return tab.reshape(-1)[idx.long()]


def gather_cols_plain(tab, idx):
    return torch.gather(tab, 0, idx.long())


def gather_chain_plain(tab, idx, steps: int = 100):
    flat = tab.reshape(-1)
    i = idx
    for _ in range(steps):
        i = flat[i.long()]
    return i


def gather_rows(tab, idx):
    """P1: out[b] = tab.flat[idx[b]], idx int32[B], tab int32 of any shape."""
    if _check(tab, idx, idx_dim=1) == "cpu":
        return gather_rows_plain(tab, idx)
    out = torch.empty_like(idx)
    _launch("gather_rows", idx.device, tab, idx, out, idx.numel())
    return out


def gather_cols(tab, idx):
    """P2: out[k, l] = tab[idx[k, l], l], tab int32[rows, C], idx int32[K, C]."""
    route = _check(tab, idx, idx_dim=2)
    if tab.dim() != 2 or idx.shape[1] != tab.shape[1]:
        raise ValueError(f"tab {tuple(tab.shape)} and idx {tuple(idx.shape)}: "
                         "need tab [rows, C] and idx [K, C]")
    if route == "cpu":
        return gather_cols_plain(tab, idx)
    out = torch.empty_like(idx)
    _launch("gather_cols", idx.device, tab, idx, out, idx.shape[0], idx.shape[1])
    return out


def gather_chain(tab, idx, steps: int = 100):
    """P3: `steps` dependent gathers i <- tab.flat[i] from i = idx[b]."""
    route = _check(tab, idx, idx_dim=1)
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    if route == "cpu":
        return gather_chain_plain(tab, idx, steps)
    out = torch.empty_like(idx)
    _launch("gather_chain", idx.device, tab, idx, out, idx.numel(), steps)
    return out


def _check(tab, idx, idx_dim: int) -> str:
    """Validate the operands; returns 'cpu' (take the plain twin) or 'cuda'
    (launch the kernel), and raises for any other device or a mix."""
    if tab.device != idx.device:
        raise ValueError(f"tab is on {tab.device}, idx on {idx.device}")
    if idx.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no gather kernel for device {idx.device}")
    for name, t in (("tab", tab), ("idx", idx)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if idx.dim() != idx_dim:
        raise ValueError(f"idx must have {idx_dim} dimension(s), got shape {tuple(idx.shape)}")
    if tab.numel() >= 1 << 31 or idx.numel() >= 1 << 31:
        raise ValueError("tables and index sets of 2^31 or more elements are not supported")
    return idx.device.type


def _launch(name: str, dev, *args) -> None:
    lib = build()
    tensors = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, f"rbt_{name}")(*tensors, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.rbt_gather_error_string(rc).decode()}")
    LAUNCHES[name] += 1
