"""P1-P3: the gather probes of tools/vmem_gather_probe.py as CUDA kernels.

The kernels (csrc/gather_probe.cu, built with nvcc for sm_90a on first use
and bound with ctypes):

  gather_rows  (P1)  out[b] = tab[idx[b] >> 7, idx[b] & 127], the flat element
                     tab[idx[b]] of a contiguous table of any shape
  gather_cols  (P2)  out[k, l] = tab[idx[k, l], l]
  gather_chain (P3)  `steps` dependent gathers i <- tab[i] per lane

P1 and P2 give each thread VEC consecutive outputs through 16-byte index
loads and stores where `launch_plan` allows it; P3 gives each thread the
CHAIN design's number of lanes, their loads issued together each step, in
blocks sized by `chain_plan`.  `gather_chain_as` launches any of
CHAIN_DESIGNS (the first design among them), for chip_smoke.py to time them
beside each other.
Each wrapper launches its kernel for CUDA tensors (and adds one to
LAUNCHES[name] when it launches) or raises; for CPU tensors it runs its
`*_plain` twin, the torch version the kernel is held against on the card.
Indices are not clamped, as the TPU kernels do not clamp them: they must lie
in the table.  `check_indices` is the one range check, for callers that
build the indices.

A call does only what a launch needs: the checks of `_check`, the output's
allocation, `launch_plan`, the current raw stream and one ctypes call into
an entry bound once by `build`.  It enters a `torch.cuda.device` context only
when the tensors' device is not the current one.
"""

from __future__ import annotations

import ctypes

import torch

from rowbowt_tpu_torch import _native

# kernel launches per wrapper since the last reset (a run sets them to 0)
LAUNCHES = {"gather_rows": 0, "gather_cols": 0, "gather_chain": 0}

VEC = 4  # outputs per thread on the 16-byte path (csrc/gather_probe.cu kVec)

# P3's designs: (chains a thread, loads through L1, block size; None: chain_plan's).
# "l1" is the first design (one chain a thread, loads through L1, 256-thread
# blocks); CHAIN is the wrapper's, the fastest on an H100
# (NVIDIA H100 80GB HBM3, 700 W: 29.01 us against 30.77-31.15 for the
# others at the probe's shape, PERF.md §6)
CHAIN_DESIGNS = {"l1": (1, True, 256), "c1": (1, False, None), "c2": (2, False, None),
                 "c4": (4, False, None)}
CHAIN = "l1"

_ENTRIES: dict = {}  # wrapper name -> its bound C entry, filled once by build()
_ERROR_STRING = None
_SMS: dict = {}  # device index -> its SM count
BUILD_LOG = ""  # nvcc's output (-Xptxas -v register/spill report) of the build


def build() -> dict:
    """Compile csrc/gather_probe.cu (once per process) and bind its C entries."""
    global BUILD_LOG, _ERROR_STRING
    if _ENTRIES:
        return _ENTRIES
    path, BUILD_LOG = _native.build_cuda_library("gather_probe")
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    signatures = {"gather_rows": [vp, vp, vp, ci, ci, ci, vp],
                  "gather_cols": [vp, vp, vp, ci, ci, ci, ci, vp],
                  "gather_chain": [vp, vp, vp, ci, ci, ci, ci, ci, vp]}
    entries = {}
    for name, argtypes in signatures.items():
        fn = getattr(lib, f"rbt_{name}")
        fn.argtypes, fn.restype = argtypes, ci
        entries[name] = fn
    _ERROR_STRING = lib.rbt_gather_error_string
    _ERROR_STRING.argtypes, _ERROR_STRING.restype = [ci], ctypes.c_char_p
    _ENTRIES.update(entries)
    return _ENTRIES


def check_indices(idx: torch.Tensor, bound: int) -> None:
    """Raise unless every index lies in [0, bound): one reduction."""
    if idx.numel() and not bool(((idx >= 0) & (idx < bound)).all()):
        raise ValueError(f"an index lies outside [0, {bound})")


def launch_plan(n: int, idx_ptr: int, out_ptr: int, sms: int) -> tuple[int, int]:
    """(groups, threads) of a P1/P2 launch over n outputs.  `groups` runs of
    VEC outputs take the 16-byte path when idx and out are both 16-byte
    aligned, none otherwise (a view such as idx[1:] is only 4-byte aligned);
    the other n - VEC * groups outputs take one thread each.  `threads` is the
    block size: the least multiple of 32 (up to 256) with which one block on
    each of the card's `sms` SMs covers the threads, so the grid spreads over
    as many SMs as it can, one block each."""
    groups = n // VEC if (idx_ptr | out_ptr) % 16 == 0 else 0
    items = n - (VEC - 1) * groups
    return groups, max(32, min(256, -(-items // (32 * sms)) * 32))


def chain_plan(n: int, chains: int, sms: int) -> int:
    """Block size of a P3 launch over n lanes, `chains` a thread: the least
    multiple of 32 (up to 256) with which one block on each of the card's
    `sms` SMs covers the ceil(n / chains) threads."""
    items = -(-n // chains)
    return max(32, min(256, -(-items // (32 * sms)) * 32))


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
    dev = _check(tab, idx, 1)
    if dev < 0:
        return gather_rows_plain(tab, idx)
    out = torch.empty_like(idx)
    n, ip, op = idx.numel(), idx.data_ptr(), out.data_ptr()
    _launch("gather_rows", dev, n, tab.data_ptr(), ip, op, n,
            *launch_plan(n, ip, op, _sm_count(dev)))
    return out


def gather_cols(tab, idx):
    """P2: out[k, l] = tab[idx[k, l], l], tab int32[rows, C], idx int32[K, C]."""
    dev = _check(tab, idx, 2)
    if tab.dim() != 2 or idx.shape[1] != tab.shape[1]:
        raise ValueError(f"tab {tuple(tab.shape)} and idx {tuple(idx.shape)}: "
                         "need tab [rows, C] and idx [K, C]")
    if dev < 0:
        return gather_cols_plain(tab, idx)
    out = torch.empty_like(idx)
    (K, cols), ip, op = idx.shape, idx.data_ptr(), out.data_ptr()
    _launch("gather_cols", dev, K * cols, tab.data_ptr(), ip, op, K, cols,
            *launch_plan(K * cols, ip, op, _sm_count(dev)))
    return out


def gather_chain(tab, idx, steps: int = 100):
    """P3: `steps` dependent gathers i <- tab.flat[i] from i = idx[b]."""
    return gather_chain_as(tab, idx, steps, CHAIN)


def gather_chain_as(tab, idx, steps: int, design: str):
    """P3 in the design CHAIN_DESIGNS[design]; the plain twin for CPU
    tensors."""
    dev = _check(tab, idx, 1)
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    chains, l1, threads = CHAIN_DESIGNS[design]
    if dev < 0:
        return gather_chain_plain(tab, idx, steps)
    out = torch.empty_like(idx)
    n = idx.numel()
    _launch("gather_chain", dev, n, tab.data_ptr(), idx.data_ptr(), out.data_ptr(), n, steps,
            chains, int(l1), threads or chain_plan(n, chains, _sm_count(dev)))
    return out


def _check(tab, idx, idx_dim: int) -> int:
    """Validate the operands; returns -1 for CPU tensors (take the plain twin)
    or the CUDA device's index (launch the kernel), and raises for any other
    device or a mix."""
    if idx.is_cuda:
        dev = idx.get_device()
        if not tab.is_cuda or tab.get_device() != dev:
            raise ValueError(f"tab is on {tab.device}, idx on {idx.device}")
    elif idx.is_cpu and tab.is_cpu:
        dev = -1
    elif tab.device != idx.device:
        raise ValueError(f"tab is on {tab.device}, idx on {idx.device}")
    else:
        raise ValueError(f"no gather kernel for device {idx.device}")
    if tab.dtype is not torch.int32 or idx.dtype is not torch.int32:
        name, t = ("tab", tab) if tab.dtype is not torch.int32 else ("idx", idx)
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if not (tab.is_contiguous() and idx.is_contiguous()):
        raise ValueError("tab and idx must be contiguous")
    if idx.dim() != idx_dim:
        raise ValueError(f"idx must have {idx_dim} dimension(s), got shape {tuple(idx.shape)}")
    if tab.numel() >= 1 << 31 or idx.numel() >= 1 << 31:
        raise ValueError("tables and index sets of 2^31 or more elements are not supported")
    return dev


def _sm_count(dev: int) -> int:
    sms = _SMS.get(dev)
    if sms is None:
        sms = _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms


def _raw_stream(dev: int) -> int:
    """The cudaStream_t of torch's current stream on device `dev`, without
    building a torch.cuda.Stream."""
    return torch._C._cuda_getCurrentRawStream(dev)


def _launch(name: str, dev: int, n: int, *args) -> None:
    """Call the entry of `name` with args and the current stream of device
    `dev`; raise on a refused launch.  The C entry launches nothing for
    n == 0, and the count moves only when it launches."""
    fn = _ENTRIES.get(name) or build()[name]
    if dev == torch.cuda.current_device():
        rc = fn(*args, _raw_stream(dev))
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, _raw_stream(dev))
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: {_ERROR_STRING(rc).decode()}")
    if n:
        LAUNCHES[name] += 1
