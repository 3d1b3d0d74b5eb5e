"""K1's record mode: the two-level search that also writes each lane's
pre-step hi of every step, the step record of a big (n >= 2^31) index's
trajectory toehold.

On the CPU the record is the plain torch loop (cuda_lf.
find_ranges_record_plain): its (lo, hi) and the toehold resolved from its
record equal the JAX package's _toehold_trajectory (rowbowt_tpu/engine/
locate.py) on each two-level row layout (fb2_64, fb2, fb2_256) at n_sup 4,
and the record itself equals a numpy replay of the contract (the pre-step hi
of every step, 0 once the range is empty, the final hi past a read's
length).  The lanes hold length-0 pads, absent codes, reads that fail
mid-way and widths 1, 3, 7 and a view one column in.  The CUDA launch path
runs with its C entry replaced by a recorder; the kernel itself is held
against the plain loop on the card by the gpu-marked test and by
chip_smoke.py.  Every output is an integer, so equality is exact."""

import ctypes
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rowbowt_tpu.engine import locate as JL
from rowbowt_tpu_torch import _native
from rowbowt_tpu_torch.engine import locate as TL
from rowbowt_tpu_torch.engine.device import PLANE_KEYS, TorchIndex
from rowbowt_tpu_torch.ops import cuda_lf
from test_bigindex import _reads_of
from test_torch_bigindex import (LAYOUTS, FB2_ARGS, _batch, _eq, _twins, from_jax,  # noqa: F401
                                 marker_panel)


@pytest.fixture(scope="module", params=list(LAYOUTS))
def layout_case(request, marker_panel):
    """(layout, JAX DeviceIndex, [port indexes], BWT codes, F, lanes) over
    the marker panel's BigIndex at n_sup 4 with its locate tables.  The
    lanes: the panel's reads (a third mutated), reads with an 'N' (absent
    from the alphabet), random reads that fail mid-way and three length-0
    pads, right-aligned to 48 columns."""
    idx, text, markers, codes, sa = marker_panel
    block, fb64 = LAYOUTS[request.param]
    jb, tb = _twins(codes, idx, 4, block=block, sa=sa)
    dx = jb.device_index(fb64=fb64)
    txs = [from_jax(dx), TorchIndex.from_big(tb, "cpu", fb64=fb64)]
    rng = np.random.default_rng(31)
    reads = _reads_of(text, rng)
    for r in reads[:6]:
        reads.append(r[:len(r) // 2] + b"N" + r[len(r) // 2 + 1:])
    acgt = np.frombuffer(b"ACGT", np.uint8)
    reads += [rng.choice(acgt, size=int(n)).tobytes() for n in (12, 30, 45)]
    reads += [b""] * 3
    return request.param, idx, dx, txs, codes, np.asarray(tb.F), _batch(idx, reads, pad_to=48)


def _views(qc, lens):
    """(qcodes, lengths) of the batch at widths 1, 3, 7 (the last w codes of
    each right-aligned read) and of the whole batch one column in."""
    L = qc.shape[1]
    out = [(np.ascontiguousarray(qc[:, L - w:]), np.minimum(lens, w).astype(lens.dtype))
           for w in (1, 3, 7)]
    return out + [(qc[:, 1:], np.minimum(lens, L - 1).astype(lens.dtype))]


def replay(codes: np.ndarray, F: np.ndarray, A: int, qc: np.ndarray, lens: np.ndarray):
    """(lo, hi, hi_rec) of the record's contract, lane by lane in numpy over
    the BWT codes: hi_rec[j, b] is lane b's hi before step j; a code outside
    [0, A) or an empty range ends the search at (1, 0), so the later entries
    are 0; for j >= the lane's length they are its final hi."""
    n = codes.shape[0]
    occ = np.zeros((n + 1, A), np.int64)
    occ[1:] = np.cumsum(codes[:, None] == np.arange(A)[None, :], axis=0)
    B, L = qc.shape
    lo_out, hi_out = np.zeros(B, np.int64), np.zeros(B, np.int64)
    rec = np.zeros((L, B), np.int64)
    for b in range(B):
        lo, hi, failed = 0, n - 1, False
        for j in range(L):
            rec[j, b] = hi
            if failed or j >= lens[b]:
                continue
            c = int(qc[b, L - 1 - j])
            ci = occ[hi + 1, c] - occ[lo, c] if 0 <= c < A else 0
            if ci <= 0:
                lo, hi, failed = 1, 0, True
            else:
                lo = int(F[c]) + int(occ[lo, c])
                hi = lo + int(ci) - 1
        lo_out[b], hi_out[b] = lo, hi
    return lo_out, hi_out, rec


def test_record_toehold_matches_jax_trajectory(layout_case):
    layout, idx, dx, txs, _, _, (qc, lens, q, ln) = layout_case
    want = JL._toehold_trajectory(dx, jnp.asarray(qc), jnp.asarray(lens))
    _eq(want, JL.find_ranges_w_toehold(dx, jnp.asarray(qc), jnp.asarray(lens)), "jax routes")
    for tx in txs:
        assert cuda_lf.row_layout(tx) == layout and "kval" not in tx.arrays
        runs = cuda_lf.RECORDS_PLAIN
        got = TL.find_ranges_w_toehold(tx, q, ln)
        assert cuda_lf.RECORDS_PLAIN == runs + 1  # the plain record loop on CPU tensors
        _eq(got, want, layout)
    lo, hi, k = (np.asarray(w) for w in want)
    assert (hi < lo).any() and (hi >= lo).any() and (k[hi >= lo] > 0).any()


def test_record_toehold_matches_jax_on_views(layout_case):
    layout, idx, dx, txs, _, _, (qc, lens, _, _) = layout_case
    for vq, vl in _views(qc, lens):
        want = JL._toehold_trajectory(dx, jnp.asarray(vq), jnp.asarray(vl))
        for tx in txs:
            _eq(TL.find_ranges_w_toehold(tx, torch.from_numpy(vq), torch.from_numpy(vl)), want,
                f"{layout} width {vq.shape[1]}")


def test_record_matches_the_contract(layout_case):
    layout, idx, dx, txs, codes, F, (qc, lens, q, ln) = layout_case
    for vq, vl in [(qc, lens)] + _views(qc, lens):
        want = replay(codes, F, txs[0].A, vq, vl)
        for tx in txs:
            got = cuda_lf.find_ranges_record_plain(tx, torch.from_numpy(vq), torch.from_numpy(vl))
            _eq(got, want, f"{layout} width {vq.shape[1]}")
    lo, hi, rec = want
    assert (rec == 0).any() and (rec == len(codes) - 1).all(axis=0).any()


def test_record_twin_routes_cpu_tensors_and_refuses_other_devices(layout_case):
    _, _, _, txs, _, _, (_, _, q, ln) = layout_case
    _eq(cuda_lf.find_ranges_record(txs[1], q, ln),
        cuda_lf.find_ranges_record_plain(txs[1], q, ln), "wrapper")
    with pytest.raises(ValueError, match="no LF loop for device meta"):
        cuda_lf.find_ranges_record(txs[1], q.to("meta"), ln.to("meta"))


# ---------------------------------------------------------------------------
# the launch path, with its C entry replaced by a recorder

@pytest.fixture
def fake_rec_entry(monkeypatch):
    """The launch path with rbt_lf_count_fb2, the stream and the SM count
    replaced by recorders; rec["rc"] is the entry's return code."""
    rec = {"calls": [], "rc": 0}

    class Lib:
        @staticmethod
        def rbt_lf_count_fb2(*a):
            rec["calls"].append(dict(zip(FB2_ARGS, a)))
            return rec["rc"]

        @staticmethod
        def rbt_lf_count(*a):
            raise AssertionError("the single-level entry was called for two-level rows")

        @staticmethod
        def rbt_cuda_error_string(rc):
            return b"invalid argument"

    monkeypatch.setattr(cuda_lf, "_LIB", Lib)
    for name in ("LAUNCHES", "LAUNCHES_FB2", "LAUNCHES_REC"):
        monkeypatch.setattr(cuda_lf, name, 0)
    monkeypatch.setattr(cuda_lf, "_raw_stream", lambda dev: 1000 + dev)
    monkeypatch.setattr(cuda_lf, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(cuda_lf.torch.cuda, "current_device", lambda: 0)
    return rec


def test_record_launch_passes_the_record(layout_case, fake_rec_entry):
    layout, _, _, txs, _, _, (_, _, q, ln) = layout_case
    tx = dataclasses.replace(txs[1], n=(1 << 31) + 77)  # n above 2^31 as the kernel sees it
    lo, hi, hi_rec = cuda_lf.launch_k1(tx, q, ln, use_ftab=False, record=True)
    (a,) = fake_rec_entry["calls"]
    B, L = q.shape
    assert hi_rec.dtype == torch.int64 and hi_rec.shape == (L, B) and hi_rec.is_contiguous()
    assert a["hi_rec"] == hi_rec.data_ptr() and (a["lo"], a["hi"]) == (lo.data_ptr(),
                                                                       hi.data_ptr())
    assert a["syms"] == {"fb2_64": 64, "fb2": 128, "fb2_256": 256}[layout]
    assert a["n"] == (1 << 31) + 77 and a["base"] == tx.arrays["fb2_base"].data_ptr()
    assert (a["B"], a["L"], a["threads"], a["stage"], a["stream"]) == (
        B, L, cuda_lf.launch_plan(B, L, 132)[0], 1, 1000)
    assert (cuda_lf.LAUNCHES_REC, cuda_lf.LAUNCHES_FB2, cuda_lf.LAUNCHES) == (1, 0, 0)
    empty = cuda_lf.launch_k1(tx, q[:0], ln[:0], record=True)  # no lanes: nothing counted
    assert empty[2].shape == (L, 0) and cuda_lf.LAUNCHES_REC == 1


def test_record_launch_failure_raises(layout_case, fake_rec_entry):
    _, _, _, txs, _, _, (_, _, q, ln) = layout_case
    fake_rec_entry["rc"] = 1
    with pytest.raises(RuntimeError, match="LF kernel launch failed: invalid argument"):
        cuda_lf.launch_k1(txs[1], q, ln, record=True)
    assert cuda_lf.LAUNCHES_REC == 0


@pytest.mark.parametrize("fault,error,match", [
    ("single-level rows", ValueError, "the step record is the two-level search's; fblock64"),
    ("no fused rows", ValueError, "K1 reads fused-block rows"),
    ("int64 qcodes", TypeError, "qcodes must be int32"),
    ("int64 lengths", TypeError, "lengths must be int32"),
    ("int32 F", TypeError, "F must be int64"),
    ("lengths shape", ValueError, "lengths must be \\[B\\]"),
])
def test_record_launch_refuses(layout_case, fake_rec_entry, fault, error, match):
    _, idx, _, txs, _, _, (_, _, q, ln) = layout_case
    tx = txs[1]
    if fault == "single-level rows":
        from rowbowt_tpu.engine.device import DeviceIndex

        tx = from_jax(DeviceIndex.from_index(idx))
        assert cuda_lf.row_layout(tx) == "fblock64"
    elif fault == "no fused rows":
        tx = dataclasses.replace(tx, arrays={k: v for k, v in tx.arrays.items()
                                             if k not in PLANE_KEYS.values()})
    elif fault == "int64 qcodes":
        q = q.long()
    elif fault == "int64 lengths":
        ln = ln.long()
    elif fault == "int32 F":
        tx = dataclasses.replace(tx, arrays=dict(tx.arrays, F=tx.arrays["F"].int()))
    else:
        ln = ln[:-1]
    with pytest.raises(error, match=match):
        cuda_lf.launch_k1(tx, q, ln, use_ftab=False, record=True)
    assert fake_rec_entry["calls"] == [] and cuda_lf.LAUNCHES_REC == 0


def test_record_entry_binding(monkeypatch):
    """build() declares rbt_lf_count_fb2's n as a C long long and every
    pointer, the record's too, as a void pointer."""
    class FakeFn:
        argtypes = restype = None

    class FakeLib:
        def __init__(self, path):
            self.fns = {}

        def __getattr__(self, name):
            return self.fns.setdefault(name, FakeFn())

    monkeypatch.setattr(_native, "build_cuda_library", lambda stem: ("lib.so", ""))
    monkeypatch.setattr(cuda_lf.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(cuda_lf, "_LIB", None)
    lib = cuda_lf.build()
    types = lib.rbt_lf_count_fb2.argtypes
    assert len(types) == len(FB2_ARGS) and lib.rbt_lf_count_fb2.restype is ctypes.c_int
    assert types[FB2_ARGS.index("n")] is ctypes.c_longlong
    assert all(types[FB2_ARGS.index(k)] is ctypes.c_void_p
               for k in ("fb", "F", "base", "q", "lengths", "lo", "hi", "hi_rec", "stream"))


@pytest.mark.gpu
def test_cuda_record_kernel_matches_plain(layout_case):
    """The record launch == find_ranges_record_plain on the card, lo, hi and
    the record, at each width.  Runs only where jax and CUDA are both
    installed; chip_smoke.py (phases big_chr and pfp_big) makes the same
    checks with torch alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the record kernel has no CPU mode)")
    layout, _, _, txs, _, _, (qc, lens, _, _) = layout_case
    tx = TorchIndex.from_arrays({k: v.numpy() for k, v in txs[1].arrays.items()}, n=txs[1].n,
                                R=txs[1].R, A=txs[1].A, ma_wsize=0, ftab_k=0,
                                acgt_codes=txs[1].acgt_codes, device="cuda")
    for vq, vl in [(qc, lens)] + _views(qc, lens):
        q, ln = torch.from_numpy(vq).cuda(), torch.from_numpy(vl).cuda()
        got = cuda_lf.find_ranges_record(tx, q, ln)
        want = cuda_lf.find_ranges_record_plain(tx, q, ln)
        torch.cuda.synchronize()
        _eq([g.cpu() for g in got], [w.cpu().numpy() for w in want], f"{layout} {vq.shape}")
