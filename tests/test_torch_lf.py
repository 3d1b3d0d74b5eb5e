"""K1's count path at the edges of its ftab start and its code staging: the
port's find_ranges on the CPU (the plain torch path) == the JAX package's
`engine/count.find_ranges` on the same index and codes; the launch plan of
the kernel; and the CUDA launch path with its C entry replaced by a
recorder, so the CPU sees what a CUDA call passes to the kernel.  Every
output is an integer, so equality is exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rowbowt_tpu.construct.build import build_index as jax_build
from rowbowt_tpu.engine.count import find_ranges as jax_find_ranges
from rowbowt_tpu.engine.device import DeviceIndex
from rowbowt_tpu_torch.construct.build import build_index as torch_build
from rowbowt_tpu_torch.engine.batch import encode_batch
from rowbowt_tpu_torch.engine.count import find_ranges
from rowbowt_tpu_torch.engine.device import TorchIndex
from rowbowt_tpu_torch.ops import cuda_lf

ACGT = np.frombuffer(b"ACGT", np.uint8)
K = 5  # ftab k: 1,024 k-mers over a 900-symbol text, so many are absent


@pytest.fixture(scope="module")
def panel():
    """(text, jax index, port index, an absent k-mer) with an ftab of k = K."""
    rng = np.random.default_rng(21)
    text = np.concatenate([rng.choice(ACGT, size=900), np.array([1], dtype=np.uint8)])
    present = {text[i:i + K].tobytes() for i in range(len(text) - K)}
    kmers = (ACGT[[int(d) for d in np.base_repr(v, 4).zfill(K)]].tobytes() for v in range(4 ** K))
    absent = next(km for km in kmers if km not in present)
    return text, jax_build(text, ftab_k=K), torch_build(text, ftab_k=K), absent


def _reads(text, absent, rng):
    """Reads of every ftab kind: substrings (hits), substrings ending in an
    absent k-mer (misses), an 'N' among the last K codes, an 'N' before them,
    reads shorter than K, then length-0 lanes."""
    acgt_pos = np.flatnonzero(np.isin(text, ACGT))
    out = []
    for q in range(60):
        n = int(rng.integers(K, 40)) if q % 5 else int(rng.integers(1, K))
        p = int(rng.choice(acgt_pos[acgt_pos < len(text) - n]))
        r = bytearray(text[p:p + n].tobytes())
        kind = q % 4
        if kind == 1 and n >= K:
            r[-K:] = absent
        elif kind == 2:
            r[-int(rng.integers(1, min(K, n) + 1))] = ord("N")
        elif kind == 3 and n > K:
            r[int(rng.integers(0, n - K))] = ord("N")
        out.append(bytes(r))
    return out + [b""] * 6


CASES = {"L=32": 32, "L=31": 31, "L=k": K, "L=k-1": K - 1, "L=1": 1, "view_1": None}


def _batch(tidx, text, absent, L):
    """(qcodes, lengths) of width L (the last L codes of each read, lengths
    cut to L), or for L = None a view one row into a batch of width 31."""
    reads = _reads(text, absent, np.random.default_rng(22))
    if L is None:
        qc, lens = encode_batch(tidx, [b"ACGT"] + reads, pad_to=31)
        return torch.from_numpy(qc)[1:], torch.from_numpy(lens)[1:]
    qc, lens = encode_batch(tidx, [r[-L:] for r in reads], pad_to=L)
    return torch.from_numpy(qc), torch.from_numpy(lens)


@pytest.mark.parametrize("use_ftab", [True, False], ids=["ftab", "no_ftab"])
@pytest.mark.parametrize("case", list(CASES))
def test_find_ranges_edges_match_jax(panel, case, use_ftab):
    text, jidx, tidx, absent = panel
    q, ln = _batch(tidx, text, absent, CASES[case])
    B, L = q.shape
    tx = TorchIndex.from_index(tidx, "cpu")
    want = jax_find_ranges(DeviceIndex.from_index(jidx), jnp.asarray(q.numpy()),
                           jnp.asarray(ln.numpy()), use_ftab=use_ftab)
    launches = cuda_lf.LAUNCHES
    got = find_ranges(tx, q, ln, use_ftab=use_ftab)
    assert cuda_lf.LAUNCHES == launches  # CPU tensors never reach the kernel
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the batch holds the cases the ftab start tells apart
    lens = ln.numpy()
    assert (lens == 0).sum() == 6 and ((lens > 0) & (lens < K)).any()
    _, _, startj = cuda_lf.lf_start(tx, q, ln, use_ftab)
    startj = startj.numpy()
    if use_ftab and L >= K:
        in_last_k = q.numpy()[:, L - K:]
        assert (startj == K).any()  # hits
        assert ((startj == 0) & (lens >= K) & (in_last_k >= 0).all(axis=1)).any()  # misses
        assert ((lens >= K) & (in_last_k < 0).any(axis=1)).any()  # an N in the last k
    else:
        assert (startj == 0).all()


@pytest.mark.parametrize("L", [1, 31, 99, 100, 128, 1_000, 3_000, 3_001, 5_000])
def test_launch_plan_covers_every_lane(L):
    rng = np.random.default_rng(L)
    lanes, group = cuda_lf.LANES_PER_BLOCK, cuda_lf.GROUP
    for B in [*range(0, 40), *rng.integers(0, 1 << 20, 60).tolist(), 65_536]:
        for sms in (1, 16, 132):
            threads, staged = cuda_lf.launch_plan(B, L, sms)
            per_block = threads // group
            assert threads % 32 == 0 and 32 <= threads <= 1024
            assert per_block <= max(lanes, 32 // group)
            assert -(-B // per_block) * per_block >= B  # the grid covers every lane
            stride, unit = cuda_lf.staged_stride(L), 32 // group
            assert per_block == unit or per_block <= min(lanes, -(-B // sms))
            if staged:
                assert per_block * stride <= cuda_lf.MAX_STAGED_BYTES
            else:  # not even one warp's lanes fit
                assert per_block == unit and unit * stride > cuda_lf.MAX_STAGED_BYTES


@pytest.mark.parametrize("B,L,sms,plan", [
    (65_536, 128, 132, (512, True)),   # the main path: 256 lanes of 2 threads
    (65_536, 100, 132, (512, True)),
    (1_000, 128, 132, (32, True)),     # a small batch: one warp a block, spread over the SMs
    (4_099, 99, 16, (512, True)),
    (65_536, 1_000, 132, (64, True)),  # 32 lanes of 1,004 bytes fit
    (65_536, 3_000, 132, (32, True)),  # 16 lanes (one warp) of 3,004 bytes fit
    (65_536, 5_000, 132, (32, False)),  # not even one warp's codes fit: no staging
    (0, 128, 132, (32, True)),
])
def test_launch_plan(B, L, sms, plan):
    assert cuda_lf.launch_plan(B, L, sms) == plan


def test_staged_stride_is_an_odd_number_of_words():
    for L in range(1, 300):
        s = cuda_lf.staged_stride(L)
        assert s >= L and s % 4 == 0 and (s // 4) % 2 == 1 and s - L < 8


@pytest.fixture
def fake_entry(monkeypatch):
    """The launch path with its C entry, stream, SM count and current device
    replaced by recorders."""
    rec = {"calls": [], "entered": [], "current": 0, "rc": 0}

    class Lib:
        @staticmethod
        def rbt_lf_count(*a):
            rec["calls"].append(a)
            return rec["rc"]

        @staticmethod
        def rbt_cuda_error_string(rc):
            return b"invalid argument"

    class Device:
        def __init__(self, dev):
            rec["entered"].append(dev)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(cuda_lf, "_LIB", Lib)
    monkeypatch.setattr(cuda_lf, "LAUNCHES", 0)
    monkeypatch.setattr(cuda_lf, "_raw_stream", lambda dev: 1000 + dev)
    monkeypatch.setattr(cuda_lf, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(cuda_lf.torch.cuda, "current_device", lambda: rec["current"])
    monkeypatch.setattr(cuda_lf.torch.cuda, "device", Device)
    return rec


ARGS = ("fb", "syms", "F", "A", "n", "q", "lengths", "B", "L", "ftab", "k", "acgt", "lo", "hi",
        "threads", "stage", "stream")


def _call(rec) -> dict:
    assert len(rec["calls"]) == 1
    return dict(zip(ARGS, rec["calls"][0]))


def _cpu_batch(panel, L=32):
    text, _, tidx, absent = panel
    return _batch(tidx, text, absent, L)


@pytest.mark.parametrize("fb64", [True, False], ids=["fblock64", "fblock"])
def test_launch_passes_codes_untransposed_and_fresh_outputs(panel, fake_entry, fb64):
    tidx = panel[2]
    tx = TorchIndex.from_index(tidx, "cpu", fb64=fb64)
    q, ln = _cpu_batch(panel)
    lo, hi = cuda_lf.launch_k1(tx, q, ln, use_ftab=False)
    a = _call(fake_entry)
    key = "fblock64" if fb64 else "fblock"
    assert a["fb"] == tx.arrays[key].data_ptr() and a["syms"] == (64 if fb64 else 128)
    assert a["F"] == tx.arrays["F"].data_ptr() and (a["A"], a["n"]) == (tx.A, tx.n)
    assert a["q"] == q.data_ptr() and a["lengths"] == ln.data_ptr()  # no transpose, no copy
    assert (a["B"], a["L"]) == tuple(q.shape)
    assert (a["ftab"], a["k"], a["acgt"]) == (None, 0, 0)
    for t, name in ((lo, "lo"), (hi, "hi")):
        assert t.dtype == torch.int32 and t.shape == (q.shape[0],) and t.data_ptr() == a[name]
    assert lo.data_ptr() != hi.data_ptr()
    assert (a["threads"], a["stage"]) == (cuda_lf.launch_plan(*q.shape, 132)[0], 1)
    assert a["stream"] == 1000 and fake_entry["entered"] == []
    assert cuda_lf.LAUNCHES == 1


@pytest.mark.parametrize("L,use_ftab,has", [(32, True, True), (32, False, False),
                                            (K, True, True), (K - 1, True, False)])
def test_launch_passes_the_ftab_or_none(panel, fake_entry, L, use_ftab, has):
    tidx = panel[2]
    tx = TorchIndex.from_index(tidx, "cpu")
    q, ln = _cpu_batch(panel, L)
    cuda_lf.launch_k1(tx, q, ln, use_ftab=use_ftab)
    a = _call(fake_entry)
    if has:
        codes = [c & 0xFF for c in tx.acgt_codes]
        assert a["ftab"] == tx.arrays["ftab"].data_ptr() and a["k"] == K
        assert a["acgt"] == codes[0] | codes[1] << 8 | codes[2] << 16 | codes[3] << 24
    else:
        assert (a["ftab"], a["k"]) == (None, 0)


def test_launch_packs_an_absent_base_as_ff(panel, fake_entry):
    tx = TorchIndex.from_index(panel[2], "cpu")
    tx = dataclasses.replace(tx, acgt_codes=(tx.acgt_codes[0], -1, *tx.acgt_codes[2:]))
    cuda_lf.launch_k1(tx, *_cpu_batch(panel))
    assert (_call(fake_entry)["acgt"] >> 8) & 0xFF == 0xFF


def test_launch_counts_launches_not_empty_batches(panel, fake_entry):
    tx = TorchIndex.from_index(panel[2], "cpu")
    q, ln = _cpu_batch(panel)
    lo, hi = cuda_lf.launch_k1(tx, q[:0], ln[:0])  # the entry launches nothing for B == 0
    assert lo.shape == (0,) and cuda_lf.LAUNCHES == 0
    cuda_lf.launch_k1(tx, q, ln)
    assert cuda_lf.LAUNCHES == 1
    fake_entry["rc"] = 1
    with pytest.raises(RuntimeError, match="LF kernel launch failed: invalid argument"):
        cuda_lf.launch_k1(tx, q, ln)
    assert cuda_lf.LAUNCHES == 1 and len(fake_entry["calls"]) == 3


def _unaligned(t):
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("fault,error,match", [
    ("int64 table", TypeError, "table must be int32"),
    ("int64 F", TypeError, "F must be int32 for fblock64 rows"),
    ("int32 F on two-level rows", TypeError, "F must be int64 for fb2_64 rows"),
    ("int64 qcodes", TypeError, "qcodes must be int32"),
    ("A > 8", ValueError, "alphabet of 9 codes"),
    ("unaligned rows", ValueError, "row table is not contiguous and 16-byte aligned"),
    ("ftab shape", ValueError, "ftab of shape"),
    ("ACGT code", ValueError, "ACGT codes"),
    ("lengths shape", ValueError, "lengths must be"),
])
def test_launch_refuses(panel, fake_entry, fault, error, match):
    tx = TorchIndex.from_index(panel[2], "cpu")
    q, ln = _cpu_batch(panel)
    arrays = dict(tx.arrays)
    if fault == "int64 table":
        arrays["fblock64"] = arrays["fblock64"].long()
    elif fault == "int64 F":
        arrays["F"] = arrays["F"].long()
    elif fault == "int32 F on two-level rows":
        # the same 64 B rows standing as a one-superblock two-level table's
        # bit planes: F must widen
        arrays["pl2_64"] = arrays.pop("fblock64")
        arrays["fb2_base"] = torch.zeros((1, 8), dtype=torch.int64)
        del arrays["ftab"]
    elif fault == "int64 qcodes":
        q = q.long()
    elif fault == "unaligned rows":
        arrays["fblock64"] = _unaligned(arrays["fblock64"])
    elif fault == "ftab shape":
        arrays["ftab"] = arrays["ftab"][:-1]
    elif fault == "lengths shape":
        ln = ln[:-1]
    tx = dataclasses.replace(tx, arrays=arrays, A=9 if fault == "A > 8" else tx.A,
                             acgt_codes=(9, 3, 4, 5) if fault == "ACGT code" else tx.acgt_codes)
    with pytest.raises(error, match=match):
        cuda_lf.launch_k1(tx, q, ln)
    assert fake_entry["calls"] == [] and cuda_lf.LAUNCHES == 0


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_at_the_edges(panel):
    """K1 == find_ranges_plain on the card at each edge of this file, both
    layouts, ftab on and off.  Runs only where jax and CUDA are both
    installed; chip_smoke.py (phase parity) makes the same checks with torch
    alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU mode)")
    text, _, tidx, absent = panel
    for fb64 in (True, False):
        tx = TorchIndex.from_index(tidx, "cuda", fb64=fb64)
        for L in CASES.values():
            q, ln = _batch(tidx, text, absent, L)
            q, ln = q.cuda(), ln.cuda()
            for use_ftab in (True, False):
                got = find_ranges(tx, q, ln, use_ftab=use_ftab)
                want = cuda_lf.find_ranges_plain(tx, q, ln, use_ftab=use_ftab)
                for g, w in zip(got, want):
                    assert torch.equal(g, w)
