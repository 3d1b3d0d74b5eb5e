"""The per-layer readers on a synthetic profile and synthetic spans."""

import types

import numpy as np
import pytest
import torch

from portbench import bounds
from portbench.spec import load_module
from portbench.trace import Profile, SpanClock

# two batches of 50 us: the codes' copy, the kernel, a torch kernel, lo and hi back
DEVICE = [
    ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 2.0, 9.0),
    ("kernel", "void (anonymous namespace)::lf_count_kernel<64, true, false>(int4 const*)", 10.0, 20.0),
    ("kernel", "void at::native::vectorized_elementwise_kernel<4>()", 19.0, 21.0),
    ("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 30.0, 31.0),
    ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 52.0, 59.0),
    ("kernel", "void (anonymous namespace)::lf_count_kernel<64, true, false>(int4 const*)", 60.0, 66.0),
    ("kernel", "void at::native::vectorized_elementwise_kernel<4>()", 70.0, 72.0),
    ("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 80.0, 81.0),
    ("kernel", "void (anonymous namespace)::lf_count_kernel<64, true, false>(int4 const*)", 120.0, 130.0),
]
MARKS = [("pb.batch", 0.0, 50.0), ("pb.h2d", 0.0, 10.0), ("pb.search", 10.0, 22.0),
         ("pb.d2h", 22.0, 40.0), ("pb.batch", 50.0, 100.0), ("pb.h2d", 50.0, 60.0),
         ("pb.search", 60.0, 73.0), ("pb.d2h", 73.0, 95.0)]


def profile(launches=2):
    return Profile(device=list(DEVICE), marks=list(MARKS), batches=2, launches=launches)


def test_busy_window_and_breakdown():
    p = profile()
    assert p.window() == (0.0, 100.0) and p.window_s() == pytest.approx(1e-4)
    # busy: 2-9, 10-21, 30-31, 52-59, 60-66, 70-72, 80-81 -> 7 + 11 + 1 + 7 + 6 + 2 + 1 us
    assert p.busy_s() == pytest.approx(35e-6)
    b = p.breakdown()
    # the kernel at 120 us lies past the window
    assert [n for n, _ in b["device_ops"]][:2] == [DEVICE[1][1], DEVICE[0][1]]
    assert [v for _, v in b["device_ops"]] == pytest.approx([16e-6, 14e-6, 4e-6, 2e-6])
    gaps = dict(b["idle_gaps"])
    # idle, named by the host's innermost mark as each gap begins: 0-2 and
    # 9-10 h2d, 21-30 search, 31-52 d2h, 59-60 h2d, 66-70 and 72-80 search,
    # 81-100 d2h
    assert gaps == pytest.approx({"h2d": 4e-6, "d2h": 40e-6, "search": 21e-6})
    assert sum(gaps.values()) == pytest.approx(1e-4 - 35e-6)


def run_of(prof, **kw):
    return types.SimpleNamespace(profile=prof, memo={}, **kw)


def test_device_idle_and_launches():
    assert load_module("metrics", "device_idle").read(run_of(profile())) == pytest.approx(65.0)
    read = load_module("metrics", "launches_per_batch").read
    assert read(run_of(profile())) == 2.0  # two records a batch, the port's 2 counted
    assert read(run_of(profile(launches=3))) is None  # the profile dropped a record
    assert load_module("metrics", "device_idle").read(
        run_of(Profile(device=[], marks=MARKS, batches=2, launches=0))) is None


def test_span_readers():
    s = SpanClock(cuda=False)
    s.spans = [("h2d", 0, 0.004), ("search", 0, 0.001), ("h2d", 1, 0.002), ("locate", 1, 0.01)]
    run = types.SimpleNamespace(spans=s, span_batches=2)
    assert load_module("metrics", "h2d_ms").read(run) == pytest.approx(3.0)
    assert load_module("metrics", "search_ms").read(run) == pytest.approx(0.5)
    assert load_module("metrics", "locate_ms").read(run) == pytest.approx(5.0)
    assert load_module("metrics", "d2h_ms").read(run) is None


def test_the_tail_of_the_batches():
    from portbench.harness import p95_ms

    times = [0.001 * k for k in range(1, 101)]  # 1 .. 100 ms
    assert p95_ms(times) == pytest.approx(95.05)
    assert p95_ms(times[::-1]) == pytest.approx(95.05)


@pytest.fixture(scope="module")
def tiny():
    from rowbowt_tpu_torch.construct.build import build_index
    from rowbowt_tpu_torch.engine.batch import encode_batch
    from rowbowt_tpu_torch.engine.device import TorchIndex

    rng = np.random.default_rng(1)
    text = np.append(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), 3000), 1).astype(np.uint8)
    idx = build_index(text, doc_starts=np.array([0]), doc_names=["ref"])
    tx = TorchIndex.from_index(idx, torch.device("cpu"))
    reads = [text[s:s + 20].tobytes() for s in (5, 700, 1500, 2900)]
    qc, ln = encode_batch(idx, reads, pad_to=32)
    return idx, tx, qc, ln


def test_k1_roofline_over_the_records(tiny):
    idx, tx, qc, ln = tiny
    prof = profile()
    pool = types.SimpleNamespace(batches=[(qc, ln)])
    q = types.SimpleNamespace(k1_record=lambda tx: False)
    got = load_module("metrics", "k1_roofline").read(
        run_of(prof, tx=tx, query=q, pool=pool, slots=[0, 0]))
    work = bounds.k1_work(tx, torch.from_numpy(qc), torch.from_numpy(ln), "fblock64")
    b = bounds.k1_bound(work, 4, 32, tx.A, "fblock64")["bound_us"]
    assert got == pytest.approx(100 * 2 * b / (10.0 + 6.0))
    prof.batches = 3  # a record a batch, or nothing
    assert load_module("metrics", "k1_roofline").read(
        run_of(prof, tx=tx, query=q, pool=pool, slots=[0, 0, 0])) is None


def test_walk_roofline_over_the_records(tiny):
    idx, tx, qc, ln = tiny
    dev = [("kernel", "void kval_walk_kernel<int>(int const*)", 10.0, 14.0),
           ("kernel", "void kval_walk_kernel<int>(int const*)", 60.0, 62.0)]
    prof = Profile(device=dev, marks=list(MARKS), batches=2, launches=2)
    res = dict(lo=np.array([3, 9]), hi=np.array([5, 9]), flat=np.array([40, 41, 42, 7]),
               offs=np.array([0, 3, 4]))
    got = load_module("metrics", "walk_roofline").read(
        run_of(prof, tx=tx, idx=idx, results=[res, res], slots=[0, 0]))
    b = bounds.walk_bound("kval", 2, res["flat"], res["offs"], res["hi"], entry_bytes=4)["bound_us"]
    assert got == pytest.approx(100 * 2 * b / 6.0)
