"""The gather probes P1-P3: the port's plain twins (ops/cuda_gather.py) ==
the Pallas kernels of tools/vmem_gather_probe.py run in interpret mode, on
the tool's own inputs; the port's probe tool on the CPU; the wrappers'
argument checks; the launch plan of the kernels' 16-byte path; the launch
path with its C entries replaced by recorders; and the CPU route on ragged
sizes and offset views.  Every output is an integer, so equality is exact."""

import functools
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from rowbowt_tpu_torch.ops import cuda_gather
from rowbowt_tpu_torch.tools import gather_probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("A rows+tala", "B tala axis0", "C chained A")


@pytest.fixture(scope="module")
def jax_probe_runs():
    """{name: (inputs, output, numpy expectation)} of the JAX tool's main():
    its `bench` is replaced by a recorder and pl.pallas_call runs in
    interpret mode, so the tool's file is run as it is."""
    from jax.experimental import pallas as pl

    spec = importlib.util.spec_from_file_location(
        "vmem_gather_probe", os.path.join(REPO, "tools", "vmem_gather_probe.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    runs = {}

    def record(name, run, args, expect=None, steps=1):
        out = np.asarray(jax.block_until_ready(run(*args)))
        runs[name] = ([np.array(a) for a in args], out, expect)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tool, "bench", record)
        mp.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
        tool.main()
    return runs


@pytest.mark.parametrize("name,plain", [
    ("A rows+tala", cuda_gather.gather_rows_plain),
    ("B tala axis0", cuda_gather.gather_cols_plain),
    ("C chained A", functools.partial(cuda_gather.gather_chain_plain, steps=gather_probe.STEPS)),
])
def test_plain_twin_matches_pallas_interpret(jax_probe_runs, name, plain):
    (tab, idx), out, expect = jax_probe_runs[name]
    np.testing.assert_array_equal(out, expect)
    got = plain(torch.from_numpy(tab), torch.from_numpy(idx)).numpy()
    assert got.dtype == out.dtype == np.int32
    np.testing.assert_array_equal(got, out)


def test_port_tool_inputs_match_jax_tool(jax_probe_runs):
    """Same draws in the same order: tab, idx, then idxB."""
    tab, idx, idxB = gather_probe.make_inputs()
    (jtab, jidx), _, _ = jax_probe_runs["A rows+tala"]
    np.testing.assert_array_equal(tab.reshape(jtab.shape), jtab)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(idxB, jax_probe_runs["B tala axis0"][0][1])
    for got, name in zip(gather_probe.expectations(tab, idx, idxB), NAMES):
        np.testing.assert_array_equal(got, jax_probe_runs[name][2])


def test_port_tool_on_cpu_prints_three_ok(capsys):
    lines = gather_probe.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out == lines and len(lines) == 3
    for line, name in zip(lines, NAMES):
        assert line.startswith(f"{name}: ok=True ") and line.endswith(" ns/elem")


def test_port_tool_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        gather_probe.main([])


_TAB = torch.zeros((16, 128), dtype=torch.int32)
_IDX = torch.zeros(8, dtype=torch.int32)
_IDX2 = torch.zeros((4, 128), dtype=torch.int32)


@pytest.mark.parametrize("call,error", [
    (lambda: cuda_gather.gather_rows(_TAB, _IDX.long()), TypeError),
    (lambda: cuda_gather.gather_rows(_TAB.float(), _IDX), TypeError),
    (lambda: cuda_gather.gather_rows(_TAB, _IDX2), ValueError),
    (lambda: cuda_gather.gather_rows(_TAB.t(), _IDX), ValueError),
    (lambda: cuda_gather.gather_cols(_TAB, _IDX), ValueError),
    (lambda: cuda_gather.gather_cols(_TAB, _IDX2[:, :64].contiguous()), ValueError),
    (lambda: cuda_gather.gather_chain(_TAB, _IDX.long(), 4), TypeError),
    (lambda: cuda_gather.gather_chain(_TAB, _IDX, -1), ValueError),
], ids=["rows_int64_idx", "rows_float_tab", "rows_2d_idx", "rows_strided_tab",
        "cols_1d_idx", "cols_width", "chain_int64_idx", "chain_negative_steps"])
def test_wrappers_reject_bad_inputs(call, error):
    with pytest.raises(error):
        call()


def test_wrappers_refuse_other_devices():
    tab = torch.zeros((16, 128), dtype=torch.int32, device="meta")
    idx = torch.zeros(8, dtype=torch.int32, device="meta")
    for call in (lambda: cuda_gather.gather_rows(tab, idx),
                 lambda: cuda_gather.gather_chain(tab, idx, 2)):
        with pytest.raises(ValueError, match="no gather kernel for device meta"):
            call()


_META = torch.zeros(8, dtype=torch.int32, device="meta")


@pytest.mark.parametrize("call,error,match", [
    (lambda: cuda_gather.gather_rows(_TAB, _META), ValueError, "tab is on cpu, idx on meta"),
    (lambda: cuda_gather.gather_rows(_TAB.long(), _IDX), TypeError, "tab must be int32"),
    (lambda: cuda_gather.gather_rows(_TAB, _IDX.long()), TypeError, "idx must be int32"),
    (lambda: cuda_gather.gather_rows(_TAB, _IDX2.t()[0]), ValueError, "contiguous"),
    (lambda: cuda_gather.gather_chain(_TAB, _IDX2, 2), ValueError, "1 dimension"),
    (lambda: cuda_gather.gather_cols(_TAB, _IDX2.t()), ValueError, "contiguous"),
], ids=["mixed_devices", "int64_tab", "int64_idx", "strided_idx", "chain_2d_idx",
        "cols_strided_idx"])
def test_checks_name_the_fault(call, error, match):
    with pytest.raises(error, match=match):
        call()


_A, _B = 0x7F0000001000, 0x7F0000002000  # two 16-byte-aligned addresses


@pytest.mark.parametrize("n,idx_ptr,out_ptr,sms,plan", [
    (32_768, _A, _B, 132, (8_192, 64)),       # the probe's shape: 128 blocks of 64
    (32_769, _A, _B, 132, (8_192, 64)),       # one ragged output after the groups
    (32_767, _A, _B, 132, (8_191, 64)),
    (32_768, _A + 4, _B, 132, (0, 256)),      # idx[1:]: every output one thread
    (32_768, _A, _B + 8, 132, (0, 256)),      # an unaligned out
    (4_096, _A, _B, 132, (1_024, 32)),
    (5, _A, _B, 132, (1, 32)),
    (3, _A, _B, 132, (0, 32)),
    (0, 0, 0, 132, (0, 32)),
    (1 << 24, _A, _B, 132, (1 << 22, 256)),   # a large call: full blocks
    (32_768, _A, _B, 16, (8_192, 256)),       # a card with fewer SMs
])
def test_launch_plan(n, idx_ptr, out_ptr, sms, plan):
    assert cuda_gather.launch_plan(n, idx_ptr, out_ptr, sms) == plan


@pytest.mark.parametrize("n,chains,sms,threads", [
    (32_768, 1, 132, 256),   # the probe's shape: 128 blocks of 256
    (32_768, 2, 132, 128),   # 16,384 threads: 128 blocks of 128
    (32_768, 4, 132, 64),
    (33_793, 4, 132, 96),    # 8,449 threads: one more than 64 a block on 132 SMs cover
    (33_792, 1, 132, 256),
    (5, 4, 132, 32), (1, 2, 132, 32), (0, 1, 132, 32),
    (1 << 22, 1, 132, 256),  # a long grid: full blocks
    (32_768, 1, 16, 256),    # a card with fewer SMs
])
def test_chain_plan(n, chains, sms, threads):
    assert cuda_gather.chain_plan(n, chains, sms) == threads
    items = -(-n // chains)
    assert threads == 256 or -(-items // threads) <= sms
    assert threads == 32 or -(-items // (threads - 32)) > sms


def test_chain_designs_launch_their_plan(fake_entries, monkeypatch):
    """gather_chain launches the CHAIN design with chain_plan's block size;
    gather_chain_as any design, the first one at its fixed 256 threads.  The
    C entry sees (tab, idx, out, n, steps, chains, l1, threads, stream)."""
    monkeypatch.setattr(cuda_gather, "_check", lambda tab, idx, d: 0)
    monkeypatch.setattr(cuda_gather, "_sm_count", lambda dev: 132)
    tab, idx = torch.zeros(128, dtype=torch.int32), torch.zeros(32_768, dtype=torch.int32)
    cuda_gather.gather_chain(tab, idx, 7)
    for design in cuda_gather.CHAIN_DESIGNS:
        cuda_gather.gather_chain_as(tab, idx, 7, design)
    got = [a[5:8] for _, a in fake_entries["calls"]]
    chains, l1, _ = cuda_gather.CHAIN_DESIGNS[cuda_gather.CHAIN]
    assert got == [(chains, int(l1), cuda_gather.chain_plan(32_768, chains, 132)),
                   (1, 1, 256), (1, 0, 256), (2, 0, 128), (4, 0, 64)]
    assert cuda_gather.LAUNCHES["gather_chain"] == 5


def test_launch_plan_covers_every_output_one_block_per_sm():
    rng = np.random.default_rng(3)
    for n in [*range(0, 70), *rng.integers(0, 1 << 26, 200).tolist()]:
        for off in (0, 4, 8, 12):
            for sms in (1, 8, 132):
                groups, threads = cuda_gather.launch_plan(n, _A + off, _B, sms)
                items = n - (cuda_gather.VEC - 1) * groups
                assert groups == (n // cuda_gather.VEC if off == 0 else 0)
                assert 0 <= items <= n and groups * cuda_gather.VEC + items - groups == n
                assert threads % 32 == 0 and 32 <= threads <= 256
                # one block per SM covers the threads, and 32 fewer would not
                assert threads == 256 or -(-items // threads) <= sms
                assert threads == 32 or -(-items // (threads - 32)) > sms


@pytest.fixture
def fake_entries(monkeypatch):
    """The launch path with its C entries, stream and current device replaced
    by recorders: the CPU sees what a CUDA call would pass to the kernel."""
    rec = {"calls": [], "entered": [], "current": 0, "rc": 0}

    class Device:
        def __init__(self, dev):
            rec["entered"].append(dev)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    for name in cuda_gather.LAUNCHES:
        monkeypatch.setitem(cuda_gather._ENTRIES, name,
                            lambda *a, name=name: rec["calls"].append((name, a)) or rec["rc"])
        monkeypatch.setitem(cuda_gather.LAUNCHES, name, 0)
    monkeypatch.setattr(cuda_gather, "_ERROR_STRING", lambda rc: b"invalid argument")
    monkeypatch.setattr(cuda_gather, "_raw_stream", lambda dev: 1000 + dev)
    monkeypatch.setattr(cuda_gather.torch.cuda, "current_device", lambda: rec["current"])
    monkeypatch.setattr(cuda_gather.torch.cuda, "device", Device)
    return rec


@pytest.mark.parametrize("dev,current", [(0, 0), (1, 1), (1, 0), (0, 2)])
def test_launch_enters_device_context_only_off_the_current_device(fake_entries, dev, current):
    fake_entries["current"] = current
    cuda_gather._launch("gather_rows", dev, 8, 11, 22, 33, 8, 2, 32)
    assert fake_entries["calls"] == [("gather_rows", (11, 22, 33, 8, 2, 32, 1000 + dev))]
    assert fake_entries["entered"] == ([] if dev == current else [dev])
    assert cuda_gather.LAUNCHES["gather_rows"] == 1


def test_launch_counts_only_launches(fake_entries):
    cuda_gather._launch("gather_cols", 0, 0, 1, 2, 3, 0, 128, 0, 32)  # empty: nothing launched
    assert cuda_gather.LAUNCHES["gather_cols"] == 0
    fake_entries["rc"] = 1
    with pytest.raises(RuntimeError, match="gather_chain kernel launch failed: invalid argument"):
        cuda_gather._launch("gather_chain", 0, 5, 1, 2, 3, 5, 4)
    assert cuda_gather.LAUNCHES["gather_chain"] == 0
    assert len(fake_entries["calls"]) == 2


def _ints(rng, high, shape):
    return torch.from_numpy(rng.integers(0, high, shape, dtype=np.int32))


@pytest.mark.parametrize("B", [0, 1, 3, 4, 5, 33, 32_769])
@pytest.mark.parametrize("skip", [0, 1], ids=["whole", "view_1"])
def test_cpu_route_rows_and_chain_ragged_and_offset(B, skip):
    rng = np.random.default_rng(B)
    tab = _ints(rng, 4096, (32, 128))
    idx = _ints(rng, 4096, B + skip)[skip:]
    flat = tab.numpy().reshape(-1)
    want = flat[idx.numpy()]
    np.testing.assert_array_equal(cuda_gather.gather_rows(tab, idx).numpy(), want)
    for _ in range(2):
        want = flat[want]
    np.testing.assert_array_equal(cuda_gather.gather_chain(tab, idx, 3).numpy(), want)


@pytest.mark.parametrize("cols", [1, 3, 100, 128])
@pytest.mark.parametrize("K,skip", [(0, 0), (1, 0), (7, 0), (256, 0), (8, 1)])
def test_cpu_route_cols_widths_and_offset(cols, K, skip):
    rng = np.random.default_rng(cols * 1000 + K)
    rows = 50
    tab = _ints(rng, 1 << 20, (rows, cols))
    idx = _ints(rng, rows, (K, cols))[skip:]
    want = tab.numpy()[idx.numpy(), np.arange(cols)[None, :]]
    got = cuda_gather.gather_cols(tab, idx)
    assert got.dtype == torch.int32 and got.shape == idx.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_check_indices():
    cuda_gather.check_indices(torch.tensor([0, 5, 9], dtype=torch.int32), 10)
    for bad in ([0, 10], [-1, 3]):
        with pytest.raises(ValueError, match=r"outside \[0, 10\)"):
            cuda_gather.check_indices(torch.tensor(bad, dtype=torch.int32), 10)


@pytest.mark.gpu
def test_cuda_kernels_match_plain():
    """P1-P3 == their plain twins on the card, at the probe tool's shapes.
    Runs only where jax and CUDA are both installed; chip_smoke.py makes the
    same check with torch alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the gather kernels have no CPU mode)")
    launches = sum(cuda_gather.LAUNCHES.values())
    for name, fn, expect, _ in gather_probe.probes(torch.device("cuda")):
        got = fn()
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), expect, err_msg=name)
    assert sum(cuda_gather.LAUNCHES.values()) == launches + 3
