"""The gather probes P1-P3: the port's plain twins (ops/cuda_gather.py) ==
the Pallas kernels of tools/vmem_gather_probe.py run in interpret mode, on
the tool's own inputs; the port's probe tool on the CPU; and the wrappers'
argument checks.  Every output is an integer, so equality is exact."""

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
