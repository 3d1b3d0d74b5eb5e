"""The port's count path (plain torch loop on the CPU) == the JAX package's
`engine/count.find_ranges` and its interpret-mode Pallas kernel, buffer for
buffer, on the same index and the same read batch."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rowbowt_tpu.construct.build import build_index as jax_build
from rowbowt_tpu.engine.batch import encode_batch as jax_encode
from rowbowt_tpu.engine.count import counts_from_ranges as jax_counts
from rowbowt_tpu.engine.count import find_ranges as jax_find_ranges
from rowbowt_tpu.engine.device import DeviceIndex
from rowbowt_tpu_torch.construct.build import build_index as torch_build
from rowbowt_tpu_torch.engine.batch import encode_batch
from rowbowt_tpu_torch.engine.count import counts_from_ranges, find_ranges
from rowbowt_tpu_torch.engine.device import TorchIndex
from rowbowt_tpu_torch.ops import cuda_lf

ACGT = np.frombuffer(b"ACGT", np.uint8)
K = 4  # ftab k of the test indexes


@pytest.fixture(scope="module")
def text700():
    rng = np.random.default_rng(11)
    t = rng.choice(ACGT, size=700)
    return np.concatenate([t, np.array([1], dtype=np.uint8)])


def _reads(text, seed):
    """Substrings (ftab hits), substrings with a substitution or an 'N'
    (absent code), random strings (empty ranges, ftab misses), reads shorter
    than K, then length-0 pad lanes."""
    rng = np.random.default_rng(seed)
    acgt_pos = np.flatnonzero(np.isin(text, ACGT))
    out = []
    for q in range(48):
        L = int(rng.integers(K, 30)) if q % 6 else int(rng.integers(1, K))
        p = int(rng.choice(acgt_pos[acgt_pos < len(text) - L]))
        r = text[p:p + L].copy()
        kind = q % 4
        if kind == 1:
            r[rng.integers(0, L)] = rng.choice(ACGT)
        elif kind == 2:
            r[rng.integers(0, L)] = ord("N")
        elif kind == 3:
            r = rng.choice(ACGT, size=L)
        out.append(bytes(r))
    return out + [b""] * 8


@pytest.fixture(scope="module", params=["text700", "rand_index"])
def case(request):
    """(jax index, port index, qcodes, lengths) over the same text, both
    built with an ftab of k = K."""
    if request.param == "text700":
        text = request.getfixturevalue("text700")
    else:
        text = request.getfixturevalue("rand_index")[1]
    jidx, tidx = jax_build(text, ftab_k=K), torch_build(text, ftab_k=K)
    reads = _reads(text, seed=12)
    qc, lens = encode_batch(tidx, reads, pad_to=32)
    jqc, jlens = jax_encode(jidx, reads, pad_to=32)
    np.testing.assert_array_equal(qc, jqc)
    np.testing.assert_array_equal(lens, jlens)
    return jidx, tidx, qc, lens


@pytest.mark.parametrize("fb64", [True, False])
@pytest.mark.parametrize("use_ftab", [True, False])
def test_find_ranges_matches_jax(case, fb64, use_ftab):
    jidx, tidx, qc, lens = case
    dx = DeviceIndex.from_index(jidx, fb64=fb64)
    tx = TorchIndex.from_index(tidx, "cpu", fb64=fb64)
    want = jax_find_ranges(dx, jnp.asarray(qc), jnp.asarray(lens), use_ftab=use_ftab)
    launches = cuda_lf.LAUNCHES
    got = find_ranges(tx, torch.from_numpy(qc), torch.from_numpy(lens), use_ftab=use_ftab)
    assert cuda_lf.LAUNCHES == launches  # CPU tensors never reach the kernel
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    lo, hi = (g.numpy() for g in got)
    np.testing.assert_array_equal(counts_from_ranges(*got).numpy(),
                                  np.asarray(jax_counts(*map(jnp.asarray, (lo, hi)))))
    # the batch covers every case the loop distinguishes
    _, _, startj = cuda_lf.lf_start(tx, torch.from_numpy(qc), torch.from_numpy(lens),
                                    use_ftab)
    startj = startj.numpy()
    assert ((lens == 0) & (lo == 0) & (hi == tidx.n - 1)).sum() == 8  # pad lanes
    assert ((hi < lo) & (lens > 0)).any() and (hi >= lo).any()  # empty and found
    assert ((lens > 0) & (lens < K)).any()  # shorter than k
    assert ((qc < 0) & (np.arange(32)[None, :] >= 32 - lens[:, None])).any()  # -1 code
    if use_ftab:
        assert (startj == K).any() and ((startj == 0) & (lens >= K)).any()  # hit, miss
    else:
        assert (startj == 0).all()


def test_find_ranges_matches_pallas_interpret(text700):
    """Port (96B rows, no ftab) == rowbowt_tpu/ops/pallas_lf.py run in
    interpret mode, as tests/test_backends.py runs it."""
    from jax.experimental import pallas as pl

    from rowbowt_tpu.ops import pallas_lf

    jidx, tidx = jax_build(text700), torch_build(text700)
    reads = _reads(text700, seed=13)[:40]  # a multiple of the tile of 8
    qc, lens = encode_batch(tidx, reads)
    dx = DeviceIndex.from_index(jidx, fb64=False)
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        want = pallas_lf.find_ranges_pallas(dx, jnp.asarray(qc), jnp.asarray(lens), tile=8)
    finally:
        pl.pallas_call = orig
    tx = TorchIndex.from_index(tidx, "cpu", fb64=False)
    got = find_ranges(tx, torch.from_numpy(qc), torch.from_numpy(lens), use_ftab=False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_lf_loop_refuses_other_devices(text700):
    tx = TorchIndex.from_index(torch_build(text700), "cpu")
    q = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    z = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no LF loop for device meta"):
        cuda_lf.find_ranges(tx, q, z)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain(text700):
    """K1 == find_ranges_plain on the card, both layouts, ftab on and off.
    Runs only where jax and CUDA are both installed; chip_smoke.py makes the
    same check with torch alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU mode)")
    reads = _reads(text700, seed=14) * 40  # ragged lane count: 2,240
    tidx = torch_build(text700, ftab_k=K)
    qc, lens = encode_batch(tidx, reads, pad_to=32)
    q, ln = torch.from_numpy(qc).cuda(), torch.from_numpy(lens).cuda()
    for fb64 in (True, False):
        tx = TorchIndex.from_index(tidx, "cuda", fb64=fb64)
        for use_ftab in (True, False):
            launches = cuda_lf.LAUNCHES
            got = find_ranges(tx, q, ln, use_ftab=use_ftab)
            want = cuda_lf.find_ranges_plain(tx, q, ln, use_ftab=use_ftab)
            torch.cuda.synchronize()
            assert cuda_lf.LAUNCHES == launches + 1
            for g, w in zip(got, want):
                assert torch.equal(g, w)
