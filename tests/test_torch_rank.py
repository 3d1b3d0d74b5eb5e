"""rowbowt_tpu_torch.ops.rank (plain torch) == rowbowt_tpu.ops.rank (JAX on
the CPU) on the same index and the same random inputs, exactly: every output
is an integer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rowbowt_tpu.construct.build import build_index as jax_build
from rowbowt_tpu.engine.device import DeviceIndex
from rowbowt_tpu.ops import rank as JR
from rowbowt_tpu_torch.construct.build import build_index as torch_build
from rowbowt_tpu_torch.engine.device import TorchIndex
from rowbowt_tpu_torch.ops import rank as TR

ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(scope="module")
def text():
    rng = np.random.default_rng(11)
    t = rng.choice(ACGT, size=700)
    return np.concatenate([t, np.array([1], dtype=np.uint8)])


def _pair(text, fb64, ftab_k=0):
    dx = DeviceIndex.from_index(jax_build(text, ftab_k=ftab_k), fb64=fb64)
    tx = TorchIndex.from_index(torch_build(text, ftab_k=ftab_k), "cpu", fb64=fb64)
    return dx, tx


def _texts(request, name):
    return request.getfixturevalue("text") if name == "text700" else \
        request.getfixturevalue("rand_index")[1]


@pytest.mark.parametrize("source", ["text700", "rand_index"])
@pytest.mark.parametrize("layout", ["fblock", "fblock64"])
def test_rank_matches_jax(request, source, layout):
    """Random (i, c) with i in [0, n] and c in [-1, A), plus explicit i == n
    and c == -1 lanes."""
    dx, tx = _pair(_texts(request, source), fb64=layout == "fblock64")
    assert layout in tx.arrays and layout in dx.arrays
    rng = np.random.default_rng(5)
    i = rng.integers(0, tx.n + 1, size=4096, dtype=np.int32)
    c = rng.integers(-1, tx.A, size=4096, dtype=np.int32)
    i[:64] = tx.n
    c[64:128] = -1
    jfn, tfn = ((JR.rank_fblock64, TR.rank_fblock64) if layout == "fblock64"
                else (JR.rank_fblock, TR.rank_fblock))
    want = np.asarray(jfn(dx, jnp.asarray(i), jnp.asarray(c)))
    got = tfn(tx, torch.from_numpy(i), torch.from_numpy(c)).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout", ["fblock", "fblock64"])
def test_lf_step_matches_jax(text, layout):
    """One LF step from random nonempty ranges, incl. the full range (hi+1 == n)."""
    dx, tx = _pair(text, fb64=layout == "fblock64")
    rng = np.random.default_rng(6)
    a = rng.integers(0, tx.n, size=2048)
    b = rng.integers(0, tx.n, size=2048)
    lo, hi = np.minimum(a, b).astype(np.int32), np.maximum(a, b).astype(np.int32)
    lo[:32], hi[:32] = 0, tx.n - 1
    c = rng.integers(-1, tx.A, size=2048, dtype=np.int32)
    jstep, tstep = JR.lf_step_auto(dx), TR.lf_step_auto(tx)
    want = jstep(dx, jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(c))
    got = tstep(tx, torch.from_numpy(lo), torch.from_numpy(hi), torch.from_numpy(c))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_kmer_codes_and_ftab_lookup_match_jax(text):
    dx, tx = _pair(text, fb64=True, ftab_k=4)
    rng = np.random.default_rng(7)
    codes = rng.integers(-1, tx.A, size=(512, 4)).astype(np.int32)
    acgt = np.asarray(tx.acgt_codes, np.int32)
    codes[:256] = acgt[rng.integers(0, 4, size=(256, 4))]  # all-ACGT k-mers
    jk = JR.kmer_codes(dx, jnp.asarray(codes))
    tk = TR.kmer_codes(tx, torch.from_numpy(codes))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    for g, w in zip(TR.ftab_lookup(tx, tk), JR.ftab_lookup(dx, jk)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_popcount32_matches_numpy():
    rng = np.random.default_rng(8)
    x = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64)
    x[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    got = TR._popcount32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), np.bitwise_count(x))


def test_lf_step_auto_names_roadmap_item(text):
    """Without fused-block rows lf_step_auto takes the run-space step (the
    JAX order's last backend), whose steps equal the JAX package's and the
    fused rows' own."""
    dx, tx = _pair(text, fb64=True)
    rows = tx.arrays.pop("fblock64")
    assert TR.lf_step_auto(tx) is TR.lf_step
    rng = np.random.default_rng(8)
    a, b = rng.integers(0, tx.n, size=(2, 1024))
    lo, hi = np.minimum(a, b).astype(np.int32), np.maximum(a, b).astype(np.int32)
    lo[:16], hi[:16] = 0, tx.n - 1
    c = rng.integers(-1, tx.A, size=1024, dtype=np.int32)
    args = [torch.from_numpy(x) for x in (lo, hi, c)]
    got = TR.lf_step(tx, *args)
    want = JR.lf_step(dx, *(jnp.asarray(x) for x in (lo, hi, c)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    tx.arrays["fblock64"] = rows
    for g, w in zip(got, TR.lf_step_fblock64(tx, *args)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
