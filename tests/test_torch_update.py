"""The port's slot helpers and window expansion (rowbowt_tpu_torch.ops.update,
indexed assignment and gather) == the JAX package's one-hot versions
(rowbowt_tpu.ops.update), values and dtypes, on random inputs made with
numpy from a seed.  Every output is an integer, so equality is exact."""

import numpy as np
import pytest
import torch

from rowbowt_tpu.ops import update as JU
from rowbowt_tpu_torch.ops import update as TU


def _eq(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_tslot_set_matches_jax(dtype):
    """Random slots and masks; vector and scalar values; the write happens in
    place and masked-off lanes keep what they held."""
    rng = np.random.default_rng(1)
    B, W = 257, 6
    arr = rng.integers(-50, 100, size=(W, B)).astype(dtype)
    slot = rng.integers(0, W, size=B).astype(np.int32)
    mask = rng.random(B) < 0.6
    val = rng.integers(0, 1 << 20, size=B).astype(np.int64)  # cast to arr's dtype
    for v in (val, 7):
        want = JU.tslot_set(arr, slot, mask, v)
        t = torch.from_numpy(arr.copy())
        got = TU.tslot_set(t, torch.from_numpy(slot), torch.from_numpy(mask),
                           torch.from_numpy(val) if v is val else v)
        assert got is t
        _eq(got, want)
        changed = (got.numpy() != arr).any(axis=0)
        assert not changed[~mask].any() and changed[mask].any()


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_tslot_get_matches_jax(dtype):
    rng = np.random.default_rng(2)
    B, W = 130, 9
    arr = rng.integers(-1000, 1000, size=(W, B)).astype(dtype)
    slot = rng.integers(0, W, size=B).astype(np.int32)
    _eq(TU.tslot_get(torch.from_numpy(arr), torch.from_numpy(slot)),
        JU.tslot_get(arr, slot))


@pytest.mark.parametrize("K", [1, 4, 8, 32])
def test_window_entry_ids_matches_jax(K):
    """Random window offsets and counts, counts above K (truncation), nrec
    from 0 to W."""
    rng = np.random.default_rng(3 + K)
    B, W = 96, 7
    for _ in range(5):
        nrec = rng.integers(0, W + 1, size=B).astype(np.int32)
        ws = rng.integers(0, 1000, size=(B, W)).astype(np.int32)
        wc = rng.integers(0, K + 3, size=(B, W)).astype(np.int32)
        want = JU.window_entry_ids(ws, wc, nrec, K)
        got = TU.window_entry_ids(*(torch.from_numpy(a) for a in (ws, wc, nrec)), K)
        for g, w in zip(got, want):
            _eq(g, w)
        used, total = got[2].numpy(), got[3].numpy()
        assert (used <= K).all() and (total > used).any()
