"""The frozen bound arithmetic held to hand counts on tiny batches."""

import numpy as np
import pytest
import torch

from portbench import bounds


def test_peaks_and_operation_counts():
    assert bounds.HBM_BYTES_PER_S == 3.35e12 and bounds.INT_OPS_PER_S == 132 * 64 * 1.98e9
    assert bounds.RANK_OPS == 104
    assert [bounds.plane_rank_ops(s) for s in (64, 128, 256)] == [24, 40, 72]
    assert bounds.PHI_STEP_OPS == {"phi1": 4, "phi_rows": 53, "kval": 2}


@pytest.mark.parametrize("layout,record", (("fblock64", False), ("fb2_256", True)))
def test_k1_bound_by_hand(layout, record):
    work = dict(codes=10, distinct_rows=3, ranked_steps=10)
    b = bounds.k1_bound(work, B=2, L=8, A=6, layout=layout, table_bytes=128, record=record)
    if layout == "fblock64":
        # codes 40, lengths 8, F 7 x 4, rows 3 x 64, base 128, lo and hi 2 x 2 x 4
        assert b["bytes"] == 40 + 8 + 28 + 192 + 128 + 16
        assert b["ops"] == 2 * 104 * 10
    else:
        # F 7 x 8, rows 3 x 128, lo and hi 2 x 2 x 8, the record 8 x 2 x 8
        assert b["bytes"] == 40 + 8 + 56 + 384 + 128 + 32 + 128
        assert b["ops"] == 2 * 72 * 10
    assert b["bound_us"] == max(b["bytes"] / 3.35e12, b["ops"] / (132 * 64 * 1.98e9)) * 1e6


def test_k1_work_by_hand():
    """Two reads that occur in a 41-symbol text: five ranked steps each, and
    every rank in row 0 of 64-symbol rows."""
    from rowbowt_tpu_torch.construct.build import build_index
    from rowbowt_tpu_torch.engine.batch import encode_batch
    from rowbowt_tpu_torch.engine.device import TorchIndex

    text = np.frombuffer(b"ACGTTGCAACGGTACCATGGACTTAGCATGCAAGTCCGTA\x01", dtype=np.uint8)
    idx = build_index(text.copy(), with_sa_samples=False)
    tx = TorchIndex.from_index(idx, torch.device("cpu"))
    qc, ln = encode_batch(idx, [b"ACGGT", b"GCATG"], pad_to=8)
    w = bounds.k1_work(tx, torch.from_numpy(qc), torch.from_numpy(ln), "fblock64")
    assert w == dict(codes=10, lane_steps=10, ranked_steps=10, row_loads=10, distinct_rows=1,
                     longest_lane_steps=5)


def test_walk_bound_by_hand():
    flat = np.array([5, 9, 2], dtype=np.int64)  # lane 0: 5, 9; lane 1: 2
    offs = np.array([0, 2, 3], dtype=np.int64)
    hi = np.array([20, 7], dtype=np.int64)
    # only 5 is stepped from: each lane's last position is not
    b = bounds.walk_bound("phi1", 2, flat, offs, hi, entry_bytes=4)
    assert (b["bytes"], b["ops"]) == (2 * 24 + 3 * 8 + 4, 4)
    # kval[19], kval[20] and kval[7]
    b = bounds.walk_bound("kval", 2, flat, offs, hi, entry_bytes=4)
    assert (b["bytes"], b["ops"]) == (2 * 24 + 3 * 8 + 3 * 4, 3 * 2)
    # position 5: phi row 0 and the delta of breakpoint rank 1
    b = bounds.walk_bound("phi_rows", 2, flat, offs, hi, np.array([0, 3, 500]))
    assert (b["bytes"], b["ops"]) == (2 * 24 + 3 * 8 + 64 + 8, 53)
    assert b["bound_us"] == max(b["bytes"] / 3.35e12, b["ops"] / (132 * 64 * 1.98e9)) * 1e6
