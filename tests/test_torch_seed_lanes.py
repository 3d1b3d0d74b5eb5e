"""The seeding machines' ftab restart and the order their lanes run in
(csrc/seeds.cu), on an index whose text holds N.

The index: a reference of ACGT with an N in about every 13 codes and a
haplotype of it, built with fused rows (7 codes: the terminator, the
separator, A, C, G, N, T) and an ftab of k = 6.  Its reads are the text's
substrings with substitutions (a failure every few codes), on both strands,
so that greedy's restarts replay the next k codes where they are A, C, G
or T (the k-mer in the text, or absent from it: an empty step that holds
the full range) and where they hold an N, which the text holds: the
replay's range is not empty.  Beside them restarts fewer than k codes from
a read's end, reads shorter than k and length-0 lanes.  The numpy model of
the kernel (test_torch_seed_kernel.machine_model behind the fake C entry)
equals the plain twins and the JAX package's markers_greedy_seeding and
markers_lmem_lanes buffer for buffer; the model's tables do not depend on
the order in which its lanes run.  Every output is an integer, so every
check is exact."""

import numpy as np
import pytest
import torch

from rowbowt_tpu.engine.device import DeviceIndex
from rowbowt_tpu.index import RbtIndex as JaxRbtIndex
from rowbowt_tpu_torch.alphabet import revcomp
from rowbowt_tpu_torch.construct.build import build_index
from rowbowt_tpu_torch.construct.panel import Marker
from rowbowt_tpu_torch.engine import seeds as TS
from rowbowt_tpu_torch.engine.device import TorchIndex
from rowbowt_tpu_torch.index import RbtIndex
from rowbowt_tpu_torch.ops import cuda_lf, cuda_seeds
from test_torch_seed_kernel import (WSIZE, ZERO, _eq, _lanes, _run, fake,  # noqa: F401
                                    machine_model, rank_table)

ACGT = np.frombuffer(b"ACGT", np.uint8)
REF_LEN, SEP_LEN, FTAB_K = 4000, 10, 6


@pytest.fixture(scope="module")
def ntext(tmp_path_factory):
    """(JAX DeviceIndex, port TorchIndex on the CPU, RbtIndex, reads) of the
    N-holding panel."""
    rng = np.random.default_rng(29)
    ref = rng.choice(ACGT, size=REF_LEN)
    ref[rng.choice(REF_LEN, REF_LEN // 13, replace=False)] = ord("N")
    sites = np.sort(rng.choice(np.flatnonzero(ref != ord("N")), 40, replace=False))
    hap = ref.copy()
    hap[sites] = np.where(ref[sites] == ord("A"), ord("C"), ord("A"))
    sep = np.full(SEP_LEN, 2, np.uint8)
    text = np.concatenate([ref, sep, hap, sep, [1]]).astype(np.uint8)
    starts = np.array([0, REF_LEN + SEP_LEN])
    markers = [Marker(text_pos=int(starts[d] + p), seq=0, pos=int(p), allele=d)
               for d in (0, 1) for p in sites]
    path = str(tmp_path_factory.mktemp("seed_lanes") / "idx")
    build_index(text, markers=markers, doc_starts=starts, doc_names=["ref", "hap"],
                ftab_k=FTAB_K).save(path)
    idx = RbtIndex.load(path)
    tx = TorchIndex.from_index(idx, "cpu")
    assert idx.alpha.size == 7 and cuda_lf.row_layout(tx) in ("fblock", "fblock64")
    reads = []
    for _ in range(60):
        m = int(rng.integers(40, 101))
        p = int(rng.integers(0, len(text) - SEP_LEN - m))
        r = text[p:p + m].copy()
        subs = rng.random(m) < 0.07
        r[subs] = rng.choice(ACGT, size=int(subs.sum()))
        r = r[(r != 1) & (r != 2)].tobytes()  # no separator or terminator in a read
        reads += [r, revcomp(r).tobytes()]
    reads += [b"ACG", b"NA", b"N", b"", ref[:FTAB_K + 1].tobytes(), ref[:FTAB_K].tobytes()]
    return DeviceIndex.from_index(JaxRbtIndex.load(path)), tx, idx, reads


# (mode, options, L): greedy from the ftab at the engine's capacities and
# at small ones, and L-MEM, each against JAX
RUNS = {"greedy_100": ("greedy", dict(), 100),
        "greedy_small_31": ("greedy", dict(max_seeds=2, max_k=2, max_range=40), 31),
        "lmem_100": ("lmem", dict(max_range=200, max_k=4), 100)}


@pytest.mark.parametrize("run", list(RUNS))
def test_restarts_over_a_text_with_n_match_jax(ntext, fake, run):
    """The engine with its plain twin == JAX, and with the model behind the
    C entry == JAX; greedy's restarts reach the replay of a window holding
    N, replays with a non-empty range and with an empty one, and
    the restart too near the read's end; the lanes hold reads shorter than
    k and empty ones."""
    mode, opt, L = RUNS[run]
    dx, tx, idx, reads = ntext
    if mode == "lmem":
        reads = TS.lmem_expand(reads[:8] + reads[-6:])[0]
    qc, lens = _lanes(idx, reads, L)
    assert ((lens > 0) & (lens < FTAB_K)).any() and (lens == 0).any() or mode == "lmem"
    want = _run(mode, True, dx, qc, lens, opt)
    _eq(_run(mode, False, tx, qc, lens, opt), want, "plain")
    events = {}
    fake["install"](tx, events)
    fake["kernel"]()
    _eq(_run(mode, False, tx, qc, lens, opt), want, "model")
    assert cuda_seeds.LAUNCHES_SEED == dict(ZERO, **{mode: 1})
    if mode == "greedy":
        edges = ("restart_replay", "replay_window_not_acgt", "replay_nonempty", "replay_held",
                 "restart_to_full", "ftab_start", "ftab_miss")
        assert all(events.get(e) for e in edges), [e for e in edges if not events.get(e)]


def _model_of(tx, mode, qc, lens, order=None):
    """machine_model's tables of `mode` over tx's fused rows, greedy and
    L-MEM from the ftab, at capacities that overflow."""
    key = cuda_lf.row_layout(tx)
    fb, F = tx.arrays[key].numpy(), tx.arrays["F"].numpy()
    syms = cuda_lf._SYMS_PER_ROW[key]
    rk = rank_table(fb, syms, F, tx.A, tx.n)
    kw = dict(greedy=dict(k=FTAB_K, wsize=WSIZE, max_range=30, W=3, S=2),
              lmem=dict(k=FTAB_K, wsize=WSIZE, max_range=1 << 30, W=4, S=1),
              sample=dict(min_length=0, S=2))[mode]
    if mode != "sample":
        kw.update(ftab=tx.arrays["ftab"].numpy(), acgt=list(tx.acgt_codes))
    return machine_model(mode, rk, F, tx.A, tx.n, qc, lens, order=order, **kw)


@pytest.mark.parametrize("order", ["reversed", "interleaved", "shuffled"])
def test_lanes_taken_in_any_order_write_the_same_tables(ntext, order):
    """The model running the lanes in a permuted order (as the kernel's
    warps hold them in an order of their own) writes the tables of the
    model run in lane order, every machine."""
    _, tx, idx, reads = ntext
    qc, lens = _lanes(idx, reads, 100)
    B = qc.shape[0]
    perm = {"reversed": np.arange(B)[::-1], "interleaved": np.r_[0:B:2, 1:B:2],
            "shuffled": np.random.default_rng(5).permutation(B)}[order]
    for mode in ("greedy", "lmem", "sample"):
        want = _model_of(tx, mode, qc, lens)
        got = _model_of(tx, mode, qc, lens, order=perm)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{mode} {key}")


def test_model_equals_the_twins_records(ntext, fake):
    """Through the launch path, the model's records == the twins' for each
    machine over the N-holding index's rows, at capacities that overflow."""
    _, tx, idx, reads = ntext
    qc, lens = _lanes(idx, reads, 100)
    q, ln = torch.from_numpy(qc), torch.from_numpy(lens)
    fake["install"](tx)
    want = TS.markers_greedy_records_plain(tx, q, ln, WSIZE, 30, 2, FTAB_K, 3)
    got = cuda_seeds.launch_machine(tx, "greedy", q, ln, k=FTAB_K, wsize=WSIZE, max_range=30,
                                    W=3, S=2)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(), err_msg=key)
    want = TS.seeds_sample_records_plain(tx, q, ln, 0, 2, "kval")
    got = cuda_seeds.launch_machine(tx, "sample", q, ln, min_length=0, S=2)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(), err_msg=key)
    assert [c["mode"] for c in fake["calls"]] == ["greedy", "sample"]
