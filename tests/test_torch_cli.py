"""The port's rbt_align prints what the JAX package's rbt_align prints, byte
for byte, on an index saved from in-repo text and a FASTQ written here."""

import json

import numpy as np
import pytest
import torch

from rowbowt_tpu_torch.alphabet import SEP_BYTE, TERM_BYTE
from rowbowt_tpu_torch.cli import common
from rowbowt_tpu_torch.cli import rbt_align
from rowbowt_tpu_torch.construct.build import build_index

ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(scope="module")
def align_inputs(tmp_path_factory):
    """A 3-document panel (reference + 2 haplotypes with SNPs), saved with an
    ftab of k = 6, and 23 reads: substrings, substitutions, an 'N' base, a
    read shorter than k, a random read, and one longer than 32 bases."""
    rng = np.random.default_rng(21)
    ref = rng.choice(ACGT, size=1500)
    sep = np.full(10, SEP_BYTE, np.uint8)
    docs = [ref]
    for _ in range(2):
        hap = ref.copy()
        sites = rng.choice(1500, size=30, replace=False)
        hap[sites] = rng.choice(ACGT, size=30)
        docs.append(hap)
    text = np.concatenate([x for d in docs for x in (d, sep)] + [np.array([TERM_BYTE], np.uint8)])
    d = tmp_path_factory.mktemp("torch_cli")
    idx_dir = str(d / "idx")
    build_index(text, doc_starts=np.array([0, 1510, 3020]), doc_names=["ref", "h0", "h1"],
                ftab_k=6).save(idx_dir)
    reads = []
    for q in range(20):
        L = int(rng.integers(12, 60))
        p = int(rng.integers(0, 1500 - L))
        r = docs[q % 3][p:p + L].copy()
        if q % 4 == 1:
            r[rng.integers(0, L)] = rng.choice(ACGT)
        reads.append(r.tobytes())
    reads[3] = reads[3][:7] + b"N" + reads[3][8:]
    reads += [ref[100:104].tobytes(), rng.choice(ACGT, size=25).tobytes(),
              ref[200:270].tobytes()]
    fq = str(d / "reads.fq")
    with open(fq, "wb") as f:
        for q, r in enumerate(reads):
            f.write(b"@read%d extra\n%s\n+\n%s\n" % (q, r, b"I" * len(r)))
    return idx_dir, fq, len(reads)


@pytest.mark.parametrize("batch", [None, 4])
def test_rbt_align_matches_jax(align_inputs, capsys, batch):
    from rowbowt_tpu.cli import rbt_align as jax_rbt_align

    idx_dir, fq, n_reads = align_inputs
    extra = [] if batch is None else ["-b", str(batch)]
    assert jax_rbt_align.main([idx_dir, fq, *extra]) == 0
    want = capsys.readouterr().out
    assert rbt_align.main([idx_dir, fq, "--device", "cpu", *extra]) == 0
    got = capsys.readouterr()
    assert got.out == want
    lines = want.splitlines()
    assert len(lines) == n_reads and lines[0].startswith("read0 (")
    assert "(1,0), count=0" in want and any(not l.endswith("count=0") for l in lines)
    assert "reads/s" in got.err


def test_native_reader_matches_python_reader(align_inputs):
    idx_dir, fq, _ = align_inputs
    idx = common.load_index(idx_dir)
    native = list(common.iter_query_batches(idx, fq, 8, use_native=True))
    plain = list(common.iter_query_batches(idx, fq, 8, use_native=False))
    assert len(native) == len(plain) == 3
    for (n1, q1, l1), (n2, q2, l2) in zip(native, plain):
        assert n1 == n2
        np.testing.assert_array_equal(q1, q2)
        np.testing.assert_array_equal(l1, l2)


def test_device_cuda_raises_without_cuda(align_inputs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    idx_dir, fq, _ = align_inputs
    with pytest.raises(RuntimeError, match="cuda"):
        rbt_align.main([idx_dir, fq])  # --device defaults to cuda


@pytest.mark.parametrize("flag", ["-s", "-m"])
def test_locate_and_markers_not_ported(align_inputs, capsys, flag):
    idx_dir, fq, _ = align_inputs
    assert rbt_align.main([idx_dir, fq, "--device", "cpu", flag]) == 2
    assert "not yet ported in rowbowt_tpu_torch" in capsys.readouterr().err


def test_big_artifact_not_ported(tmp_path):
    (tmp_path / "meta.json").write_text(json.dumps({"format": "rowbowt-tpu-bigindex"}))
    with pytest.raises(NotImplementedError, match="ROADMAP M6"):
        common.load_index(str(tmp_path))
