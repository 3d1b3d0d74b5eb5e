"""The panel generator, the read sampler and the encoder: each repeats from
its seed, and the encoder equals the port's engine/batch.encode_batch."""

import numpy as np
import pytest

from portbench.panel import (SEP_BYTE, TERM_BYTE, encode, make_panel, pow2_at_least,
                             sample_reads)
from portbench.tests.conftest import BIG, SMALL, SPECTRUM

SEEDS = (0, 2**31 + 11, 2**40 + 3)


@pytest.mark.parametrize("cfg", (SMALL, BIG), ids=("bench", "giant"))
def test_the_panel_repeats_from_its_seed(cfg):
    a, b = make_panel(cfg), make_panel(cfg)
    for k in ("ref", "var_pos", "var_alt", "carry"):
        assert np.array_equal(getattr(a, k), getattr(b, k))
    assert a.n == (cfg["n_haps"] + 1) * (cfg["ref_len"] + cfg["sep_len"]) + 1
    assert a.text().shape == (a.n,)
    assert not a.carry[0].any() and a.carry[1:].any(axis=0).all()
    assert (a.var_alt != a.ref[a.var_pos]).all()
    assert (np.diff(a.var_pos) > 0).all() and a.var_pos.shape[0] <= cfg["n_vars"]


def test_the_panel_draws_the_configured_spectrum():
    """Each haplotype carries a site's alt with the site's frequency, drawn
    log-uniform within a bin chosen by weight: over many sites and
    haplotypes the share of carried alts is the spectrum's mean frequency,
    and the sites some haplotype carries are as many as it predicts."""
    bins = np.array(SPECTRUM, dtype=np.float64)
    cfg = dict(BIG, ref_len=400_000, n_haps=200, n_vars=40_000)
    p = make_panel(cfg)
    w = bins[:, 2] / bins[:, 2].sum()
    lo, hi = bins[:, 0], bins[:, 1]
    mean_f = (w * (hi - lo) / np.log(hi / lo)).sum()
    assert abs(p.carry.sum() / (cfg["n_haps"] * cfg["n_vars"]) - mean_f) < 0.05 * mean_f
    # the share of sites some haplotype carries: 1 - E[(1 - f)^H] by quadrature
    f = np.exp(np.linspace(np.log(lo), np.log(hi), 20001))  # [grid, bins], log-uniform
    kept = (w * (1 - (1 - f) ** cfg["n_haps"]).mean(axis=0)).sum()
    assert abs(p.var_pos.shape[0] / cfg["n_vars"] - kept) < 0.02


def test_the_documents_and_text_layout():
    p = make_panel(SMALL)
    text = p.text()
    for d in range(p.n_docs):
        s = p.doc_starts[d]
        assert np.array_equal(text[s:s + p.ref_len], p.doc(d))
        assert (text[s + p.ref_len:s + p.doc_len] == SEP_BYTE).all()
    assert text[-1] == TERM_BYTE
    tpos, packed = p.markers()
    site, allele = packed >> 8, packed & 0xFF
    s = np.searchsorted(p.var_pos, site)
    assert np.array_equal(p.var_pos[s], site)
    assert np.array_equal(text[tpos], np.where(allele == 1, p.var_alt[s], p.ref[site]))


@pytest.mark.parametrize("seed", SEEDS)
def test_the_sampler_repeats_from_a_seed_and_reads_lie_in_their_documents(seed):
    p = make_panel(SMALL)
    a = sample_reads(p, np.random.default_rng(seed), 500, 100, 0.2)
    b = sample_reads(p, np.random.default_rng(seed), 500, 100, 0.2)
    assert np.array_equal(a.bases, b.bases) and np.array_equal(a.offs, b.offs)
    text = p.text()
    clean = sample_reads(p, np.random.default_rng(seed), 500, 100, 0.0)
    for i in range(500):
        s = p.doc_starts[clean.docs[i]] + clean.offs[i]
        assert np.array_equal(text[s:s + 100], clean.bases[i])
    differ = (a.bases != clean.bases).sum(axis=1)
    assert differ.max() <= 1 and 0.05 < (differ == 1).mean() < 0.3


def test_the_encoder_equals_encode_batch():
    from rowbowt_tpu_torch.alphabet import SEP_BYTE as PORT_SEP, TERM_BYTE as PORT_TERM, Alphabet
    from rowbowt_tpu_torch.engine.batch import encode_batch

    assert (SEP_BYTE, TERM_BYTE) == (PORT_SEP, PORT_TERM)
    p = make_panel(SMALL)
    alpha = Alphabet.from_text(p.text())
    reads = sample_reads(p, np.random.default_rng(5), 300, 100, 0.2)
    width = pow2_at_least(100)
    assert width == 128

    class Idx:
        pass

    idx = Idx()
    idx.alpha = alpha
    want_c, want_l = encode_batch(idx, [r.tobytes() for r in reads.bases], pad_to=width)
    got_c, got_l = encode(reads.bases, alpha.encode_table(), width)
    assert got_c.dtype == np.int32 and got_l.dtype == np.int32
    assert np.array_equal(got_c, want_c) and np.array_equal(got_l, want_l)
