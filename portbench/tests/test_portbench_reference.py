"""The plain reference: its occurrences equal a brute-force search of the
whole text, its judges flag what they should, and it agrees with the port's
CPU path on a tiny panel."""

import numpy as np
import pytest
import torch

from portbench import index_cache
from portbench.panel import make_panel, sample_reads
from portbench.reference import doc_matches, judge_counts, judge_locs
from portbench.trace import no_marks
from portbench.tests.conftest import BIG, COUNT, LOCATE, SMALL, tiny_cell


def brute_force(text: bytes, read: bytes) -> list[int]:
    out, i = [], text.find(read)
    while i >= 0:
        out.append(i)
        i = text.find(read, i + 1)
    return out


@pytest.mark.parametrize("cfg", (SMALL, BIG), ids=("bench", "giant"))
def test_the_reference_equals_a_search_of_the_whole_text(cfg):
    p = make_panel(cfg)
    text = p.text().tobytes()
    reads = sample_reads(p, np.random.default_rng(3), 400, 100, 0.5)
    match = doc_matches(p, reads.bases, reads.offs)
    for i in range(400):
        want = brute_force(text, reads.bases[i].tobytes())
        got = (p.doc_starts[np.flatnonzero(match[i])] + reads.offs[i]).tolist()
        assert got == want, i
    assert match.sum(axis=1).min() == 0 and match.sum(axis=1).max() > 1


def test_the_judges_flag_wrong_answers():
    p = make_panel(SMALL)
    reads = sample_reads(p, np.random.default_rng(4), 50, 100, 0.0)
    match = doc_matches(p, reads.bases, reads.offs)
    ids = np.arange(50)
    cnt = match.sum(axis=1)
    assert not judge_counts(match, ids, cnt).any()
    bad = cnt.copy()
    bad[7] += 1
    assert np.flatnonzero(judge_counts(match, ids, bad)).tolist() == [7]
    docs = [np.flatnonzero(match[i]) for i in ids]
    pos = np.concatenate([p.doc_starts[d] + reads.offs[i] for i, d in enumerate(docs)])
    doc = np.concatenate(docs)
    doff = np.concatenate([np.full(len(d), reads.offs[i]) for i, d in enumerate(docs)])
    seg = np.concatenate([[0], np.cumsum(cnt)])
    locs, dw = judge_locs(p, match, reads.offs, ids, seg, pos, doc, doff)
    assert not locs.any() and not dw.any()
    # a duplicated position in place of another, a shifted one, a wrong document
    pos2 = pos.copy()
    j = seg[3]
    pos2[j + 1] = pos2[j]
    pos2[seg[5]] += 1
    doc2 = doc.copy()
    doc2[seg[9]] += 1
    locs, dw = judge_locs(p, match, reads.offs, ids, seg, pos2, doc2, doff)
    assert set(np.flatnonzero(locs)) == ({3, 5} if cnt[3] > 1 else {5})
    assert 9 in set(np.flatnonzero(dw))
    # a read's last occurrence left out
    seg3 = seg.copy()
    seg3[12:] -= 1
    keep = np.ones(pos.shape[0], dtype=bool)
    keep[seg[12] - 1] = False
    locs, _ = judge_locs(p, match, reads.offs, ids, seg3, pos[keep], doc[keep], doff[keep])
    assert np.flatnonzero(locs).tolist() == [11]


@pytest.mark.parametrize("cfg,traffic", ((SMALL, COUNT), (SMALL, LOCATE), (BIG, COUNT), (BIG, LOCATE)),
                         ids=("bench-count", "bench-locate", "giant-count", "giant-locate"))
def test_the_reference_agrees_with_the_ports_cpu_path(cfg, traffic, cache_root):
    from portbench.harness import make_pool

    cell = tiny_cell(cfg, traffic)
    q = cell.query
    p = make_panel(cfg)
    idx, tx = index_cache.load(index_cache.ensure(cfg, q.FLAGS, cache_root), q.FLAGS,
                               torch.device("cpu"))
    pool = make_pool(p, traffic, 2**33 + 1, idx.alpha.encode_table())
    match = doc_matches(p, pool.bases, pool.offs)
    B = traffic["batch"]
    for b, (qc, lens) in enumerate(pool.batches):
        res = q.run(tx, qc, lens, no_marks)
        wrong = q.judge(p, match, pool.offs, b * B + np.arange(B), q.collect(res))
        assert all(not v.any() for v in wrong.values()), {k: int(v.sum()) for k, v in wrong.items()}
    assert match.sum(axis=1).max() > 1
