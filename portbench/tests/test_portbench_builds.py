"""Each configuration's builder, with the tables of each query's flags: the
index has the panel's n, holds what the flags ask for and no more, and
loads as rbt_align loads it."""

import numpy as np
import pytest
import torch

from portbench import index_cache
from portbench.panel import make_panel
from portbench.tests.conftest import BIG, SMALL

FLAGS = [dict(sa=False, ma=False, dl=False), dict(sa=True, ma=False, dl=True),
         dict(sa=True, ma=True, dl=True)]


@pytest.mark.parametrize("flags", FLAGS, ids=index_cache.part_name)
@pytest.mark.parametrize("cfg", (SMALL, BIG), ids=("build_index", "pfp"))
def test_the_builder_keeps_what_the_flags_ask_for(cfg, flags, tmp_path):
    p = make_panel(cfg)
    path = index_cache.ensure(cfg, flags, str(tmp_path), log=lambda *a: None)
    assert path == str(tmp_path / cfg["name"] / index_cache.part_name(flags))
    assert index_cache.ensure(cfg, flags, str(tmp_path), log=None) == path  # built once
    idx, tx = index_cache.load(path, flags, torch.device("cpu"))
    assert idx.n == p.n == tx.n
    assert ("samples_last" in tx.arrays) == flags["sa"]
    assert ("ma_val" in tx.arrays) == flags["ma"]
    assert ("doc_starts" in tx.arrays) == flags["dl"]
    if flags["dl"]:
        assert np.array_equal(tx.arrays["doc_starts"].numpy(), p.doc_starts)
    if flags["ma"]:
        # a marker for every site of every document, over its window of 10
        # rows (fewer at a document's start)
        tpos, _ = p.markers()
        want = int(np.minimum(tpos + 1, cfg["ma_wsize"]).sum())
        assert tx.arrays["ma_val"].shape[0] == want
