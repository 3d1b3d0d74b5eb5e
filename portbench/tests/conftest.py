"""Tiny panels, traffic and cells for the benchmark's CPU tests, and the
card fixture of the tests marked gpu (it decides, inside the fixture,
whether there is a card)."""

import json

import pytest

from portbench.spec import ROOT, Cell

# the 1000 Genomes Phase 3 spectrum of the configurations, and a common one
# that keeps most sites of a panel of a few haplotypes
SPECTRUM = [[0.0002, 0.005, 64], [0.005, 0.05, 12], [0.05, 1.0, 8]]
COMMON = [[0.2, 0.8, 1]]
SMALL = dict(name="tiny", ref_len=30_000, n_haps=3, n_vars=120, af_bins=COMMON, panel_seed=7,
             sep_len=10, ma_wsize=10, build="build_index")
BIG = dict(name="tinybig", ref_len=20_000, n_haps=5, n_vars=60, af_bins=SPECTRUM, panel_seed=9,
           sep_len=10, ma_wsize=10, pfp_p=100, row_syms=256, build="pfp")
COUNT = dict(query="count", batch=64, read_len=100, width=128, sub_rate=0.2, pool_batches=3,
             warm_batches=1, sample_per_batch=4, profile_batches=2)
LOCATE = dict(COUNT, query="locate", batch=32)


def tiny_cell(config: dict, traffic: dict, name: str = "tiny.cell") -> Cell:
    with open(f"{ROOT}/BENCHMARK.json") as f:
        bench = json.load(f)
    return Cell(name=name, config=config, traffic=traffic, end_to_end=bench["end_to_end"],
                per_layer=[])


@pytest.fixture(scope="session")
def cache_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("portbench_cache"))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)
