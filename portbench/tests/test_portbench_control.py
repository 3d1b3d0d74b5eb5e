"""`correct` comes out false for the control and for each fault a cell can
have, planted under the timed path, and true for the sound program: a run
driven on the CPU at a tiny size, past the harness's look for a card."""

import types

import pytest
import torch

from portbench import harness
from portbench.control import controlled
from portbench.spec import load_module
from portbench.tests.conftest import BIG, COUNT, LOCATE, SMALL, tiny_cell

CPU = torch.device("cpu")
SEED = 2**33 + 7
# a crowded panel: most reads occur in all 81 documents, more than the
# locate control's cap of 16
CROWD = dict(BIG, name="crowd", ref_len=3_000, n_haps=80, n_vars=3)
# a short panel, on which a search left at the whole BWT walks few positions
SHORT = dict(BIG, name="short", ref_len=2_000, n_vars=4)
CASES = [(SMALL, COUNT, "count"), (BIG, LOCATE, "locate"), (CROWD, LOCATE, "locate")]
IDS = ["bench-count", "giant-locate", "crowd-locate"]


def run(cfg, traffic, cache_root, query=None, trace=False):
    return harness.run_cell(tiny_cell(cfg, traffic), SEED, 0.2, trace, CPU, query=query,
                            cache_root=cache_root, log=lambda *a: None)


@pytest.mark.parametrize("cfg,traffic,_", CASES, ids=IDS)
def test_the_sound_program_is_correct(cfg, traffic, _, cache_root):
    out = run(cfg, traffic, cache_root)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks" and set(out["checks"]) == set(load_module(
        "queries", traffic["query"]).CHECKS)


def test_the_traced_run_is_judged_alike(cache_root):
    out = run(SMALL, COUNT, cache_root, trace=True)
    assert out["correct"] and "breakdown" in out and "busy_s" in out["device"]


@pytest.mark.parametrize("cfg,traffic", [(SMALL, COUNT), (CROWD, LOCATE)], ids=["count", "locate"])
def test_the_control_is_not_correct(cfg, traffic, cache_root):
    out = run(cfg, traffic, cache_root, query=controlled(load_module("queries", traffic["query"])))
    assert not out["correct"]
    assert max(v for v, _ in out["checks"].values()) > 0


def unchanged(search):
    """The search returns each lane's start state: the whole BWT."""
    def f(tx, q, ln, *a):
        out = search(tx, q, ln, *a)
        full = (torch.zeros_like(out[0]), torch.full_like(out[1], tx.n - 1))
        return full + tuple(out[2:])
    return f


def half_left_out(search):
    """Only the first half of the batch is searched; the rest get the
    empty range."""
    def f(tx, q, ln, *a):
        h = q.shape[0] // 2
        out = search(tx, q[:h], ln[:h], *a)
        pad = [torch.ones(q.shape[0] - h, dtype=out[0].dtype),
               torch.zeros(q.shape[0] - h, dtype=out[1].dtype)] + \
            [torch.zeros(q.shape[0] - h, dtype=x.dtype) for x in out[2:]]
        return tuple(torch.cat([x, y]) for x, y in zip(out, pad))
    return f


def one_altered(search):
    """One lane's hi of each batch is one past the program's."""
    def f(tx, q, ln, *a):
        out = list(search(tx, q, ln, *a))
        out[1] = out[1].clone()
        out[1][5] += 1
        return tuple(out)
    return f


SEARCH = {"count": "find_ranges", "locate": "find_ranges_w_toehold"}


@pytest.mark.parametrize("fault", [unchanged, half_left_out, one_altered],
                         ids=["state_unchanged", "half_left_out", "answer_altered"])
@pytest.mark.parametrize("cfg,traffic,kind", [(SMALL, COUNT, "count"), (SHORT, LOCATE, "locate")],
                         ids=["bench-count", "giant-locate"])
def test_each_fault_under_the_timed_path_is_not_correct(cfg, traffic, kind, fault, cache_root,
                                                        monkeypatch):
    mod = load_module("queries", kind)
    monkeypatch.setattr(mod, SEARCH[kind], fault(getattr(mod, SEARCH[kind])))
    out = run(cfg, traffic, cache_root, query=types.SimpleNamespace(
        **{k: getattr(mod, k) for k in ("FLAGS", "CHECKS", "run", "collect", "judge")}))
    assert not out["correct"], out["checks"]



@pytest.mark.gpu
@pytest.mark.parametrize("cfg,traffic", [(SMALL, COUNT), (CROWD, LOCATE)], ids=["count", "locate"])
def test_a_tiny_cell_on_the_card(cfg, traffic, cache_root, card):
    """The harness's whole run on the card at a tiny size: the kernels build
    and run, the sound program is correct and the control is not, and the
    traced run's readers find one record of the port's kernels a batch."""
    from portbench.spec import load_benchmark

    cell = tiny_cell(cfg, traffic)
    cell.per_layer = [m for m in load_benchmark()["per_layer"]
                      if traffic["query"] == "locate" or "chr.count" in m["workloads"]]
    out = harness.run_cell(cell, SEED, 0.5, True, card, cache_root=cache_root,
                           log=lambda *a: None)
    assert out["correct"] and out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
    assert {"k1_roofline", "launches_per_batch", "device_idle"} <= set(out["metrics"])
    assert 0 < out["metrics"]["k1_roofline"]["value"] <= 105
    ctl = harness.run_cell(cell, SEED, 0.5, False, card, cache_root=cache_root,
                           query=controlled(cell.query), log=lambda *a: None)
    assert not ctl["correct"]
