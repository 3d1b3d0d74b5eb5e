"""BENCHMARK.json against the contract's shapes, and every cell's files
found by name."""

import json
import os

import pytest

from portbench.spec import HERE, NAME, ROOT, UNIT, find_cell, load_benchmark, load_module

BENCH = load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_names_and_units_use_the_allowed_characters():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + [w["traffic"] for w in BENCH["workloads"]] + [w["config"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    for name in names:
        assert NAME.fullmatch(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([c["source"] for c in BENCH["configs"]] + [c["why"] for c in BENCH["configs"]]
                 + [w["why"] for w in BENCH["workloads"]] + [m["layer"] for m in BENCH["per_layer"]]
                 + BENCH["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text


def test_the_file_keeps_the_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    assert len({m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}) == \
        len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["name"] in used
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files_by_name(cell):
    c = find_cell(cell)
    assert c.config["name"] == next(w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    q = c.query
    for attr in ("FLAGS", "CHECKS", "run", "control", "collect", "judge", "k1_record"):
        assert hasattr(q, attr), attr
    assert load_module("builds", c.config["build"]).build
    conf = next(x for x in BENCH["configs"] if x["name"] == c.config["name"])
    assert conf["reduced"] == c.config["reduced"]
    assert all(k in c.config for k in conf["reduced"])
    for m in c.per_layer:
        assert callable(load_module("metrics", m["name"]).read)
    assert {m["name"] for m in c.end_to_end} == {
        m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", CELLS)}
    assert {"setup_s", "reads_per_s"} <= {m["name"] for m in c.end_to_end} and c.per_layer
    with open(os.path.join(HERE, "traffic", f"{next(w['traffic'] for w in BENCH['workloads'] if w['name'] == cell)}.json")) as f:
        assert json.load(f) == c.traffic


def test_every_per_layer_metric_has_a_reader_file():
    for m in BENCH["per_layer"]:
        assert os.path.exists(os.path.join(HERE, "metrics", f"{m['name']}.py")), m["name"]


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_each_panel_keeps_its_sources_density_and_spectrum(conf):
    """The panels' sizes follow the 1000 Genomes Phase 3 figures: one SNP
    site per 36.6 bp (84.7 M over 3.1 Gbp), and a spectrum under which a
    diploid genome differs from the reference at 4.1 to 5.0 M of the
    84.7 M sites, the source's range.  `reduced` names every key cut from
    the source, with the source's value beside it."""
    import numpy as np

    with open(os.path.join(ROOT, conf["file"])) as f:
        cfg = json.load(f)
    assert cfg["n_vars"] == round(cfg["ref_len"] * 84.7e6 / 3.1e9)
    bins = np.asarray(cfg["af_bins"], dtype=np.float64)
    w = bins[:, 2] / bins[:, 2].sum()
    f = np.exp(np.linspace(np.log(bins[:, 0]), np.log(bins[:, 1]), 100_001))
    differ = 84.7e6 * (w * (2 * f - f * f).mean(axis=0)).sum()
    assert 4.1e6 <= differ <= 5.0e6
    assert set(cfg["source_sizes"]) == set(cfg["reduced"]) == {"n_haps"}
    assert cfg["n_haps"] < cfg["source_sizes"]["n_haps"]
