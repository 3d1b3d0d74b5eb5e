"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of `workloads`) names its configuration, whose `file` is a
JSON file of its own under portbench/configs/, and its traffic mix,
portbench/traffic/<traffic>.json.  The traffic names its query class,
portbench/queries/<query>.py, and every per-layer metric is read by
portbench/metrics/<name>.py.  A later cell or metric adds files and entries;
nothing here changes for it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """portbench/<kind>/<name>.py as a module (a file name may hold dots)."""
    key = f"portbench.{kind}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config: dict  # the configuration's file
    traffic: dict  # the traffic mix's file
    end_to_end: list  # BENCHMARK.json's end-to-end metrics that this cell reports
    per_layer: list  # its per-layer metrics

    @property
    def query(self):
        return load_module("queries", self.traffic["query"])


def reported(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: dict | None = None, root: str = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json with its files read."""
    bench = bench or load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    return Cell(name=name, config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if reported(m, name)],
                per_layer=[m for m in bench["per_layer"] if reported(m, name)])
