"""Neither the harness nor the reference imports jax or the JAX package,
compared by whole top-level module names (the port's own name begins with
the JAX package's); the reference imports nothing of the port either."""

import ast
import os
import subprocess
import sys

import pytest

from portbench.spec import HERE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "rowbowt_tpu"}
# the reference and what it imports of the benchmark: no module of the port
PLAIN = ("reference.py", "panel.py")


def imported_tops(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".", 1)[0])
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".", 1)[0])
    return tops


def sources():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("name", PLAIN)
def test_the_reference_imports_nothing_of_the_port(name):
    tops = imported_tops(os.path.join(HERE, name))
    assert not tops & (FORBIDDEN | {"rowbowt_tpu_torch", "torch"}), tops
    assert tops <= {"__future__", "dataclasses", "numpy", "portbench"}, tops


def loaded_tops(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.', 1)[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_the_reference_loads_nothing_of_the_port():
    tops = loaded_tops("import portbench.reference")
    assert not tops & (FORBIDDEN | {"rowbowt_tpu_torch"}), tops & (FORBIDDEN | {"rowbowt_tpu_torch"})


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """The command's modules, each query class's and each reader's, loaded
    in one process: none pulls in jax or the JAX package."""
    code = ("import portbench.run, portbench.control\n"
            "from portbench.spec import load_benchmark, find_cell, load_module\n"
            "b = load_benchmark()\n"
            "[find_cell(w['name'], b).query for w in b['workloads']]\n"
            "[load_module('metrics', m['name']) for m in b['per_layer']]\n"
            "[load_module('builds', n) for n in ('build_index', 'pfp')]\n"
            "import rowbowt_tpu_torch.construct.pfp, rowbowt_tpu_torch.construct.build\n"
            "from portbench.harness import forbidden_modules\n"
            "assert not forbidden_modules(), forbidden_modules()")
    tops = loaded_tops(code)
    assert "rowbowt_tpu_torch" in tops and not tops & FORBIDDEN, tops & FORBIDDEN
