"""The benchmark's command: one run of one cell on the card.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed` (reads that raised or were refused: none do; a wrong
answer makes `correct` false), `metrics` (the cell's end-to-end metrics with
--trace 0, its per-layer metrics with --trace 1), `device`, with --trace 1
`breakdown`, and last `checks`, each number compared with its limit, which
also close standard error.  Exits non-zero with no result where CUDA is
absent or has fewer cards than the cell asks for, and where, once the window
has closed, the process holds jax, jaxlib, flax or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import sys


def eprint(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.run", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench import harness
    from portbench.spec import find_cell, load_benchmark

    bench = load_benchmark()
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload)
    cell = find_cell(args.workload, bench)
    if not torch.cuda.is_available():
        eprint("error: torch.cuda.is_available() is False; the benchmark measures the card")
        return 2
    if torch.cuda.device_count() < chips:
        eprint(f"error: {args.workload} asks for {chips} cards, "
               f"torch.cuda.device_count() is {torch.cuda.device_count()}")
        return 2
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), chips=chips, log=eprint)
    bad = harness.forbidden_modules()
    if bad:
        eprint(f"error: the run's process holds {', '.join(bad)} once the window has closed")
        return 3
    checks = out.pop("checks")
    for name, (value, limit) in checks.items():
        eprint(f"check {name}: {value} (limit {limit})")
    out["checks"] = {name: dict(value=v, limit=lim) for name, (v, lim) in checks.items()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
