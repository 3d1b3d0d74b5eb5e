"""The readings that set a cell's limits: the program's sound runs and its
control, on many seeds in one process, at the cell's own size and load.

    python -m portbench.control --workload <cell> --seeds 11 12 ... \\
        --control-seeds 21 22 23 --seconds 3

The index is loaded once; each seed then draws its own pool, runs warm
batches and a short window of the cell's batches (`--seconds`), and is
judged by the reference as a benchmark run is, with as many reads: each
batch's sample grows by run_seconds / --seconds.  The control is the query
class's `control`: the program with one guarantee of the configuration
broken (a count over each read's last 64 bases; a locate capped at 16
occurrences a read).  One JSON line a seed: {"mode", "seed", "checks",
"reads_checked", "batches"}.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import types


def controlled(query):
    """The query class with its timed path replaced by its control."""
    return types.SimpleNamespace(FLAGS=query.FLAGS, CHECKS=query.CHECKS, run=query.control,
                                 collect=query.collect, judge=query.judge)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.control", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)

    import torch

    from portbench import harness, index_cache
    from portbench.panel import make_panel
    from portbench.spec import find_cell, load_benchmark
    from portbench.trace import no_marks

    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = find_cell(args.workload)
    query = cell.query
    panel = make_panel(cell.config)
    path = index_cache.ensure(cell.config, query.FLAGS,
                              log=lambda *a: print(*a, file=sys.stderr))
    idx, tx = index_cache.load(path, query.FLAGS, device)
    grow = math.ceil(load_benchmark()["run_seconds"] / args.seconds)
    t = dict(cell.traffic, sample_per_batch=cell.traffic["sample_per_batch"] * grow)
    for mode, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        q = query if mode == "program" else controlled(query)
        for seed in seeds:
            pool = harness.make_pool(panel, t, seed, idx.alpha.encode_table())
            for b in range(min(len(pool.batches), t["warm_batches"])):
                q.run(tx, *pool.batches[b], no_marks)
            win = harness.window(tx, q, pool, args.seconds, no_marks)
            wrong = harness.check(panel, pool, q, win.last, win.samples, t["batch"])
            print(json.dumps(dict(mode=mode, seed=seed, batches=win.batches,
                                  reads_checked=wrong.pop("reads_checked"), checks=wrong)),
                  flush=True)
            del pool, win
    return 0


if __name__ == "__main__":
    sys.exit(main())
