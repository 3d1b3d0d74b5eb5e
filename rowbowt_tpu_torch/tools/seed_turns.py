"""The seeding machines of csrc/seeds.cu timed beside earlier designs of
them, in turns on the same batches, on one NVIDIA GPU.

    python -m rowbowt_tpu_torch.tools.seed_turns \\
        --design parent=DIR [--design NAME=DIR ...] [PHASE ...]

Each DIR holds another commit's kernel sources, as
`git archive <commit> rowbowt_tpu_torch/csrc | tar -x -C DIR` writes them;
where its C entries rbt_seed_machine and rbt_seed_machine_tables take a
lane counter before `threads` (a persistent-grid design), each launch gets
one, zeroed on the stream.  The tool builds each design's seeds.cu with
nvcc for sm_90a (_native.NVCC_FLAGS) into a library of its own beside the
checkout's, then runs chip_smoke.py's PHASEs (by default greedy, lmem,
locs, nodense_chr, raw_chr, big_chr and build_small: every path whose
machine chip_smoke.py times) with its seeds_times wrapped: each batch it
times is also launched through launch_machine on every design's library
and on the checkout's, in turns (the designs in order, the checkout's
twice, the designs in reverse), each turn the device time of one launch by
CUDA events just around it (chip_smoke.kernel_event_us), every design's
tables equal to the checkout's.  Prints a `seed_turns` line a batch and,
first, each design's nvcc register and spill report (`seed_designs`).  Run
it from the root of a checkout, where chip_smoke.py is.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

DEFAULT_PHASES = ("greedy", "lmem", "locs", "nodense_chr", "raw_chr", "big_chr", "build_small")
PASSES = 10  # launches a turn, after a warm-up launch
ENTRIES = ("rbt_seed_machine", "rbt_seed_machine_tables")


class Design:
    """A design's library as launch_machine's `lib`: its C entries take the
    checkout's arguments and, where `counter`, a lane counter before
    `threads` (the third from the end), a device int32 zeroed for each
    launch on the current stream, inside the timed call as the wrapper of
    that design zeroed it."""

    def __init__(self, path: str, current, counter: bool):
        self.lib = ctypes.CDLL(path)
        self.counter = counter
        for entry in ENTRIES:
            types = list(getattr(current, entry).argtypes)
            if counter:
                types.insert(len(types) - 3, ctypes.c_void_p)
            getattr(self.lib, entry).argtypes = types
            getattr(self.lib, entry).restype = ctypes.c_int
        self.lib.rbt_cuda_error_string.argtypes = [ctypes.c_int]
        self.lib.rbt_cuda_error_string.restype = ctypes.c_char_p

    def _args(self, args):
        if not self.counter:
            return args
        import torch

        self._next = torch.zeros(1, dtype=torch.int32, device="cuda")
        return (*args[:-3], self._next.data_ptr(), *args[-3:])

    def rbt_seed_machine(self, *args):
        return self.lib.rbt_seed_machine(*self._args(args))

    def rbt_seed_machine_tables(self, *args):
        return self.lib.rbt_seed_machine_tables(*self._args(args))

    def rbt_cuda_error_string(self, code):
        return self.lib.rbt_cuda_error_string(code)


def build_designs(smoke, designs: dict) -> dict:
    """{name: Design} built side by side with the checkout's seeds.cu, each
    into its own library (librbt_seeds_<name>); prints each design's
    registers and spills an instance (chip_smoke.ptxas_instances)."""
    from rowbowt_tpu_torch import _native
    from rowbowt_tpu_torch.ops import cuda_seeds

    cmd = [_native.find_tool("nvcc", "/usr/local/cuda/bin/nvcc"), *_native.NVCC_FLAGS]
    csrc = {name: os.path.join(src, "rowbowt_tpu_torch", "csrc") for name, src in designs.items()}

    def build(name):
        d = csrc[name]
        headers = tuple(os.path.join(d, f) for f in sorted(os.listdir(d)) if f.endswith(".cuh"))
        return _native.build_shared(f"librbt_seeds_{name}", cmd, [os.path.join(d, "seeds.cu")],
                                    headers=headers)

    with ThreadPoolExecutor(len(designs) + 1) as ex:
        futures = {name: ex.submit(build, name) for name in designs}
        current = ex.submit(cuda_seeds.build).result()
        built = {name: f.result() for name, f in futures.items()}
    print(json.dumps({"seed_designs": {
        **{name: smoke.ptxas_instances(log) for name, (_, log) in built.items()},
        "checkout": smoke.ptxas_instances(cuda_seeds.BUILD_LOG)}}), flush=True)
    out = {}
    for name, (path, _) in built.items():
        with open(os.path.join(csrc[name], "seeds.cu")) as f:
            counter = "void* next" in f.read()
        out[name] = Design(path, current, counter)
    return out


def turns(smoke, libs: dict, tx, runs: dict) -> None:
    """Each batch of `runs` ({name: (q, ln, cfg)}) on every design and the
    checkout's kernel, in turns; prints one seed_turns line a batch."""
    import torch

    from rowbowt_tpu_torch.ops import cuda_lf, cuda_seeds

    order = list(libs) + ["checkout", "checkout"] + list(libs)[::-1]
    for name, (q, ln, cfg) in runs.items():
        mode = name.split("_")[0]

        def call(lib):
            def run():
                return cuda_seeds.launch_machine(tx, mode, q, ln, lib=lib, **cfg)
            return run

        want = call(None)()
        errs = {}
        for d, lib in libs.items():
            got = call(lib)()
            torch.cuda.synchronize()
            errs[d] = smoke.records_err(got, want)
            smoke.check(errs[d] == 0, f"design {d} != the checkout's kernel on {name}")
        us = {d: [] for d in ["checkout", *libs]}
        for d in order:
            us[d].append(smoke.kernel_event_us([smoke.around(call(libs.get(d)))], PASSES))
        key = cuda_lf.row_layout(tx) or cuda_lf.table_policy(tx)
        print(json.dumps({"seed_turns": {
            "batch": name, "route": smoke.seed_route(tx, mode, cfg), "tables": key,
            "lanes": q.shape[0], "L": q.shape[1], "order": order, "device_us_turns": us,
            "device_us": {d: sum(v) / len(v) for d, v in us.items()},
            "max_abs_err": errs}}), flush=True)


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--design", action="append", default=[], metavar="NAME=DIR",
                    help="an earlier design's kernel sources (repeatable, timed in this order)")
    ap.add_argument("phases", nargs="*", default=list(DEFAULT_PHASES))
    args = ap.parse_args(argv)
    designs = dict(d.split("=", 1) for d in args.design)
    if not designs or "checkout" in designs:
        ap.error("at least one --design NAME=DIR, none named checkout")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as smoke
    import torch

    if not torch.cuda.is_available():
        print("seed_turns needs a CUDA device; torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    libs = build_designs(smoke, designs)
    real = smoke.seeds_times

    def seeds_times(tx, runs, lat):
        out = real(tx, runs, lat)
        turns(smoke, libs, tx, runs)
        return out

    smoke.seeds_times = seeds_times
    return smoke.main(list(args.phases))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
