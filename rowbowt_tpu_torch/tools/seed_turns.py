"""The tables kernel, K1's toehold launch and the seeding machines of
csrc/lf.cu and csrc/seeds.cu, and the walks of csrc/phi_walk.cu, timed
beside earlier designs of them, in turns on the same batches, on one NVIDIA
GPU.

    python -m rowbowt_tpu_torch.tools.seed_turns \\
        --design parent=DIR [--design NAME=DIR ...] [--time-only NAME=DIR ...] \\
        [PHASE ...]

Each DIR holds another commit's kernel sources, as `git archive <commit>
rowbowt_tpu_torch/csrc | tar -x -C DIR` writes them, of a commit whose C
entries take the checkout's arguments (the bit-plane rows and bucket
directories, and rbt_lane_threads, are every compared design's); where its
chain walk's entries take the lanes' order (the designs before the chain
took lane t on thread t), each such launch gets the lanes in descending
size order, as its wrapper sorted them.  A design without the kval walk
walks its chain over phi1 on that route.  A candidate design is timed as a
DIR of its own: a copy of the checkout's csrc with the candidate in place;
a fork that leaves a part of a kernel out, to measure what that part
costs, is a --time-only design: timed like the others, its outputs not
held to the checkout's.  A design's threads a lane over each tables policy
come from its lf.cu's rbt_lane_threads, and each of its tables launches
gets its own launch plan at those (cuda_lf.launch_plan), so that it runs
as its own wrapper ran it.  The
tool builds each design's lf.cu,
seeds.cu and phi_walk.cu with nvcc for sm_90a (_native.NVCC_FLAGS) into
libraries of their own beside the checkout's, prints each design's nvcc
register and spill report (`designs`) and which of its kernels compile to
the checkout's machine code (`sass`, by cuobjdump; `params_only`: the same
but for the offsets of their parameters), then runs chip_smoke.py's PHASEs
(by default k1, greedy, lmem, locs, nodense_chr, raw_chr, big_chr and
build_small: every path whose tables kernel or machine chip_smoke.py times)
with its tables_times, seeds_times, walk_times (every route: each design
as its wrapper launches it, the kval kernel where a design has it and the
route is kval, and beside them the checkout's chain over phi1 on the kval
route and the empty kernel in the walk's grid), toehold_work (K1's toehold launch, on the batch
toehold_times times, beside K1's count instance on the same batch),
record_times and held_record (K1 and its record launch over big_chr's and
pfp_big's two-level rows) wrapped: each batch they time is also launched
through cuda_lf.launch_tables, cuda_seeds.launch_machine,
cuda_phi.launch_walk, cuda_lf.launch_toehold or cuda_lf.launch_k1 on every
design's library and on the checkout's, in turns (the designs in order, the
checkout's twice, the designs in reverse), each turn the device time of one
launch by CUDA events just around it (chip_smoke.kernel_event_us), every
design's outputs equal to the checkout's; where a timed count search is the
dense step's, also the toehold search of that index without kval
(dense_toehold). After phase nodense_chr it also times two views of chr's
BWT at full width (chr_views): its dense tables (build_dense_tables over
chr's codes, 80 MB of bwt4) and its occ1 (build_occ1, A * (n + 1) int32,
3.84 GB at n = 160 M), each without fused rows, on the count batch (65,536
reads, no ftab start) and rbt_markers -f's and rbt_locs' batches, each with
its bound (chip_smoke.tables_times, seeds_times). Prints a `table_turns`,
`seed_turns`, `walk_turns`, `toehold_turns` or `k1_turns` line a batch, a
`dense_toehold` line and a `chr_view` line a view.  Run it from the root of
a checkout, where chip_smoke.py is, with its output sent to a file: the
lines are long.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

DEFAULT_PHASES = ("k1", "greedy", "lmem", "locs", "nodense_chr", "raw_chr", "big_chr",
                  "build_small")
PASSES = 10  # launches a turn, after a warm-up launch
ENTRIES = {"seeds": ("rbt_seed_machine", "rbt_seed_machine_tables"),
           "lf": ("rbt_lf_tables", "rbt_lf_toehold", "rbt_lf_count_fb2", "rbt_lf_count"),
           "phi_walk": ("rbt_phi_walk_pred", "rbt_phi_walk_phi1", "rbt_phi_walk_rows",
                        "rbt_phi_walk_kval")}
# the chain walk's C entries: a design before the chain took lane t on
# thread t also takes the lanes' order, before `out` (Design)
WALK_CHAINS = ("rbt_phi_walk_pred", "rbt_phi_walk_phi1", "rbt_phi_walk_rows")
# the argument positions of a tables entry: (its policy, B, L); threads and
# stage are the third and second from the end
TABLE_ARGS = {"rbt_lf_tables": (0, 22, 23), "rbt_seed_machine_tables": (1, 22, 23)}
POLICIES = {0: "runs", 1: "dense", 2: "occ1"}  # csrc/lf_tables.cuh enum Policy


class Design:
    """A design's libraries as the `lib` of launch_machine, launch_tables,
    launch_toehold, launch_k1 and launch_walk: its C entries take the
    checkout's arguments; a tables launch gets the design's own threads a
    lane (its rbt_lane_threads) and its launch plan at them; where
    `ordered` (a walk whose entries take the lanes' order: before the chain
    took lane t on thread t), a chain walk's launch also gets `order`, the
    lanes in descending size order (int64 [B], set by walk_turns), before
    `out`, as that design's wrapper sorted them."""

    def __init__(self, paths: dict, current: dict, sms: int, ordered: bool):
        self.libs = {stem: ctypes.CDLL(path) for stem, path in paths.items()}
        self.sms, self.ordered, self.order = sms, ordered, None
        threads = self.libs["lf"].rbt_lane_threads
        threads.argtypes, threads.restype = [ctypes.c_int], ctypes.c_int
        self.groups = {name: threads(code) for code, name in POLICIES.items()}
        self.lacks = set()  # entries of ENTRIES that the design has not (the kval walk before it)
        for stem, entries in ENTRIES.items():
            lib = self.libs[stem]
            for entry in entries:
                if not hasattr(lib, entry):
                    self.lacks.add(entry)
                    continue
                types = list(getattr(current[stem], entry).argtypes)
                if ordered and entry in WALK_CHAINS:
                    types.insert(len(types) - 4, ctypes.c_void_p)
                getattr(lib, entry).argtypes = types
                getattr(lib, entry).restype = ctypes.c_int
            error = "rbt_phi_walk_error_string" if stem == "phi_walk" else "rbt_cuda_error_string"
            getattr(lib, error).argtypes = [ctypes.c_int]
            getattr(lib, error).restype = ctypes.c_char_p

    def _plan(self, entry, args):
        """args with the design's own (threads, stage) for a tables entry."""
        from rowbowt_tpu_torch.ops import cuda_lf

        if entry not in TABLE_ARGS:
            return args
        pos, b, l = TABLE_ARGS[entry]
        threads, staged = cuda_lf.launch_plan(args[b], args[l], self.sms,
                                              group=self.groups[POLICIES[args[pos]]])
        return (*args[:-3], threads, int(staged), args[-1])

    def _call(self, stem, entry, args):
        args = self._plan(entry, args)
        if self.ordered and entry in WALK_CHAINS:
            args = (*args[:-4], self.order.data_ptr(), *args[-4:])
        return getattr(self.libs[stem], entry)(*args)

    def rbt_seed_machine(self, *args):
        return self._call("seeds", "rbt_seed_machine", args)

    def rbt_seed_machine_tables(self, *args):
        return self._call("seeds", "rbt_seed_machine_tables", args)

    def rbt_lf_tables(self, *args):
        return self._call("lf", "rbt_lf_tables", args)

    def rbt_lf_toehold(self, *args):
        return self._call("lf", "rbt_lf_toehold", args)

    def rbt_lf_count_fb2(self, *args):
        return self._call("lf", "rbt_lf_count_fb2", args)

    def rbt_lf_count(self, *args):
        return self._call("lf", "rbt_lf_count", args)

    def rbt_phi_walk_pred(self, *args):
        return self._call("phi_walk", "rbt_phi_walk_pred", args)

    def rbt_phi_walk_phi1(self, *args):
        return self._call("phi_walk", "rbt_phi_walk_phi1", args)

    def rbt_phi_walk_rows(self, *args):
        return self._call("phi_walk", "rbt_phi_walk_rows", args)

    def rbt_phi_walk_kval(self, *args):
        return self._call("phi_walk", "rbt_phi_walk_kval", args)

    def rbt_cuda_error_string(self, code):
        return self.libs["seeds"].rbt_cuda_error_string(code)

    def rbt_phi_walk_error_string(self, code):
        return self.libs["phi_walk"].rbt_phi_walk_error_string(code)


def sass_functions(path: str) -> dict:
    """{kernel: its machine code} of a library by cuobjdump -sass, the
    kernel's name without its file's anonymous-namespace id (nvcc names
    each build's apart) and the code without addresses or spacing, or {}
    where cuobjdump is missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    out = subprocess.run([tool, "-sass", path], capture_output=True, text=True).stdout
    funcs = {}
    for part in out.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        body = re.sub(r"/\*[0-9a-f]{4,}\*/", "", body.split(".....")[0])
        funcs[re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "", name.strip())] = [
            " ".join(ln.split()) for ln in body.splitlines() if ln.strip()]
    return funcs


def instructions(code: list) -> list:
    """Machine code without its encodings: one instruction a line."""
    out = (re.sub(r"/\* 0x[0-9a-f]+ \*/", "", ln).strip() for ln in code)
    return [ln for ln in out if ln]


def same_sass(design: str, checkout: str) -> dict:
    """{"same": [...], "params_only": [...], "differ": [...], "only_one":
    [...], "first_difference": {kernel: [index, design's, checkout's]}}: the
    kernels of two libraries by whether their machine code is equal, equal
    but for the offsets into constant bank 0, where a kernel's parameters
    sit, or neither (with the first instruction where they part)."""
    def masked(code):
        return [re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][.]", ln) for ln in code]

    a, b = sass_functions(design), sass_functions(checkout)
    out = {"same": [], "params_only": [], "differ": [], "only_one": [], "first_difference": {}}
    for n in sorted(set(a) | set(b)):
        if n not in a or n not in b:
            out["only_one"].append(n)
            continue
        x, y = instructions(a[n]), instructions(b[n])
        if a[n] == b[n]:
            out["same"].append(n)
        elif masked(x) == masked(y):
            out["params_only"].append(n)
        else:
            out["differ"].append(n)
            i = next((i for i, (p, q) in enumerate(zip(x, y)) if p != q), min(len(x), len(y)))
            out["first_difference"][n] = [i, x[i] if i < len(x) else None,
                                          y[i] if i < len(y) else None]
    return out


def build_designs(smoke, designs: dict) -> dict:
    """{name: Design} built side by side with the checkout's lf.cu, seeds.cu
    and phi_walk.cu, each into its own libraries (librbt_<stem>_<name>);
    prints
    each design's registers and spills an instance
    (chip_smoke.ptxas_instances) and its kernels' machine code against the
    checkout's (same_sass)."""
    import torch

    from rowbowt_tpu_torch import _native
    from rowbowt_tpu_torch.ops import cuda_gather, cuda_lf, cuda_phi, cuda_seeds

    cmd = [_native.find_tool("nvcc", "/usr/local/cuda/bin/nvcc"), *_native.NVCC_FLAGS]
    csrc = {name: os.path.join(src, "rowbowt_tpu_torch", "csrc") for name, src in designs.items()}

    def build(name, stem):
        d = csrc[name]
        headers = tuple(os.path.join(d, f) for f in sorted(os.listdir(d)) if f.endswith(".cuh"))
        return _native.build_shared(f"librbt_{stem}_{name}", cmd, [os.path.join(d, f"{stem}.cu")],
                                    headers=headers)

    with ThreadPoolExecutor(2 * len(designs) + 2) as ex:
        futures = {(name, stem): ex.submit(build, name, stem) for name in designs
                   for stem in ENTRIES}
        current = {"seeds": ex.submit(cuda_seeds.build), "lf": ex.submit(cuda_lf.build),
                   "phi_walk": ex.submit(cuda_phi.build)}
        current = {stem: f.result() for stem, f in current.items()}
        built = {key: f.result() for key, f in futures.items()}
    logs = {"seeds": cuda_seeds.BUILD_LOG, "lf": cuda_lf.BUILD_LOG, "phi_walk": cuda_phi.BUILD_LOG}
    paths = {stem: lib._name for stem, lib in current.items()}
    print(json.dumps({"designs": {
        **{name: {stem: smoke.ptxas_instances(built[name, stem][1]) for stem in ENTRIES}
           for name in designs},
        "checkout": {stem: smoke.ptxas_instances(logs[stem]) for stem in ENTRIES}}}), flush=True)
    print(json.dumps({"sass": {name: {stem: same_sass(built[name, stem][0], paths[stem])
                                      for stem in ENTRIES} for name in designs}}), flush=True)
    # the step loops of each design's K1: the single-level lf_count_kernel
    # (count and toehold) and the two-level lf_count2_kernel
    libs_lf = {**{name: built[name, "lf"][0] for name in designs}, "checkout": paths["lf"]}
    STEP_LOOPS.update({name: {**smoke.loop_instructions(path, "lf_count_kernel"),
                              **smoke.loop_instructions(path, "lf_count2_kernel")}
                       for name, path in libs_lf.items()})
    print(json.dumps({"step_loops": STEP_LOOPS}), flush=True)
    sms = cuda_gather._sm_count(torch.cuda.current_device())
    out = {}
    for name in designs:
        with open(os.path.join(csrc[name], "phi_walk.cu")) as f:
            ordered = "const void* order" in f.read()
        out[name] = Design({stem: built[name, stem][0] for stem in ENTRIES}, current, sms,
                           ordered)
    return out


# {design: {instance: its step loop's instructions}} (build_designs)
STEP_LOOPS = {}


# designs timed but not held to the checkout's outputs (--time-only: forks
# that measure a part of a kernel by leaving it out)
TIME_ONLY = set()


def held(smoke, design: str, err: int, what: str) -> None:
    """A design's outputs equal the checkout's (err 0), unless it is timed
    only."""
    if design not in TIME_ONLY:
        smoke.check(err == 0, what)


def in_turns(smoke, libs: dict, launch) -> dict:
    """{design: [device µs of a launch, a turn each]} of launch(lib) on
    every design's library and the checkout's (lib None), in turns."""
    order = list(libs) + ["checkout", "checkout"] + list(libs)[::-1]
    us = {d: [] for d in ["checkout", *libs]}
    for d in order:
        us[d].append(smoke.kernel_event_us([smoke.around(lambda lib=libs.get(d): launch(lib))],
                                           PASSES))
    return dict(order=order, device_us_turns=us,
                device_us={d: sum(v) / len(v) for d, v in us.items()})


def seed_turns(smoke, libs: dict, tx, runs: dict) -> None:
    """Each batch of `runs` ({name: (q, ln, cfg)}) on every design and the
    checkout's kernel, in turns; prints one seed_turns line a batch."""
    import torch

    from rowbowt_tpu_torch.ops import cuda_lf, cuda_seeds

    for name, (q, ln, cfg) in runs.items():
        mode = name.split("_")[0]

        def launch(lib, mode=mode, q=q, ln=ln, cfg=cfg):
            return cuda_seeds.launch_machine(tx, mode, q, ln, lib=lib, **cfg)

        want = launch(None)
        errs = {}
        for d, lib in libs.items():
            got = launch(lib)
            torch.cuda.synchronize()
            errs[d] = smoke.records_err(got, want)
            held(smoke, d, errs[d], f"design {d} != the checkout's kernel on {name}")
        key = cuda_lf.row_layout(tx) or cuda_lf.table_policy(tx)
        print(json.dumps({"seed_turns": {
            "batch": name, "route": smoke.seed_route(tx, mode, cfg), "tables": key,
            "lanes": q.shape[0], "L": q.shape[1], **in_turns(smoke, libs, launch),
            "max_abs_err": errs}}), flush=True)


def table_turns(smoke, libs: dict, tx, batches: list, toehold: bool) -> None:
    """The tables kernel on the first of `batches` ([(q, ln)]: the count
    search without the ftab start, or the toehold search) on every design
    and the checkout's, in turns; prints one table_turns line."""
    import torch

    from rowbowt_tpu_torch.ops import cuda_lf

    q, ln = batches[0]
    ln = ln.to(torch.int32)

    def launch(lib):
        return cuda_lf.launch_tables(tx, q, ln, use_ftab=False, toehold=toehold, lib=lib)

    want = launch(None)
    errs = {}
    for d, lib in libs.items():
        got = launch(lib)
        torch.cuda.synchronize()
        errs[d] = smoke.max_abs_err(got, want)
        held(smoke, d, errs[d], f"design {d} != the checkout's tables kernel")
    print(json.dumps({"table_turns": {
        "policy": cuda_lf.table_policy(tx), "toehold": toehold, "lanes": q.shape[0],
        "L": q.shape[1], "step_tables": smoke.step_tables(tx, cuda_lf.table_policy(tx)),
        **in_turns(smoke, libs, launch), "max_abs_err": errs}}), flush=True)


# pseudo-designs of walk_turns: the checkout's chain where the checkout
# walks kval, and the empty kernel in the walk's grid (the method's floor)
CHAIN, EMPTY = "checkout_chain", "empty_kernel"


def walk_turns(smoke, libs: dict, tx, ranges: list, route: str) -> None:
    """The walk of rbt_align -s over tx (`route`, as chip_smoke.walk_times
    takes it) on the first batch of `ranges` ([(lo, hi, k)]) on every
    design and the checkout's, in turns, each as its wrapper launches it: a
    design with the kval kernel gets each lane's hi where the route is
    kval, one whose chain takes the lanes' order gets them in descending
    size order (Design); beside them, on the kval route, the checkout's
    chain over phi1 (CHAIN), and the empty kernel in the walk's grid
    (EMPTY); prints one walk_turns line."""
    import torch

    from rowbowt_tpu_torch.ops import cuda_gather, cuda_phi

    lo, hi, k = ranges[0]
    size = torch.clamp(hi - lo + 1, min=0).to(torch.int64)
    k, off = k.to(torch.int64), torch.cumsum(size, 0) - size
    hi = hi.to(torch.int64) if route == "kval" else None
    out = torch.empty(int(size.sum()), dtype=torch.int64, device=k.device)
    dev = k.device.index if k.device.index is not None else torch.cuda.current_device()
    threads = cuda_phi.launch_plan(k.numel(), cuda_gather._sm_count(dev))
    order = torch.argsort(size, descending=True)
    for lib in libs.values():
        lib.order = order

    def launch(lib):
        if lib is None:
            return cuda_phi.launch_walk(tx, k, size, off, out, hi)
        if lib == CHAIN:
            return cuda_phi.launch_walk(tx, k, size, off, out)
        if lib == EMPTY:
            return cuda_phi.build().rbt_phi_walk_empty(k.numel(), threads,
                                                       cuda_gather._raw_stream(dev))
        h = hi if "rbt_phi_walk_kval" not in lib.lacks else None
        return cuda_phi.launch_walk(tx, k, size, off, out, h, lib=lib)

    want = launch(None).clone()
    extra = {**({CHAIN: CHAIN} if route == "kval" else {}), EMPTY: EMPTY}
    errs = {}
    for d, lib in {**libs, **extra}.items():
        if lib == EMPTY:
            continue
        got = launch(lib)
        torch.cuda.synchronize()
        errs[d] = smoke.max_abs_err([got], [want])
        held(smoke, d, errs[d], f"design {d} != the checkout's walk kernel")
    print(json.dumps({"walk_turns": {
        "route": route, "lanes": k.numel(), "hits": out.numel(),
        "longest": int(size.max()) if size.numel() else 0,
        **({"pred_bs": list(tx.pred_bs)} if route == "pred" else {}),
        **in_turns(smoke, {**libs, **extra}, launch), "max_abs_err": errs}}), flush=True)


def toehold_turns(smoke, libs: dict, tx, q, ln) -> None:
    """K1's toehold launch over tx on the batch (q, ln) on every design and
    the checkout's, in turns, and K1's count instance on the same batch
    from the full range (no ftab start) the same way; each design's toehold
    time over its count time (`over_count`) and the step loops of both
    instances (chip_smoke.k1_loop); prints one toehold_turns line."""
    import torch

    from rowbowt_tpu_torch.ops import cuda_lf

    ln = ln.to(torch.int32)
    out = {"route": cuda_lf.toehold_route(tx), "rs_bs": list(tx.rs_bs), "lanes": q.shape[0],
           "L": q.shape[1]}
    for name, launch in (
            ("toehold", lambda lib: cuda_lf.launch_toehold(tx, q, ln, lib=lib)),
            ("count", lambda lib: cuda_lf.launch_k1(tx, q, ln, use_ftab=False, lib=lib))):
        want = launch(None)
        errs = {}
        for d, lib in libs.items():
            got = launch(lib)
            torch.cuda.synchronize()
            errs[d] = smoke.max_abs_err(got, want)
            held(smoke, d, errs[d], f"design {d} != the checkout's {name} launch")
        out[name] = dict(in_turns(smoke, libs, launch), max_abs_err=errs)
    out["over_count"] = {d: us / out["count"]["device_us"][d]
                         for d, us in out["toehold"]["device_us"].items()}
    syms = cuda_lf._SYMS_PER_ROW[cuda_lf.row_layout(tx)]
    out["step_loops"] = {d: {name: smoke.k1_loop(syms, toe, STEP_LOOPS.get(d, {}))
                             for name, toe in (("count", False), ("toehold", True))}
                         for d in ["checkout", *libs]}
    print(json.dumps({"toehold_turns": out}), flush=True)


def k1_turns(smoke, libs: dict, tx, q, ln) -> None:
    """K1 over tx's two-level rows on the batch (q, ln), the count search
    and the record launch, on every design and the checkout's, in turns;
    prints one k1_turns line."""
    import torch

    from rowbowt_tpu_torch.ops import cuda_lf

    ln = ln.to(torch.int32)
    key = cuda_lf.row_layout(tx)
    out = {"layout": key, "n": tx.n, "lanes": q.shape[0], "L": q.shape[1]}
    # the issue bound of each design: its two threads' step loop a ranked
    # step over the card's int32 rate (chip_smoke.k1_bound's operations)
    ranked = smoke.k1_work(tx, q, ln, False)["ranked_steps"]
    for name, record in (("count", False), ("record", True)):
        loops = {d: smoke.step_loop(cuda_lf._SYMS_PER_ROW[key], record, STEP_LOOPS.get(d, {}))
                 for d in ["checkout", *libs]}
        out[f"{name}_issue_us"] = {d: 2 * v * ranked / smoke.INT_OPS_PER_S * 1e6
                                   for d, v in loops.items() if v}
        out[f"{name}_step_loop"] = loops
    for name, record in (("count", False), ("record", True)):
        def launch(lib, record=record):
            return cuda_lf.launch_k1(tx, q, ln, use_ftab=False, record=record, lib=lib)

        want = launch(None)
        errs = {}
        for d, lib in libs.items():
            got = launch(lib)
            torch.cuda.synchronize()
            errs[d] = smoke.max_abs_err(got, want)
            held(smoke, d, errs[d], f"design {d} != the checkout's K1 ({name})")
        out[name] = dict(in_turns(smoke, libs, launch), max_abs_err=errs)
    print(json.dumps({"k1_turns": out}), flush=True)


def dense_toehold(smoke, device, tx, batches: list, lat, path: str | None) -> None:
    """Where tx's count search is the dense step's, the toehold search of
    the same index without kval (the ltk route; loaded from `path` with its
    toehold tables where tx holds none) on the same batches, timed and
    bounded (chip_smoke.tables_times, so in turns with the designs too);
    prints a dense_toehold line."""
    import torch

    from rowbowt_tpu_torch.ops import cuda_lf

    if cuda_lf.table_policy(tx) != "dense":
        return
    if "ltk" not in tx.arrays:
        if path is None:
            return
        tx = smoke.load_dense(device, path, "-s")[1]
    # without kval the resolve reads ltk through rs_off, which a load of
    # such an index builds
    view = dataclasses.replace(tx, arrays={k: v for k, v in tx.arrays.items()
                                           if k != "kval"}).with_card_tables()
    out = smoke.tables_times(device, view, [(q, ln.to(torch.int32)) for q, ln in batches], True,
                             lat, stage=False)
    print(json.dumps({"dense_toehold": out}, default=str), flush=True)


def chr_views(smoke, device, chr_: dict, lat: dict) -> None:
    """chr's BWT at full width as an index without fused rows: its dense
    tables (build_dense_tables over its codes) and its occ1 (build_occ1),
    each with chr's other tables (kval, the ftab); chip_smoke.tables_times
    on the count batch (the first 65,536 reads, no ftab start) and
    seeds_times on rbt_markers -f's and rbt_locs' batches, each in turns
    with the designs through the wrapped timers; prints a chr_view line a
    view with the checkout's times, bounds and shares."""
    import numpy as np
    import torch

    from rowbowt_tpu_torch.cli.common import iter_query_batches
    from rowbowt_tpu_torch.construct.build import build_dense_tables, build_occ1
    from rowbowt_tpu_torch.engine.device import TorchIndex
    from rowbowt_tpu_torch.ops import cuda_lf

    idx, paths = chr_["idx"], chr_["paths"]
    codes = np.repeat(idx.run_head, np.diff(np.append(idx.run_start, idx.n))).astype(np.int64)
    bare = dict(fblock=None, phi1=None, occ1=None, tk1=None, bwt4=None, occ_blk=None)
    for name in ("dense", "occ1"):
        if name == "dense":
            bwt4, occ_blk = build_dense_tables(codes, idx.A)
            view = dataclasses.replace(idx, **dict(bare, bwt4=bwt4, occ_blk=occ_blk))
        else:
            view = dataclasses.replace(idx, **dict(bare, occ1=build_occ1(codes, idx.A)))
        tx = TorchIndex.from_index(view, device)
        smoke.check(cuda_lf.table_policy(tx) == name, f"the chr {name} view's policy")
        _, qc, lens = next(iter(iter_query_batches(view, paths["reads.fq"], smoke.BATCH)))
        count = smoke.tables_times(device, tx, [(torch.from_numpy(qc).to(device),
                                                 torch.from_numpy(lens).to(device))],
                                   False, lat, stage=False)
        seeds = smoke.seeds_times(tx, smoke.seed_batches(device, view, tx, paths,
                                                         ("greedy", "sample")), lat)
        print(json.dumps({"chr_view": {"policy": name, "n": idx.n, "A": idx.A,
                                       "step_tables": smoke.step_tables(tx, name),
                                       "l2_bytes": smoke.l2_bytes(), "count": count,
                                       "seeds": seeds}}, default=str), flush=True)
        del tx, view
        torch.cuda.empty_cache()


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--design", action="append", default=[], metavar="NAME=DIR",
                    help="an earlier design's kernel sources (repeatable, timed in this order)")
    ap.add_argument("--time-only", action="append", default=[], metavar="NAME=DIR",
                    help="a design timed beside the others whose outputs are not held to the "
                         "checkout's (a fork that leaves a part of a kernel out; repeatable)")
    ap.add_argument("phases", nargs="*", default=list(DEFAULT_PHASES))
    args = ap.parse_args(argv)
    named = args.design + args.time_only
    designs = dict(d.split("=", 1) for d in named)
    TIME_ONLY.update(d.split("=", 1)[0] for d in args.time_only)
    if not args.design or "checkout" in designs or len(designs) < len(named):
        ap.error("at least one --design NAME=DIR, names distinct, none named checkout")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as smoke
    import torch

    if not torch.cuda.is_available():
        print("seed_turns needs a CUDA device; torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    libs = build_designs(smoke, designs)
    real_seeds, real_tables, real_nodense = (smoke.seeds_times, smoke.tables_times,
                                             smoke.phase_nodense_chr)
    real_walk, real_toehold_work = smoke.walk_times, smoke.toehold_work
    real_record, real_held = smoke.record_times, smoke.held_record
    timed_big = set()  # the pfp_big views K1's turns have run on
    real_load, loaded = smoke.load_dense, {}

    def load_dense(device, path, mode):
        loaded["path"] = path
        return real_load(device, path, mode)

    def seeds_times(tx, runs, lat):
        out = real_seeds(tx, runs, lat)
        seed_turns(smoke, libs, tx, runs)
        return out

    def tables_times(device, tx, batches, toehold, lat, stage=True):
        out = real_tables(device, tx, batches, toehold, lat, stage)
        table_turns(smoke, libs, tx, batches, toehold)
        if not toehold:
            dense_toehold(smoke, device, tx, batches, lat, loaded.pop("path", None))
        return out

    def walk_times(device, tx, ranges, route, step_us, step_us_old=None):
        out = real_walk(device, tx, ranges, route, step_us, step_us_old)
        walk_turns(smoke, libs, tx, ranges, route)
        return out

    def toehold_work(tx, q, ln):
        # toehold_times asks for the work of the batch it times, with the
        # index it loaded
        out = real_toehold_work(tx, q, ln)
        toehold_turns(smoke, libs, tx, q, ln)
        return out

    def record_times(device, big, tx, dev, *rest):
        # big_chr's timed view and batches
        out = real_record(device, big, tx, dev, *rest)
        k1_turns(smoke, libs, tx, *dev[0])
        return out

    def held_record(tx, q, ln, ranges=None):
        # pfp_big checks each two-level view above 2^31 on its full batches
        out = real_held(tx, q, ln, ranges)
        if tx.n >= 1 << 31 and q.shape[0] >= smoke.BATCH and id(tx) not in timed_big:
            timed_big.add(id(tx))
            k1_turns(smoke, libs, tx, q, ln)
        return out

    def phase_nodense_chr(device, card, chr_, count, loc, markers, k1, seeding):
        out = real_nodense(device, card, chr_, count, loc, markers, k1, seeding)
        chr_views(smoke, device, chr_, k1["us_per_dependent_step"])
        return out

    smoke.seeds_times, smoke.tables_times = seeds_times, tables_times
    smoke.walk_times, smoke.toehold_work = walk_times, toehold_work
    smoke.record_times, smoke.held_record = record_times, held_record
    smoke.phase_nodense_chr, smoke.load_dense = phase_nodense_chr, load_dense
    return smoke.main(list(args.phases))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
