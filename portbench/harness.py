"""One run of a cell: set-up, the measured window, the traced run's readers,
and the check against the plain reference.

Set-up draws the panel from the configuration's seed, builds its index on a
checkout's first run, loads it as rbt_align does, draws a pool of distinct
batches from `--seed` and encodes them as cli/common.iter_query_batches
yields them, and runs warm batches on the cell's own shapes.  The window is
a closed loop with one client: pool batches back to back until `seconds`
have passed, each from its codes on the host to its result arrays on the
host.  With `trace` the window closes each layer's span with a synchronize,
and a bounded stretch of batches is profiled after it.  Once the window has
closed, the program's device state is freed and the reference judges every
answer of the last pass over the pool and a sample, drawn from the seed, of
every batch of the window.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

from portbench import index_cache
from portbench.panel import encode, make_panel, pow2_at_least, sample_reads
from portbench.spec import Cell, load_module
from portbench.trace import SpanClock, no_marks, profile_batches

PROFILE_SLOTS = 4  # pool slots the profiled stretch cycles over (each replayed for K1's work)
SEL_ROWS = 4096  # rows of the seeded table of each window batch's sampled reads
FORBIDDEN = ("jax", "jaxlib", "flax", "rowbowt_tpu")  # top-level module names a run may not hold


def process_age_s() -> float | None:
    """Seconds since this process started (/proc), or None."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None
    return up - start / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list[str]:
    """The modules of FORBIDDEN that sys.modules holds, by whole top-level
    name."""
    top = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(top & set(FORBIDDEN))


@dataclasses.dataclass
class Pool:
    batches: list  # (codes int32 [B, width], lengths int32 [B]) each
    bases: np.ndarray  # uint8 [P * B, read_len]: every read of the pool
    offs: np.ndarray  # int64 [P * B]: each read's offset in its document
    sels: np.ndarray  # int64 [SEL_ROWS, k]: the reads sampled from window batch i are sels[i % SEL_ROWS]


def make_pool(panel, traffic: dict, seed: int, table: np.ndarray) -> Pool:
    """The cell's batches of `seed`: pool_batches batches of `batch` reads,
    and the table of sampled reads."""
    B, P, L = traffic["batch"], traffic["pool_batches"], traffic["read_len"]
    width = pow2_at_least(L)
    if width != traffic["width"]:
        raise ValueError(f"reads of {L} bases pad to {width}, the traffic states {traffic['width']}")
    rr, rs = (np.random.default_rng(s) for s in np.random.SeedSequence(seed).spawn(2))
    reads = sample_reads(panel, rr, P * B, L, traffic["sub_rate"])
    codes, lens = encode(reads.bases, table, width)
    batches = [(np.ascontiguousarray(codes[p * B:(p + 1) * B]), lens[p * B:(p + 1) * B].copy())
               for p in range(P)]
    sels = rs.integers(0, B, size=(SEL_ROWS, traffic["sample_per_batch"]))
    return Pool(batches=batches, bases=reads.bases, offs=reads.offs, sels=sels)


@dataclasses.dataclass
class TracedRun:
    """What the per-layer readers read (metrics/<name>.py read(run))."""
    cell: Cell
    query: object
    tx: object  # the program's device view of the index
    idx: object  # the loaded index (host)
    pool: Pool
    spans: SpanClock
    span_batches: int  # batches of the span window
    profile: object  # trace.Profile of the profiled stretch
    slots: list  # the pool slot of each profiled batch
    results: list  # each profiled batch's result arrays
    memo: dict = dataclasses.field(default_factory=dict)


def concat(collections: list[dict]) -> dict:
    """One collection of answers from several (query.collect's), segment
    offsets ("seg") shifted onto each other."""
    out = {}
    for key in collections[0]:
        if key == "seg":
            parts, base = [np.zeros(1, dtype=np.int64)], 0
            for c in collections:
                parts.append(c["seg"][1:] - c["seg"][0] + base)
                base = int(parts[-1][-1]) if parts[-1].size else base
            out[key] = np.concatenate(parts)
        else:
            out[key] = np.concatenate([c[key] for c in collections])
    return out


def check(panel, pool: Pool, query, last: list, samples: list, B: int) -> dict:
    """{check: wrong reads}: every answer of the last pass over the pool
    (last[p], pool slot p's newest result) and the sampled answers of the
    window (samples: (slot, rows, collected)), judged by the reference."""
    from portbench.reference import doc_matches

    match = doc_matches(panel, pool.bases, pool.offs)
    reads, got = [], []
    for p, res in enumerate(last):
        if res is not None:
            reads.append(p * B + np.arange(B))
            got.append(query.collect(res))
    for p, rows, col in samples:
        reads.append(p * B + rows)
        got.append(col)
    reads = np.concatenate(reads)
    wrong = query.judge(panel, match, pool.offs, reads, concat(got))
    return {k: int(v.sum()) for k, v in wrong.items()} | {"reads_checked": int(reads.shape[0])}


@dataclasses.dataclass
class Window:
    batches: int  # batches run
    seconds: float  # from the first batch's hand-in to the last one's results on the host
    times: list  # each batch's seconds
    last: list  # each pool slot's newest result arrays
    samples: list  # (slot, rows, collected answers) of each batch's sampled reads


def window(tx, query, pool: Pool, seconds: float, mark, spans: SpanClock | None = None) -> Window:
    """The measured window: pool batches back to back, a closed loop with
    one client, until `seconds` have passed at the end of a batch; each
    batch from its codes on the host to its result arrays on the host
    (query.run with `mark` around its layers).  Keeps each pool slot's
    newest results and the sampled reads' answers of every batch."""
    P = len(pool.batches)
    last: list = [None] * P
    samples, times = [], []
    i = 0
    t_start = time.perf_counter()
    while True:
        p = i % P
        if spans is not None:
            spans.batch = i
        t0 = time.perf_counter()
        res = query.run(tx, *pool.batches[p], mark)
        t1 = time.perf_counter()
        times.append(t1 - t0)
        last[p] = res
        rows = pool.sels[i % SEL_ROWS]
        samples.append((p, rows, query.collect(res, rows)))
        i += 1
        if t1 - t_start >= seconds:
            return Window(batches=i, seconds=t1 - t_start, times=times, last=last, samples=samples)


def p95_ms(times: list) -> float:
    """The 95th percentile, in milliseconds, of every batch's seconds from
    hand-in to its last result array on the host."""
    return float(np.percentile(np.asarray(times), 95)) * 1e3


def device_info(device, count: int) -> dict:
    import torch

    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=count, memory_peak_bytes=0)
    info = dict(platform="gpu", kind=torch.cuda.get_device_name(device), count=count,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated(device)))
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              f"--id={device.index or 0}"],
                             capture_output=True, text=True, timeout=30)
        info["power_limit"] = out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return info


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, chips: int = 1,
             query=None, cache_root: str = index_cache.CACHE_ROOT, log=None) -> dict:
    """One run of `cell`; returns the result line's fields, with `checks`
    ({name: (value, limit)}) last.  `query` replaces the cell's query class
    (its control, or a fault planted under the timed path)."""
    import torch

    t_import = time.perf_counter()
    log = log or (lambda *a: print(*a, file=sys.stderr))
    query = query or cell.query
    traffic, cfg = cell.traffic, cell.config
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    stages, t = {}, time.perf_counter()

    def stage(name):
        nonlocal t
        sync()
        stages[name] = time.perf_counter() - t
        t = time.perf_counter()

    panel = make_panel(cfg)
    stage("panel")
    path = index_cache.ensure(cfg, query.FLAGS, cache_root, log=log)
    stage("build")
    idx, tx = index_cache.load(path, query.FLAGS, device)
    stage("load")
    pool = make_pool(panel, traffic, seed, idx.alpha.encode_table())
    stage("pool")
    B, P = traffic["batch"], traffic["pool_batches"]
    for p in range(min(P, traffic["warm_batches"])):
        query.run(tx, *pool.batches[p], no_marks)
    stage("warm")
    age = process_age_s()
    setup_s = age if age is not None else time.perf_counter() - t_import
    log("set-up stages: " + json.dumps(dict(stages, before=setup_s - sum(stages.values()))))

    spans = SpanClock(cuda)
    win = window(tx, query, pool, seconds, spans if trace else no_marks, spans)
    i, window_s, times = win.batches, win.seconds, win.times
    out = dict(correct=False, attempted=i * B, failed=0)
    dev = device_info(device, chips)

    metrics, breakdown = {}, None
    if trace:
        k = traffic["profile_batches"]
        slots = [j % min(P, PROFILE_SLOTS) for j in range(k)]
        prof, results = profile_batches(
            lambda j, m: query.run(tx, *pool.batches[j % min(P, PROFILE_SLOTS)], m), k, cuda)
        log("profiled batches, ms: " + json.dumps(prof.batch_ms()))
        dev.update(busy_s=prof.busy_s(), window_s=prof.window_s())
        run = TracedRun(cell=cell, query=query, tx=tx, idx=idx, pool=pool, spans=spans,
                        span_batches=i, profile=prof, slots=slots, results=results)
        for m in cell.per_layer:
            t = time.perf_counter()
            v = load_module("metrics", m["name"]).read(run)
            log(f"metric {m['name']}: {v} ({time.perf_counter() - t:.3f} s)")
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
        breakdown = prof.breakdown()
        del run, results
    else:
        values = dict(setup_s=setup_s, reads_per_s=i * B / window_s,
                      batch_ms_p95=p95_ms(times),
                      device_peak_gb=dev["memory_peak_bytes"] / 1e9)
        log("untraced window: " + json.dumps(values))
        for m in cell.end_to_end:
            metrics[m["name"]] = dict(value=float(values[m["name"]]), unit=m["unit"])
    log(f"window: {i} batches ({i * B} reads) in {window_s:.3f} s; set-up {setup_s:.3f} s")

    del tx
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    wrong = check(panel, pool, query, win.last, win.samples, B)
    log(f"reference: {wrong['reads_checked']} reads judged in {time.perf_counter() - t:.3f} s")
    checks = {name: (wrong[name], 0) for name in query.CHECKS}
    out.update(correct=all(v <= lim for v, lim in checks.values()), metrics=metrics, device=dev)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out
