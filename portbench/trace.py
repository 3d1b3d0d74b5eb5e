"""Spans around the harness's calls into each layer, and the profile of a
bounded stretch of batches.

SpanClock is a frozen copy of the port's cli/common.StageClock pattern:
host-clock seconds of a named stage, closed by a synchronize on a CUDA
device so that the stage's device work counts in it, with the batch id of
each span.  Profile holds the device's kernels, copies and memsets and the
host's `pb.*` annotations of a torch.profiler Chrome trace, in the trace's
clock (microseconds).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # device activity in a Chrome trace
MARK = "pb."  # prefix of the harness's annotations
# the port's hand-written kernels, whose launches its counters count
PORT_KERNELS = ("lf_count_kernel", "lf_count2_kernel", "lf_tables_kernel", "phi_walk_kernel",
                "kval_walk_kernel", "seed_machine_kernel", "seed_tables_kernel")
NULL = contextlib.nullcontext()


def no_marks(name: str):
    """The timed window's marks: none."""
    return NULL


class SpanClock:
    """Host-clock spans (name, batch, seconds); on a CUDA device each closes
    with a synchronize."""

    def __init__(self, cuda: bool):
        self.spans: list[tuple[str, int, float]] = []
        self.batch = 0
        self._cuda = cuda

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            if self._cuda:
                import torch

                torch.cuda.synchronize()
            self.spans.append((name, self.batch, time.perf_counter() - t))

    def ms_a_batch(self, name: str, batches: int) -> float | None:
        """Milliseconds of the spans called `name` over `batches` batches;
        None where there are none."""
        s = [x for n, _, x in self.spans if n == name]
        return sum(s) / batches * 1e3 if s and batches else None


def annotate(name: str):
    """The profiled stretch's marks: a torch.profiler annotation pb.<name>."""
    import torch

    return torch.profiler.record_function(MARK + name)


@dataclasses.dataclass
class Profile:
    device: list[tuple[str, str, float, float]]  # (cat, name, start, end) of each device event
    marks: list[tuple[str, float, float]]  # (name, start, end) of each pb.* annotation
    batches: int  # batches in the stretch
    launches: int  # the port's launch counters' increase over the stretch

    def window(self) -> tuple[float, float] | None:
        """(start, end) of the stretch: the first batch mark's start to the
        last one's end."""
        b = [(s, e) for n, s, e in self.marks if n == MARK + "batch"]
        return (min(s for s, _ in b), max(e for _, e in b)) if b else None

    def batch_ms(self) -> list[float]:
        """Each profiled batch's milliseconds, by its pb.batch mark."""
        return [(e - s) / 1e3 for n, s, e in self.marks if n == MARK + "batch"]

    def kernels(self, *names: str) -> list[tuple[str, float, float]]:
        """(name, start, end) of the kernels that start in the window and
        whose (demangled) names hold one of `names` (every kernel where none
        is given)."""
        w = self.window()
        return [(n, s, e) for c, n, s, e in self.device
                if c == "kernel" and w and w[0] <= s <= w[1]
                and (not names or any(x in n for x in names))]

    def busy(self) -> list[tuple[float, float]]:
        """The merged intervals in the window in which a kernel, a copy or a
        memset ran on the device."""
        w = self.window()
        if w is None:
            return []
        spans = sorted((max(s, w[0]), min(e, w[1])) for _, _, s, e in self.device
                       if e > w[0] and s < w[1])
        merged: list[list[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e6

    def window_s(self) -> float:
        w = self.window()
        return (w[1] - w[0]) / 1e6 if w else 0.0

    def host_at(self, t: float) -> str:
        """The innermost pb.* annotation open at time t (the batch mark only
        where no other is), or "outside"."""
        best = None
        for n, s, e in self.marks:
            if s <= t < e and (best is None or s >= best[1]):
                best = (n, s)
        return best[0][len(MARK):] if best else "outside"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took the most seconds in the window,
        and the device's idle seconds by what the host was doing as each
        gap began, the largest first."""
        w = self.window()
        ops: dict[str, float] = {}
        for _, n, s, e in self.device:
            if w and e > w[0] and s < w[1]:
                ops[n[:120]] = ops.get(n[:120], 0.0) + (e - s) / 1e6
        gaps: dict[str, float] = {}
        if w:
            t = w[0]
            for s, e in self.busy() + [(w[1], w[1])]:
                if s > t:
                    name = self.host_at(t)
                    gaps[name] = gaps.get(name, 0.0) + (s - t) / 1e6
                t = max(t, e)
        order = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in order],
                "idle_gaps": [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]}


def parse_chrome_trace(path: str) -> tuple[list, list]:
    """(device events, pb.* annotations) of a torch.profiler Chrome trace."""
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    device, marks = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"])
        e = s + float(ev["dur"])
        if ev.get("cat") in DEVICE_CATS:
            device.append((ev["cat"], ev.get("name", "?"), s, e))
        elif ev.get("cat") == "user_annotation" and ev.get("name", "").startswith(MARK):
            marks.append((ev["name"], s, e))
    return device, marks


def port_launches() -> int:
    """The sum of the port's kernel launch counters (read, never reset)."""
    from rowbowt_tpu_torch.ops import cuda_lf, cuda_phi, cuda_seeds

    return (cuda_lf.LAUNCHES + cuda_lf.LAUNCHES_FB2 + cuda_lf.LAUNCHES_REC + cuda_lf.LAUNCHES_TOE
            + sum(cuda_lf.LAUNCHES_TAB.values()) + sum(cuda_lf.LAUNCHES_TAB_TOE.values())
            + cuda_phi.LAUNCHES + cuda_phi.LAUNCHES_KVAL + sum(cuda_seeds.LAUNCHES_SEED.values()))


def profile_batches(run_batch, count: int, cuda: bool, warmup: int = 4) -> tuple[Profile, list]:
    """Profile `count` calls of run_batch(j, mark) (mark: annotate), each
    inside a pb.batch annotation, after `warmup` calls that the profiler
    runs but does not keep (its own start-up); returns the Profile and the
    kept calls' results.  The Chrome trace goes through a temporary file in
    TMPDIR, removed once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out = []
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        with profile(activities=acts, schedule=schedule(wait=0, warmup=warmup, active=count),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            for j in range(warmup + count):
                if j == warmup:
                    l0 = port_launches()
                with annotate("batch"):
                    res = run_batch(j, annotate)
                if j >= warmup:
                    out.append(res)
                if cuda:
                    torch.cuda.synchronize()
                prof.step()
            launches = port_launches() - l0
        device, marks = parse_chrome_trace(path)
    finally:
        os.remove(path)
    return Profile(device=device, marks=marks, batches=count, launches=launches), out
