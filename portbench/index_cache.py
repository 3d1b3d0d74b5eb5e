"""The index of a configuration, built once per checkout and loaded by each run.

The first run of a cell builds its configuration's index, with only the
arrays that its query class reads, into portbench/.cache/<config>/<part>/
(git ignores it), in a spawned child process so that the build's host
memory leaves with it.  The build writes a stamp last: a directory without
a stamp that matches the configuration is built again.  Later runs load it
as the port's CLI does (cli/common.load_index and device_index), gated by
the query class's flags.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
import shutil
import time

from portbench.spec import HERE, load_module

CACHE_ROOT = os.path.join(HERE, ".cache")
STAMP = "portbench_stamp.json"


def part_name(flags: dict) -> str:
    """The cache directory of an index with the tables of `flags`: "rank"
    with no SA samples, markers or document list, else the flags held."""
    return "_".join(k for k in ("sa", "ma", "dl") if flags[k]) or "rank"


def stamp_of(cfg: dict, flags: dict) -> str:
    return hashlib.sha256(json.dumps([cfg, flags], sort_keys=True).encode()).hexdigest()


def _build_child(cfg: dict, flags: dict, tmp: str, out_json: str) -> None:
    from portbench.panel import make_panel

    t = time.perf_counter()
    info = load_module("builds", cfg["build"]).build(make_panel(cfg), cfg, flags, tmp)
    info["build_s"] = time.perf_counter() - t
    # the index on disk before the child ends, so that its write-back does
    # not fall in the first run's window
    for name in os.listdir(tmp):
        fd = os.open(os.path.join(tmp, name), os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    info["sync_s"] = time.perf_counter() - t - info["build_s"]
    with open(out_json, "w") as f:
        json.dump(info, f)


def ensure(cfg: dict, flags: dict, root: str = CACHE_ROOT, log=print) -> str:
    """The directory of `cfg`'s index for a query of `flags`, built first
    where no finished build is there.  Checks the index's n and R against
    the configuration's (where it states them)."""
    out = os.path.join(root, cfg["name"], part_name(flags))
    stamp = stamp_of(cfg, flags)
    path = os.path.join(out, STAMP)
    if os.path.exists(path):
        with open(path) as f:
            if json.load(f).get("stamp") == stamp:
                return out
    tmp = out + ".building"
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(tmp)
    info_path = os.path.join(tmp, "build_info.json")
    proc = multiprocessing.get_context("spawn").Process(
        target=_build_child, args=(cfg, flags, tmp, info_path))
    proc.start()
    proc.join()
    if proc.exitcode != 0:
        raise RuntimeError(f"building {cfg['name']}'s index failed (exit {proc.exitcode})")
    with open(info_path) as f:
        info = json.load(f)
    for key in ("n", "R"):
        if key in cfg and info[key] != cfg[key]:
            raise RuntimeError(f"{cfg['name']}'s index has {key} = {info[key]}, "
                               f"the configuration states {cfg[key]}")
    written = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp))
    log(f"built {cfg['name']} ({part_name(flags)}): n={info['n']:,} R={info['R']:,} "
        f"in {info['build_s']:.1f} s (+ {info['sync_s']:.1f} s to disk), "
        f"{written / 1e9:.3f} GB written")
    with open(os.path.join(tmp, STAMP), "w") as f:
        json.dump(dict(stamp=stamp, bytes=written, **info), f)
    os.rename(tmp, out)
    return out


def load(path: str, flags: dict, device):
    """(index, device view) of the index at `path`, as rbt_align loads it
    for the query's flags."""
    from rowbowt_tpu_torch.cli.common import device_index, load_index

    idx = load_index(path, sa=flags["sa"], ma=flags["ma"], dl=flags["dl"])
    return idx, device_index(idx, device, sa=flags["sa"], ma=flags["ma"])
