"""Build-on-first-use of the port's shared libraries.

The host library (SA-IS, the FASTQ batch reader, the BWT merge, PFP and the
CPU query engine, from the repo's `native/` sources) is compiled with g++,
and the CUDA kernels (from `rowbowt_tpu_torch/csrc/`) with nvcc, into
`rowbowt_tpu_torch/_build/`, which git ignores.  Each library's file name carries a hash of its sources
and its compile command, so an edited source or flag builds anew and a stale
library is never loaded.  A compile writes a temporary file and renames it
into place, so processes that build at the same time (test workers) never
load a half-written library.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(PKG_DIR)
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NATIVE_DIR = os.path.join(REPO_DIR, "native")
CSRC_DIR = os.path.join(PKG_DIR, "csrc")


class BuildError(RuntimeError):
    """A compiler was missing or refused a source."""


def build_shared(name: str, cmd: list[str], sources: list[str],
                 libs: tuple[str, ...] = (), headers: tuple[str, ...] = ()) -> tuple[str, str]:
    """Compile `sources` with `cmd` into a shared library; returns (path,
    compiler output).  The output is "" when the library was already built.
    `headers`, the files the sources include, are hashed with them."""
    h = hashlib.sha256(" ".join(cmd + list(libs)).encode())
    for src in list(sources) + list(headers):
        with open(src, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([*cmd, "-o", tmp, *sources, *libs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise BuildError(f"{cmd[0]} failed building {name} "
                             f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, proc.stdout + proc.stderr


def find_tool(name: str, fallback: str | None = None) -> str:
    path = shutil.which(name)
    if path is None and fallback is not None and os.path.exists(fallback):
        path = fallback
    if path is None:
        raise BuildError(f"{name} not found on PATH")
    return path


HOST_SOURCES = ("sais.cpp", "fastq_reader.cpp", "bwt_merge.cpp", "pfp.cpp", "cpu_engine.cpp")


def build_host_library() -> tuple[str, str]:
    """The sources native/Makefile links into librbt_native.so: SA-IS, the
    FASTQ batch reader, the BWT merge walk, PFP and the CPU query engine.
    Where zlib does not link, the same library without the FASTQ reader."""
    cmd = [find_tool("g++"), "-O3", "-std=c++17", "-fPIC", "-shared"]
    srcs = [os.path.join(NATIVE_DIR, s) for s in HOST_SOURCES]
    try:
        return build_shared("librbt_host", cmd, srcs, libs=("-lz",))
    except BuildError:
        return build_shared("librbt_host_nozlib", cmd,
                            [s for s in srcs if not s.endswith("fastq_reader.cpp")])


# nvcc's flags for every kernel library: sm_90a, ptxas's register and spill
# report (-Xptxas -v) in the build's output
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def build_cuda_library(stem: str) -> tuple[str, str]:
    """One hand-written Hopper kernel source, csrc/<stem>.cu, for sm_90a, into
    its own library: each source builds with its own nvcc, so the builds can
    run side by side.  The headers of csrc/ (lf_rank.cuh, which lf.cu and
    seeds.cu include) are part of every library's hash."""
    nvcc = find_tool("nvcc", "/usr/local/cuda/bin/nvcc")
    cmd = [nvcc, *NVCC_FLAGS]
    headers = tuple(os.path.join(CSRC_DIR, f) for f in sorted(os.listdir(CSRC_DIR))
                    if f.endswith(".cuh"))
    return build_shared(f"librbt_{stem}", cmd, [os.path.join(CSRC_DIR, f"{stem}.cu")],
                        headers=headers)
