#!/usr/bin/env python3
"""Smoke run of the rowbowt_tpu_torch count path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the LF kernel K1 (csrc/lf.cu, nvcc for sm_90a) and the host library
(SA-IS + FASTQ reader, g++), then:

  1. device: the card's name and `nvidia-smi` name and power limit;
  2. build: seconds taken by both builds, and nvcc's register report;
  3. parity: on the small synthetic panel (1 Mbp reference + 7 haplotypes,
     n ~ 8.0 M, ftab k = 10), 65,536 reads (with absent codes, reads shorter
     than k and length-0 lanes) through K1 and through `find_ranges_plain` on
     the card, for the 64B and 96B row layouts with the ftab on and off:
     every (lo, hi) equal; 1,000 of them also equal to a host run-space
     search that never reads the row tables;
  4. main path: on the chr panel (20 Mbp reference + 7 haplotypes, 60,000
     variants, n ~ 160 M), the port's `rbt_align` answers 262,144 reads of
     100 bp in 65,536-read batches; its lines are counted and every range
     checked against `find_ranges_plain`; the CLI's own load and query
     seconds and its meter are recorded (reads/s and LF-steps/s over the
     query seconds alone), its stages are timed one by one, and K1 and the
     plain loop over the four batches with CUDA events.

Every phase prints one JSON line.  Any failure raises, so the exit code is
non-zero and the last line is never printed.  The last two lines are the
kernel record and {"ok": true, "device": {...}}.  Needs one CUDA card; exits
non-zero without one.  Uses no network.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, ".cache", "chip_smoke")  # gitignored scratch

# bench.py's synthetic panel configs: same text recipe and seeds
SMALL = dict(ref_len=1_000_000, n_haps=7, n_vars=3_000, seed=1234)
CHR = dict(ref_len=20_000_000, n_haps=7, n_vars=60_000, seed=4321)
FTAB_K = 10
READ_LEN = 100
N_READS = 262_144
BATCH = 65_536
N_HOST = 1_000  # lanes also checked against the host run-space search


def emit(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def panel_text(cfg) -> np.ndarray:
    """bench.py's synthetic pangenome text (reference + haplotypes carrying
    random SNPs), each document followed by 10 SEP bytes, one final TERM."""
    from rowbowt_tpu_torch.alphabet import SEP_BYTE, TERM_BYTE

    rng = np.random.default_rng(cfg["seed"])
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref = rng.choice(acgt, size=cfg["ref_len"])
    var_pos = np.sort(rng.choice(cfg["ref_len"], size=cfg["n_vars"], replace=False))
    var_alt = rng.choice(acgt, size=cfg["n_vars"])
    sep = np.full(10, SEP_BYTE, dtype=np.uint8)
    parts = [ref, sep]
    for _ in range(cfg["n_haps"]):
        hap = ref.copy()
        carry = rng.random(cfg["n_vars"]) < 0.5
        hap[var_pos[carry]] = var_alt[carry]
        parts += [hap, sep]
    parts.append(np.array([TERM_BYTE], dtype=np.uint8))
    return np.concatenate(parts)


def sample_reads(text: np.ndarray, rng, n_reads: int) -> np.ndarray:
    """bench.py's reads: ACGT-only windows of the text, 20% with one substitution."""
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    starts = rng.integers(0, len(text) - READ_LEN - 1, size=n_reads)
    reads = text[starts[:, None] + np.arange(READ_LEN)[None, :]]
    bad = ~np.isin(reads, acgt).all(axis=1)
    for i in np.flatnonzero(bad):
        while True:
            s = int(rng.integers(0, len(text) - READ_LEN - 1))
            r = text[s:s + READ_LEN]
            if np.isin(r, acgt).all():
                reads[i] = r
                break
    mut = rng.random(n_reads) < 0.2
    mpos = rng.integers(0, READ_LEN, size=n_reads)
    mchar = rng.choice(acgt, size=n_reads)
    reads[np.arange(n_reads)[mut], mpos[mut]] = mchar[mut]
    return reads


def edge_lanes(idx, reads: np.ndarray, rng):
    """Right-aligned [B, 128] codes from `reads`, with edge cases mixed in:
    an 'N' (absent from the index: code -1), reads shorter than the ftab k,
    reads of random length, and length-0 lanes."""
    from rowbowt_tpu_torch.engine.batch import encode_batch

    B = reads.shape[0]
    reads = reads.copy()
    kind = rng.random(B)
    lens = np.full(B, READ_LEN)
    with_n = kind < 0.05
    reads[np.flatnonzero(with_n), rng.integers(0, READ_LEN, size=int(with_n.sum()))] = ord("N")
    short = (kind >= 0.05) & (kind < 0.10)
    lens[short] = rng.integers(1, FTAB_K, size=int(short.sum()))
    ragged = (kind >= 0.10) & (kind < 0.20)
    lens[ragged] = rng.integers(FTAB_K, READ_LEN, size=int(ragged.sum()))
    lens[kind >= 0.98] = 0
    seqs = [reads[b, READ_LEN - lens[b]:].tobytes() for b in range(B)]
    qc, qlens = encode_batch(idx, seqs, pad_to=128)
    in_read = np.arange(qc.shape[1])[None, :] >= qc.shape[1] - qlens[:, None]
    counts = {"absent_code": int(((qc < 0) & in_read).any(axis=1).sum()),
              "shorter_than_k": int(((qlens > 0) & (qlens < FTAB_K)).sum()),
              "length_0": int((qlens == 0).sum())}
    return qc, qlens, counts


def host_ranges(idx, qc: np.ndarray, lens: np.ndarray, use_ftab: bool):
    """Batched backward search on the host over the run tables alone
    (engine/naive._lf_range_vec), the ftab start read from idx.ftab."""
    from rowbowt_tpu_torch.engine import naive

    B, L = qc.shape
    lo = np.zeros(B, np.int64)
    hi = np.full(B, idx.n - 1, np.int64)
    startj = np.zeros(B, np.int64)
    k = idx.ftab_k
    if use_ftab and idx.ftab is not None and L >= k > 0:
        base = np.full(idx.A + 1, -1, np.int64)  # code -> 2-bit base; base[-1] = -1
        base[naive.acgt_code_array(idx)] = np.arange(4)
        bases = base[qc[:, L - k:]]
        kmer = (bases * 4 ** np.arange(k - 1, -1, -1)).sum(axis=1)
        hit = (bases >= 0).all(axis=1) & (lens >= k)
        hit[hit] = idx.ftab[kmer[hit], 0] >= 0
        lo[hit], hi[hit], startj[hit] = idx.ftab[kmer[hit], 0], idx.ftab[kmer[hit], 1], k
    done = np.zeros(B, bool)
    for j in range(L):
        c = qc[:, L - 1 - j]
        active = ~done & (j >= startj) & (j < lens)
        nlo, nhi = np.ones(B, np.int64), np.zeros(B, np.int64)
        for code in range(idx.A):
            m = active & (c == code)
            nlo[m], nhi[m] = naive._lf_range_vec(idx, lo[m], hi[m], code)
        lo = np.where(active, nlo, lo)
        hi = np.where(active, nhi, hi)
        done |= active & (nlo > nhi)
    return lo, hi


def cuda_ms(fns, cycles: int) -> float:
    """Mean milliseconds per call of the fns on the card, by CUDA events, over
    `cycles` passes through the list after one warm-up pass."""
    import torch

    for fn in fns:
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(cycles):
        for fn in fns:
            fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (cycles * len(fns))


def max_abs_err(got, want) -> int:
    return max(int((g.long() - w.long()).abs().max().item()) if g.numel() else 0
               for g, w in zip(got, want))


def phase_device() -> dict:
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    emit("device", name=name, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda, numpy=np.__version__)
    return {"name": name, "nvidia_smi": smi}


def phase_build() -> None:
    from rowbowt_tpu_torch.construct import sa
    from rowbowt_tpu_torch.ops import cuda_lf

    t0 = time.perf_counter()
    cuda_lf.build()
    t1 = time.perf_counter()
    check(sa._load_native() is not None, f"host library did not build: {sa._NATIVE_ERROR}")
    t2 = time.perf_counter()
    regs = [ln.strip() for ln in cuda_lf.BUILD_LOG.splitlines()
            if "registers" in ln or "spill" in ln]
    emit("build", nvcc_s=t1 - t0, host_s=t2 - t1, ptxas=regs)


def phase_parity(device, cfg=SMALL, n_lanes=BATCH) -> int:
    """K1 == find_ranges_plain on the card, both layouts, ftab on and off."""
    import torch

    from rowbowt_tpu_torch.construct.build import build_index
    from rowbowt_tpu_torch.engine.count import find_ranges
    from rowbowt_tpu_torch.engine.device import TorchIndex
    from rowbowt_tpu_torch.ops import cuda_lf

    t0 = time.perf_counter()
    text = panel_text(cfg)
    idx = build_index(text, with_sa_samples=False, ftab_k=FTAB_K)
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(cfg["seed"] + 1)
    qc, lens, counts = edge_lanes(idx, sample_reads(text, rng, n_lanes), rng)
    check(all(v > 0 for v in counts.values()), f"edge cases missing: {counts}")
    q, ln = torch.from_numpy(qc).to(device), torch.from_numpy(lens).to(device)
    err = 0
    launches0 = cuda_lf.LAUNCHES
    results = {}
    for fb64 in (True, False):
        tx = TorchIndex.from_index(idx, device, fb64=fb64)
        for use_ftab in (True, False):
            got = find_ranges(tx, q, ln, use_ftab=use_ftab)
            want = cuda_lf.find_ranges_plain(tx, q, ln, use_ftab=use_ftab)
            torch.cuda.synchronize()
            e = max_abs_err(got, want)
            check(e == 0, f"K1 != plain (fb64={fb64}, ftab={use_ftab}): max |err| {e}")
            # a ragged lane count (not a multiple of the 256-thread block)
            # against the host run-space search
            sub = find_ranges(tx, q[:N_HOST], ln[:N_HOST], use_ftab=use_ftab)
            hlo, hhi = host_ranges(idx, qc[:N_HOST], lens[:N_HOST], use_ftab)
            check(np.array_equal(sub[0].cpu().numpy(), hlo)
                  and np.array_equal(sub[1].cpu().numpy(), hhi),
                  f"K1 != host run-space search (fb64={fb64}, ftab={use_ftab})")
            err = max(err, e)
            results[f"fb64={fb64},ftab={use_ftab}"] = int((got[1] >= got[0]).sum().item())
    launches = cuda_lf.LAUNCHES - launches0
    check(launches == 8, f"expected 8 K1 launches, counted {launches}")
    emit("parity", n=idx.n, R=idx.R, build_s=build_s, lanes=n_lanes, edge_cases=counts,
         nonempty=results, host_checked=N_HOST, launches=launches, max_abs_err=err)
    return err


def write_fastq(path: str, reads: np.ndarray) -> None:
    with open(path, "wb") as f:
        for i in range(reads.shape[0]):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, reads[i].tobytes(), b"I" * READ_LEN))


def phase_main(device, card: dict, cfg=CHR) -> dict:
    """The port's rbt_align on the chr index, then K1 vs plain timings."""
    import torch

    from rowbowt_tpu_torch.cli import rbt_align
    from rowbowt_tpu_torch.cli.common import iter_query_batches
    from rowbowt_tpu_torch.construct.build import build_index
    from rowbowt_tpu_torch.engine.count import find_ranges
    from rowbowt_tpu_torch.engine.device import TorchIndex
    from rowbowt_tpu_torch.index import RbtIndex
    from rowbowt_tpu_torch.ops import cuda_lf

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    t0 = time.perf_counter()
    text = panel_text(cfg)
    idx = build_index(text, with_sa_samples=False, ftab_k=FTAB_K)
    build_s = time.perf_counter() - t0
    idx_dir, fq, out_path = (os.path.join(WORK, x) for x in ("idx", "reads.fq", "out.txt"))
    idx.save(idx_dir)
    reads = sample_reads(text, np.random.default_rng(cfg["seed"] + 1), N_READS)
    write_fastq(fq, reads)
    del text, reads
    setup_s = time.perf_counter() - t0

    # the main path: reset the count, run the CLI, read the count
    cuda_lf.LAUNCHES = 0
    err_buf = io.StringIO()
    t1 = time.perf_counter()
    with open(out_path, "w") as out, contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err_buf):
        rc = rbt_align.main([idx_dir, fq, "-b", str(BATCH), "--device", str(device)])
    cli_wall_s = time.perf_counter() - t1
    launches = cuda_lf.LAUNCHES
    sys.stderr.write(err_buf.getvalue())
    check(rc == 0, f"rbt_align exited {rc}")
    # the CLI's own "<load_s> <query_s>" line and its meter line
    err_lines = err_buf.getvalue().splitlines()
    cli_load_s, cli_query_s = (float(x) for x in
                               next(ln for ln in err_lines if ln[:1].isdigit()).split())
    cli_meter = next(ln for ln in err_lines if ln.startswith("meter:"))
    check(launches == N_READS // BATCH, f"K1 launched {launches} times in the main path")
    with open(out_path) as f:
        lines = f.read().splitlines()
    check(len(lines) == N_READS, f"rbt_align printed {len(lines)} lines")

    # the CLI's stages one by one on the same file (host clock; each device
    # stage ends in a synchronize): where the main path's time goes
    stages = {}
    t = time.perf_counter()
    loaded = RbtIndex.load(idx_dir, with_sa=False, with_ma=False, with_dl=False,
                           with_ft=False)
    tx = TorchIndex.from_index(loaded, device)
    torch.cuda.synchronize()
    stages["load_s"] = time.perf_counter() - t
    t = time.perf_counter()
    batches = list(iter_query_batches(loaded, fq, BATCH))
    stages["parse_s"] = time.perf_counter() - t
    t = time.perf_counter()
    dev = [(torch.from_numpy(qc).to(device), torch.from_numpy(lens).to(device))
           for _, qc, lens in batches]
    torch.cuda.synchronize()
    stages["h2d_s"] = time.perf_counter() - t
    t = time.perf_counter()
    ranges = [find_ranges(tx, q, ln) for q, ln in dev]
    torch.cuda.synchronize()
    stages["lf_s"] = time.perf_counter() - t
    t = time.perf_counter()
    host = [(lo.cpu().numpy(), hi.cpu().numpy()) for lo, hi in ranges]
    stages["d2h_s"] = time.perf_counter() - t
    t = time.perf_counter()
    text_out = "".join(
        f"{name} ({s},{e}), count={e - s + 1 if e >= s else 0}\n"
        for (names, _, _), (lo, hi) in zip(batches, host)
        for name, s, e in zip(names, lo.tolist(), hi.tolist()))
    stages["format_s"] = time.perf_counter() - t
    with open(out_path) as f:
        check(f.read() == text_out, "rbt_align output != the staged run's lines")

    # every batch: the CLI's ranges == the plain loop on the card
    plain_out = [cuda_lf.find_ranges_plain(tx, q, ln) for q, ln in dev]
    err = max(max_abs_err((torch.from_numpy(lo), torch.from_numpy(hi)), (plo.cpu(), phi.cpu()))
              for (lo, hi), (plo, phi) in zip(host, plain_out))
    check(err == 0, f"rbt_align ranges != plain loop: max |err| {err}")
    nonempty = sum(int((hi >= lo).sum()) for lo, hi in host)

    # K1 vs the plain loop over the four distinct batches (distinct reads, so
    # the L2 holds only what a real run would reuse), in turns: plain, K1, K1, plain
    n_chars = sum(int(lens.sum()) for _, _, lens in batches)
    k1 = [lambda q=q, ln=ln: find_ranges(tx, q, ln) for q, ln in dev]
    plain = [lambda q=q, ln=ln: cuda_lf.find_ranges_plain(tx, q, ln) for q, ln in dev]
    plain_ms = cuda_ms(plain, 1)
    k1_ms = (cuda_ms(k1, 5) + cuda_ms(k1, 5)) / 2
    plain_ms = (plain_ms + cuda_ms(plain, 1)) / 2
    tx96 = TorchIndex.from_index(loaded, device, fb64=False)
    k1_fb96_ms = cuda_ms([lambda q=q, ln=ln: find_ranges(tx96, q, ln) for q, ln in dev], 5)
    txf = TorchIndex.from_index(idx, device)  # with the ftab start
    k1_ftab_ms = cuda_ms([lambda q=q, ln=ln: find_ranges(txf, q, ln) for q, ln in dev], 5)
    per_batch = n_chars / len(dev)
    res = dict(n=idx.n, R=idx.R, ref_len=cfg["ref_len"], build_s=build_s, setup_s=setup_s,
               reads=N_READS, batch=BATCH, cli_load_s=cli_load_s, cli_query_s=cli_query_s,
               cli_reads_per_s=N_READS / cli_query_s,
               cli_lf_steps_per_s=n_chars / cli_query_s, cli_meter=cli_meter,
               cli_wall_s=cli_wall_s, cli_reads_per_s_with_load=N_READS / cli_wall_s,
               launches=launches, max_abs_err=err, nonempty=nonempty, stages=stages,
               table_mb=tx.arrays["fblock64"].numel() * 4 / 1e6,
               k1_ms=k1_ms, plain_ms=plain_ms, k1_fb96_ms=k1_fb96_ms, k1_ftab_ms=k1_ftab_ms,
               k1_reads_per_s=BATCH / (k1_ms / 1e3),
               k1_lf_steps_per_s=per_batch / (k1_ms / 1e3),
               plain_reads_per_s=BATCH / (plain_ms / 1e3),
               plain_lf_steps_per_s=per_batch / (plain_ms / 1e3),
               card=card["nvidia_smi"])
    emit("main", **res)
    shutil.rmtree(WORK, ignore_errors=True)
    return res


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "rowbowt_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = phase_device()
    phase_build()
    par_err = phase_parity(device)
    res = phase_main(device, card)
    print(json.dumps({"kernels": [{
        "name": "lf_count", "route": "cuda", "source": "rowbowt_tpu_torch/csrc/lf.cu",
        "replaces": "rowbowt_tpu/ops/pallas_lf.py:49", "launches": res["launches"],
        "max_abs_err": max(par_err, res["max_abs_err"]), "ms": res["k1_ms"],
        "plain_ms": res["plain_ms"]}]}))
    print(card["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
