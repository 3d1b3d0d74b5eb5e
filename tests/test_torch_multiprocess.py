"""The port's config-5 deployment script (python -m rowbowt_tpu_torch.tools.
sharded_stream) as real process groups on the CPU: two processes (gloo over
localhost, --device cpu), each streaming its own FASTQ shard over the
position-sharded index (--n-idx 2), each writing its own reads' lines in
its own input order.

Count lines == the port's rbt_align on that process's reads; -m lines (the
window markers of the JAX script) == the JAX engine's find_ranges_w_markers
on those reads, formatted as the script formats them; --greedy lines == a
1-process run's and the JAX engine's markers_greedy_seeding.  The same on a
two-level BigIndex directory (n_sup = 2).  Processes that stream different
numbers of batches, or different batch sizes, raise on every rank with the
sizes named, well inside the test's timeout; a BigIndex packed for another
n_idx is refused.  Every process runs under its own timeout."""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from rowbowt_tpu.engine.batch import encode_batch
from rowbowt_tpu.engine.device import DeviceIndex
from rowbowt_tpu.engine.markers import find_ranges_w_markers as j_markers
from rowbowt_tpu.engine.seeds import markers_greedy_seeding as j_greedy
from rowbowt_tpu.index import marker_allele, marker_pos
from rowbowt_tpu_torch.parallel.multihost import host_store

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACGT = np.frombuffer(b"ACGT", np.uint8)


def _env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


def write_fastq(path, names, reads):
    with open(path, "w") as f:
        for name, r in zip(names, reads):
            f.write(f"@{name}\n{r.decode()}\n+\n{'I' * len(r)}\n")


def stream(pre, fastqs, *flags, batch=4, n_idx=2, timeout=180):
    """sharded_stream as one process per FASTQ (a process group over
    localhost when there are several): (return codes, stdouts, stderrs).
    Each process writes to files of its own: a pipe left unread would stall
    it, and its peers with it, at their next collective.  This process
    hosts the group's store (host_store), so that no concurrent test can
    take its port before the processes join it."""
    n = len(fastqs)
    store = host_store() if n > 1 else None
    group = (["--coordinator", f"localhost:{store.port}", "--num-processes", str(n),
              "--hosted-coordinator"] if n > 1 else [])
    procs, files = [], []
    try:
        for pid, fq in enumerate(fastqs):
            b = batch[pid] if isinstance(batch, tuple) else batch
            files.append((tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "rowbowt_tpu_torch.tools.sharded_stream", pre, fq,
                 "--n-idx", str(n_idx), "-b", str(b), "--device", "cpu", *flags, *group,
                 *(["--process-id", str(pid)] if n > 1 else [])],
                cwd=REPO, env=_env(), stdout=files[-1][0], stderr=files[-1][1], text=True))
        for p in procs:
            p.wait(timeout=timeout)
        outs = []
        for out, err in files:
            out.seek(0)
            err.seek(0)
            outs.append((out.read(), err.read()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in files:
            out.close()
            err.close()
    return [p.returncode for p in procs], [o for o, _ in outs], [e for _, e in outs]


@pytest.fixture(scope="module")
def shards(rand_index, tmp_path_factory):
    """The JAX-saved index, its BigIndex directory (n_sup = 2, the index's
    marker CSR) and two FASTQ shards of 10 reads (20-59 bases, every second
    with one substitution): (dir, index prefix, big dir, [(names, reads,
    fastq)] per shard)."""
    from rowbowt_tpu.bigindex import BigIndex

    idx, text = rand_index
    d = tmp_path_factory.mktemp("stream")
    pre = str(d / "idx")
    idx.save(pre)
    codes = np.repeat(idx.run_head.astype(np.uint8), np.diff(np.append(idx.run_start, idx.n)))
    big = BigIndex.from_codes(codes, idx.alpha, n_sup=2)
    big.attach_locate(codes, np.asarray(idx.kval).astype(np.uint32))
    big.ma_row = np.asarray(idx.ma_row).astype(np.uint32)
    big.ma_val = np.asarray(idx.ma_val)
    big.ma_wsize = idx.ma_wsize
    big.save(str(d / "big"))
    rng = np.random.default_rng(61)
    out = []
    for s in range(2):
        names, reads = [], []
        while len(reads) < 10:
            L = int(rng.integers(20, 60))
            p = int(rng.integers(0, len(text) - L))
            r = np.array(text[p:p + L])
            if len(reads) % 2:
                r[int(rng.integers(0, L))] = ACGT[int(rng.integers(0, 4))]
            if np.isin(r, ACGT).all():
                names.append(f"s{s}r{len(reads)}")
                reads.append(bytes(r))
        fq = str(d / f"shard{s}.fq")
        write_fastq(fq, names, reads)
        out.append((names, reads, fq))
    return d, pre, str(d / "big"), out


def rbt_align_lines(pre, fq):
    r = subprocess.run([sys.executable, "-m", "rowbowt_tpu_torch.cli.rbt_align", pre, fq,
                        "--device", "cpu"], cwd=REPO, env=_env(), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


def expected_marker_lines(idx, names, reads):
    """The script's -m lines from the JAX window-marker engine."""
    qc, lens = encode_batch(idx, reads)
    lo, hi, buf, used, _ = map(np.asarray, j_markers(DeviceIndex.from_index(idx), qc, lens,
                                                    wsize=idx.ma_wsize, max_k=32))
    lines = []
    for b, name in enumerate(names):
        s, e = int(lo[b]), int(hi[b])
        lines.append(f"{name} ({s},{e}), count={e - s + 1 if e >= s else 0}\n")
        got = buf[b, buf.shape[1] - int(used[b]):]
        lines.append("\tmarkers: " + "".join(f"{int(marker_pos(np.int64(v)))}/"
                                             f"{int(marker_allele(np.int64(v)))} "
                                             for v in got) + "\n")
    return "".join(lines)


def expected_greedy_lines(idx, names, reads):
    """The script's --greedy lines from the JAX greedy engine (fwd, revcomp
    lanes interleaved; 8 seeds, 16 markers each)."""
    tab = idx.alpha.encode_table()
    comp = np.full(16, -1, dtype=np.int64)
    for x, y in zip(b"ACGT", b"TGCA"):
        comp[int(tab[x])] = int(tab[y])
    lanes = []
    for r in reads:
        fwd = tab[np.frombuffer(r, np.uint8).astype(np.int64)]
        lanes += [fwd, comp[fwd[::-1]]]
    L = max(len(x) for x in lanes)
    qc = np.full((len(lanes), L), -1, np.int32)
    for b, x in enumerate(lanes):
        qc[b, L - len(x):] = x
    lens = np.array([len(x) for x in lanes], np.int32)
    res = j_greedy(DeviceIndex.from_index(idx), qc, lens, wsize=idx.ma_wsize, max_range=1000,
                   use_ftab=False)
    mvals, mcnt, ns = (np.asarray(v) for v in res[4:])
    lines = []
    for b, name in enumerate(names):
        for strand, lane in (("+", 2 * b), ("-", 2 * b + 1)):
            got = []
            for s_ in range(mvals.shape[1]):
                k = min(int(mcnt[lane, s_]), mvals.shape[2])
                got += [int(v) for v in mvals[lane, s_, :k] if v >= 0]
            lines.append(f"{name} {strand} seeds={int(ns[lane])} markers: " + "".join(
                f"{int(marker_pos(np.int64(v)))}/{int(marker_allele(np.int64(v)))} "
                for v in got) + "\n")
    return "".join(lines)


def test_two_process_stream_count(shards):
    _, pre, _, sh = shards
    rcs, outs, errs = stream(pre, [fq for _, _, fq in sh])
    assert rcs == [0, 0], errs
    for pid, (_, _, fq) in enumerate(sh):
        assert outs[pid] == rbt_align_lines(pre, fq), pid


@pytest.mark.parametrize("layout", ["dense", "big"])
def test_two_process_stream_markers(rand_index, shards, layout):
    """-m over the dense index and over its BigIndex directory (the same
    marker CSR): the JAX engine's window markers, and the count lines of
    each process's reads."""
    idx, _ = rand_index
    _, pre, big, sh = shards
    rcs, outs, errs = stream(pre if layout == "dense" else big, [fq for _, _, fq in sh], "-m",
                             "--wsize", str(idx.ma_wsize))
    assert rcs == [0, 0], errs
    for pid, (names, reads, fq) in enumerate(sh):
        assert outs[pid] == expected_marker_lines(idx, names, reads), pid
        assert outs[pid].splitlines(keepends=True)[0::2] == \
            rbt_align_lines(pre, fq).splitlines(keepends=True)


def test_two_process_stream_greedy(rand_index, shards):
    """--greedy: each process's lines == a 1-process run of its shard (no
    group, the index whole) == the JAX greedy engine's."""
    idx, _ = rand_index
    _, pre, _, sh = shards
    flags = ("--greedy", "--wsize", str(idx.ma_wsize), "--max-range", "1000")
    rcs, outs, errs = stream(pre, [fq for _, _, fq in sh], *flags)
    assert rcs == [0, 0], errs
    for pid, (names, reads, fq) in enumerate(sh):
        rc1, out1, err1 = stream(pre, [fq], *flags, n_idx=1)
        assert rc1 == [0], err1
        assert outs[pid] == out1[0] == expected_greedy_lines(idx, names, reads), pid


@pytest.mark.parametrize("kind", ["batches", "batch_size"])
def test_stream_mismatch_raises(shards, tmp_path, kind):
    """A process that runs out of reads a batch early (3 reads against 9 at
    -b 4), or one with another -b, makes every rank raise with the sizes
    named, not hang."""
    _, pre, _, sh = shards
    names, reads, fq = sh[1]
    if kind == "batches":
        short = str(tmp_path / "short.fq")
        write_fastq(short, names[:3], reads[:3])
        rcs, _, errs = stream(pre, [short, fq], timeout=120)
        msg = "ran out of reads at batch 1"
    else:
        rcs, _, errs = stream(pre, [fq, fq], batch=(4, 8), timeout=120)
        msg = "has [4, 8] lanes by rank"
    assert all(rc != 0 for rc in rcs), rcs
    assert all(msg in e for e in errs), [e[-1500:] for e in errs]


def test_stream_big_refuses_other_n_idx(shards):
    """A BigIndex's superblocks are its shards: --n-idx must be n_sup."""
    _, _, big, sh = shards
    rcs, _, errs = stream(big, [sh[0][2]], n_idx=1)
    assert rcs == [1] and "packed for n_idx == 2" in errs[0], errs
