"""The port's rbt_align prints what the JAX package's rbt_align prints, byte
for byte, on an index saved from in-repo text and a FASTQ written here."""

import json

import numpy as np
import pytest
import torch

from rowbowt_tpu_torch.alphabet import SEP_BYTE, TERM_BYTE
from rowbowt_tpu_torch.cli import common
from rowbowt_tpu_torch.cli import rbt_align
from rowbowt_tpu_torch.construct.build import build_index
from rowbowt_tpu_torch.construct.panel import Marker

ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(scope="module")
def align_inputs(tmp_path_factory):
    """A 3-document panel (reference + 2 haplotypes with SNPs, a marker at
    every site of every document), saved with an ftab of k = 6, and 23
    reads: substrings, substitutions, an 'N' base, a 2-base read (hundreds
    of hits and markers), a random read, and one longer than 32 bases.  Also
    the same text saved without markers and the document list, and without
    SA samples."""
    rng = np.random.default_rng(21)
    ref = rng.choice(ACGT, size=1500)
    sep = np.full(10, SEP_BYTE, np.uint8)
    docs = [ref]
    sites = []
    for _ in range(2):
        hap = ref.copy()
        s = rng.choice(1500, size=30, replace=False)
        hap[s] = rng.choice(ACGT, size=30)
        docs.append(hap)
        sites.append(s)
    sites = np.unique(np.concatenate(sites))
    text = np.concatenate([x for d in docs for x in (d, sep)] + [np.array([TERM_BYTE], np.uint8)])
    doc_starts = np.array([0, 1510, 3020])
    markers = [Marker(text_pos=int(doc_starts[d] + p), seq=0, pos=int(p),
                      allele=int(docs[d][p] != ref[p]))
               for d in range(3) for p in sites]
    d = tmp_path_factory.mktemp("torch_cli")
    dirs = {name: str(d / name) for name in ("idx", "bare", "no_sa")}
    build_index(text, markers=markers, doc_starts=doc_starts, doc_names=["ref", "h0", "h1"],
                ftab_k=6).save(dirs["idx"])
    build_index(text).save(dirs["bare"])
    build_index(text, with_sa_samples=False).save(dirs["no_sa"])
    reads = []
    for q in range(20):
        L = int(rng.integers(12, 60))
        p = int(rng.integers(0, 1500 - L))
        r = docs[q % 3][p:p + L].copy()
        if q % 4 == 1:
            r[rng.integers(0, L)] = rng.choice(ACGT)
        reads.append(r.tobytes())
    reads[3] = reads[3][:7] + b"N" + reads[3][8:]
    reads += [ref[100:102].tobytes(), rng.choice(ACGT, size=25).tobytes(),
              ref[200:270].tobytes()]
    fq = str(d / "reads.fq")
    with open(fq, "wb") as f:
        for q, r in enumerate(reads):
            f.write(b"@read%d extra\n%s\n+\n%s\n" % (q, r, b"I" * len(r)))
    return dirs, fq, len(reads)


def _both(capsys, argv):
    """(JAX CLI's rc, stdout, stderr), (the port's rc, stdout, stderr) for argv."""
    from rowbowt_tpu.cli import rbt_align as jax_rbt_align

    runs = []
    for fn, extra in ((jax_rbt_align.main, []), (rbt_align.main, ["--device", "cpu"])):
        rc = fn([*argv, *extra])
        got = capsys.readouterr()
        runs.append((rc, got.out, got.err))
    return runs


@pytest.mark.parametrize("batch", [None, 4])
def test_rbt_align_matches_jax(align_inputs, capsys, batch):
    from rowbowt_tpu.cli import rbt_align as jax_rbt_align

    dirs, fq, n_reads = align_inputs
    idx_dir = dirs["idx"]
    extra = [] if batch is None else ["-b", str(batch)]
    assert jax_rbt_align.main([idx_dir, fq, *extra]) == 0
    want = capsys.readouterr().out
    assert rbt_align.main([idx_dir, fq, "--device", "cpu", *extra]) == 0
    got = capsys.readouterr()
    assert got.out == want
    lines = want.splitlines()
    assert len(lines) == n_reads and lines[0].startswith("read0 (")
    assert "(1,0), count=0" in want and any(not l.endswith("count=0") for l in lines)
    assert "reads/s" in got.err


def test_native_reader_matches_python_reader(align_inputs):
    dirs, fq, _ = align_inputs
    idx = common.load_index(dirs["idx"])
    native = list(common.iter_query_batches(idx, fq, 8, use_native=True))
    plain = list(common.iter_query_batches(idx, fq, 8, use_native=False))
    assert len(native) == len(plain) == 3
    for (n1, q1, l1), (n2, q2, l2) in zip(native, plain):
        assert n1 == n2
        np.testing.assert_array_equal(q1, q2)
        np.testing.assert_array_equal(l1, l2)


def test_device_cuda_raises_without_cuda(align_inputs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    dirs, fq, _ = align_inputs
    with pytest.raises(RuntimeError, match="cuda"):
        rbt_align.main([dirs["idx"], fq])  # --device defaults to cuda


@pytest.mark.parametrize("batch", [None, 4])
@pytest.mark.parametrize("flags", [["-s"], ["-m"], ["-s", "-m"], ["-s", "--max-hits", "2"]],
                         ids=["s", "m", "s_m", "s_max_hits_2"])
def test_locate_and_markers_match_jax(align_inputs, capsys, flags, batch):
    """-s / -m lines byte-identical to the JAX CLI, with (-b 4: the last
    batch carries a pad lane) and without pad lanes in a batch."""
    dirs, fq, n_reads = align_inputs
    extra = [] if batch is None else ["-b", str(batch)]
    (jrc, want, _), (rc, got, err) = _both(capsys, [dirs["idx"], fq, *flags, *extra])
    assert jrc == rc == 0
    assert got == want
    lines = want.splitlines()
    assert len(lines) == n_reads * (1 + ("-s" in flags) + ("-m" in flags))
    if "-s" in flags:
        locs = [l for l in lines if l.startswith("\tlocs: ")]
        assert len(locs) == n_reads and any("/h1:" in l for l in locs)
        widest = max(len(l.split()) - 1 for l in locs)
        assert widest == 2 if "--max-hits" in flags else widest > 64
    if "-m" in flags:
        marks = [l for l in lines if l.startswith("\tmarkers: ")]
        assert any("no markers" in l for l in marks)
        assert max(len(l.split()) - 1 for l in marks) > 64  # the re-probe ran
    assert "reads/s" in err


def test_locate_and_markers_see_real_lanes_only(align_inputs, capsys, monkeypatch):
    """-b 24 over 23 reads: one batch of 24 lanes, one of them padding.
    Locate and markers get the 23 real lanes and never the pad lane."""
    dirs, fq, n_reads = align_inputs
    seen = {"locate": [], "markers": []}

    def record(name, fn):
        def wrapped(tx, lo, hi, *a, **kw):
            seen[name].append(lo.shape[0])
            return fn(tx, lo, hi, *a, **kw)
        return wrapped

    monkeypatch.setattr(rbt_align, "locate_ragged", record("locate", rbt_align.locate_ragged))
    monkeypatch.setattr(rbt_align, "markers_for_ranges",
                        record("markers", rbt_align.markers_for_ranges))
    assert rbt_align.main([dirs["idx"], fq, "-s", "-m", "-b", "24", "--device", "cpu"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 3 * n_reads
    assert seen["locate"] == [n_reads]
    assert seen["markers"] and set(seen["markers"]) == {n_reads}


@pytest.mark.parametrize("flag,index,message", [
    ("-m", "bare", "error: index has no marker array"),
    ("-s", "no_sa", "error: index has no toehold SA"),
])
def test_missing_component_exits_1(align_inputs, capsys, flag, index, message):
    dirs, fq, _ = align_inputs
    (jrc, jout, jerr), (rc, out, err) = _both(capsys, [dirs[index], fq, flag])
    assert jrc == rc == 1
    assert jout == out == ""
    want = [l for l in jerr.splitlines() if l.startswith("error:")]
    assert want and want[0].startswith(message)
    assert [l for l in err.splitlines() if l.startswith("error:")] == want


def test_locate_without_doc_list_matches_jax(align_inputs, capsys):
    """An index without a document list prints raw positions with doc '?'."""
    dirs, fq, n_reads = align_inputs
    (jrc, want, _), (rc, got, _) = _both(capsys, [dirs["bare"], fq, "-s", "-b", "8"])
    assert jrc == rc == 0
    assert got == want
    assert len(want.splitlines()) == 2 * n_reads and "/?:" in want


@pytest.mark.parametrize("flags", [["-x"], ["-o", "OUT"], ["-x", "-s", "-m"],
                                   ["-o", "OUT", "-s", "-m"]],
                         ids=["x", "o", "x_s_m", "o_s_m"])
def test_reference_flags_match_jax(align_inputs, capsys, tmp_path, flags):
    """-x and -o are accepted and unused, as in the JAX CLI."""
    dirs, fq, n_reads = align_inputs
    flags = [str(tmp_path / "out") if f == "OUT" else f for f in flags]
    (jrc, want, _), (rc, got, _) = _both(capsys, [dirs["idx"], fq, *flags])
    assert jrc == rc == 0
    assert got == want
    assert len(want.splitlines()) == n_reads * (3 if "-s" in flags else 1)


def _traces(trace_dir):
    return sorted(trace_dir.glob("*.pt.trace.json"))


def test_profile_writes_a_trace_and_keeps_stdout(align_inputs, capsys, tmp_path):
    dirs, fq, _ = align_inputs
    argv = [dirs["idx"], fq, "-s", "-m", "--device", "cpu"]
    assert rbt_align.main(argv) == 0
    want = capsys.readouterr().out
    trace_dir = tmp_path / "trace"
    assert rbt_align.main([*argv, "--profile", str(trace_dir)]) == 0
    got = capsys.readouterr()
    assert got.out == want
    assert f"profiler trace written to {trace_dir}" in got.err.splitlines()
    (trace,) = _traces(trace_dir)
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_profile_flushes_when_the_loop_raises(align_inputs, tmp_path, monkeypatch):
    def failing_loop(*args):
        torch.arange(4).sum()
        raise RuntimeError("query loop failed")

    monkeypatch.setattr(rbt_align, "_query_loop", failing_loop)
    dirs, fq, _ = align_inputs
    trace_dir = tmp_path / "trace"
    with pytest.raises(RuntimeError, match="query loop failed"):
        rbt_align.main([dirs["idx"], fq, "--device", "cpu", "--profile", str(trace_dir)])
    (trace,) = _traces(trace_dir)
    assert trace.stat().st_size > 0


@pytest.fixture(scope="module")
def big_dir(align_inputs, tmp_path_factory):
    """The panel's index as a BigIndex directory written by the JAX package."""
    from test_torch_seeds import save_jax_big

    return save_jax_big(align_inputs[0]["idx"], str(tmp_path_factory.mktemp("big") / "big"))


def test_big_artifact_not_ported(big_dir, capsys):
    """A BigIndex directory loads as the port's BigIndex, with the JAX CLI's
    stderr lines (and its note that big artifacts carry no ftab)."""
    from rowbowt_tpu_torch.bigindex import BigIndex

    big = common.load_index(big_dir, sa=True, ma=True, dl=True, ft=True)
    assert isinstance(big, BigIndex) and big.has_locate and big.has_markers
    assert capsys.readouterr().err.splitlines() == [
        f"loading (big two-level artifact): {big_dir}",
        "note: big artifacts carry no ftab; running without it"]
    for sa, ma in ((False, False), (True, False), (False, True)):
        tx = common.device_index(big, "cpu", sa=sa, ma=ma)
        assert tx.idx_dtype == torch.int64 and "pl2_64" in tx.arrays
        assert ("cruns_keys" in tx.arrays) == sa and ("ma_val" in tx.arrays) == ma


@pytest.mark.parametrize("flags", [[], ["-s"], ["-m"], ["-s", "-m", "-b", "4"]],
                         ids=["count", "s", "m", "s_m_b4"])
def test_rbt_align_on_big_dir_matches_jax(align_inputs, big_dir, capsys, flags):
    """On a BigIndex directory saved by the JAX package the port prints the
    JAX CLI's lines, and the lines it prints on the same index saved whole."""
    dirs, fq, n_reads = align_inputs
    (jrc, want, _), (rc, got, err) = _both(capsys, [big_dir, fq, *flags])
    assert jrc == rc == 0 and got == want
    assert err.startswith(f"loading (big two-level artifact): {big_dir}\n")
    assert rbt_align.main([dirs["idx"], fq, "--device", "cpu", *flags]) == 0
    assert capsys.readouterr().out == got
    assert len(got.splitlines()) == n_reads * (1 + ("-s" in flags) + ("-m" in flags))


def test_torch_console_scripts_resolve():
    """Every `*_torch` console script of pyproject.toml names a callable
    `main` of the port, one for each port CLI; the JAX package's entries
    and the dependencies stay as they were."""
    import importlib
    import os
    import tomllib

    with open(os.path.join(os.path.dirname(__file__), "..", "pyproject.toml"), "rb") as f:
        project = tomllib.load(f)["project"]
    scripts = project["scripts"]
    torch_scripts = {k: v for k, v in scripts.items() if k.endswith("_torch")}
    assert set(torch_scripts) == {"rbt_build_torch", "rbt_align_torch", "rbt_markers_torch",
                                  "rbt_locs_torch", "rbt_midx_torch"}
    for name, target in torch_scripts.items():
        module, func = target.split(":")
        assert module == f"rowbowt_tpu_torch.cli.{name[:-len('_torch')]}" and func == "main"
        assert callable(getattr(importlib.import_module(module), func)), name
    assert {k: scripts[k] for k in ("rbt_build", "rbt_align", "rbt_markers", "rbt_locs",
                                    "rbt_midx")} == {
        k: f"rowbowt_tpu.cli.{k}:main" for k in ("rbt_build", "rbt_align", "rbt_markers",
                                                 "rbt_locs", "rbt_midx")}
    assert project["dependencies"] == ["numpy", "jax"]
