"""rbt_build_torch (rowbowt_tpu_torch.cli.rbt_build) against the JAX package's
rbt_build on the same FASTA/VCF, raw and serialized inputs, in every mode:
equal saved indexes, equal `.midx.npz`, byte-identical `.ftab` and
`--emit-ref` files and the same stderr lines.  Then the port's query CLIs on
every kind of index rbt_build_torch writes (--no-dense, raw with occ1 + tk1
and with ltk, serialized, an alphabet of 13 codes, -x) print the JAX CLIs'
lines byte for byte."""

import contextlib
import io
import os
import re
import shutil

import numpy as np
import pytest

from rowbowt_tpu.cli import rbt_build as jax_rbt_build
from rowbowt_tpu.construct import rawio as JRAW
from rowbowt_tpu_torch.cli import rbt_build
from rowbowt_tpu_torch.construct import rawio as TRAW
from rowbowt_tpu_torch.construct.sdslwrite import write_mab
from rowbowt_tpu_torch.index import RbtIndex
from test_torch_build import assert_index_equal, write_inputs

TOOLS = ("port", "jax")


def _mask(err: str, d: str) -> str:
    """stderr with the seconds and the package's output directory masked."""
    err = re.sub(r"\d+\.\d+s\b", "<s>", err)
    return err.replace(os.path.join(d, "port"), "<out>").replace(os.path.join(d, "jax"), "<out>")


@pytest.fixture(scope="module")
def all_built(tmp_path_factory):
    """Every mode built by both CLIs, their stderr lines held equal: {mode:
    (the port's index dir, its stderr)}, and under "inputs" (the input paths,
    the work directory)."""
    d = str(tmp_path_factory.mktemp("torch_build_cli"))
    inp = write_inputs(d)
    iu_dir = os.path.join(d, "iupac")
    os.makedirs(iu_dir)
    iu = write_inputs(iu_dir, seed=8, iupac=True)
    for t in TOOLS:
        os.makedirs(os.path.join(d, t))
    native = ["--fasta", inp["fa"], "--vcf", inp["vcf"]]
    out = {"inputs": (inp, d)}

    def run(mode, argv_of, patch_occ1=False):
        errs = {}
        for t, main in (("port", rbt_build.main), ("jax", jax_rbt_build.main)):
            saved = (TRAW.OCC1_MAX_N, JRAW.OCC1_MAX_N)
            if patch_occ1:
                TRAW.OCC1_MAX_N = JRAW.OCC1_MAX_N = 1000
            err = io.StringIO()
            try:
                with contextlib.redirect_stderr(err):
                    assert main(argv_of(os.path.join(d, t, mode))) == 0
            finally:
                TRAW.OCC1_MAX_N, JRAW.OCC1_MAX_N = saved
            errs[t] = _mask(err.getvalue(), d)
        assert errs["port"] == errs["jax"], mode
        out[mode] = (os.path.join(d, "port", mode), errs["port"])

    run("native", lambda o: [*native, "-s", "-m", "-l", "-f", "-k", "6", "-o", o,
                             "--emit-ref", o + "_ref"])
    run("native_x", lambda o: [*native, "-x", "-s", "-m", "-l", "-o", o])
    run("no_dense", lambda o: [*native, "--no-dense", "-s", "-m", "-l", "-o", o])
    run("samples", lambda o: [*native, "--samples", "s0,s2", "--wsize", "7", "-s", "-m",
                              "-o", o])
    run("iupac", lambda o: ["--fasta", iu["fa"], "--vcf", iu["vcf"], "-s", "-m", "-l", "-o", o])
    # raw prefix: the native index's .bwt/.ssa/.esa/.docs/.mab
    idx = RbtIndex.load(os.path.join(d, "port", "native"))
    prefix = os.path.join(d, "raw")
    TRAW.write_raw(idx, prefix)
    write_mab(prefix + ".mab", idx.ma_row, idx.ma_val, idx.ma_wsize, idx.n)
    run("raw", lambda o: [prefix, "-s", "-m", "-l", "-f", "-k", "6", "-o", o])
    run("raw_ltk", lambda o: [prefix, "-s", "-m", "-l", "-o", o], patch_occ1=True)
    run("raw_bwt", lambda o: [prefix, "-o", o])
    # serialized: the port's --emit-ref files of the native index
    ser = os.path.join(d, "port", "native_ref")
    run("serialized", lambda o: [ser, "-s", "-m", "-l", "-o", o])
    for t in TOOLS:
        shutil.copytree(os.path.join(d, t, "native"), os.path.join(d, t, "ftab_only"))
    run("ftab_only", lambda o: ["--ftab-only", "-k", "4", "-o", o])
    # rbt_locs reads <idx>.midx.npz: the native build's serves every index of
    # the same panel
    for mode in ("raw", "raw_ltk", "no_dense", "serialized"):
        shutil.copy(os.path.join(d, "port", "native.midx.npz"),
                    os.path.join(d, "port", mode + ".midx.npz"))
    return out


MODES = ["native", "native_x", "no_dense", "samples", "iupac", "raw", "raw_ltk", "raw_bwt",
         "serialized", "ftab_only"]


@pytest.mark.parametrize("mode", MODES)
def test_rbt_build_matches_jax(all_built, mode):
    """The saved index of each mode equals the JAX CLI's, array for array, in
    either package's loader; the stderr lines were held equal when built."""
    from rowbowt_tpu.index import RbtIndex as JaxRbtIndex

    port_dir, err = all_built[mode]
    d = all_built["inputs"][1]
    jax_dir = os.path.join(d, "jax", mode)
    assert_index_equal(RbtIndex.load(port_dir), RbtIndex.load(jax_dir))
    assert_index_equal(JaxRbtIndex.load(port_dir), RbtIndex.load(jax_dir))
    idx = RbtIndex.load(port_dir)
    expect = {
        "native": dict(fblock=True, kval=True, ma_row=True, ftab=True, occ1=False),
        "native_x": dict(fblock=True, kval=False, samples_last=False, ma_row=True),
        "no_dense": dict(fblock=False, kval=False, samples_last=True, ma_start1=False),
        "iupac": dict(fblock=False, bwt4=True, kval=True),
        "raw": dict(fblock=True, kval=False, occ1=True, tk1=True, phi1=True, ftab=True),
        "raw_ltk": dict(fblock=True, kval=False, occ1=False, ltk=True, phi1=True),
        "raw_bwt": dict(samples_last=False, ma_row=False, doc_starts=False),
        "serialized": dict(fblock=True, occ1=True, tk1=True, ma_row=True),
        "ftab_only": dict(ftab=True),
    }.get(mode, {})
    for name, present in expect.items():
        assert (getattr(idx, name) is not None) == present, (mode, name)
    if mode == "ftab_only":
        assert idx.ftab_k == 4 and "ftab rebuilt" in err
    if mode == "native_x":
        assert "Warning: fbb backend does not support the toehold suffix array" in err


@pytest.mark.parametrize("mode", ["native", "samples", "iupac"])
def test_rbt_build_side_files_match_jax(all_built, mode):
    """-m's `.midx.npz`, -f's `.ftab` text and --emit-ref's files."""
    d = all_built["inputs"][1]
    port, jax = os.path.join(d, "port", mode), os.path.join(d, "jax", mode)
    a, b = np.load(port + ".midx.npz"), np.load(jax + ".midx.npz")
    assert a.files == b.files
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    suffixes = [".ftab", "_ref.rbwt", "_ref.tsa", "_ref.mab", "_ref.docs"] \
        if mode == "native" else []
    for s in suffixes:
        with open(port + s, "rb") as f, open(jax + s, "rb") as g:
            assert f.read() == g.read(), s
    assert os.path.exists(port + ".ftab") == (mode == "native")


def _query(capsys, tool, argv):
    """[(rc, stdout, stderr's first line)] of the JAX CLI, then the port's."""
    import importlib

    runs = []
    for pkg, extra in (("rowbowt_tpu", []), ("rowbowt_tpu_torch", ["--device", "cpu"])):
        main = importlib.import_module(f"{pkg}.cli.{tool}").main
        rc = main([*argv, *extra])
        got = capsys.readouterr()
        runs.append((rc, got.out, got.err.splitlines()[:1]))
    return runs


QUERY_INDEXES = ["no_dense", "raw", "raw_ltk", "serialized", "iupac", "native_x"]


@pytest.mark.parametrize("flags", [[], ["-s"], ["-m"], ["-s", "-m"]],
                         ids=["count", "locate", "markers", "both"])
@pytest.mark.parametrize("mode", QUERY_INDEXES)
def test_rbt_align_lines_match_jax(all_built, capsys, mode, flags):
    """count, -s and -m on every index kind: the JAX CLI's lines (an index
    built with -x refuses -s in both)."""
    inp = all_built["inputs"][0]
    fq = inp["fq"] if mode != "iupac" else os.path.join(all_built["inputs"][1], "iupac",
                                                         "reads.fq")
    (jrc, jout, jerr), (rc, out, err) = _query(
        capsys, "rbt_align", [all_built[mode][0], fq, "-b", "16", *flags])
    assert (rc, out) == (jrc, jout)
    if mode == "native_x" and "-s" in flags:
        assert rc == 1 and out == ""
    else:
        assert rc == 0 and out.count("count=") == 40
        if "-m" in flags:
            assert "\tmarkers: " in out and re.search(r"markers: \d+/\d", out)
        if "-s" in flags:
            assert re.search(r"locs: \d+/chr", out)


@pytest.mark.parametrize("mode,tool,flags", [
    ("no_dense", "rbt_markers", ["-w", "10"]),
    ("raw", "rbt_markers", ["-f", "-w", "10"]),
    ("raw_ltk", "rbt_markers", ["-w", "10"]),
    ("no_dense", "rbt_locs", ["-w", "12"]),
    ("raw", "rbt_locs", ["-w", "12"]),
    ("raw_ltk", "rbt_locs", ["-w", "12"]),
], ids=["markers_no_dense", "markers_raw_ftab", "markers_raw_ltk", "locs_no_dense", "locs_raw",
        "locs_raw_ltk"])
def test_markers_and_locs_lines_match_jax(all_built, capsys, mode, tool, flags):
    """rbt_markers (greedy seeding over the run-space, occ1 and fused steps)
    and rbt_locs (sample seeding with the per-step toehold) on the indexes
    without kval."""
    (jrc, jout, _), (rc, out, _) = _query(
        capsys, tool, [all_built[mode][0], all_built["inputs"][0]["fq"], "-b", "16", *flags])
    assert rc == jrc == 0 and out == jout and out
