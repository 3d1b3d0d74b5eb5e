"""The port's pangenome builders (tools/build_big_index.py, the merge build;
tools/build_giant_index.py, the PFP build) at toy size: each writes the
directory that the JAX package's scripts/ copy writes with the same
constants, array for array; the directory loads in both packages'
BigIndex.load; and the port's rbt_align prints the JAX rbt_align's count and
-m lines on it, the PFP panel's counts, occurrence sets and marker multisets
equal to the build tool's analytic oracle."""

import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest

from rowbowt_tpu_torch.bigindex import BigIndex
from rowbowt_tpu_torch.cli import rbt_align
from rowbowt_tpu_torch.tools import build_big_index, build_giant_index

from test_torch_pfp import assert_big_equal, jax_native  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = {"big": dict(REF_LEN=20_000, N_HAPS=3, N_VARS=60, N_READS=300, N_PARITY=64),
       "giant": dict(REF_LEN=20_000, N_HAPS=6, N_VARS=20, N_READS=300, N_PARITY=64)}
TOOLS = {"big": build_big_index, "giant": build_giant_index}
TABLES = ("fb2", "base", "F", "run_start", "run_head", "samples_last", "pred_pos", "phi_at",
          "cruns_keys", "ma_row", "ma_val", "doc_starts")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """{"big": directory, "giant": directory} from the port's build()."""
    d = tmp_path_factory.mktemp("build_tools")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RBT_BIG_ALLOW_SMALL", "1")  # the merge build refuses n <= 2^31 without it
        for name, tool in TOOLS.items():
            out[name] = str(d / name)
            tool.build(out[name], **{k.lower(): v for k, v in TOY[name].items()})
    return out


def jax_script_build(name, out, monkeypatch):
    """scripts/build_<name>_index.py's main() with TOY's constants and
    OUT/TMP pointing at `out`."""
    path = os.path.join(REPO, "scripts", f"build_{name}_index.py")
    spec = importlib.util.spec_from_file_location(f"jax_build_{name}_index", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in {**TOY[name], "OUT": out, "TMP": out + ".building"}.items():
        monkeypatch.setattr(mod, k, v)
    monkeypatch.setenv("RBT_BIG_ALLOW_SMALL", "1")
    mod.main()


@pytest.mark.parametrize("name", ["big", "giant"])
def test_builder_writes_the_jax_scripts_directory(jax_native, built, tmp_path, monkeypatch,
                                                  name):
    """Every .npy the JAX script writes, the port's build() writes equal
    (dtype too), and build_stats.json has the same keys and counts."""
    want = str(tmp_path / name)
    jax_script_build(name, want, monkeypatch)
    files = sorted(f for f in os.listdir(want) if f.endswith(".npy"))
    assert files == sorted(f for f in os.listdir(built[name]) if f.endswith(".npy"))
    for f in files:
        g, w = np.load(os.path.join(built[name], f)), np.load(os.path.join(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)

    def read(d, f):
        with open(os.path.join(d, f)) as fh:
            return json.load(fh)

    stats = [read(d, "build_stats.json") for d in (built[name], want)]
    assert stats[0].keys() == stats[1].keys()
    for k in ("n", "R", "M", "n_docs", "n_vars", "parse"):
        assert stats[0].get(k) == stats[1].get(k), k
    assert read(built[name], "meta.json") == read(want, "meta.json")


@pytest.mark.parametrize("name", ["big", "giant"])
def test_artifact_loads_in_both_packages(built, name):
    from rowbowt_tpu.bigindex import BigIndex as JaxBigIndex

    big, jbig = BigIndex.load(built[name]), JaxBigIndex.load(built[name])
    assert_big_equal(big, jbig, names=TABLES)
    assert big.doc_names == jbig.doc_names and len(big.doc_names) == TOY[name]["N_HAPS"] + 1
    assert big.fb2.shape[1] == (24 if name == "big" else 40) and big.has_locate
    q = np.load(os.path.join(built[name], "qcodes.npy"))
    assert q.shape == (TOY[name]["N_READS"], 100) and q.dtype == np.int16


def write_reads_fastq(d, path, n):
    """The build tool's first n query reads (qcodes.npy, decoded) as a FASTQ."""
    big = BigIndex.load(d)
    reads = big.alpha.bytes_[np.load(os.path.join(d, "qcodes.npy"))[:n]]
    with open(path, "wb") as f:
        for i, r in enumerate(reads):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, r.tobytes(), b"I" * len(r)))


def cli_lines(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        assert main(argv) == 0
    return out.getvalue().splitlines()


@pytest.mark.parametrize("flags", [[], ["-m"]], ids=["count", "m"])
@pytest.mark.parametrize("name", ["big", "giant"])
def test_rbt_align_lines_match_jax(built, tmp_path, name, flags):
    from rowbowt_tpu.cli import rbt_align as jax_rbt_align

    fq = str(tmp_path / "r.fq")
    write_reads_fastq(built[name], fq, TOY[name]["N_READS"])
    got = cli_lines(rbt_align.main, [built[name], fq, *flags, "-b", "128", "--device", "cpu"])
    assert got == cli_lines(jax_rbt_align.main, [built[name], fq, *flags, "-b", "128"])
    assert len(got) == TOY[name]["N_READS"] * (1 + len(flags))
    if name == "big":  # the build tool's own CPU-engine record of the first reads
        lo, hi = (np.load(os.path.join(built[name], f"expect_{x}.npy")) for x in ("lo", "hi"))
        want = [f"({a},{b})" if b >= a else "(1,0)" for a, b in zip(lo, hi)]
        assert [ln.split()[1][:-1] for ln in got[::1 + len(flags)][:len(lo)]] == want


def test_pfp_panel_lines_match_analytic_oracle(built, tmp_path):
    """On the PFP panel the port's rbt_align count, -s and -m lines hold the
    build tool's analytic oracle on its parity reads: counts, occurrence sets
    (doc x doc_len + offset; the toehold member is the standard order's) and
    final-range marker multisets."""
    d = built["giant"]
    n = TOY["giant"]["N_PARITY"]
    fq = str(tmp_path / "r.fq")
    write_reads_fastq(d, fq, n)
    e = {x: np.load(os.path.join(d, f"expect_{x}.npy"))
         for x in ("cnt", "pos_flat", "pos_off", "mval_flat", "mval_off")}
    lines = cli_lines(rbt_align.main, [d, fq, "-s", "-m", "--device", "cpu"])
    for i in range(n):
        head, locs, marks = lines[3 * i:3 * i + 3]
        assert head.endswith(f"count={e['cnt'][i]}")
        pos = sorted(int(x.split("/")[0]) for x in locs.split()[1:])
        assert pos == sorted(e["pos_flat"][e["pos_off"][i]:e["pos_off"][i + 1]].tolist())
        want = e["mval_flat"][e["mval_off"][i]:e["mval_off"][i + 1]]
        got = [] if "no markers" in marks else [
            (int(p) << 8) | int(a) for p, a in (x.split("/") for x in marks.split()[1:])]
        assert sorted(got) == sorted(want.tolist())
