"""The port's build half (construct/panel.py, the occ1/tk1/phi1 tables of
construct/build.py, construct/rawio.py, construct/sdslio.py,
construct/sdslwrite.py) == the JAX package's copies of the same modules on
the same inputs: equal parses, equal arrays, byte-identical files.

The inputs are written here from a seed: a FASTA of two contigs and a
gzipped VCF of three diploid samples with SNPs, insertions, deletions, a
multi-allelic site, a variant inside a deletion, unphased and missing
genotypes, a haploid call, a GT that is not the first FORMAT field, a
no-ALT record and a record on a contig the FASTA lacks."""

import gzip
import os

import numpy as np
import pytest

from rowbowt_tpu.construct import build as JB
from rowbowt_tpu.construct import panel as JP
from rowbowt_tpu.construct import rawio as JRAW
from rowbowt_tpu.construct import sdslio as JSIO
from rowbowt_tpu.construct import sdslwrite as JSW
from rowbowt_tpu.index import RbtIndex as JaxRbtIndex
from rowbowt_tpu_torch.construct import build as TB
from rowbowt_tpu_torch.construct import panel as TP
from rowbowt_tpu_torch.construct import rawio as TRAW
from rowbowt_tpu_torch.construct import sdslio as TSIO
from rowbowt_tpu_torch.construct import sdslwrite as TSW
from rowbowt_tpu_torch.index import RbtIndex

ACGT = np.frombuffer(b"ACGT", np.uint8)
IUPAC = np.frombuffer(b"NRYKMSW", np.uint8)
INDEX_ARRAYS = ("run_start", "run_head", "occ", "F", "cruns_flat", "cruns_off",
                "samples_last", "pred_pos", "pred_to_run", "ltk", "ma_row", "ma_val",
                "ma_start1", "doc_starts", "ftab", "bwt4", "occ_blk", "occ1", "tk1", "kval",
                "phi1", "fblock")


def write_inputs(d, seed=7, iupac=False, n_reads=40):
    """FASTA (contigs chrA 2,000 bp and chrB 1,500 bp), gzipped VCF and a
    FASTQ of reads from the panel's haplotypes under d.  iupac=True sprinkles
    7 IUPAC codes over the FASTA (an alphabet of 13 codes).  Returns
    {"fa", "vcf", "fq"}: the paths."""
    rng = np.random.default_rng(seed)
    contigs = {"chrA": rng.choice(ACGT, size=2000), "chrB": rng.choice(ACGT, size=1500)}
    if iupac:
        for seq in contigs.values():
            p = rng.choice(seq.shape[0], size=30, replace=False)
            seq[p] = rng.choice(IUPAC, size=30)
    fa = os.path.join(str(d), "ref.fa")
    with open(fa, "w") as f:
        for name, seq in contigs.items():
            f.write(f">{name} description\n")
            s = seq.tobytes().decode().lower()  # parse_fasta upper-cases
            f.writelines(s[i:i + 70] + "\n" for i in range(0, len(s), 70))
            f.write("\n")

    def base(c, p, k=1):
        return contigs[c][p:p + k].tobytes().decode()

    gts = ["0|0", "0|1", "1|0", "1|1", "0/1", "1/1", ".|1", "./.", "1|.", "0"]
    recs = []
    used = {1200, 1300, 1500, 1600, 1603}  # the hand-made records below
    for c, n_snp in (("chrA", 30), ("chrB", 15)):
        for p in sorted(rng.choice(np.arange(10, contigs[c].shape[0] - 10), n_snp,
                                   replace=False).tolist()):
            if any(abs(p - q) < 8 for q in used):
                continue
            used.add(p)
            alt = [x for x in "ACGT" if x != base(c, p).upper()][int(rng.integers(0, 3))]
            recs.append((c, p, base(c, p), alt, [gts[i] for i in rng.integers(0, 10, 3)]))
    # an insertion, a deletion with a SNP inside it (skipped on the haplotypes
    # that take the deletion), a multi-allelic site, GT:DP with GT second
    recs += [("chrA", 1500, base("chrA", 1500), base("chrA", 1500) + "GTCA",
              ["0|1", "1|1", "0/1"]),
             ("chrA", 1600, base("chrA", 1600, 6), base("chrA", 1600), ["1|0", "0|1", "1|1"]),
             ("chrA", 1603, base("chrA", 1603), "A" if base("chrA", 1603) != "A" else "C",
              ["1|1", "1|1", "0|1"]),
             ("chrB", 1200, base("chrB", 1200), "A,C" if base("chrB", 1200) not in "AC" else "G,T",
              ["1|2", "2|0", "2/2"]),
             ("chrB", 1300, base("chrB", 1300), ".", ["1|1", "1|1", "1|1"]),
             ("chrZ", 10, "A", "C", ["1|1", "1|1", "1|1"])]
    vcf = os.path.join(str(d), "panel.vcf.gz")
    with gzip.open(vcf, "wt") as f:
        f.write("##fileformat=VCFv4.2\n##contig=<ID=chrA>\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts0\ts1\ts2\n")
        for i, (c, p, ref, alt, g) in enumerate(sorted(recs, key=lambda r: (r[0], r[1]))):
            fmt, calls = ("DP:GT", [f"7:{x}" for x in g]) if i % 7 == 3 else ("GT", g)
            f.write(f"{c}\t{p + 1}\tv{i}\t{ref.upper()}\t{alt}\t.\tPASS\t.\t{fmt}\t"
                    + "\t".join(calls) + "\n")
    panel = TP.build_panel(fa, vcf)
    text = panel.text
    reads = []
    for q in range(n_reads - 3):
        L = int(rng.integers(15, 70))
        p = int(rng.integers(0, text.shape[0] - L - 1))
        r = text[p:p + L].copy()
        r[r < 65] = ord("A")  # no separator bytes in a read
        if q % 4 == 1:
            r[rng.integers(0, L)] = rng.choice(ACGT)
        reads.append(r.tobytes())
    reads[2] = reads[2][:6] + b"N" + reads[2][7:]
    reads += [b"AC", rng.choice(ACGT, size=30).tobytes(), reads[0]]
    fq = os.path.join(str(d), "reads.fq")
    with open(fq, "wb") as f:
        for q, r in enumerate(reads):
            f.write(b"@read%d\n%s\n+\n%s\n" % (q, r, b"I" * len(r)))
    return {"fa": fa, "vcf": vcf, "fq": fq}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return write_inputs(tmp_path_factory.mktemp("torch_build"))


@pytest.fixture(scope="module")
def iupac_inputs(tmp_path_factory):
    return write_inputs(tmp_path_factory.mktemp("torch_build_iupac"), seed=8, iupac=True)


def assert_index_equal(got, want):
    """Every array, and the metadata, of two RbtIndexes (either package's)."""
    assert (got.n, got.R, got.ma_wsize, got.ftab_k, got.doc_names) == \
        (want.n, want.R, want.ma_wsize, want.ftab_k, want.doc_names)
    np.testing.assert_array_equal(got.alpha.bytes_, want.alpha.bytes_)
    for name in INDEX_ARRAYS:
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)


def _panel_equal(got, want):
    np.testing.assert_array_equal(got.text, want.text)
    np.testing.assert_array_equal(got.doc_starts, want.doc_starts)
    assert got.doc_names == want.doc_names and got.wsize == want.wsize
    assert [(m.text_pos, m.seq, m.pos, m.allele) for m in got.markers] == \
        [(m.text_pos, m.seq, m.pos, m.allele) for m in want.markers]


def test_parse_fasta_matches_jax(inputs):
    got = TP.parse_fasta(inputs["fa"])
    assert got == JP.parse_fasta(inputs["fa"])
    assert [name for name, _ in got] == ["chrA", "chrB"] and len(got[0][1]) == 2000


@pytest.mark.parametrize("samples", [None, ["s0", "s2"]])
def test_parse_vcf_matches_jax(inputs, samples):
    got, names = TP.parse_vcf(inputs["vcf"], samples)
    want, wnames = JP.parse_vcf(inputs["vcf"], samples)
    assert names == wnames == (samples or ["s0", "s1", "s2"])
    assert [(v.contig, v.pos0, v.ref, v.alts, v.genotypes) for v in got] == \
        [(v.contig, v.pos0, v.ref, v.alts, v.genotypes) for v in want]
    alleles = {a for v in got for g in v.genotypes.values() for a in g}
    assert alleles == {0, 1, 2}
    assert any(len(g) == 1 for v in got for g in v.genotypes.values())  # the haploid call
    assert {len(v.alts) for v in got} == {1, 2}


@pytest.mark.parametrize("samples,wsize", [(None, 10), (["s1"], 7)])
def test_build_panel_matches_jax(inputs, samples, wsize):
    got = TP.build_panel(inputs["fa"], inputs["vcf"], samples=samples, wsize=wsize)
    _panel_equal(got, JP.build_panel(inputs["fa"], inputs["vcf"], samples=samples,
                                     wsize=wsize))
    n_docs = 2 * (1 + 2 * len(samples or [0, 1, 2]))
    assert len(got.doc_names) == n_docs and got.markers
    assert len({len(got.text[a:b]) for a, b in zip(got.doc_starts[::2],
                                                   got.doc_starts[1::2])}) > 1  # indels


def test_build_panel_without_vcf_matches_jax(iupac_inputs):
    got = TP.build_panel(iupac_inputs["fa"])
    _panel_equal(got, JP.build_panel(iupac_inputs["fa"]))
    assert got.doc_names == ["chrA", "chrB"] and not got.markers


@pytest.fixture(scope="module")
def panel_index(inputs):
    """(panel, port index with SA samples, markers and an ftab of k = 6, the
    JAX package's, BWT codes)."""
    panel = TP.build_panel(inputs["fa"], inputs["vcf"])
    idx = TB.build_index_from_panel(panel, ftab_k=6)
    jidx = JB.build_index_from_panel(JP.build_panel(inputs["fa"], inputs["vcf"]), ftab_k=6)
    codes = np.repeat(idx.run_head, idx.run_lengths()).astype(np.int64)
    return panel, idx, jidx, codes


@pytest.mark.parametrize("kw", [{}, {"dense": False}, {"with_sa_samples": False},
                                {"dense": False, "with_sa_samples": False}],
                         ids=["dense", "no_dense", "no_sa", "no_dense_no_sa"])
def test_build_index_matches_jax(inputs, panel_index, kw):
    panel = panel_index[0]
    got = TB.build_index_from_panel(panel, ftab_k=6, **kw)
    assert_index_equal(got, JB.build_index_from_panel(panel, ftab_k=6, **kw))
    assert (got.fblock is None) == (kw.get("dense") is False)
    assert (got.kval is None) == (kw != {})


def test_build_index_wide_alphabet_matches_jax(iupac_inputs):
    """Thirteen codes: the dense bwt4/occ_blk tables in place of fblock."""
    panel = TP.build_panel(iupac_inputs["fa"], iupac_inputs["vcf"])
    got = TB.build_index_from_panel(panel)
    assert_index_equal(got, JB.build_index_from_panel(panel))
    assert got.A == 13 and got.fblock is None and got.bwt4 is not None


@pytest.mark.parametrize("table", ["occ1", "tk1", "phi1"])
def test_tables_match_jax(panel_index, table):
    _, idx, _, codes = panel_index
    if table == "occ1":
        got, want = TB.build_occ1(codes, idx.A), JB.build_occ1(codes, idx.A)
        assert got[:, -1].tolist() == np.diff(idx.F).tolist()
    elif table == "tk1":
        args = (codes, idx.run_start, idx.samples_last, idx.A, np.int32)
        got, want = TB.build_tk1_from_runs(*args), JB.build_tk1_from_runs(*args)
    else:
        args = (idx.pred_pos, idx.pred_to_run, idx.samples_last, idx.n, np.int32)
        got, want = TB.build_phi1(*args, chunk=1000), JB.build_phi1(*args)
        np.testing.assert_array_equal(got, idx.phi1)  # the full-SA scatter's table
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert TB.OCC1_MAX_N == JB.OCC1_MAX_N


def _files_equal(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), (a, b)


def test_write_raw_byte_identical(tmp_path, panel_index):
    _, idx, jidx, _ = panel_index
    TRAW.write_raw(idx, str(tmp_path / "t"))
    JRAW.write_raw(jidx, str(tmp_path / "j"))
    for ext in (".bwt", ".ssa", ".esa", ".docs"):
        _files_equal(tmp_path / ("t" + ext), tmp_path / ("j" + ext))
    assert TRAW.read_docs(str(tmp_path / "t.docs"))[0] == idx.doc_names
    np.testing.assert_array_equal(TRAW.read_sa_samples(str(tmp_path / "t.esa"), idx.n),
                                  idx.samples_last)


@pytest.fixture(scope="module")
def raw_prefix(tmp_path_factory, panel_index):
    """The panel index written as <prefix>.bwt/.ssa/.esa/.docs/.mab."""
    _, idx, _, _ = panel_index
    prefix = str(tmp_path_factory.mktemp("torch_raw") / "panel")
    TRAW.write_raw(idx, prefix)
    TSW.write_mab(prefix + ".mab", idx.ma_row, idx.ma_val, idx.ma_wsize, idx.n)
    return prefix


@pytest.mark.parametrize("small_occ1", [False, True], ids=["occ1", "ltk"])
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "no_dense"])
@pytest.mark.parametrize("parts", ["all", "bwt_only", "no_mab"])
def test_build_index_from_raw_matches_jax(monkeypatch, raw_prefix, panel_index, small_occ1,
                                          dense, parts):
    """With and without the SA samples, docs and markers; n below OCC1_MAX_N
    (occ1 + tk1) and above a patched small one (the run-space ltk toehold)."""
    if small_occ1:
        monkeypatch.setattr(TRAW, "OCC1_MAX_N", 1000)
        monkeypatch.setattr(JRAW, "OCC1_MAX_N", 1000)
    kw = dict(dense=dense, ftab_k=6)
    if parts == "bwt_only":
        kw.update(with_sa=False, with_docs=False, with_ma=False)
    elif parts == "no_mab":
        kw.update(with_ma=False)
    got = TRAW.build_index_from_raw(raw_prefix, **kw)
    assert_index_equal(got, JRAW.build_index_from_raw(raw_prefix, **kw))
    idx = panel_index[1]
    assert got.n == idx.n and got.kval is None
    assert (got.occ1 is not None) == (dense and not small_occ1)
    assert (got.tk1 is not None) == (dense and not small_occ1 and parts != "bwt_only")
    if dense and parts != "bwt_only":
        np.testing.assert_array_equal(got.phi1, idx.phi1)
    if parts == "all":
        np.testing.assert_array_equal(got.ma_row, idx.ma_row)
        np.testing.assert_array_equal(got.ma_val, idx.ma_val)


def test_ftab_text_both_ways(tmp_path, panel_index):
    idx = panel_index[1]
    TRAW.write_ftab_text(idx.ftab, idx.ftab_k, str(tmp_path / "t.ftab"))
    JRAW.write_ftab_text(idx.ftab, idx.ftab_k, str(tmp_path / "j.ftab"))
    _files_equal(tmp_path / "t.ftab", tmp_path / "j.ftab")
    for mod in (TRAW, JRAW):
        ft, k = mod.read_ftab_text(str(tmp_path / "t.ftab"))
        assert k == 6
        np.testing.assert_array_equal(ft, idx.ftab)


def test_save_reference_format_byte_identical(tmp_path, panel_index):
    _, idx, jidx, _ = panel_index
    got = TSW.save_reference_format(idx, str(tmp_path / "t"))
    want = JSW.save_reference_format(jidx, str(tmp_path / "j"))
    assert [os.path.basename(p)[1:] for p in got] == [os.path.basename(p)[1:] for p in want]
    assert [os.path.splitext(p)[1] for p in got] == [".rbwt", ".tsa", ".mab", ".docs"]
    for a, b in zip(got, want):
        _files_equal(a, b)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "no_dense"])
def test_load_serialized_index_either_writer(tmp_path, panel_index, writer, dense):
    """load_serialized_index of either package's .rbwt/.tsa/.mab/.docs gives
    equal arrays in both packages, and the panel index's BWT, samples and
    markers."""
    _, idx, jidx, _ = panel_index
    prefix = str(tmp_path / "ser")
    (TSW if writer == "port" else JSW).save_reference_format(
        idx if writer == "port" else jidx, prefix)
    got = TSIO.load_serialized_index(prefix, ftab_k=6, dense=dense)
    assert_index_equal(got, JSIO.load_serialized_index(prefix, ftab_k=6, dense=dense))
    for name in ("run_start", "run_head", "samples_last", "pred_pos", "ma_row", "ma_val",
                 "doc_starts", "ftab"):
        np.testing.assert_array_equal(getattr(got, name), getattr(idx, name), err_msg=name)
    assert TSIO.load_rbwt(prefix + ".rbwt").tobytes() == JSIO.load_rbwt(prefix + ".rbwt").tobytes()


def test_index_loads_in_either_package(tmp_path, panel_index):
    _, idx, jidx, _ = panel_index
    idx.save(str(tmp_path / "t"))
    jidx.save(str(tmp_path / "j"))
    assert_index_equal(JaxRbtIndex.load(str(tmp_path / "t")), idx)
    assert_index_equal(RbtIndex.load(str(tmp_path / "j")), jidx)


def test_write_mab_nested_ranges_read_back(tmp_path):
    """A marker's row run nested inside another's (a later start, an earlier
    end, in a lower sd_vector bucket): the port's .mab reads back the same
    CSR in either package; the JAX writer's file reads back other arrays or
    none (its ends are out of order)."""
    from rowbowt_tpu_torch.index import pack_marker

    rng = np.random.default_rng(3)
    n = 4000
    rows = np.concatenate([np.arange(0, 51), np.arange(10, 21), rng.integers(0, n, 2000)])
    vals = np.concatenate([np.full(51, pack_marker(0, 5, 0)), np.full(11, pack_marker(1, 9, 1)),
                           [pack_marker(0, int(p), int(p) % 3) for p in rng.integers(0, 400, 2000)]])
    key = np.unique(np.stack([rows, vals], 1), axis=0)
    rows, vals = key[:, 0], key[:, 1]
    TSW.write_mab(str(tmp_path / "t.mab"), rows, vals, 10, n)
    for mod in (TSIO, JSIO):
        r, v, w = mod.load_mab(str(tmp_path / "t.mab"))
        assert w == 10
        np.testing.assert_array_equal(r, rows)
        np.testing.assert_array_equal(v, vals)
    JSW.write_mab(str(tmp_path / "j.mab"), rows, vals, 10, n)
    try:
        r, v, _ = JSIO.load_mab(str(tmp_path / "j.mab"))
        assert not (np.array_equal(r, rows) and np.array_equal(v, vals))
    except ValueError as e:
        assert "sd_vector" in str(e) or ".mab" in str(e)
