"""The port's rbt_markers (`--device cpu`) prints what the JAX package's
rbt_markers prints, byte for byte, for each flag combination, on the panel
of test_torch_seeds.build_panel (ftab k = 6, markers with window 10)."""

import json

import numpy as np
import pytest
import torch

from rowbowt_tpu_torch.cli import rbt_markers
from test_torch_seeds import build_panel


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    dirs, fq, reads = build_panel(tmp_path_factory.mktemp("torch_markers_cli"))
    return dirs, fq, len(reads)


def _both(capsys, argv):
    """(JAX CLI's rc, stdout, stderr), (the port's rc, stdout, stderr)."""
    from rowbowt_tpu.cli import rbt_markers as jax_rbt_markers

    runs = []
    for fn, extra in ((jax_rbt_markers.main, []), (rbt_markers.main, ["--device", "cpu"])):
        rc = fn([*argv, *extra])
        got = capsys.readouterr()
        runs.append((rc, got.out, got.err))
    return runs


FLAGS = {
    "default": [],
    "ftab": ["-f"],
    "min_range_2": ["-m", "2"],
    "heuristic_best_strand": ["--heuristic", "--best-strand-only", "-y", "12", "-l", "50"],
    "clear": ["--clear-conflicting", "--clear-identical"],
    "heuristic_clear": ["--heuristic", "--clear-conflicting", "--clear-identical", "-y", "12",
                        "-f"],
    "lmem": ["--lmem", "-r", "200"],
    "small_tables": ["--max-seeds", "2", "--max-markers", "3", "-r", "100000"],
    "parity_flags": ["-t", "4", "-u", "8", "-x", "-w", "12"],
}


@pytest.mark.parametrize("flags", list(FLAGS.values()), ids=list(FLAGS))
def test_rbt_markers_matches_jax(inputs, capsys, flags):
    dirs, fq, n_reads = inputs
    (jrc, want, _), (rc, got, err) = _both(capsys, [dirs["idx"], fq, "-b", "32", *flags])
    assert jrc == rc == 0
    assert got == want
    lines = want.splitlines()
    names = {ln.split()[0] for ln in lines}
    assert len(names) > n_reads // 2 and {ln.split()[2] for ln in lines} <= {"+", "-"}
    assert any(ln.endswith(" .") for ln in lines) and any("/" in ln for ln in lines)
    assert "reads/s" in err and "seeds/s" in err
    stages = json.loads(next(ln for ln in err.splitlines() if ln.startswith("stages: "))[8:])
    want_stages = {"parse", "h2d", "d2h", "assemble", "format"}
    assert want_stages | ({"expand", "lmem"} if "--lmem" in flags else {"greedy", "resolve"}) \
        <= set(stages) and all(v >= 0 for v in stages.values())


HEURISTIC = ["-b", "32", "--heuristic", "--best-strand-only", "-y", "12", "-l", "40"]


@pytest.mark.parametrize("skip_off", [False, True], ids=["strand_skip", "no_strand_skip"])
def test_heuristic_strand_skip_matches_jax(inputs, capsys, monkeypatch, skip_off):
    """--heuristic --best-strand-only with and without RBT_NO_STRAND_SKIP,
    each against the JAX CLI under the same switch."""
    dirs, fq, _ = inputs
    if skip_off:
        monkeypatch.setenv("RBT_NO_STRAND_SKIP", "1")
    (jrc, want, _), (rc, got, _) = _both(capsys, [dirs["idx"], fq, *HEURISTIC])
    assert jrc == rc == 0 and got == want and want


def test_strand_skip_runs_the_second_strand_on_unstopped_reads(inputs, capsys, monkeypatch):
    """With the skip, each batch runs its forward lanes, then one compacted
    batch of the reads that did not stop (or none); the lines equal the
    always-both-strands run's."""
    dirs, fq, n_reads = inputs
    argv = [dirs["idx"], fq, *HEURISTIC, "--device", "cpu"]
    monkeypatch.setenv("RBT_NO_STRAND_SKIP", "1")
    assert rbt_markers.main(argv) == 0
    want = capsys.readouterr().out
    monkeypatch.delenv("RBT_NO_STRAND_SKIP")
    calls = []
    real = rbt_markers.greedy_on_device

    def record(args, idx, tx, qc, lens, clock):
        calls.append((qc.shape[0], int((np.asarray(lens) > 0).sum())))
        return real(args, idx, tx, qc, lens, clock)

    monkeypatch.setattr(rbt_markers, "greedy_on_device", record)
    assert rbt_markers.main(argv) == 0
    assert capsys.readouterr().out == want
    forward = [c for c in calls if c[0] == 32 and c[1] in (32, n_reads - 32)]
    assert calls[0] == (32, 32) and len(forward) >= 2
    second = [c for c in calls if c not in forward[:2]]
    assert second and all(0 < n < 32 for _, n in second)


@pytest.mark.parametrize("flags,index,message", [
    (["--overlap"], "idx", "overlapped seeds currently broken"),
    ([], "bare", "error: index has no marker array (build with -m)"),
], ids=["overlap", "no_markers"])
def test_refusals_exit_1(inputs, capsys, flags, index, message):
    dirs, fq, _ = inputs
    (jrc, jout, jerr), (rc, out, err) = _both(capsys, [dirs[index], fq, *flags])
    assert jrc == rc == 1
    assert jout == out == ""
    assert message in jerr.splitlines() and message in err.splitlines()


def test_device_cuda_raises_without_cuda(inputs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    dirs, fq, _ = inputs
    with pytest.raises(RuntimeError, match="cuda"):
        rbt_markers.main([dirs["idx"], fq])  # --device defaults to cuda


@pytest.mark.parametrize("flags", [["-f"], ["--lmem"]], ids=["greedy", "lmem"])
def test_profile_writes_a_trace_and_keeps_stdout(inputs, capsys, tmp_path, flags):
    dirs, fq, _ = inputs
    argv = [dirs["idx"], fq, "-b", "32", "--device", "cpu", *flags]
    assert rbt_markers.main(argv) == 0
    want = capsys.readouterr().out
    trace_dir = tmp_path / "trace"
    assert rbt_markers.main([*argv, "--profile", str(trace_dir)]) == 0
    got = capsys.readouterr()
    assert got.out == want
    assert f"profiler trace written to {trace_dir}" in got.err.splitlines()
    (trace,) = sorted(trace_dir.glob("*.pt.trace.json"))
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


@pytest.mark.parametrize("normalize,with_rc", [(True, True), (True, False), (False, True)])
def test_native_reader_matches_python_reader(inputs, normalize, with_rc):
    """iter_query_batches with N-normalization and reverse complements: the
    native reader and the Python reader give the same batches, with
    2 * batch_size lanes under with_rc, as the JAX package's
    iter_query_batches does."""
    from rowbowt_tpu.cli import common as jax_common
    from rowbowt_tpu_torch.cli import common

    dirs, fq, n_reads = inputs
    idx = common.load_index(dirs["idx"], ft=True)
    assert idx.ftab is not None and common.load_index(dirs["idx"]).ftab is None
    kw = dict(normalize=normalize, with_rc=with_rc)
    native = list(common.iter_query_batches(idx, fq, 16, use_native=True, **kw))
    plain = list(common.iter_query_batches(idx, fq, 16, use_native=False, **kw))
    want = list(jax_common.iter_query_batches(idx, fq, 16, use_native=False, **kw))
    assert len(native) == len(plain) == len(want) == -(-n_reads // 16)
    for a, b, c in zip(native, plain, want):
        assert a[0] == b[0] == c[0]
        assert a[1].shape[0] == 16 * (2 if with_rc else 1)
        for x, y in ((a, b), (a, c)):
            np.testing.assert_array_equal(x[1], y[1])
            np.testing.assert_array_equal(x[2], y[2])


@pytest.fixture(scope="module")
def big_dir(inputs, tmp_path_factory):
    from test_torch_seeds import save_jax_big

    return save_jax_big(inputs[0]["idx"], str(tmp_path_factory.mktemp("big") / "big"))


BIG_FLAGS = {"default": [], "ftab": ["-f"], "heuristic_best_strand": HEURISTIC[2:],
             "heuristic_clear": FLAGS["heuristic_clear"]}


@pytest.mark.parametrize("flags", list(BIG_FLAGS.values()), ids=list(BIG_FLAGS))
def test_rbt_markers_on_big_dir_matches_jax(inputs, big_dir, capsys, flags):
    """On a BigIndex directory saved by the JAX package the port prints the
    JAX CLI's lines; without an ftab (big artifacts carry none) they are the
    lines of the same index saved whole, run without -f."""
    dirs, fq, _ = inputs
    (jrc, want, jerr), (rc, got, err) = _both(capsys, [big_dir, fq, "-b", "32", *flags])
    assert jrc == rc == 0 and got == want and want
    note = "note: big artifacts carry no ftab; running without it"
    assert (note in err.splitlines()) == (note in jerr.splitlines()) == ("-f" in flags)
    whole = [f for f in flags if f != "-f"]
    assert rbt_markers.main([dirs["idx"], fq, "-b", "32", "--device", "cpu", *whole]) == 0
    assert capsys.readouterr().out == got


def test_lmem_on_big_dir_refuses_like_jax(inputs, big_dir, capsys):
    """--lmem needs the ftab (rowbowt.hpp:346-349): both CLIs refuse a big
    directory with the same error."""
    from rowbowt_tpu.cli import rbt_markers as jax_rbt_markers

    dirs, fq, _ = inputs
    for fn, extra in ((jax_rbt_markers.main, []), (rbt_markers.main, ["--device", "cpu"])):
        with pytest.raises(ValueError, match="ftab must be enabled"):
            fn([big_dir, fq, "--lmem", *extra])
