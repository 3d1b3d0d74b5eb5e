"""The port's rbt_midx and rbt_locs (`--device cpu`) print and write what
the JAX package's print and write, byte for byte, on the panel of
test_torch_seeds.build_panel; the missing `.midx.npz` and an index without
SA samples exit 1 with the JAX CLI's message."""

import shutil

import numpy as np
import pytest
import torch

from rowbowt_tpu_torch.cli import rbt_locs, rbt_midx
from rowbowt_tpu_torch.midx import PosMarkers
from test_torch_seeds import build_panel


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The panel, with `<idx>.midx.npz` written by the port's rbt_midx and a
    copy of the JAX rbt_midx's file beside it."""
    from rowbowt_tpu.cli import rbt_midx as jax_rbt_midx

    d = tmp_path_factory.mktemp("torch_locs_cli")
    dirs, fq, reads = build_panel(d)
    assert rbt_midx.main([dirs["midx_txt"], dirs["idx"] + ".midx"]) == 0  # appends .npz
    assert jax_rbt_midx.main([dirs["midx_txt"], str(d / "jax.midx.npz")]) == 0
    return dirs, fq, len(reads), str(d / "jax.midx.npz")


def test_rbt_midx_matches_jax(inputs):
    dirs, _, _, jax_path = inputs
    got, want = PosMarkers.load(dirs["idx"] + ".midx.npz"), PosMarkers.load(jax_path)
    for g, w in ((got.pos, want.pos), (got.val, want.val)):
        assert g.dtype == w.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    assert (np.diff(got.pos) >= 0).all() and len(got.pos) > 100


def _both(capsys, argv):
    from rowbowt_tpu.cli import rbt_locs as jax_rbt_locs

    runs = []
    for fn, extra in ((jax_rbt_locs.main, []), (rbt_locs.main, ["--device", "cpu"])):
        rc = fn([*argv, *extra])
        got = capsys.readouterr()
        runs.append((rc, got.out, got.err))
    return runs


@pytest.mark.parametrize("flags", [[], ["-b", "8"], ["-m", "1", "-w", "12"], ["-m", "40"],
                                   ["-o", "OUT", "-w", "25"]],
                         ids=["default", "b8", "m1_w12", "m40", "o_w25"])
def test_rbt_locs_matches_jax(inputs, capsys, tmp_path, flags):
    """-m 40 widens the marker probe past its first width of 8."""
    dirs, fq, n_reads, _ = inputs
    flags = [str(tmp_path / "out") if f == "OUT" else f for f in flags]
    (jrc, want, _), (rc, got, err) = _both(capsys, [dirs["idx"], fq, *flags])
    assert jrc == rc == 0
    assert got == want
    lines = want.splitlines()
    assert len(lines) == n_reads and any(len(ln.split()) > 1 for ln in lines)
    assert any(len(ln.split()) == 1 for ln in lines)
    if "40" in flags:
        assert max(len(ln.split()) for ln in lines) > 9
    assert "reads/s" in err


@pytest.mark.parametrize("index,message", [
    ("no_midx", "error: positional marker index not found"),
    ("no_sa", "error: index has no toehold SA"),
])
def test_refusals_exit_1(inputs, capsys, tmp_path, index, message):
    dirs, fq, _, _ = inputs
    if index == "no_midx":
        path = str(tmp_path / "copy")
        shutil.copytree(dirs["idx"], path)
    else:
        path = dirs["no_sa"]
        shutil.copy(dirs["idx"] + ".midx.npz", path + ".midx.npz")
    (jrc, jout, jerr), (rc, out, err) = _both(capsys, [path, fq])
    assert jrc == rc == 1
    assert jout == out == ""
    want = [ln for ln in jerr.splitlines() if ln.startswith("error:")]
    assert want and want[0].startswith(message)
    assert [ln for ln in err.splitlines() if ln.startswith("error:")] == want


def test_device_cuda_raises_without_cuda(inputs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    dirs, fq, _, _ = inputs
    with pytest.raises(RuntimeError, match="cuda"):
        rbt_locs.main([dirs["idx"], fq])


@pytest.mark.parametrize("flags", [[], ["-b", "8", "-m", "40"]], ids=["default", "b8_m40"])
def test_rbt_locs_on_big_dir_matches_jax(inputs, capsys, tmp_path, flags):
    """On a BigIndex directory saved by the JAX package, with
    `<dir>.midx.npz` beside it, the port prints the JAX CLI's lines and the
    lines of the same index saved whole."""
    from test_torch_seeds import save_jax_big

    dirs, fq, n_reads, _ = inputs
    big_dir = save_jax_big(dirs["idx"], str(tmp_path / "big"), with_markers=False)
    (jrc, want, _), (rc, got, err) = _both(capsys, [big_dir, fq, *flags])
    assert jrc == rc == 0 and got == want
    assert err.startswith(f"loading (big two-level artifact): {big_dir}\n")
    assert rbt_locs.main([dirs["idx"], fq, "--device", "cpu", *flags]) == 0
    assert capsys.readouterr().out == got and len(got.splitlines()) == n_reads
