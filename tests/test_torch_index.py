"""The port's index: built array-equal to the JAX package's, one on-disk
artifact for both packages, the device view carried across, and no jax."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rowbowt_tpu.construct.build import build_index as jax_build
from rowbowt_tpu.engine.device import DeviceIndex
from rowbowt_tpu.index import RbtIndex as JaxRbtIndex
from rowbowt_tpu_torch.construct import build as tbuild
from rowbowt_tpu_torch.construct import sa as tsa
from rowbowt_tpu_torch.construct.panel import Marker
from rowbowt_tpu_torch.engine.device import TorchIndex
from rowbowt_tpu_torch.index import RbtIndex

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("run_start", "run_head", "occ", "F", "cruns_flat", "cruns_off",
          "samples_last", "pred_pos", "pred_to_run", "ltk", "ma_row", "ma_val",
          "ma_start1", "doc_starts", "ftab", "bwt4", "occ_blk", "occ1", "tk1",
          "kval", "phi1", "fblock")


def _assert_same_index(a, b):
    assert (a.n, a.R, a.A, a.ma_wsize, a.ftab_k, a.doc_names) == \
        (b.n, b.R, b.A, b.ma_wsize, b.ftab_k, b.doc_names)
    np.testing.assert_array_equal(a.alpha.bytes_, b.alpha.bytes_)
    for name in FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.fixture(scope="module")
def marker_text(rand_index):
    """The rand_index fixture's text and markers, as port Markers."""
    jidx, text = rand_index
    rng = np.random.default_rng(42)  # conftest.rand_index's marker draws, replayed
    markers, pos = [], 0
    for _ in range(3):
        L = int(rng.integers(200, 400))
        rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=L)
        for _ in range(6):
            p = int(rng.integers(0, L))
            markers.append(Marker(text_pos=pos + p, seq=0, pos=p,
                                  allele=int(rng.integers(0, 2))))
        pos += L + 7
    return jidx, text, markers


def test_build_matches_jax_with_markers(marker_text):
    """Every table of the port's build == the JAX build (conftest.rand_index)."""
    jidx, text, markers = marker_text
    tidx = tbuild.build_index(text, markers=markers, doc_starts=jidx.doc_starts,
                              doc_names=jidx.doc_names, ma_wsize=7)
    _assert_same_index(tidx, jidx)


@pytest.mark.parametrize("ftab_k", [0, 4])
def test_build_matches_jax_ftab(rand_index, ftab_k):
    text = rand_index[1]
    _assert_same_index(tbuild.build_index(text, ftab_k=ftab_k),
                       jax_build(text, ftab_k=ftab_k))


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_artifact_round_trip(rand_index, tmp_path, direction):
    """An index saved by either package loads in the other with equal arrays."""
    text = rand_index[1]
    if direction == "port_to_jax":
        tbuild.build_index(text, ftab_k=4).save(str(tmp_path))
        a, b = RbtIndex.load(str(tmp_path)), JaxRbtIndex.load(str(tmp_path))
    else:
        jax_build(text, ftab_k=4).save(str(tmp_path))
        a, b = JaxRbtIndex.load(str(tmp_path)), RbtIndex.load(str(tmp_path))
    _assert_same_index(a, b)
    _assert_same_index(b, jax_build(text, ftab_k=4))


@pytest.mark.parametrize("fb64", [True, False])
def test_from_arrays_of_jax_device_index(rand_index, fb64):
    """TorchIndex.from_arrays(JAX DeviceIndex leaves) == TorchIndex.from_index."""
    jidx, text = rand_index
    dx = DeviceIndex.from_index(jidx, fb64=fb64)
    a = TorchIndex.from_arrays({k: np.asarray(v) for k, v in dx.arrays.items()},
                               n=dx.n, R=dx.R, A=dx.A, ma_wsize=dx.ma_wsize,
                               ftab_k=dx.ftab_k, acgt_codes=dx.acgt_codes,
                               device="cpu")
    b = TorchIndex.from_index(jidx, torch.device("cpu"), fb64=fb64)
    assert (a.n, a.R, a.A, a.ma_wsize, a.ftab_k, a.acgt_codes, a.device) == \
        (b.n, b.R, b.A, b.ma_wsize, b.ftab_k, b.acgt_codes, b.device)
    assert sorted(a.arrays) == sorted(b.arrays)
    assert ("fblock64" in b.arrays) == fb64 and ("fblock" in b.arrays) != fb64
    for k in a.arrays:
        assert a.arrays[k].dtype == b.arrays[k].dtype, k
        assert torch.equal(a.arrays[k], b.arrays[k]), k


def test_suffix_array_native_matches_numpy():
    rng = np.random.default_rng(3)
    text = np.concatenate([rng.choice(np.frombuffer(b"ACGT", np.uint8), size=3000),
                           [2] * 5, rng.choice(np.frombuffer(b"AC", np.uint8), size=500),
                           [1]]).astype(np.uint8)
    assert tsa._load_native() is not None, tsa._NATIVE_ERROR
    np.testing.assert_array_equal(tsa.suffix_array(text), tsa.suffix_array_numpy(text))


def test_port_imports_no_jax():
    """Every rowbowt_tpu_torch module imports without jax or rowbowt_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import rowbowt_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'rowbowt_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'rowbowt_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'rowbowt_tpu_torch.cli.rbt_align' in mods, mods\n"
        "for m in ('parallel.mesh', 'parallel.multihost', 'parallel.sharded',\n"
        "          'parallel.sharded_dense', 'tools.sharded_stream', 'tools.dryrun_multichip'):\n"
        "    assert 'rowbowt_tpu_torch.' + m in mods, m\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 15
