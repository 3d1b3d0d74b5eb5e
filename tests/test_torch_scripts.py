"""The port's pipeline scripts (rowbowt_tpu_torch/tools/fa_to_rowbowt.sh and
vcf_to_rowbowt.sh, the twins of scripts/*.sh) write, on the in-repo FASTA
and gzipped VCF of tests/test_torch_build.py, the same artifact bytes as
rbt_build_torch run with the flags and defaults of the scripts in
scripts/."""

import filecmp
import os
import subprocess
import sys

import pytest

from rowbowt_tpu_torch.cli import rbt_build
from test_torch_build import write_inputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "rowbowt_tpu_torch", "tools")


@pytest.mark.parametrize("script,args,flags", [
    ("fa_to_rowbowt.sh", ["fa", "OUT"], ["--fasta", "fa", "-s", "-l", "-o", "OUT"]),
    ("vcf_to_rowbowt.sh", ["fa", "vcf", "OUT"],
     ["--fasta", "fa", "--vcf", "vcf", "-s", "-m", "-l", "--wsize", "10", "-o", "OUT"]),
    ("vcf_to_rowbowt.sh", ["fa", "vcf", "OUT", "s0,s2", "7"],
     ["--fasta", "fa", "--vcf", "vcf", "-s", "-m", "-l", "--wsize", "7", "-o", "OUT",
      "--samples", "s0,s2"]),
], ids=["fa", "vcf", "vcf_samples_wsize"])
def test_script_writes_rbt_build_artifact(tmp_path, script, args, flags):
    inp = write_inputs(tmp_path)

    def fill(argv, out):
        return [inp.get(a, out if a == "OUT" else a) for a in argv]

    # `python` of the scripts is this interpreter, the repo on its path
    env = dict(os.environ, PYTHONPATH=REPO,
               PATH=os.path.dirname(sys.executable) + os.pathsep + os.environ.get("PATH", ""))
    proc = subprocess.run([os.path.join(TOOLS, script), *fill(args, str(tmp_path / "sh"))],
                          env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert rbt_build.main(fill(flags, str(tmp_path / "cli"))) == 0
    side = ".midx.npz" if "-m" in flags else None
    for out, want in (("sh", "cli"),) + (((f"sh{side}", f"cli{side}"),) if side else ()):
        a, b = str(tmp_path / out), str(tmp_path / want)
        if os.path.isdir(b):
            names = sorted(os.listdir(b))
            assert sorted(os.listdir(a)) == names and names
            match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
            assert match == names, (mismatch, errors)
        else:
            assert filecmp.cmp(a, b, shallow=False)
