#!/bin/sh
# FASTA -> serialized index with locate support, through the port's build CLI
# (scripts/fa_to_rowbowt.sh with rowbowt_tpu_torch.cli.rbt_build: no jax).
# Usage: fa_to_rowbowt.sh <in.fa> <out_prefix>
set -e
exec python -m rowbowt_tpu_torch.cli.rbt_build --fasta "$1" -s -l -o "$2"
