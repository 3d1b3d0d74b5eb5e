#!/bin/sh
# FASTA+VCF -> haplotype-panel index with markers + locate, through the port's
# build CLI (scripts/vcf_to_rowbowt.sh with rowbowt_tpu_torch.cli.rbt_build:
# no jax).
# Usage: vcf_to_rowbowt.sh <in.fa> <in.vcf.gz> <out_prefix> [samples] [wsize]
set -e
FA=$1; VCF=$2; OUT=$3; SAMPLES=${4:-}; WSIZE=${5:-10}
ARGS="--fasta $FA --vcf $VCF -s -m -l --wsize $WSIZE -o $OUT"
[ -n "$SAMPLES" ] && ARGS="$ARGS --samples $SAMPLES"
exec python -m rowbowt_tpu_torch.cli.rbt_build $ARGS
