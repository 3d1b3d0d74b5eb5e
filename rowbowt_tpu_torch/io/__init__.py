from rowbowt_tpu_torch.io.fastq import read_seqs  # noqa: F401
