"""rowbowt_tpu_torch: the PyTorch + CUDA port of rowbowt-tpu.

The same pangenome r-index query engine as `rowbowt_tpu`, for an NVIDIA
Hopper GPU: host code is numpy, device code is torch on an explicit device,
and the LF loop of the count path is a hand-written CUDA kernel
(ops/cuda_lf.py, csrc/lf.cu).  It reads and writes the JAX package's on-disk
index artifact, imports neither jax nor rowbowt_tpu, and mirrors the JAX
package's module names, so each counterpart is found by path.
"""

from rowbowt_tpu_torch.alphabet import Alphabet, TERM_BYTE, SEP_BYTE
from rowbowt_tpu_torch.index import RbtIndex

__version__ = "0.1.0"

__all__ = [
    "Alphabet",
    "RbtIndex",
    "TERM_BYTE",
    "SEP_BYTE",
    "__version__",
]
