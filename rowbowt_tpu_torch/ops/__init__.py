"""Batched device ops: plain torch rank/LF primitives and the CUDA LF kernel.

Import the module, not the functions: `from rowbowt_tpu_torch.ops import rank as R`
(keeps the `rank` submodule addressable despite its `rank_*` functions).
"""
