"""TorchIndex: the device-resident view of an RbtIndex.

The counterpart of rowbowt_tpu/engine/device.py:DeviceIndex.  Its tensors are
the flat sorted tables of `RbtIndex.device_arrays()` (same names, same
dtypes), all on one explicit `device`; the static metadata (sizes, ftab k,
window size, the codes of A/C/G/T) rides beside them as plain ints.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rowbowt_tpu_torch.index import RbtIndex


@dataclasses.dataclass
class TorchIndex:
    arrays: dict[str, torch.Tensor]
    n: int
    R: int
    A: int
    ma_wsize: int
    ftab_k: int
    acgt_codes: tuple  # index codes of A,C,G,T (-1 entries when absent)
    device: torch.device

    @property
    def idx_dtype(self) -> torch.dtype:
        return self.arrays["F"].dtype

    @property
    def has_sa(self) -> bool:
        return "samples_last" in self.arrays

    @property
    def has_ma(self) -> bool:
        return "ma_val" in self.arrays

    @property
    def has_ftab(self) -> bool:
        return "ftab" in self.arrays

    @staticmethod
    def from_arrays(arrays: dict[str, np.ndarray], *, n: int, R: int, A: int,
                    ma_wsize: int, ftab_k: int, acgt_codes, device) -> "TorchIndex":
        """Tensors on `device` from numpy leaves, keeping each leaf's dtype —
        e.g. a JAX DeviceIndex's `{k: np.asarray(v) for k, v in dx.arrays.items()}`."""
        device = torch.device(device)
        tensors = {k: torch.from_numpy(np.require(v, requirements=["C", "W"])).to(device)
                   for k, v in arrays.items()}
        return TorchIndex(
            arrays=tensors,
            n=int(n),
            R=int(R),
            A=int(A),
            ma_wsize=int(ma_wsize),
            ftab_k=int(ftab_k),
            acgt_codes=tuple(int(c) for c in acgt_codes),
            device=device,
        )

    @staticmethod
    def from_index(idx: RbtIndex, device, fb64: bool | None = None) -> "TorchIndex":
        """fb64=None or True repacks the 96B fblock rows into the 64-symbol/64B
        rows (`fblock64`), the count path's default layout; the on-disk
        artifact always stores the 96B rows, so the repack is load-time only.
        fb64=False keeps the 96B rows.  Only one layout is ever resident."""
        arrs_np = dict(idx.device_arrays())
        if fb64 is not False and "fblock" in arrs_np:
            from rowbowt_tpu_torch.construct.build import fblock_to_fb64

            arrs_np["fblock64"] = fblock_to_fb64(arrs_np.pop("fblock"), idx.n)
        acgt_np = idx.alpha.encode(np.frombuffer(b"ACGT", dtype=np.uint8))
        return TorchIndex.from_arrays(
            arrs_np,
            n=idx.n,
            R=idx.R,
            A=idx.A,
            ma_wsize=idx.ma_wsize,
            ftab_k=idx.ftab_k,
            acgt_codes=acgt_np,
            device=device,
        )
