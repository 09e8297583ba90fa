"""Adjacent-unique mask over lexsorted (N, C) rows: wrapper over
``csrc/unique_mask.cu``.

Replaces the Pallas kernel ``unique_mask`` (``src/repro/kernels/
unique_mask.py``, body ``_unique_kernel``).

Bound on the card: device-memory bytes, one read of the rows and one int32
write per row.  One thread per row reads row i-1 in place, so no shifted
copy of the input is made (the reference builds one to feed its block
specs), and neighbouring threads read neighbouring rows.  Written in CUDA
C++ like the other kernels, so that all four build as one library.
"""
from __future__ import annotations

import torch

from repro_torch.analysis import cost as _cost
from repro_torch.kernels import build, ref

# kernel launches since the last reset (``kernels.ops.reset_launch_counts``)
LAUNCHES = {"unique_mask": 0}


@_cost.counted("unique_mask", _cost.unique_mask_cost)
def unique_mask(data: torch.Tensor) -> torch.Tensor:
    """data: (N, C) int16/int32/int64 lexsorted, PAD rows last.  Returns
    (N,) int32: 1 where a valid row differs from the row before it."""
    if data.dim() != 2 or data.shape[1] < 1:
        raise ValueError(f"rows must be (N, C>=1), got {tuple(data.shape)}")
    if data.dtype not in build.KEY_CODES:
        raise TypeError(f"rows must be int16/int32/int64, got {data.dtype}")
    if data.device.type == "cpu":
        return ref.unique_mask_ref(data)
    if data.device.type != "cuda" or not data.is_contiguous():
        raise ValueError("rows must be a contiguous CPU or CUDA tensor")
    out = torch.empty(data.shape[0], dtype=torch.int32, device=data.device)
    if data.shape[0]:
        build.launch("rt_unique_mask", data.device,
                     build.KEY_CODES[data.dtype], data.data_ptr(),
                     out.data_ptr(), data.shape[0], data.shape[1])
        LAUNCHES["unique_mask"] += 1
    return out
