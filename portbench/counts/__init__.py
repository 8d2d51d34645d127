"""Operations and bytes of the port's kernels and model steps, from shapes.

The peaks are NVIDIA's data sheet for one H100 SXM at its 700 W power limit
(dense, no sparsity): 989 TFLOP/s on the tensor cores in bf16, 67 TFLOP/s in
float32 outside them, 3.35 TB/s of HBM3.  A card set below 700 W reaches
less; the result line gives the card's limit beside every number.

A kernel's least time is the larger of its operations over the peak of its
dtype and its bytes over the bandwidth, each input byte read once and each
output byte written once (``Work.bound_s``).
"""

from __future__ import annotations

import dataclasses

PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


@dataclasses.dataclass(frozen=True)
class Work:
    ops: float
    nbytes: float
    peak_ops: float

    def bound_s(self) -> float:
        return max(self.ops / self.peak_ops, self.nbytes / PEAK_BYTES)

    def bound_by(self) -> str:
        return 'operations' if self.ops / self.peak_ops >= self.nbytes / PEAK_BYTES else 'bytes'
