"""Arithmetic precisions of the plain references.

Every reference computes its products through :class:`Precision`:

* ``fp32``: float32 operands and sums, TF32 off for matmuls and cuDNN
  convolutions (the default, the reference's own precision);
* ``tf32``: the same with TF32 on, the control for a float32 stage;
* ``bf16``: operands rounded to bfloat16, float32 sums;
* ``fp8``: operands rounded to float8 e4m3 with a power-of-two scale per
  tensor (its largest magnitude brought under 448), float32 sums: the
  control for a bfloat16 stage.

Rounding the operands and summing in float32 is what a tensor-core product of
that input type does, so the controls need no kernel of their own.
"""

from __future__ import annotations

import contextlib
import math
import typing as tp

import torch
import torch.nn.functional as F

PRECISIONS = ('fp32', 'tf32', 'bf16', 'fp8')
_FP8_MAX = 448.0


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    amax = float(x.detach().abs().max()) if x.numel() else 0.0
    if amax == 0.0 or not math.isfinite(amax):
        return x
    scale = 2.0 ** math.floor(math.log2(_FP8_MAX / amax))
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class Precision:
    """Operand rounding and the TF32 switches of one precision."""

    def __init__(self, name: str = 'fp32'):
        if name not in PRECISIONS:
            raise ValueError(f'precision {name!r}: one of {PRECISIONS}')
        self.name = name

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as a product's operand: float32 holding the rounded values."""
        x = x.float()
        if self.name == 'bf16':
            return x.to(torch.bfloat16).float()
        if self.name == 'fp8':
            return _round_fp8(x)
        return x

    @contextlib.contextmanager
    def context(self) -> tp.Iterator[None]:
        """TF32 on for ``tf32``, off otherwise; the flags are restored on exit."""
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        on = self.name == 'tf32'
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.operand(a), self.operand(b))

    def linear(self, x: torch.Tensor, w: torch.Tensor,
               b: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        y = F.linear(self.operand(x), self.operand(w))
        return y if b is None else y + b.float()

    def conv1d(self, x: torch.Tensor, w: torch.Tensor, b: tp.Optional[torch.Tensor],
               stride: int = 1, dilation: int = 1) -> torch.Tensor:
        return F.conv1d(self.operand(x), self.operand(w),
                        None if b is None else b.float(), stride=stride, dilation=dilation)

    def conv_transpose1d(self, x: torch.Tensor, w: torch.Tensor, b: tp.Optional[torch.Tensor],
                         stride: int) -> torch.Tensor:
        return F.conv_transpose1d(self.operand(x), self.operand(w),
                                  None if b is None else b.float(), stride=stride)
