"""The data-movement probe's kernels (P1), counterpart of the Pallas
kernels in ``scripts/probe_mosaic_ops.py`` (``try_kernel``, ``k_dotg``).

:func:`gather` covers the merge and split reshapes and the strided slices
(``csrc/probe.cu``: ``y[r, c] = x[r * row_stride + c * col_stride]``);
:func:`split_contract` is the 3-D split of ``[M * S, C]`` into ``[M, S, C]``
contracted with taps ``[S, C, N]`` over (slot, channel), fp32 sums and a bf16
result.  :func:`reshape` and :func:`strided_slice` name the gathers the probe
runs.  On a CPU tensor each runs its plain version; on a CUDA tensor its
kernel, or raises.  ``apps/probe_ops.py`` drives the seven probe operations.
"""

from __future__ import annotations

import typing as tp

import torch

from . import _build


def _check(x: torch.Tensor, what: str) -> bool:
    """True for a CPU tensor; raise unless a contiguous bf16 CUDA matrix."""
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f"{what} runs on CUDA or CPU tensors, not {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{what} probes bf16, not {x.dtype}")
    if x.device.type == 'cpu':
        return True
    if not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous input")
    return False


def gather_reference(x: torch.Tensor, rows: int, cols: int, row_stride: int,
                     col_stride: int) -> torch.Tensor:
    """Plain version: y[r, c] = x.flatten()[r * row_stride + c * col_stride]."""
    r = torch.arange(rows, device=x.device)[:, None]
    c = torch.arange(cols, device=x.device)[None, :]
    return x.reshape(-1)[r * row_stride + c * col_stride]


def gather(x: torch.Tensor, rows: int, cols: int, row_stride: int,
           col_stride: int) -> torch.Tensor:
    """y [rows, cols] gathered from the contiguous x at r * row_stride +
    c * col_stride (every index must lie inside x)."""
    cpu = _check(x, 'gather')
    if rows < 1 or cols < 1 or row_stride < 0 or col_stride < 0:
        raise ValueError(f"gather of [{rows}, {cols}] with strides {row_stride}, {col_stride}")
    if (rows - 1) * row_stride + (cols - 1) * col_stride >= x.numel():
        raise ValueError(f"gather of [{rows}, {cols}] with strides {row_stride}, {col_stride} "
                         f"reads past the {x.numel()} elements of x")
    if cpu:
        return gather_reference(x, rows, cols, row_stride, col_stride)
    y = torch.empty(rows, cols, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.library().acx_probe_gather(x.data_ptr(), y.data_ptr(), rows, cols,
                                                row_stride, col_stride,
                                                torch.cuda.current_stream().cuda_stream)
    _build.check(err, 'acx_probe_gather')
    gather.launches += 1
    return y


gather.launches = 0  # kernel launches since the last reset


def reshape(x: torch.Tensor, shape: tp.Sequence[int]) -> torch.Tensor:
    """A merge or split reshape of a contiguous array, copied by the gather
    kernel in flat order."""
    shape = tuple(shape)
    n = 1
    for d in shape:
        n *= d
    if n != x.numel():
        raise ValueError(f"cannot reshape {tuple(x.shape)} to {shape}")
    cols = shape[-1]
    return gather(x, n // cols, cols, cols, 1).reshape(shape)


def strided_slice(x: torch.Tensor, row_step: int, col_step: int) -> torch.Tensor:
    """x[::row_step, ::col_step] of a contiguous [R, C] matrix, copied by the
    gather kernel."""
    if x.dim() != 2 or row_step < 1 or col_step < 1:
        raise ValueError(f"strided_slice of {tuple(x.shape)} by {row_step}, {col_step}")
    R, C = x.shape
    return gather(x, -(-R // row_step), -(-C // col_step), row_step * C, col_step)


def split_contract_reference(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Plain version: x [M * S, C] split to [M, S, C], contracted with taps
    [S, C, N] over (S, C) in fp32 -> [M, N] bf16."""
    S, C, N = taps.shape
    m3 = x.float().reshape(-1, S * C)
    return (m3 @ taps.float().reshape(S * C, N)).to(torch.bfloat16)


def split_contract(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """The 3-D split + dot_general of the probe: x [M * S, C], taps [S, C, N]
    -> [M, N], bf16 in and out, fp32 sums."""
    cpu = _check(x, 'split_contract')
    if taps.dim() != 3 or x.dim() != 2 or x.shape[1] != taps.shape[1] \
            or x.shape[0] % taps.shape[0]:
        raise ValueError(f"split_contract of {tuple(x.shape)} with taps {tuple(taps.shape)}")
    if taps.dtype != x.dtype or taps.device != x.device:
        raise ValueError("taps must share x's dtype and device")
    if cpu:
        return split_contract_reference(x, taps)
    S, C, N = taps.shape
    M = x.shape[0] // S
    w = taps.contiguous()
    y = torch.empty(M, N, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.library().acx_probe_contract(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                                  M, S * C, N,
                                                  torch.cuda.current_stream().cuda_stream)
    _build.check(err, 'acx_probe_contract')
    split_contract.launches += 1
    return y


split_contract.launches = 0  # kernel launches since the last reset
