"""The data-movement probe's kernels (P1), counterpart of the Pallas
kernels in ``scripts/probe_mosaic_ops.py`` (``try_kernel``, ``k_dotg``).

:func:`gather` covers the merge and split reshapes and the strided slices
(``csrc/probe.cu``: ``y[r, c] = x[r * row_stride + c * col_stride]``, by
16-byte vectors where :func:`gather_plan` allows);
:func:`split_contract` is the 3-D split of ``[M * S, C]`` into ``[M, S, C]``
contracted with taps ``[S, C, N]`` over (slot, channel), fp32 sums and a bf16
result (on the tensor cores where :func:`contract_plan` allows).
:func:`reshape` and :func:`strided_slice` name the gathers the probe runs.
On a CPU tensor each runs its plain version; on a CUDA tensor its kernel, or
raises.  ``apps/probe_ops.py`` drives the seven probe operations.
"""

from __future__ import annotations

import functools
import math
import typing as tp

import torch

from . import _build


@functools.cache
def _entry_points() -> tp.Tuple[tp.Callable, tp.Callable]:
    """The two C entries, fetched from the built library once."""
    lib = _build.library()
    return lib.acx_probe_gather, lib.acx_probe_contract


def _launch(entry: int, x: torch.Tensor, args: tuple, what: str) -> None:
    """Call C entry ``entry`` (0 gather, 1 contract) on the current stream of
    x's card, entering that card only when it is not the current device;
    raise if the launch returned an error."""
    fn, index = _entry_points()[entry], x.device.index
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err:
        _build.check(err, what)


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


def gather_plan(rows: int, cols: int, row_stride: int, col_stride: int, numel: int,
                offset: int = 0) -> tp.Tuple[int, int, int, int]:
    """How the gather kernel copies ``y[r, c] = x[r * row_stride + c *
    col_stride]``: ``(vector, rows, cols, row_stride)``.

    Rows that follow each other in x (``row_stride == cols``, column stride
    1) merge into one row, so a flat copy needs only its count to be a
    multiple of 8.  ``vector`` k > 0: each thread reads k 16-byte vectors of
    a row of x and stores one of y, every k-th element (k is the column
    stride: 1, 2, 4 or 8); that needs x on 16 bytes (``offset``, its address
    modulo 16, is 0), cols and row_stride multiples of 8, the last row's k *
    cols elements inside x's ``numel`` and fewer than 2^31 elements.
    ``vector`` 0: one element a thread."""
    if col_stride == 1 and row_stride == cols and rows * cols < 2 ** 31:
        rows, cols, row_stride = 1, rows * cols, rows * cols
    k = col_stride
    vector = (k in (1, 2, 4, 8) and offset % 16 == 0 and cols % 8 == 0
              and row_stride % 8 == 0 and (rows - 1) * row_stride + cols * k <= numel
              and rows * cols < 2 ** 31)
    return (k if vector else 0), rows, cols, row_stride


def gather(x: torch.Tensor, rows: int, cols: int, row_stride: int,
           col_stride: int) -> torch.Tensor:
    """y [rows, cols] gathered from the contiguous x at r * row_stride +
    c * col_stride (every index must lie inside x)."""
    return _gather(x, rows, cols, row_stride, col_stride, (rows, cols))


def _gather(x: torch.Tensor, rows: int, cols: int, row_stride: int, col_stride: int,
            shape: tp.Tuple[int, ...]) -> torch.Tensor:
    """:func:`gather`, its output allocated as ``shape`` (rows * cols elements)."""
    cpu = _check(x, 'gather')
    if rows < 1 or cols < 1 or row_stride < 0 or col_stride < 0:
        raise ValueError(f"gather of [{rows}, {cols}] with strides {row_stride}, {col_stride}")
    if (rows - 1) * row_stride + (cols - 1) * col_stride >= x.numel():
        raise ValueError(f"gather of [{rows}, {cols}] with strides {row_stride}, {col_stride} "
                         f"reads past the {x.numel()} elements of x")
    if cpu:
        return gather_reference(x, rows, cols, row_stride, col_stride).reshape(shape)
    y = torch.empty(shape, dtype=x.dtype, device=x.device)
    vector, r, c, rs = gather_plan(rows, cols, row_stride, col_stride, x.numel(),
                                   x.data_ptr() % 16)
    _launch(0, x, (x.data_ptr(), y.data_ptr(), r, c, rs, col_stride, vector),
            'acx_probe_gather')
    gather.launches += 1
    return y


gather.launches = 0  # kernel launches since the last reset


def reshape(x: torch.Tensor, shape: tp.Sequence[int]) -> torch.Tensor:
    """A merge or split reshape of a contiguous array, copied by the gather
    kernel in flat order."""
    shape = tuple(shape)
    n = math.prod(shape)
    if n != x.numel():
        raise ValueError(f"cannot reshape {tuple(x.shape)} to {shape}")
    cols = shape[-1]
    return _gather(x, n // cols, cols, cols, 1, shape)


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


def contract_plan(depth: int, n_cols: int, x_offset: int = 0, taps_offset: int = 0) -> int:
    """1 where the contraction runs on the tensor cores (depth a multiple of
    16 up to 512, the probe's 32 columns, x and taps on 16 bytes: their
    addresses modulo 16 are 0), else 0: one output a thread on fp32 FMA."""
    return int(depth % 16 == 0 and depth <= 512 and n_cols == 32
               and x_offset % 16 == 0 and taps_offset % 16 == 0)


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
    mma = contract_plan(S * C, N, x.data_ptr() % 16, w.data_ptr() % 16)
    _launch(1, x, (x.data_ptr(), w.data_ptr(), y.data_ptr(), M, S * C, N, mma),
            'acx_probe_contract')
    split_contract.launches += 1
    return y


split_contract.launches = 0  # kernel launches since the last reset
