"""Residual-VQ encode on a hand-written CUDA kernel (K1).

Replaces ``audiocraft_tpu/ops/rvq_pallas.py:_rvq_kernel`` with
``csrc/rvq.cu``: for each of ``n_q`` codebooks, fp32 distances, a
first-index argmax and ``r <- r - E[idx]``, with the residual kept in shared
memory across the whole chain.  Bound on an H100 and design: see the note at
the top of ``csrc/rvq.cu`` (fp32 FMA bound; TF32 is ruled out because it
changes tokens).

On a CPU tensor :func:`rvq_encode` runs :func:`rvq_encode_reference`, the
plain version with the same distance expression and tie-break; on a CUDA
tensor it launches the kernel, or raises.
"""

from __future__ import annotations

import torch

from ..quant.codebook import dequantize, quantize
from . import _build


def rvq_encode_reference(x: torch.Tensor, embeds: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x [N, D], embeds [n_q, K, D] -> codes [n_q, N] int32."""
    residual = x.float()
    codes = []
    for embed in embeds.float():
        idx = quantize(residual, embed)
        residual = residual - dequantize(idx, embed)
        codes.append(idx)
    return torch.stack(codes)


def rvq_encode(x: torch.Tensor, embeds: torch.Tensor) -> torch.Tensor:
    """Residual VQ encode: x [N, D] fp32, embeds [n_q, K, D] fp32 -> codes
    [n_q, N] int32, both inputs contiguous on one device."""
    if x.device.type == 'cpu':
        return rvq_encode_reference(x, embeds)
    if x.device.type != 'cuda':
        raise ValueError(f"rvq_encode runs on CUDA or CPU tensors, not {x.device}")
    if x.dim() != 2 or embeds.dim() != 3 or embeds.shape[2] != x.shape[1]:
        raise ValueError(f"shapes {tuple(x.shape)} and {tuple(embeds.shape)} are not "
                         "[N, D] and [n_q, K, D]")
    if x.dtype != torch.float32 or embeds.dtype != torch.float32:
        raise ValueError("the RVQ kernel takes fp32 inputs: distances stay fp32")
    if embeds.device != x.device:
        raise ValueError("x and embeds must be on one device")
    if not (x.is_contiguous() and embeds.is_contiguous()):
        raise ValueError("the RVQ kernel takes contiguous inputs")
    n, d = x.shape
    n_q, k, _ = embeds.shape
    lib = _build.library()
    if d > lib.acx_rvq_max_dim():
        raise ValueError(f"D={d} is wider than the RVQ kernel's {lib.acx_rvq_max_dim()}")
    if max(n * d, n_q * k * d, n_q * n) >= 2 ** 31:
        raise ValueError("input too large for the RVQ kernel's int sizes")
    codes = torch.empty(n_q, n, dtype=torch.int32, device=x.device)
    if n == 0 or n_q == 0:
        return codes
    esq = embeds.square().sum(-1).contiguous()  # |E|^2 in plain torch, as the JAX wrapper
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.acx_rvq_encode(x.data_ptr(), embeds.data_ptr(), esq.data_ptr(),
                                 codes.data_ptr(), n, d, k, n_q, stream)
    _build.check(err, 'acx_rvq_encode')
    rvq_encode.launches += 1
    return codes


rvq_encode.launches = 0  # kernel launches since the last reset
