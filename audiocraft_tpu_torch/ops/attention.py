"""Full-sequence self-attention on a hand-written CUDA kernel (K3 forward).

Replaces the Pallas flash-attention forward that
``audiocraft_tpu/ops/attention_pallas.py:fused_attention`` runs on the TPU
with ``csrc/attention.cu``: an fp32 online softmax over key tiles streamed
through shared memory, so the ``[B, H, T, T]`` scores never reach device
memory; bf16 inputs run on the tensor cores, fp32 inputs on fp32 FMA.  q, k
and v are read in the JAX package's ``[B, T, H, D]`` layout by strides (a
slice of a fused qkv projection needs no copy); the ragged tail of T and the
causal mask are masked inside the kernel, so nothing is padded.  Bound on an
H100 and design: see the note at the top of ``csrc/attention.cu``.

:func:`plain_attention` is the plain PyTorch version, the twin of the JAX
package's ``_xla_attention`` and ``nn/transformer._attend``: q pre-scaled in
its dtype, fp32 scores, softmax and products, the output cast back.
:func:`fused_attention` runs it on a CPU tensor; on a CUDA tensor it
launches the kernel, or raises.
"""

from __future__ import annotations

import math
import typing as tp

import torch

from . import _build

_DTYPES = (torch.float32, torch.bfloat16)


def kernel_route(flag: tp.Union[bool, str]) -> bool:
    """Resolve an ``attn_kernel`` config flag.

    ``'auto'``, ``'auto_local'`` and True take the kernel for every eligible
    call, False keeps the plain masked path.  The JAX package's sequence
    threshold and single-device rule are TPU measurements and a GSPMD rule;
    no card number supports a threshold here yet.
    """
    if flag in ('auto', 'auto_local'):
        return True
    return bool(flag)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: tp.Optional[torch.Tensor] = None,
                    sm_scale: tp.Optional[float] = None) -> torch.Tensor:
    """q [B, Tq, H, D], k/v [B, Tk, H, D], ``mask`` an additive fp32 bias
    broadcastable to [B, H, Tq, Tk] -> [B, Tq, H, D] in q's dtype."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    qf = (q * sm_scale).float().transpose(1, 2)               # [B, H, Tq, D]
    logits = torch.matmul(qf, k.float().permute(0, 2, 3, 1))  # [B, H, Tq, Tk]
    if mask is not None:
        logits = logits + mask
    w = torch.softmax(logits, dim=-1)
    out = torch.matmul(w, v.float().transpose(1, 2))          # [B, H, Tq, D]
    return out.transpose(1, 2).to(q.dtype)


def additive_mask(valid: torch.Tensor) -> torch.Tensor:
    """[Tq, Tk] bool -> additive fp32 [1, 1, Tq, Tk] bias: 0 where valid, -inf elsewhere."""
    return torch.where(valid, 0.0, float('-inf'))[None, None]


def causal_mask(t: int, device: torch.device,
                past_context: tp.Optional[int] = None) -> torch.Tensor:
    """Additive [1, 1, T, T] bias: 0 where the key is not after the query (and,
    with ``past_context``, at most that many steps before it)."""
    pos = torch.arange(t, device=device)
    delta = pos[:, None] - pos[None, :]
    valid = delta >= 0
    if past_context is not None:
        valid &= delta <= past_context
    return additive_mask(valid)


def fused_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                              causal: bool,
                              sm_scale: tp.Optional[float] = None) -> torch.Tensor:
    """Plain version of :func:`fused_attention` (``_xla_attention``)."""
    mask = causal_mask(q.shape[1], q.device) if causal else None
    return plain_attention(q, k, v, mask, sm_scale)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                    sm_scale: tp.Optional[float] = None) -> torch.Tensor:
    """Self-attention over a full sequence: q, k, v [B, T, H, D], fp32 or bf16,
    with a contiguous last axis -> [B, T, H, D] in q's dtype."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == 'cpu':
        return fused_attention_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    if q.device.type != 'cuda':
        raise ValueError(f"fused_attention runs on CUDA or CPU tensors, not {q.device}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [B, T, H, D] shape (self-attention over "
                         f"the full sequence), not {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the attention kernel takes fp32 or bf16 q, k, v of one dtype, not "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("the attention kernel reads D contiguously")
    B, T, H, D = q.shape
    lib = _build.library()
    if D > lib.acx_attention_max_dim():
        raise ValueError(f"head dim {D} is wider than the attention kernel's "
                         f"{lib.acx_attention_max_dim()}")
    if B > 65535 or H > 65535 or B * T * H * D >= 2 ** 62:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the attention kernel's grid")
    out = torch.empty(B, T, H, D, dtype=q.dtype, device=q.device)
    if T == 0 or B == 0 or H == 0:
        return out
    strides = [s for x in (q, k, v) for s in (x.stride(0), x.stride(1), x.stride(2))]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.acx_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                    B, T, H, D, *strides, float(sm_scale), int(causal),
                                    int(q.dtype == torch.bfloat16), stream)
    _build.check(err, 'acx_attention_fwd')
    fused_attention.launches += 1
    return out


fused_attention.launches = 0  # kernel launches since the last reset
