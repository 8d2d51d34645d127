"""Full-sequence self-attention on hand-written CUDA kernels: the forward
(K3f) and its backward (K3b).

Replaces the Pallas flash attention that
``audiocraft_tpu/ops/attention_pallas.py:fused_attention`` runs on the TPU,
forward and custom VJP.  ``csrc/attention.cu`` (K3f) streams key tiles
through a ring in shared memory with an fp32 online softmax, so the
``[B, H, T, T]`` scores never reach device memory, and writes each row's
fp32 log-sum-exp when asked; ``csrc/attention_bwd.cu`` (K3b) recomputes P
from it in two kernels, one for dK and dV and one for dQ.  In bf16 all three
run on the tensor cores and copy rows in 16-byte pieces
(:func:`_rows_on_16_bytes`).  q, k, v and dO are read in the JAX package's
``[B, T, H, D]`` layout by strides (a slice of a fused qkv projection needs
no copy); the ragged tail of T and the causal mask are masked inside the
kernels, so nothing is padded but a head width that is not a multiple of 8
in bf16.  Bounds on an H100 and designs: see the notes at the top of the two
sources.

:func:`plain_attention` is the plain PyTorch version, the twin of the JAX
package's ``_xla_attention`` and ``nn/transformer._attend``: q pre-scaled in
its dtype, fp32 scores, softmax and products, the output cast back.
:func:`attention_lse_reference`, :func:`attention_bwd_dkv_reference` and
:func:`attention_bwd_dq_reference` are the plain versions of the log-sum-exp
and of the two backward kernels.  On a CPU tensor every wrapper runs its
plain version (and :func:`fused_attention` is differentiated by autograd);
on a CUDA tensor it launches its kernel, or raises.  On the card
:func:`fused_attention` is a ``torch.autograd.Function`` whose forward runs
K3f with the log-sum-exp and whose backward runs K3b.
"""

from __future__ import annotations

import ctypes
import math
import typing as tp

import torch

from . import _build

_DTYPES = (torch.float32, torch.bfloat16)

# The widest head the kernels hold (kMaxDim of csrc/attention.cu and
# csrc/attention_bwd.cu; chip_smoke.py checks it against the library), kept
# here so that the route is decided by shape, on any host, before a launch.
MAX_HEAD_DIM = 128


def kernel_route(flag: tp.Union[bool, str], head_dim: tp.Optional[int] = None) -> bool:
    """Resolve an ``attn_kernel`` config flag for a call of ``head_dim``.

    ``'auto'``, ``'auto_local'`` and True take the kernel for every eligible
    call, False keeps the plain masked path.  A call is eligible when its
    head is at most :data:`MAX_HEAD_DIM` wide; a wider one takes the plain
    path by shape (the JAX package zero-pads D to its 128 tile instead, which
    gives the same result).  The JAX package's sequence threshold and
    single-device rule are TPU measurements and a GSPMD rule; no card number
    supports a threshold here yet.
    """
    if head_dim is not None and head_dim > MAX_HEAD_DIM:
        return False
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


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            sm_scale: float) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (q * scale rounded to q's dtype, [B, H, T, D]) and the scores
    [B, H, T, T], -inf at keys after the query when causal."""
    qs = (q * sm_scale).float().transpose(1, 2)
    s = torch.matmul(qs, k.float().permute(0, 2, 3, 1))
    if causal:
        s = s + causal_mask(q.shape[1], q.device)
    return qs, s


def _scale(q: torch.Tensor, sm_scale: tp.Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else float(sm_scale)


def fused_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                              causal: bool,
                              sm_scale: tp.Optional[float] = None) -> torch.Tensor:
    """Plain version of :func:`fused_attention` (``_xla_attention``)."""
    mask = causal_mask(q.shape[1], q.device) if causal else None
    return plain_attention(q, k, v, mask, sm_scale)


def attention_lse_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            causal: bool, sm_scale: tp.Optional[float] = None) -> torch.Tensor:
    """Plain version of K3f's second output: each row's fp32 log-sum-exp of
    the scores, [B, H, T]."""
    return torch.logsumexp(_scores(q, k, causal, _scale(q, sm_scale))[1], dim=-1)


def attention_di(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = rowsum(dO * O) in fp32, [B, H, T] (plain torch, as the JAX
    backward computes it outside its kernels)."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def _recompute(q, k, v, do, lse, di, causal, sm_scale):
    """P and dS as the backward kernels recompute them, fp32 [B, H, T, T].
    For bf16 inputs each is rounded once to bf16, as the kernels round them
    to enter the tensor cores (dS from the unrounded P)."""
    qs, s = _scores(q, k, causal, sm_scale)
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(do.float().transpose(1, 2), v.float().permute(0, 2, 3, 1))
    ds = p * (dp - di[..., None])
    if q.dtype == torch.bfloat16:
        p, ds = p.bfloat16().float(), ds.bfloat16().float()
    return qs, p, ds


def attention_bwd_dkv_reference(q, k, v, do, lse, di, *, causal: bool,
                                sm_scale: tp.Optional[float] = None):
    """Plain version of the dK/dV kernel: (dk, dv) [B, T, H, D] in q's dtype
    from q, k, v, dO [B, T, H, D] and fp32 lse, di [B, H, T]."""
    qs, p, ds = _recompute(q, k, v, do, lse, di, causal, _scale(q, sm_scale))
    dv = torch.matmul(p.transpose(-1, -2), do.float().transpose(1, 2))
    dk = torch.matmul(ds.transpose(-1, -2), qs)
    return dk.transpose(1, 2).to(q.dtype), dv.transpose(1, 2).to(q.dtype)


def attention_bwd_dq_reference(q, k, v, do, lse, di, *, causal: bool,
                               sm_scale: tp.Optional[float] = None) -> torch.Tensor:
    """Plain version of the dQ kernel: dq [B, T, H, D] in q's dtype."""
    scale = _scale(q, sm_scale)
    _, _, ds = _recompute(q, k, v, do, lse, di, causal, scale)
    dq = scale * torch.matmul(ds, k.float().transpose(1, 2))
    return dq.transpose(1, 2).to(q.dtype)


def fused_attention_backward_reference(q, k, v, o, lse, do, *, causal: bool,
                                       sm_scale: tp.Optional[float] = None):
    """Plain version of K3b: (dq, dk, dv) from the forward's o and lse and the
    output gradient dO, with P recomputed in fp32."""
    di = attention_di(o, do)
    dk, dv = attention_bwd_dkv_reference(q, k, v, do, lse, di, causal=causal,
                                         sm_scale=sm_scale)
    dq = attention_bwd_dq_reference(q, k, v, do, lse, di, causal=causal, sm_scale=sm_scale)
    return dq, dk, dv


def _check_cuda(what: str, *xs: torch.Tensor) -> None:
    """Raise unless the [B, T, H, D] tensors suit the CUDA kernels."""
    q = xs[0]
    if q.device.type != 'cuda':
        raise ValueError(f"{what} runs on CUDA or CPU tensors, not {q.device}")
    if q.dim() != 4 or any(x.shape != q.shape for x in xs):
        raise ValueError(f"{what}: q, k, v (and dO) must share one [B, T, H, D] shape "
                         f"(self-attention over the full sequence), not "
                         f"{[tuple(x.shape) for x in xs]}")
    if q.dtype not in _DTYPES or any(x.dtype != q.dtype for x in xs):
        raise ValueError(f"{what} takes fp32 or bf16 inputs of one dtype, not "
                         f"{[x.dtype for x in xs]}")
    if any(x.device != q.device for x in xs):
        raise ValueError(f"{what}: the inputs must be on one device")
    if any(x.stride(3) != 1 for x in xs):
        raise ValueError(f"{what} reads D contiguously")
    B, T, H, D = q.shape
    lib = _build.library()
    if D > lib.acx_attention_max_dim():
        raise ValueError(f"head dim {D} is wider than the attention kernels' "
                         f"{lib.acx_attention_max_dim()}")
    if B > 65535 or H > 65535 or B * T * H * D >= 2 ** 62:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the attention kernels' grid")


def _strides(*xs: torch.Tensor) -> tp.List[int]:
    return [s for x in xs for s in (x.stride(0), x.stride(1), x.stride(2))]


def _launch(fn, x: torch.Tensor, *args) -> int:
    """Call a kernel entry point on x's device and its current stream."""
    with torch.cuda.device(x.device):
        return fn(*args, torch.cuda.current_stream().cuda_stream)


def _check_stats(q: torch.Tensor, *stats: torch.Tensor) -> None:
    B, T, H, _ = q.shape
    for x in stats:
        if x.shape != (B, H, T) or x.dtype != torch.float32 or not x.is_contiguous() \
                or x.device != q.device:
            raise ValueError(f"lse and di must be contiguous fp32 [B, H, T] = {(B, H, T)} on "
                             f"{q.device}, not {tuple(x.shape)} {x.dtype} on {x.device}")


def _rows_on_16_bytes(*xs: torch.Tensor) -> tp.List[torch.Tensor]:
    """The bf16 kernels and the fp32 forward copy rows in 16-byte pieces
    (``n`` = 8 bf16 or 4 fp32 elements).  Views whose rows all start on 16
    bytes (D a multiple of n, strides multiples of n elements, an aligned
    start) pass as they are, the fused qkv projection's slices among them;
    any other is copied to a fresh contiguous tensor, with D zero-padded to a
    multiple of n (zero features add nothing to s or dP, and the outputs and
    gradients of the padding are dropped)."""
    n = 16 // xs[0].element_size()
    pad = -xs[0].shape[-1] % n
    out = []
    for x in xs:
        if pad:
            x = torch.nn.functional.pad(x, (0, pad))
        elif x.data_ptr() % 16 or any(s % n for s in x.stride()[:3]):
            x = x.clone(memory_format=torch.contiguous_format)
        out.append(x)
    return out


# K3f's fp32 kernel (csrc/attention.cu:flash_fwd_f32_kernel): query rows of a
# block, keys of a streamed tile, threads
F32_ROWS, F32_KEYS, F32_THREADS = 64, 32, 128
SMEM_LIMIT = 232448   # shared bytes an H100 block may take


def fwd_f32_geometry(dim: int) -> tp.Dict[str, int]:
    """The fp32 forward's block for heads of ``dim`` (held in a width class
    of 32, 64 or 128 features, as ``by_width`` picks it): its rows, keys a
    tile, threads and shared bytes (q^T [DP][64], two stages of K [32][DP]
    and V [32][DP], each warp's P^T [32 keys][16 rows]; K swizzled, not
    padded; csrc/attention.cu:smem_floats_f32 computes the same, and
    chip_smoke.py holds the two equal on the card)."""
    if not 0 < dim <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {dim} is outside 1 .. {MAX_HEAD_DIM}")
    dp = 32 if dim <= 32 else 64 if dim <= 64 else 128
    floats = dp * F32_ROWS + 2 * F32_KEYS * 2 * dp + (F32_THREADS // 32) * F32_KEYS * 16
    return dict(width=dp, rows=F32_ROWS, keys=F32_KEYS, threads=F32_THREADS,
                shared_bytes=4 * floats)


def _backward_launch(name: str, q, k, v, do, lse, di, n_out: int, causal: bool,
                     sm_scale: float) -> tp.List[torch.Tensor]:
    """Launch one backward kernel: n_out gradients [B, T, H, D] in q's dtype."""
    _check_cuda('the attention backward', q, k, v, do)
    _check_stats(q, lse, di)
    D = q.shape[-1]
    if q.dtype == torch.bfloat16:
        q, k, v, do = _rows_on_16_bytes(q, k, v, do)
    outs = [torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(n_out)]
    if q.numel() == 0:
        return [x[..., :D] for x in outs]
    B, T, H, Dk = q.shape
    err = _launch(
        getattr(_build.library(), name), q,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        di.data_ptr(), *(x.data_ptr() for x in outs), B, T, H, Dk, *_strides(q, k, v, do),
        sm_scale, int(causal), int(q.dtype == torch.bfloat16))
    _build.check(err, name)
    return [x[..., :D] for x in outs]


def attention_bwd_kernel_info(dim: int, dtype: torch.dtype) -> tp.Dict[str, tp.Dict[str, int]]:
    """What the dK/dV and dQ kernels for head width ``dim`` and ``dtype`` use
    on the current card (``cudaFuncGetAttributes`` and the occupancy API):
    registers per thread, shared memory per block in bytes, blocks resident
    per SM, threads per block and spilled bytes per thread."""
    lib = _build.library()
    info = {}
    for name, dkv in (('dkv', 1), ('dq', 0)):
        out = (ctypes.c_int * 5)()
        _build.check(lib.acx_attention_bwd_info(dkv, dim, int(dtype == torch.bfloat16), out),
                     'acx_attention_bwd_info')
        info[name] = dict(zip(('registers', 'shared_bytes', 'blocks_per_sm', 'threads',
                               'spill_bytes'), out))
    return info


def fused_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             causal: bool, sm_scale: tp.Optional[float] = None
                             ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """K3f with its log-sum-exp: (o [B, T, H, D] in q's dtype, lse fp32
    [B, H, T]).  Not differentiable; :func:`fused_attention` is."""
    sm_scale = _scale(q, sm_scale)
    if q.device.type == 'cpu':
        return (fused_attention_reference(q, k, v, causal=causal, sm_scale=sm_scale),
                attention_lse_reference(q, k, v, causal=causal, sm_scale=sm_scale))
    return _forward_kernel(q, k, v, causal, sm_scale, with_lse=True)


def _forward_kernel(q, k, v, causal: bool, sm_scale: float, with_lse: bool):
    """Launch K3f: (o [B, T, H, D] in q's dtype, lse fp32 [B, H, T] or None)."""
    _check_cuda('the attention kernel', q, k, v)
    B, T, H, D = q.shape
    bf16 = q.dtype == torch.bfloat16
    q, k, v = _rows_on_16_bytes(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device) if with_lse else None
    if T == 0 or B == 0 or H == 0:
        return out[..., :D], lse
    err = _launch(
        _build.library().acx_attention_fwd, q,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, T, H, q.shape[-1], *_strides(q, k, v),
        sm_scale, int(causal), int(bf16))
    _build.check(err, 'acx_attention_fwd')
    fused_attention.launches += 1
    if not bf16:
        fused_attention.fp32_launches += 1
    return out[..., :D], lse


def attention_fwd_kernel_info(dim: int, dtype: torch.dtype) -> tp.Dict[str, int]:
    """What the forward kernel for head width ``dim`` and ``dtype`` uses on
    the current card, as :func:`attention_bwd_kernel_info` reports it."""
    out = (ctypes.c_int * 5)()
    _build.check(_build.library().acx_attention_fwd_info(
        dim, int(dtype == torch.bfloat16), out), 'acx_attention_fwd_info')
    return dict(zip(('registers', 'shared_bytes', 'blocks_per_sm', 'threads', 'spill_bytes'),
                    out))


def attention_bwd_dkv(q, k, v, do, lse, di, *, causal: bool,
                      sm_scale: tp.Optional[float] = None):
    """K3b's dK/dV kernel: (dk, dv) [B, T, H, D] in q's dtype from q, k, v,
    dO [B, T, H, D] and fp32 lse, di [B, H, T]."""
    sm_scale = _scale(q, sm_scale)
    if q.device.type == 'cpu':
        return attention_bwd_dkv_reference(q, k, v, do, lse, di, causal=causal,
                                           sm_scale=sm_scale)
    dk, dv = _backward_launch('acx_attention_bwd_dkv', q, k, v, do, lse, di, 2, causal,
                              sm_scale)
    attention_bwd_dkv.launches += 1
    attention_bwd_dkv.fp32_launches += q.dtype == torch.float32
    return dk, dv


def attention_bwd_dq(q, k, v, do, lse, di, *, causal: bool,
                     sm_scale: tp.Optional[float] = None) -> torch.Tensor:
    """K3b's dQ kernel: dq [B, T, H, D] in q's dtype."""
    sm_scale = _scale(q, sm_scale)
    if q.device.type == 'cpu':
        return attention_bwd_dq_reference(q, k, v, do, lse, di, causal=causal,
                                          sm_scale=sm_scale)
    dq, = _backward_launch('acx_attention_bwd_dq', q, k, v, do, lse, di, 1, causal, sm_scale)
    attention_bwd_dq.launches += 1
    attention_bwd_dq.fp32_launches += q.dtype == torch.float32
    return dq


def fused_attention_backward(q, k, v, o, lse, do, *, causal: bool,
                             sm_scale: tp.Optional[float] = None):
    """K3b: (dq, dk, dv) from the forward's o and lse and the output gradient
    dO: di in plain torch, then the dK/dV and the dQ kernels."""
    do = do if do.stride(-1) == 1 else do.contiguous()
    di = attention_di(o, do)
    dk, dv = attention_bwd_dkv(q, k, v, do, lse, di, causal=causal, sm_scale=sm_scale)
    dq = attention_bwd_dq(q, k, v, do, lse, di, causal=causal, sm_scale=sm_scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K3f forward with the log-sum-exp saved; K3b backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        out, lse = _forward_kernel(q, k, v, causal, sm_scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = fused_attention_backward(q, k, v, out, lse, do, causal=ctx.causal,
                                              sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                    sm_scale: tp.Optional[float] = None) -> torch.Tensor:
    """Self-attention over a full sequence: q, k, v [B, T, H, D], fp32 or bf16,
    with a contiguous last axis -> [B, T, H, D] in q's dtype.  Differentiable:
    on the card the gradient comes from the K3b kernels."""
    sm_scale = _scale(q, sm_scale)
    if q.device.type == 'cpu':
        return fused_attention_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, sm_scale)
    return _forward_kernel(q, k, v, causal, sm_scale, with_lse=False)[0]


# kernel launches since the last reset (and of them, the fp32 FMA kernels')
fused_attention.launches = fused_attention.fp32_launches = 0         # K3f
attention_bwd_dkv.launches = attention_bwd_dkv.fp32_launches = 0     # K3b, dK and dV
attention_bwd_dq.launches = attention_bwd_dq.fp32_launches = 0       # K3b, dQ
