"""Residual-VQ encode on a hand-written CUDA kernel (K1).

Replaces ``audiocraft_tpu/ops/rvq_pallas.py:_rvq_kernel`` with
``csrc/rvq.cu``: for each of ``n_q`` codebooks, fp32 distances, a
first-index argmax and ``r <- r - E[idx]``, with the residual kept in shared
memory across the whole chain, for rows of up to ``acx_rvq_max_dim()`` =
1024 features (the style conditioner's widest).  Bound on an H100 and
design: see the note at the top of ``csrc/rvq.cu`` (fp32 FMA bound; TF32 is
ruled out because it changes tokens).

The launch plan (rows a block, codes a tile, the ring of codebook chunks,
shared bytes) is decided here by :func:`rvq_plan`; the C entry computes it
again and refuses a plan that disagrees.  :func:`pack_codebooks` lays the
codebooks out as the kernel streams them, transposed and padded, on every
call (4 MiB at the codec's sizes), so a changed codebook always gives codes
of its own.

On a CPU tensor :func:`rvq_encode` runs :func:`rvq_encode_reference`, the
plain version with the same distance expression and tie-break; on a CUDA
tensor it launches the kernel, or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import typing as tp

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


def _check(x: torch.Tensor, embeds: torch.Tensor) -> None:
    """Raise on what the kernel does not take (a CUDA tensor's checks)."""
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
    max_dim = _build.library().acx_rvq_max_dim()
    if d > max_dim:
        raise ValueError(f"D={d} is wider than the RVQ kernel's {max_dim}")
    if max(n * d, n_q * k * d, n_q * n) >= 2 ** 31:
        raise ValueError("input too large for the RVQ kernel's int sizes")


THREADS = 256       # csrc/rvq.cu:kRvqThreads
TILE = 8            # rows and codes of a thread's register tile (csrc/rvq.cu:kTile)
CHUNK = 16          # features per streamed chunk (csrc/rvq.cu:kChunk)
STAGES = 3          # chunks in the ring (csrc/rvq.cu:kStages)
SMEM_LIMIT = 232448  # shared bytes an H100 block may take (csrc/rvq.cu:kRvqSmemLimit)


@dataclasses.dataclass(frozen=True)
class RvqPlan:
    rows: int        # residual rows a block keeps in shared memory
    codes: int       # codes a tile: the 256 threads' 8 x 8 tiles cover rows x codes
    chunk: int       # features per streamed chunk of E^T
    stages: int      # chunks in the ring
    smem_bytes: int

    def args(self) -> ctypes.Array:
        return (ctypes.c_int * 5)(self.rows, self.codes, self.chunk, self.stages,
                                  self.smem_bytes)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _smem_bytes(rows: int, d: int) -> int:
    """Shared bytes of a block (csrc/rvq.cu:smem_bytes): the residual [Dp,
    rows], the ring [STAGES, CHUNK, codes], the |r|^2 partials [256], |r|^2
    [rows], the partial bests (value, index) of each warp of a row's threads
    [partials, rows] and the chosen codes [rows]."""
    codes = THREADS * TILE * TILE // rows
    partials = max(1, codes // TILE // 32)
    return 4 * (_round_up(d, CHUNK) * rows + STAGES * CHUNK * codes + THREADS + rows
                + 2 * partials * rows + rows)


def rvq_plan(d: int) -> RvqPlan:
    """The plan for rows of ``d`` features: the most rows a block (128, 64
    or 32) whose shared memory fits."""
    for rows in (128, 64, 32):
        smem = _smem_bytes(rows, d)
        if smem <= SMEM_LIMIT:
            return RvqPlan(rows, THREADS * TILE * TILE // rows, CHUNK, STAGES, smem)
    raise ValueError(f"D={d} does not fit the RVQ kernel's shared memory")


def pack_codebooks(embeds: torch.Tensor, plan: RvqPlan
                   ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """The codebooks as the kernel streams them: E^T [n_q, Dp, Kp] (Dp = D
    rounded up to the chunk, Kp = K to the code tile, zeros past D and K)
    and |E|^2 [n_q, Kp] summed in plain torch, as the JAX wrapper does."""
    n_q, k, d = embeds.shape
    et = embeds.new_zeros(n_q, _round_up(d, plan.chunk), _round_up(k, plan.codes))
    et[:, :d, :k] = embeds.transpose(1, 2)
    esq = embeds.new_zeros(n_q, et.shape[2])
    esq[:, :k] = embeds.square().sum(-1)
    return et, esq


def _launch(x: torch.Tensor, embeds: torch.Tensor,
            clocks: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K1 (the counter's instance with ``clocks``)."""
    n, d = x.shape
    n_q, k, _ = embeds.shape
    codes = torch.empty(n_q, n, dtype=torch.int32, device=x.device)
    if n == 0 or n_q == 0:
        return codes
    plan = rvq_plan(d)
    et, esq = pack_codebooks(embeds, plan)
    lib = _build.library()
    args = (x.data_ptr(), et.data_ptr(), esq.data_ptr(), embeds.data_ptr(), codes.data_ptr(),
            n, d, k, n_q, plan.args())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if clocks is None:
            _build.check(lib.acx_rvq_encode(*args, stream), 'acx_rvq_encode')
        else:
            _build.check(lib.acx_rvq_encode_clocks(*args, clocks.data_ptr(), stream),
                         'acx_rvq_encode_clocks')
    return codes


def rvq_encode(x: torch.Tensor, embeds: torch.Tensor) -> torch.Tensor:
    """Residual VQ encode: x [N, D] fp32, embeds [n_q, K, D] fp32 -> codes
    [n_q, N] int32, both inputs contiguous on one device."""
    if x.device.type == 'cpu':
        return rvq_encode_reference(x, embeds)
    _check(x, embeds)
    codes = _launch(x, embeds)
    if codes.numel():
        rvq_encode.launches += 1
    return codes


rvq_encode.launches = 0  # kernel launches since the last reset

PHASES = ('residual load', '|r|^2', 'codebook wait', 'products', 'argmax epilogue',
          'cross-lane reduction', 'residual update')
_CLOCK_PHASES = 8   # csrc/phase_clock.cuh:kPhases


def rvq_encode_clocks(x: torch.Tensor, embeds: torch.Tensor
                      ) -> tp.Tuple[torch.Tensor, tp.Dict[str, int], tp.Dict[str, int]]:
    """A measurement, not a route: one K1 launch built with its per-phase
    cycle counter.  Returns the codes, each phase's cycles of one thread a
    block summed over the blocks, and each warp's own work in the phases that
    end at a barrier, summed over the warps.  Not counted in ``launches``."""
    if x.device.type == 'cpu':
        raise ValueError("rvq_encode_clocks measures the kernel: it takes a CUDA tensor")
    _check(x, embeds)
    clocks = torch.zeros(2 * _CLOCK_PHASES, dtype=torch.int64, device=x.device)
    codes = _launch(x, embeds, clocks)
    counts = clocks.tolist()
    return (codes, dict(zip(PHASES, counts)), dict(zip(PHASES, counts[_CLOCK_PHASES:])))


_INFO_KEYS = ('registers', 'shared_bytes', 'blocks_per_sm', 'threads', 'spill_bytes',
              'rows', 'blocks')


def rvq_kernel_info(n: int, d: int, k: int, n_q: int) -> tp.Dict[str, int]:
    """Registers, shared bytes, blocks per SM, threads, spilled bytes, rows a
    block and blocks launched of the K1 instance that ``rvq_encode`` would
    launch for these sizes (nothing is launched)."""
    out = (ctypes.c_int * len(_INFO_KEYS))()
    _build.check(_build.library().acx_rvq_info(n, d, k, n_q, rvq_plan(d).args(), out),
                 'acx_rvq_info')
    return dict(zip(_INFO_KEYS, out))
