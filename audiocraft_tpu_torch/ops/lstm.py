"""One LSTM layer with its recurrence on a hand-written CUDA kernel (K2).

Replaces ``audiocraft_tpu/ops/lstm_pallas.py:_lstm_kernel`` with
``csrc/lstm.cu``.  The input projection ``x . W_ih^T + b_ih + b_hh`` for all
timesteps stays one ``torch.matmul``, as in the JAX package; the kernel runs
the whole recurrence of a layer in one cooperative launch on the current
stream.  Each block owns a few hidden units and keeps their four gate rows of
``W_hh`` in shared memory for all T steps (the TPU kernel's resident weight,
split across the SMs); a grid-wide barrier separates the steps.  Gates and the
cell state are fp32, the hidden state is stored in the compute dtype (fp32 or
bf16), which are the TPU kernel's numerics.

A layer starts from zero or from a carried ``state = (h0, c0)`` (h0 in the
compute dtype, c0 fp32: what the kernel keeps), and with ``return_state``
also returns its final ``(h_T, c_T)`` in the same dtypes; a stream of chunks
(``codec/streaming.py``) threads that state from one launch to the next.
With neither, the launch is the zero-start one of a whole signal.

:func:`lstm_plan` is the launch plan, pure Python so that the CPU tests reach
it: units per block, grid, batch tile, K chunk, whether the weight slice is
resident or streamed, and the shared-memory bytes.  Bound on an H100 and
design: see the note at the top of ``csrc/lstm.cu``.

On a CPU tensor :func:`lstm_layer` runs :func:`lstm_layer_reference`, the
plain version of the same algorithm; on a CUDA tensor it launches the kernel
once per layer, or raises (a refused cooperative launch included).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import typing as tp

import torch

from . import _build
from ._grad import refuse_grad

_DTYPES = (torch.float32, torch.bfloat16)

# Mirrors of csrc/lstm.cu's constants: the plan and the kernel must agree
# (the kernel recomputes the shared-memory bytes and refuses a mismatch).
THREADS = 256
WARPS = THREADS // 32
MAX_STAGES = 4      # deepest cp.async ring
MAX_TILES = 4       # (m16, n8) accumulator tiles per warp
MAX_BATCH_TILE = 128
# bytes of one ring stage, tried largest first: more bytes in flight hide
# more of the L2 latency of each step's h
STAGE_BYTES = (32768, 16384, 8192, 4096)
_ALIGN = 128


@dataclasses.dataclass(frozen=True)
class LstmPlan:
    """How one layer is launched: ``grid`` blocks, each owning ``units``
    hidden units and ``batch_rows`` batch rows (``batch_groups`` groups of
    rows, so grid = ceil(H / units) * batch_groups); a block's rows in tiles
    of ``batch_tile``; h (and a streamed weight) in K chunks of ``k_chunk``
    features through a ring of ``stages``."""
    units: int
    grid: int
    batch_groups: int
    batch_rows: int
    batch_tile: int
    k_chunk: int
    stages: int
    resident: bool       # W_hh's slice stays in shared memory for all steps
    weight_bytes: int    # the block's slice of W_hh: 4 * units * H in the dtype
    smem_bytes: int      # dynamic shared memory per block
    masked: bool         # ragged units or batch rows (a tile or group not full)


def _align(x: int) -> int:
    return -(-x // _ALIGN) * _ALIGN


def _smem_bytes(brows: int, hidden: int, elt: int, units: int, nb: int, kc: int,
                stages: int, resident: bool) -> int:
    """Shared-memory bytes of the kernel's layout for a block of ``brows``
    batch rows.  ``csrc/lstm.cu:make_plan`` computes the same bytes and the
    kernel refuses a plan that disagrees, so the two copies change together;
    ``tests/test_torch_lstm_plan.py`` pins the bytes of the launched plans."""
    pad, rows = 16 // elt, 4 * units
    kp = -(-hidden // 16) * 16
    mt, nt = units // 4, nb // 8
    wm = 1 if mt <= 4 else min(mt, WARPS)   # 1: a warp holds all gates of its units
    wn = min(nt, WARPS // wm)
    ks = WARPS // (wm * wn)
    ld_w = (kp if resident else kc) + pad
    ld_h = kc + pad
    stage = nb * ld_h + (0 if resident else rows * ld_w)
    pre = ((ks - 1) * wn * (mt // wm) * (nt // wn) * 128 if wm == 1
           else ks * rows * (nb + 4))   # fp32 partials
    return ((_align(rows * ld_w * elt) if resident else 0) + _align(stages * stage * elt)
            + _align(pre * 4) + _align(brows * rows * elt) + _align(brows * units * 4))


def _pow2_ceil(x: int) -> int:
    return 1 << (x - 1).bit_length()


def fit_plan(hidden: int, batch: int, dtype: torch.dtype, units: int, bgroups: int,
             resident: bool, smem_limit: int) -> tp.Optional[LstmPlan]:
    """The plan of ``units`` units (a power of two >= 4) and ``bgroups``
    batch groups with the largest ring stage of STAGE_BYTES and the deepest
    ring that fit ``smem_limit``, or None."""
    elt = 2 if dtype == torch.bfloat16 else 4
    brows = -(-batch // bgroups)
    mt = units // 4
    nt = min(_pow2_ceil(-(-brows // 8)), MAX_BATCH_TILE // 8, WARPS * MAX_TILES // mt)
    nb = 8 * nt
    kp = -(-hidden // 16) * 16
    ugroups = -(-hidden // units)
    rows = nb if resident else nb + 4 * units   # rows a ring stage holds
    for target in STAGE_BYTES:
        kc = min(kp, max(16, target // (rows * elt) // 16 * 16))
        for stages in range(min(MAX_STAGES, -(-kp // kc)), 0, -1):
            smem = _smem_bytes(brows, hidden, elt, units, nb, kc, stages, resident)
            if smem <= smem_limit and (stages > 1 or kc == kp):
                masked = (ugroups * units != hidden or brows % nb != 0
                          or brows * bgroups != batch)
                return LstmPlan(units, ugroups * bgroups, bgroups, brows, nb, kc, stages,
                                resident, 4 * units * hidden * elt, smem, masked)
    return None


def lstm_plan(hidden: int, batch: int, dtype: torch.dtype, sms: int,
              smem_limit: int) -> LstmPlan:
    """Launch plan of one layer for ``sms`` SMs and ``smem_limit`` bytes of
    shared memory per block; raises ValueError for a shape it cannot hold.

    Units per block: at least the fewest that cover H with one block per
    SM, a power of two >= 4 (whole m16 tiles of 4 gates x units).  Doubling
    the units halves the unit groups, and the SMs that frees split the batch
    into groups: each block then reads only its rows of h every step, which
    is what bounds a step at large B.  The plan takes the split with the
    fewest batch rows a block whose weight slice still stays resident in
    shared memory (at B = 128, H = 1024 in bf16: 16 units x 64 rows; at
    B <= 8 no split).  The batch tile is the block's rows rounded up to a
    power of two times 8, at most 128 and small enough that a warp holds at
    most MAX_TILES tiles.  Where no resident slice fits (fp32 at H >= 2048),
    the weight streams with h.  Then the largest ring stage (h, and the
    weight slice's chunk when streamed) of STAGE_BYTES and the deepest ring
    that fit; the K chunk is what a stage holds, all of H when that fits."""
    if dtype not in _DTYPES:
        raise ValueError(f"the LSTM kernel takes fp32 or bf16, not {dtype}")
    if hidden <= 0 or batch <= 0 or sms <= 0:
        raise ValueError(f"no LSTM plan for H={hidden}, B={batch} on {sms} SMs")
    base = max(4, _pow2_ceil(-(-hidden // sms)))
    if base // 4 > WARPS * MAX_TILES:
        raise ValueError(f"H={hidden} needs {base} units a block on {sms} SMs; the LSTM "
                         f"kernel holds at most {4 * WARPS * MAX_TILES}")
    best = None
    units = base
    while units // 4 <= WARPS * MAX_TILES:
        ugroups = -(-hidden // units)
        # groups of at least 16 rows: below that a split costs more than it saves
        bgroups = min(1 << ((sms // ugroups).bit_length() - 1), max(1, batch // 16))
        plan = fit_plan(hidden, batch, dtype, units, bgroups, True, smem_limit)
        if plan is None:
            break
        if best is None or plan.batch_rows < best.batch_rows:
            best = plan
        units *= 2
    if best is None:
        best = fit_plan(hidden, batch, dtype, base, 1, False, smem_limit)
    if best is None:
        raise ValueError(f"LSTM H={hidden} B={batch} {dtype}: no plan fits {smem_limit} bytes "
                         "of shared memory a block, even with the weight streamed")
    return best


@functools.cache
def device_limits(index: int) -> tp.Tuple[int, int]:
    """(SMs, opt-in shared bytes per block) of CUDA device ``index``."""
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(index):
        _build.check(_build.library().acx_lstm_device(out), 'acx_lstm_device')
    return out[0], out[1]


def device_plan(hidden: int, batch: int, dtype: torch.dtype,
                device: torch.device) -> LstmPlan:
    """:func:`lstm_plan` for a CUDA device, with its SM count and shared memory."""
    sms, smem = device_limits(torch.device(device).index or 0)
    return lstm_plan(hidden, batch, dtype, sms, smem)


def lstm_kernel_info(dtype: torch.dtype, plan: LstmPlan) -> tp.Dict[str, int]:
    """What the kernel instance for ``dtype`` and ``plan`` uses on the current
    card (``cudaFuncGetAttributes``): registers per thread, static shared
    bytes, threads per block and spilled bytes per thread."""
    out = (ctypes.c_int * 4)()
    _build.check(_build.library().acx_lstm_info(int(dtype == torch.bfloat16), plan.units,
                                                plan.batch_tile, out), 'acx_lstm_info')
    return dict(zip(('registers', 'static_shared_bytes', 'threads', 'spill_bytes'), out))


def _gates_x(x: torch.Tensor, w_ih: torch.Tensor, b_ih: torch.Tensor,
             b_hh: torch.Tensor) -> torch.Tensor:
    """Hoisted input projection for all timesteps: [T, B, C] -> [T, B, 4H]."""
    return torch.matmul(x, w_ih.t()) + (b_ih + b_hh)


State = tp.Tuple[torch.Tensor, torch.Tensor]
LayerOut = tp.Union[torch.Tensor, tp.Tuple[torch.Tensor, State]]


def _check_state(state: tp.Optional[State], x: torch.Tensor, H: int) -> None:
    if state is None:
        return
    h0, c0 = state
    B = x.shape[1]
    if tuple(h0.shape) != (B, H) or tuple(c0.shape) != (B, H):
        raise ValueError(f"LSTM state {tuple(h0.shape)}, {tuple(c0.shape)} is not [{B}, {H}]")
    if h0.device != x.device or c0.device != x.device:
        raise ValueError("the LSTM state must be on the input's device")


def lstm_layer_reference(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                         b_ih: torch.Tensor, b_hh: torch.Tensor,
                         state: tp.Optional[State] = None,
                         return_state: bool = False) -> LayerOut:
    """Plain PyTorch version: [T, B, C] -> [T, B, H] in ``x.dtype`` (and the
    final ``(h, c)`` with ``return_state``).

    The step product takes h in the compute dtype and sums in fp32; gates and
    c are fp32, h is rounded to the compute dtype each step, as in the kernel.
    ``state`` is the starting ``(h, c)``, zeros when None.
    """
    T, B, _ = x.shape
    H = w_hh.shape[1]
    _check_state(state, x, H)
    gx = _gates_x(x, w_ih, b_ih, b_hh)
    w_t = w_hh.float().t()
    if state is None:
        h = torch.zeros(B, H, dtype=x.dtype, device=x.device)
        c = torch.zeros(B, H, dtype=torch.float32, device=x.device)
    else:
        h, c = state[0].to(x.dtype), state[1].float()
    out = torch.empty(T, B, H, dtype=x.dtype, device=x.device)
    for t in range(T):
        gates = gx[t].float() + h.float() @ w_t
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = (torch.sigmoid(o) * torch.tanh(c)).to(x.dtype)
        out[t] = h
    return (out, (h, c)) if return_state else out


def lstm_layer(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
               b_ih: torch.Tensor, b_hh: torch.Tensor, state: tp.Optional[State] = None,
               return_state: bool = False) -> LayerOut:
    """One LSTM layer over [T, B, C] -> [T, B, H], weights in ``x.dtype``
    (torch layout: ``w_ih`` [4H, C], ``w_hh`` [4H, H], biases [4H]).

    ``state`` = (h0 [B, H], c0 [B, H]) starts the recurrence there (zeros
    when None); ``return_state`` returns ``(out, (h_T, c_T))``, h_T in
    ``x.dtype`` and c_T in fp32, as the kernel keeps them.

    Forward only: a tensor that requires a gradient raises while grad mode
    is on (``ops/_grad.py``), on either device."""
    refuse_grad('lstm_layer (K2)', (x, w_ih, w_hh, b_ih, b_hh) + tuple(state or ()),
                'StreamableLSTM(lstm_kernel=False)')
    if x.device.type == 'cpu':
        return lstm_layer_reference(x, w_ih, w_hh, b_ih, b_hh, state, return_state)
    if x.device.type != 'cuda':
        raise ValueError(f"lstm_layer runs on CUDA or CPU tensors, not {x.device}")
    T, B, C = x.shape
    H = w_hh.shape[1]
    if w_ih.shape != (4 * H, C) or w_hh.shape != (4 * H, H) \
            or b_ih.shape != (4 * H,) or b_hh.shape != (4 * H,):
        raise ValueError(f"LSTM weight shapes {tuple(w_ih.shape)}, {tuple(w_hh.shape)}, "
                         f"{tuple(b_ih.shape)}, {tuple(b_hh.shape)} do not fit input "
                         f"width {C} and hidden size {H}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"the LSTM kernel takes fp32 or bf16, not {x.dtype}")
    for w in (w_ih, w_hh, b_ih, b_hh):
        if w.dtype != x.dtype or w.device != x.device:
            raise ValueError("LSTM weights must share the input's dtype and device")
    _check_state(state, x, H)
    if T == 0:
        out = x.new_empty(0, B, H)
        if not return_state:
            return out
        h, c = state if state is not None else (x.new_zeros(B, H), x.new_zeros(B, H))
        return out, (h.to(x.dtype), c.float())
    if B * H * 4 >= 2 ** 31:
        raise ValueError(f"batch {B} x hidden {H} is too large for the kernel's int sizes")
    plan = device_plan(H, B, x.dtype, x.device)
    if T * plan.grid >= 2 ** 31:
        raise ValueError(f"{T} steps x {plan.grid} blocks overflow the LSTM kernel's barrier")
    gx = _gates_x(x, w_ih, b_ih, b_hh).contiguous()
    w = w_hh.contiguous()
    out = torch.empty(T, B, H, dtype=x.dtype, device=x.device)
    h0 = c0 = None
    if state is not None:
        h0 = state[0].to(x.dtype).contiguous()
        c0 = state[1].float().contiguous()
    c_out = torch.empty(B, H, dtype=torch.float32, device=x.device) if return_state else None
    barrier = torch.zeros(1, dtype=torch.int32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        err = _build.library().acx_lstm_layer(
            gx.data_ptr(), w.data_ptr(), out.data_ptr(), ptr(h0), ptr(c0), ptr(c_out),
            barrier.data_ptr(), T, B, H, int(x.dtype == torch.bfloat16), plan.units, plan.grid,
            plan.batch_tile, plan.k_chunk, int(plan.resident), plan.stages, plan.batch_groups,
            plan.smem_bytes, torch.cuda.current_stream().cuda_stream)
    _build.check(err, 'acx_lstm_layer')
    lstm_layer.launches += 1
    return (out, (out[-1], c_out)) if return_state else out


lstm_layer.launches = 0  # kernel launches (one per layer call) since the last reset
