"""One LSTM layer with its recurrence on a hand-written CUDA kernel (K2).

Replaces ``audiocraft_tpu/ops/lstm_pallas.py:_lstm_kernel`` with
``csrc/lstm.cu``.  The input projection ``x . W_ih^T + b_ih + b_hh`` for all
timesteps stays one ``torch.matmul``, as in the JAX package; the kernel runs
the recurrence, launched once per timestep on the current stream.  Gates and
the cell state are fp32, the hidden state is stored in the compute dtype
(fp32 or bf16), which are the TPU kernel's numerics.

Bound on an H100 and design: see the note at the top of ``csrc/lstm.cu``.
The per-step launch and the fp32 FMA step are this first version's costs;
the resident-weight persistent kernel is later work.

On a CPU tensor :func:`lstm_layer` runs :func:`lstm_layer_reference`, the
plain version of the same algorithm; on a CUDA tensor it launches the kernel
at every shape, or raises.
"""

from __future__ import annotations

import torch

from . import _build

_DTYPES = (torch.float32, torch.bfloat16)


def _gates_x(x: torch.Tensor, w_ih: torch.Tensor, b_ih: torch.Tensor,
             b_hh: torch.Tensor) -> torch.Tensor:
    """Hoisted input projection for all timesteps: [T, B, C] -> [T, B, 4H]."""
    return torch.matmul(x, w_ih.t()) + (b_ih + b_hh)


def lstm_layer_reference(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                         b_ih: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: [T, B, C] -> [T, B, H] in ``x.dtype``.

    The step product takes h in the compute dtype and sums in fp32; gates and
    c are fp32, h is rounded to the compute dtype each step, as in the kernel.
    """
    T, B, _ = x.shape
    H = w_hh.shape[1]
    gx = _gates_x(x, w_ih, b_ih, b_hh)
    w_t = w_hh.float().t()
    h = torch.zeros(B, H, dtype=x.dtype, device=x.device)
    c = torch.zeros(B, H, dtype=torch.float32, device=x.device)
    out = torch.empty(T, B, H, dtype=x.dtype, device=x.device)
    for t in range(T):
        gates = gx[t].float() + h.float() @ w_t
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = (torch.sigmoid(o) * torch.tanh(c)).to(x.dtype)
        out[t] = h
    return out


def lstm_layer(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
               b_ih: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """One LSTM layer over [T, B, C] -> [T, B, H], weights in ``x.dtype``
    (torch layout: ``w_ih`` [4H, C], ``w_hh`` [4H, H], biases [4H])."""
    if x.device.type == 'cpu':
        return lstm_layer_reference(x, w_ih, w_hh, b_ih, b_hh)
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
    if T == 0:
        return x.new_empty(0, B, H)
    if B * H * 4 >= 2 ** 31:
        raise ValueError(f"batch {B} x hidden {H} is too large for the kernel's int sizes")
    gx = _gates_x(x, w_ih, b_ih, b_hh).contiguous()
    w = w_hh.contiguous()
    out = torch.empty(T, B, H, dtype=x.dtype, device=x.device)
    c = torch.zeros(B, H, dtype=torch.float32, device=x.device)
    lib = _build.library()
    is_bf16 = int(x.dtype == torch.bfloat16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for t in range(T):
            _build.check(lib.acx_lstm_step(gx.data_ptr(), w.data_ptr(), out.data_ptr(),
                                           c.data_ptr(), t, B, H, is_bf16, stream),
                         'acx_lstm_step')
            lstm_layer.launches += 1
    return out


lstm_layer.launches = 0  # kernel launches (one per timestep) since the last reset
