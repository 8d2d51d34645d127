"""Multi-layer LSTM over conv layout with a skip connection
(counterpart of ``audiocraft_tpu/nn/lstm.py``).

``forward(x, lstm_kernel=True)`` sends each layer through
:func:`audiocraft_tpu_torch.ops.lstm.lstm_layer`: the hand-written
recurrence kernel on a CUDA tensor, its plain version on a CPU tensor.  That
route is forward only and refuses a tensor that requires a gradient while
grad mode is on (``ops/_grad.py``).  ``lstm_kernel=False`` is the
differentiable route, :func:`lstm_stack_differentiable`: torch's own LSTM
(cuDNN's on the card) over all layers, in fp32 whatever the input dtype, as
the training forward runs it (the JAX package runs a ``lax.scan`` there).
The caller picks the route; nothing falls back from one to the other.
Parameters sit at the ``torch.nn.LSTM`` names under ``lstm.``
(``lstm.weight_ih_l0`` ...), gate order i, f, g, o.

:meth:`StreamableLSTM.stream` runs a chunk from the ``(h, c)`` of each layer
that the chunk before left, and returns the new ones
(:func:`lstm_layer_with_state`): on the card that is the kernel started from
the carried state.  ``pipelined=True`` runs two layers as one skewed loop
(:func:`lstm_2layer_pipelined`), a plain formulation that applies on CPU
tensors only, as the JAX package's applies only without its kernel; on a
CUDA tensor every layer still runs the kernel.
"""

from __future__ import annotations

import math
import typing as tp
import warnings

import torch

from ..ops.lstm import State, lstm_layer
from .init import uniform

Weights = tp.Sequence[torch.Tensor]   # (w_ih, w_hh, b_ih, b_hh), torch layout


def lstm_layer_with_state(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                          b_ih: torch.Tensor, b_hh: torch.Tensor,
                          carry: tp.Optional[State] = None
                          ) -> tp.Tuple[torch.Tensor, State]:
    """One layer over [T, B, C] from an optional ``(h, c)``: returns
    ([T, B, H], the final ``(h, c)``), h in ``x.dtype`` and c in fp32."""
    return lstm_layer(x, w_ih, w_hh, b_ih, b_hh, state=carry, return_state=True)


def _cell(gates: torch.Tensor, c: torch.Tensor) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm_2layer_pipelined(x: torch.Tensor, p0: Weights, p1: Weights) -> torch.Tensor:
    """Two stacked layers over [T, B, C] as one loop of T + 1 steps: at step
    t the first cell takes input t while the second takes the first's output
    of step t - 1 (its input projection moves into the loop); step 0's
    second-cell update is dropped, so its state starts from zeros.  Gates
    and c are fp32, h is rounded to ``x.dtype`` each step; in fp32 it equals
    two :func:`lstm_layer` calls up to the order of the sums."""
    T, B, _ = x.shape
    w_ih0, w_hh0, b_ih0, b_hh0 = p0
    w_ih1, w_hh1, b_ih1, b_hh1 = p1
    H = w_hh0.shape[1]
    gx1 = torch.matmul(x, w_ih0.t()) + (b_ih0 + b_hh0)
    b2 = (b_ih1 + b_hh1).float()
    w_hh0_t, w_ih1_t, w_hh1_t = w_hh0.float().t(), w_ih1.float().t(), w_hh1.float().t()
    zero = torch.zeros(B, H, dtype=torch.float32, device=x.device)
    h1, c1, h2, c2 = zero.to(x.dtype), zero, zero.to(x.dtype), zero
    out = torch.empty(T, B, H, dtype=x.dtype, device=x.device)
    for t in range(T + 1):
        h1_prev = h1
        if t < T:
            h1, c1 = _cell(gx1[t].float() + h1.float() @ w_hh0_t, c1)
            h1 = h1.to(x.dtype)
        if t > 0:
            gates2 = (h1_prev.float() @ w_ih1_t + b2) + h2.float() @ w_hh1_t
            h2, c2 = _cell(gates2, c2)
            h2 = h2.to(x.dtype)
            out[t - 1] = h2
    return out


def lstm_stack_differentiable(x: torch.Tensor, layers: tp.Sequence[Weights]) -> torch.Tensor:
    """Stacked layers over [T, B, C] from zero state through torch's LSTM
    (cuDNN on the card), differentiable in the input and every weight.  It
    computes in fp32 and returns ``x.dtype``; an fp32 stack inside
    ``nn/conv.fp32_convs`` runs cuDNN without TF32."""
    T, B, _ = x.shape
    H = layers[0][1].shape[1]
    flat = [w.float() for layer in layers for w in layer]
    zeros = torch.zeros(len(layers), B, H, dtype=torch.float32, device=x.device)
    with warnings.catch_warnings():
        # cuDNN packs the separate weights into its buffer each call (a copy
        # of the weights, small beside the recurrence) and warns that it does
        warnings.filterwarnings('ignore', message='RNN module weights are not part')
        out, _, _ = torch._VF.lstm(x.float(), (zeros, zeros), flat, True, len(layers), 0.0,
                                   torch.is_grad_enabled(), False, False)
    return out.to(x.dtype)


class StreamableLSTM(torch.nn.Module):
    """LSTM over [B, C, T] with an additive skip connection."""

    def __init__(self, dimension: int, num_layers: int = 2, skip: bool = True,
                 pipelined: bool = False, generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self.dimension, self.num_layers, self.skip = dimension, num_layers, skip
        self.pipelined = pipelined
        H = dimension
        bound = 1.0 / math.sqrt(H)
        params = {}
        for layer in range(num_layers):
            params[f'weight_ih_l{layer}'] = uniform((4 * H, H), bound, generator)
            params[f'weight_hh_l{layer}'] = uniform((4 * H, H), bound, generator)
            params[f'bias_ih_l{layer}'] = uniform((4 * H,), bound, generator)
            params[f'bias_hh_l{layer}'] = uniform((4 * H,), bound, generator)
        self.lstm = torch.nn.ParameterDict(params)

    def _weights(self, layer: int, dtype: torch.dtype) -> tp.List[torch.Tensor]:
        return [self.lstm[f'{name}_l{layer}'].to(dtype)
                for name in ('weight_ih', 'weight_hh', 'bias_ih', 'bias_hh')]

    def forward(self, x: torch.Tensor, lstm_kernel: bool = True) -> torch.Tensor:
        """[B, C, T] -> [B, C, T].  ``lstm_kernel`` True runs K2 (its plain
        version on a CPU tensor; forward only), False the differentiable
        route."""
        y = x.permute(2, 0, 1)  # [B, C, T] -> [T, B, C]
        inp = y
        if not lstm_kernel:
            y = lstm_stack_differentiable(y, [self._weights(layer, torch.float32)
                                              for layer in range(self.num_layers)])
        elif self.pipelined and self.num_layers == 2 and x.device.type == 'cpu':
            weights = [self._weights(layer, x.dtype) for layer in range(self.num_layers)]
            y = lstm_2layer_pipelined(y, *weights)
        else:
            for layer in range(self.num_layers):
                y = lstm_layer(y, *self._weights(layer, x.dtype))
        if self.skip:
            y = y + inp
        return y.permute(1, 2, 0)

    def stream(self, x: torch.Tensor, state: tp.Optional[tp.Sequence[State]] = None
               ) -> tp.Tuple[torch.Tensor, tp.List[State]]:
        """A chunk [B, C, T] from each layer's carried ``(h, c)`` (zeros when
        ``state`` is None) -> (output, the new per-layer state).  Chunks
        streamed one after another give the whole signal's output."""
        y = x.permute(2, 0, 1)
        inp = y
        new_state = []
        for layer in range(self.num_layers):
            carry = None if state is None else state[layer]
            y, final = lstm_layer_with_state(y, *self._weights(layer, x.dtype), carry)
            new_state.append(final)
        if self.skip:
            y = y + inp
        return y.permute(1, 2, 0), new_state
