"""Plain EnCodec (SEANet encoder and decoder, the two-layer LSTM, the
residual vector quantizer) over a state dict under the reference names.

Written from the published architecture (facebook/encodec_32khz's SEANet
with weight norm folded into the stored weights) and the configuration file,
not from the port: non-causal convolutions pad by reflection, the larger
half on the left, and pad the right so that the last window is full;
transposed convolutions trim ``kernel - stride`` samples, the larger half on
the left; ELU activations; residual blocks ``[ELU, conv k3, ELU, conv k1]``
plus the identity; the LSTM adds its input back; the quantizer takes, per
codebook, the nearest vector by squared distance (the first on a tie) of the
residual the codebooks before it left.

``state`` maps the codec's own names (``encoder.model.0.conv.conv.weight``,
...) to tensors; every product goes through a :class:`Precision`.  Rows run
in blocks of ``block`` so that a b128 x 10 s batch fits beside the program.
"""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn.functional as F

from .precision import Precision

State = tp.Mapping[str, torch.Tensor]


def _extra_padding(length: int, kernel: int, stride: int, padding_total: int) -> int:
    n_frames = (length - kernel + padding_total) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + (kernel - padding_total)
    return ideal - length


def _reflect(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    n = x.shape[-1]
    if n <= max(left, right):
        extra = max(left, right) - n + 1
        padded = _reflect(F.pad(x, (0, extra)), left, right)
        return padded[..., :padded.shape[-1] - extra]
    return torch.cat([x[..., 1:left + 1].flip(-1), x, x[..., n - 1 - right:n - 1].flip(-1)], -1)


def conv(x: torch.Tensor, state: State, name: str, p: Precision, stride: int = 1,
         dilation: int = 1, magnitude: bool = False) -> torch.Tensor:
    """A non-causal convolution; ``magnitude`` sums the terms' magnitudes
    instead (``|w| * |x| + |b|``), the scale of a correctly rounded sum's error."""
    w = state[f'{name}.conv.conv.weight']
    b = state.get(f'{name}.conv.conv.bias')
    k = (w.shape[-1] - 1) * dilation + 1
    total = k - stride
    extra = _extra_padding(x.shape[-1], k, stride, total)
    x = _reflect(x, total - total // 2, total // 2 + extra)
    if magnitude:
        return F.conv1d(x.abs(), w.abs(), None if b is None else b.abs(), stride=stride,
                        dilation=dilation)
    return p.conv1d(x, w, b, stride=stride, dilation=dilation)


def conv_tr(x: torch.Tensor, state: State, name: str, p: Precision, stride: int) -> torch.Tensor:
    w = state[f'{name}.convtr.convtr.weight']
    y = p.conv_transpose1d(x, w, state.get(f'{name}.convtr.convtr.bias'), stride)
    total = w.shape[-1] - stride
    right = total // 2
    return y[..., total - right:y.shape[-1] - right]


def resblock(x: torch.Tensor, state: State, name: str, p: Precision,
             dilation: int) -> torch.Tensor:
    y = conv(F.elu(x), state, f'{name}.block.1', p, dilation=dilation)
    y = conv(F.elu(y), state, f'{name}.block.3', p)
    return x + y


def lstm(x: torch.Tensor, state: State, name: str, layers: int, p: Precision) -> torch.Tensor:
    """[B, C, T] -> [B, C, T]: ``layers`` stacked LSTM layers from zero state,
    gates i, f, g, o, plus the input."""
    y = x.permute(2, 0, 1).float()                       # [T, B, C]
    inp = y
    for layer in range(layers):
        w_ih = state[f'{name}.lstm.weight_ih_l{layer}']
        w_hh = state[f'{name}.lstm.weight_hh_l{layer}']
        bias = (state[f'{name}.lstm.bias_ih_l{layer}'] + state[f'{name}.lstm.bias_hh_l{layer}'])
        T, B, _ = y.shape
        H = w_hh.shape[1]
        gx = p.linear(y, w_ih) + bias.float()
        w_t = p.operand(w_hh).t()
        h = torch.zeros(B, H, device=y.device)
        c = torch.zeros(B, H, device=y.device)
        out = torch.empty(T, B, H, device=y.device)
        for t in range(T):
            gates = gx[t] + p.operand(h) @ w_t
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out[t] = h
        y = out
    return (y + inp).permute(1, 2, 0)


def _blocks(fn: tp.Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
            block: int) -> torch.Tensor:
    return torch.cat([fn(x[i:i + block]) for i in range(0, x.shape[0], block)])


def encode_latent(state: State, cfg: dict, wav: torch.Tensor, p: Precision = Precision(),
                  block: int = 8) -> torch.Tensor:
    """wav [B, 1, T] -> the encoder's latent [B, dimension, T / hop] fp32: the
    convolutions in blocks of ``block`` rows, the LSTM over all rows at once."""
    s = cfg['seanet']
    n_front = 1 + len(s['ratios']) * (s['n_residual_layers'] + 2)

    def front(x: torch.Tensor) -> torch.Tensor:
        x = conv(x.float(), state, 'encoder.model.0', p)
        i = 1
        for ratio in reversed(s['ratios']):
            for j in range(s['n_residual_layers']):
                x = resblock(x, state, f'encoder.model.{i}', p, s['dilation_base'] ** j)
                i += 1
            x = conv(F.elu(x), state, f'encoder.model.{i + 1}', p, stride=ratio)
            i += 2
        return x

    with p.context():
        x = _blocks(front, wav, block)
        x = lstm(x, state, f'encoder.model.{n_front}', s['lstm'], p)
        return conv(F.elu(x), state, f'encoder.model.{n_front + 2}', p)


def decode_latent(state: State, cfg: dict, latent: torch.Tensor, p: Precision = Precision(),
                  block: int = 1, magnitude: bool = False) -> torch.Tensor:
    """latent [B, dimension, T_frames] -> wav [B, 1, T_frames * hop] fp32: the
    input conv and the LSTM over all rows at once, the upsampling tail in
    blocks of ``block`` rows.  ``magnitude`` stacks beside the wav (on dim 1)
    the sum of the magnitudes of the terms its last convolution adds up."""
    s = cfg['seanet']

    def tail(x: torch.Tensor) -> torch.Tensor:
        i = 2
        for ratio in s['ratios']:
            x = conv_tr(F.elu(x), state, f'decoder.model.{i + 1}', p, ratio)
            i += 2
            for j in range(s['n_residual_layers']):
                x = resblock(x, state, f'decoder.model.{i}', p, s['dilation_base'] ** j)
                i += 1
        x, name = F.elu(x), f'decoder.model.{i + 1}'
        wav = conv(x, state, name, p)
        return torch.cat([wav, conv(x, state, name, p, magnitude=True)], 1) if magnitude else wav

    with p.context():
        x = conv(latent.float(), state, 'decoder.model.0', p)
        x = lstm(x, state, 'decoder.model.1', s['lstm'], p)
        return _blocks(tail, x, block)


def codebooks(state: State, n_q: int) -> torch.Tensor:
    """[n_q, bins, dimension] fp32."""
    return torch.stack([state[f'quantizer.vq.layers.{q}._codebook.embed'].float()
                        for q in range(n_q)])


def rvq_encode(latent: torch.Tensor, embeds: torch.Tensor, p: Precision = Precision(),
               rows: int = 16384) -> torch.Tensor:
    """latent [B, D, T] -> codes [B, n_q, T] int64, in blocks of ``rows`` frames."""
    B, D, T = latent.shape
    flat = latent.transpose(1, 2).reshape(B * T, D).float()
    out = []
    with p.context():
        for start in range(0, flat.shape[0], rows):
            residual = flat[start:start + rows]
            codes = []
            for embed in embeds:
                dist = (residual.square().sum(1, keepdim=True)
                        - 2 * p.matmul(residual, embed.t())
                        + embed.square().sum(1)[None])
                idx = dist.argmin(1)
                residual = residual - embed[idx]
                codes.append(idx)
            out.append(torch.stack(codes, 1))
    return torch.cat(out).view(B, T, -1).transpose(1, 2)


def rvq_decode(codes: torch.Tensor, embeds: torch.Tensor) -> torch.Tensor:
    """codes [B, K, T] -> latent [B, D, T]: the sum of the codes' vectors."""
    total = sum(embeds[q][codes[:, q].long()] for q in range(codes.shape[1]))
    return total.transpose(1, 2)
