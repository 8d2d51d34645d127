"""Streaming EnCodec: tokenize and reconstruct a signal chunk by chunk
(counterpart of ``audiocraft_tpu/codec/streaming.py``).

A causal codec encodes or decodes an unbounded stream one chunk at a time
with an explicit carried state, a dict by layer index of what each layer
needs from the chunk before:

* a causal ``StreamableConv1d`` (kernel K, stride S, dilation D) carries the
  last ``(K - 1) * D + 1 - S`` input samples.  The first chunk takes the
  model's own left padding (``pad_mode``), as the whole-signal pass does;
  later chunks prepend the carry.
* a causal ``StreamableConvTranspose1d`` carries its overlap: the transposed
  conv of T frames emits ``T * S`` samples and a ``K - S`` tail, without the
  bias, that the next chunk's head adds; the bias is added once, on the
  samples emitted.  The last tail is dropped, which is the whole-signal
  pass's causal right trim.
* a ``StreamableLSTM`` carries each layer's ``(h, c)``: on the card the
  recurrence kernel K2 starts from it (``ops/lstm.py``), h in the compute
  dtype and c in fp32.

Chunks must be multiples of the hop so that every conv sees a stride-aligned
length; :class:`CodecStreamer` buffers input of any length.  In fp32 the
streamed codes equal the whole-signal encode's and the streamed audio its
decode's up to the order of the sums (the convs run at other lengths).

Refused, as in the JAX package: a model that is not causal, ``renormalize``
(its scale is one per signal) and ``time_group_norm`` (it normalizes over the
whole time axis).  Refused here and not there: a first chunk whose length, at
a reflect-padded conv, is no longer than the conv's left pad.  Its reflection
would reach past the chunk into zeros (``pad1d``), where the whole signal
reflects real samples, so its outputs would differ from the whole-signal
pass's; the JAX package accepts a length equal to the pad.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.activations import Activation
from ..nn.conv import StreamableConv1d, StreamableConvTranspose1d, fp32_convs, pad1d
from ..nn.lstm import StreamableLSTM
from ..nn.seanet import SEANetDecoder, SEANetEncoder, SEANetResnetBlock
from .encodec import Dtype, EncodecModel

__all__ = ['encoder_stream', 'decoder_stream', 'encode_stream', 'decode_stream',
           'CodecStreamer']

StreamState = tp.Dict[int, tp.Any]


def _check_streamable(conv: tp.Union[StreamableConv1d, StreamableConvTranspose1d]) -> None:
    if not conv.causal:
        raise ValueError('streaming requires a causal model')
    if conv.norm == 'time_group_norm':
        raise ValueError('time_group_norm normalizes over the whole time axis; not streamable')


def _conv_stream(conv: StreamableConv1d, x: torch.Tensor, buf: tp.Optional[torch.Tensor]
                 ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """A chunk through a causal conv; ``buf=None`` starts the stream."""
    _check_streamable(conv)
    pt = conv.effective_kernel_size - conv.stride
    if x.shape[-1] % conv.stride:
        raise ValueError(f'chunk length {x.shape[-1]} is not a multiple of stride {conv.stride}')
    if pt > 0:
        if buf is None:
            if x.shape[-1] < pt or (conv.pad_mode == 'reflect' and x.shape[-1] == pt):
                raise ValueError(f'the first chunk reaches a conv with {x.shape[-1]} steps, '
                                 f'not more than its left pad of {pt}: the stream would '
                                 'differ from the whole signal')
            x = pad1d(x, (pt, 0), mode=conv.pad_mode)
        else:
            x = torch.cat([buf, x], dim=-1)
    new_buf = x[..., x.shape[-1] - max(pt, 0):]
    p = conv.conv['conv']
    bias = p['bias'].to(x.dtype) if 'bias' in p else None
    return F.conv1d(x, p['weight'].to(x.dtype), bias, stride=conv.stride,
                    dilation=conv.dilation), new_buf


def _convtr_stream(mod: StreamableConvTranspose1d, x: torch.Tensor,
                   carry: tp.Optional[torch.Tensor]) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """A chunk through a causal transposed conv by overlap-add."""
    _check_streamable(mod)
    if mod.trim_right_ratio != 1.0:
        raise ValueError('streaming decode takes trim_right_ratio = 1 (every published config)')
    p = mod.convtr['convtr']
    y = F.conv_transpose1d(x, p['weight'].to(x.dtype), None, stride=mod.stride)
    emit = x.shape[-1] * mod.stride
    if carry is not None and carry.shape[-1]:
        y[..., :carry.shape[-1]] += carry
    out, new_carry = y[..., :emit], y[..., emit:]
    if 'bias' in p:
        out = out + p['bias'].to(x.dtype)[:, None]
    return out, new_carry


def _res_stream(block: SEANetResnetBlock, x: torch.Tensor, st: tp.Optional[dict]
                ) -> tp.Tuple[torch.Tensor, dict]:
    y, new_st, j = x, {}, 0
    for layer in block.block:
        if isinstance(layer, StreamableConv1d):
            y, new_st[j] = _conv_stream(layer, y, None if st is None else st[j])
            j += 1
        else:
            y = layer(y)
    if block.shortcut is not None:   # a kernel-1 conv: nothing to carry
        _check_streamable(block.shortcut)
        x = block.shortcut(x)
    return x + y, new_st


def _stack_stream(layers: torch.nn.ModuleList, x: torch.Tensor,
                  state: tp.Optional[StreamState]) -> tp.Tuple[torch.Tensor, StreamState]:
    """A SEANet ``model`` list with carried state, as its ``forward`` walks it."""
    new_state: StreamState = {}
    with fp32_convs(x.dtype):
        for i, layer in enumerate(layers):
            st = None if state is None else state.get(i)
            if isinstance(layer, Activation):
                x = layer(x)
            elif isinstance(layer, StreamableConv1d):
                x, new_state[i] = _conv_stream(layer, x, st)
            elif isinstance(layer, StreamableConvTranspose1d):
                x, new_state[i] = _convtr_stream(layer, x, st)
            elif isinstance(layer, SEANetResnetBlock):
                x, new_state[i] = _res_stream(layer, x, st)
            elif isinstance(layer, StreamableLSTM):
                x, new_state[i] = layer.stream(x, st)
            else:
                raise TypeError(f'no streaming rule for {type(layer).__name__}')
    return x, new_state


def encoder_stream(encoder: SEANetEncoder, x: torch.Tensor,
                   state: tp.Optional[StreamState] = None
                   ) -> tp.Tuple[torch.Tensor, StreamState]:
    """A chunk [B, C, T] (T a multiple of the hop) -> (latent
    [B, D, T / hop] in ``x.dtype``, state)."""
    if x.shape[-1] % encoder.hop_length:
        raise ValueError(f'chunk length {x.shape[-1]} is not a multiple of the hop '
                         f'{encoder.hop_length}')
    return _stack_stream(encoder.model, x, state)


def decoder_stream(decoder: SEANetDecoder, z: torch.Tensor,
                   state: tp.Optional[StreamState] = None
                   ) -> tp.Tuple[torch.Tensor, StreamState]:
    """A latent chunk [B, D, F] -> (wav [B, C, F * hop] in ``z.dtype``, state)."""
    return _stack_stream(decoder.model, z, state)


def _check_model(model: EncodecModel) -> None:
    if not model.causal:
        raise ValueError('streaming requires a causal model')
    if model.renormalize:
        raise ValueError('renormalize computes one scale per signal; not streamable')


@torch.no_grad()
def encode_stream(model: EncodecModel, x: torch.Tensor,
                  state: tp.Optional[StreamState] = None, compute_dtype: Dtype = None
                  ) -> tp.Tuple[torch.Tensor, StreamState]:
    """A wav chunk [B, C, T] (T a multiple of the hop) -> (codes
    [B, K, T / hop], state); ``state=None`` starts a stream.
    ``compute_dtype`` as in ``EncodecModel.encode``."""
    _check_model(model)
    if x.dim() != 3:
        raise ValueError(f'expected a [B, C, T] chunk, got {tuple(x.shape)}')
    emb, state = encoder_stream(model.encoder, model._cast(x, compute_dtype), state)
    return model.quantizer.encode(emb.float()), state


@torch.no_grad()
def decode_stream(model: EncodecModel, codes: torch.Tensor,
                  state: tp.Optional[StreamState] = None, compute_dtype: Dtype = None
                  ) -> tp.Tuple[torch.Tensor, StreamState]:
    """A codes chunk [B, K, F] -> (wav [B, C, F * hop] fp32, state)."""
    _check_model(model)
    latent = model._cast(model.decode_latent(codes), compute_dtype)
    wav, state = decoder_stream(model.decoder, latent, state)
    return wav.float(), state


class CodecStreamer:
    """Feed audio (or codes) of any length, get codes (or audio) chunk by
    chunk: the buffer holds the input until a whole ``chunk`` (samples for
    encode, a multiple of the hop; frames for decode) is there.
    :meth:`flush` zero-pads the rest to a chunk and says how much of its
    output is real."""

    def __init__(self, model: EncodecModel, chunk: int, direction: str = 'encode',
                 compute_dtype: Dtype = None):
        if direction not in ('encode', 'decode'):
            raise ValueError(f"direction is 'encode' or 'decode', not {direction!r}")
        _check_model(model)
        self.hop = model.encoder.hop_length
        if direction == 'encode' and chunk % self.hop:
            raise ValueError(f'chunk {chunk} is not a multiple of the hop {self.hop}')
        self.model, self.chunk, self.direction = model, chunk, direction
        self.compute_dtype = compute_dtype
        self.state: tp.Optional[StreamState] = None
        self._buffer: tp.Optional[torch.Tensor] = None
        self._fn = encode_stream if direction == 'encode' else decode_stream

    def _step(self, piece: torch.Tensor) -> torch.Tensor:
        out, self.state = self._fn(self.model, piece, self.state, self.compute_dtype)
        return out

    def feed(self, x: tp.Union[torch.Tensor, np.ndarray]) -> tp.List[torch.Tensor]:
        """Append ``x`` [B, C, T] (codes [B, K, F] to decode); returns the
        outputs of the chunks it completed."""
        x = torch.as_tensor(x)
        if x.dim() != 3:
            raise ValueError(f'expected a [B, C, T] piece, got {tuple(x.shape)}')
        self._buffer = x if self._buffer is None else torch.cat([self._buffer, x], dim=-1)
        outs = []
        while self._buffer.shape[-1] >= self.chunk:
            piece, self._buffer = self._buffer[..., :self.chunk], self._buffer[..., self.chunk:]
            outs.append(self._step(piece))
        return outs

    def flush(self) -> tp.Tuple[tp.Optional[torch.Tensor], int]:
        """The buffered rest, zero-padded to a chunk: ``(output, n_valid)``,
        the first ``n_valid`` frames (encode) or samples (decode) of which
        come from real input; ``(None, 0)`` when nothing is buffered."""
        if self._buffer is None or self._buffer.shape[-1] == 0:
            return None, 0
        rem = self._buffer.shape[-1]
        piece = F.pad(self._buffer, (0, self.chunk - rem))
        self._buffer = self._buffer[..., :0]
        n_valid = rem // self.hop if self.direction == 'encode' else rem * self.hop
        return self._step(piece), n_valid
