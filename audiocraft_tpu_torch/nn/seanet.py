"""SEANet encoder and decoder, the EnCodec convolutional stacks
(counterpart of ``audiocraft_tpu/nn/seanet.py``).

Each stack is one ``model`` list in the order of the JAX package's
``_layers()``, which is the reference Sequential's order: activations take an
index too, so parameter names match the reference state dict
(``encoder.model.{i}.conv.conv.weight``, ``encoder.model.{i}.block.{1,3}...``,
``encoder.model.{i}.lstm.weight_ih_l0``).  An fp32 stack runs its cuDNN
convs without TF32 (``conv.fp32_convs``), whatever the caller's flag.

The encoder's front end takes one of three routes (``SEANetEncoder.forward``):
the module stack; the fused route, the input conv and the first stages
through the fused stage kernel K4, where on a CUDA tensor the input conv
itself is K5 when it is a mono stride-1 conv (the JAX package and the CPU
run the module's conv there); or the input conv alone through K5
(``conv0_kernel`` without the fused route).

``split_index``, the corruption radii and the ``start_layer`` /
``stop_layer`` slices are what ``codec/chunked.py`` windows by: the
encoder's time-local conv front and the decoder's upsampling tail run per
window, the LSTM (unbounded receptive field) once on the whole sequence.
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch

from ..ops.seanet import banded_mono_conv, fused_encoder_apply
from .activations import Activation
from .conv import (StreamableConv1d, StreamableConvTranspose1d, fp32_convs,
                   get_extra_padding_for_conv1d, pad1d)
from .lstm import StreamableLSTM


def corruption_radius(layers: tp.Sequence[torch.nn.Module], lo: int,
                      hi: int) -> tp.Tuple[int, int]:
    """(left, right) corruption radius of the layer slice ``[lo, hi)`` run on
    an interior time chunk: how far the layers' own pads at the chunk edges
    (standing in for the true neighbouring signal) reach into the slice's
    output, in its time base.  A conv of stride s with one-sided pads pl, pr
    turns a corrupt width c into ceil((c + pl) / s); a transposed conv into
    c * s + pr (mirrored on the right); activations and skips are neutral."""
    c_l = c_r = 0
    for layer in layers[lo:hi]:
        if isinstance(layer, StreamableLSTM):
            raise ValueError("an LSTM has an unbounded receptive field")
        if isinstance(layer, StreamableConvTranspose1d):
            p = layer.kernel_size - layer.stride
            pr = math.ceil(p * layer.trim_right_ratio) if layer.causal else p // 2
            c_l, c_r = c_l * layer.stride + pr, c_r * layer.stride + (p - pr)
            continue
        convs: tp.List[StreamableConv1d] = []
        if isinstance(layer, StreamableConv1d):
            convs = [layer]
        elif isinstance(layer, SEANetResnetBlock):
            convs = [m for m in layer.block if isinstance(m, StreamableConv1d)]
        for conv in convs:
            p = conv.effective_kernel_size - conv.stride
            pl = p if conv.causal else p // 2
            s = conv.stride
            c_l = max(0, -(-(c_l + pl) // s))
            c_r = max(0, -(-(c_r + p - pl) // s))
    return c_l, c_r


def _check_outer_blocks(n: int, n_blocks: int) -> int:
    if not 0 <= n <= n_blocks:
        raise ValueError(f"disable_norm_outer_blocks={n} is outside [0, {n_blocks}]")
    return n


def _run(layers: tp.Iterable[torch.nn.Module], x: torch.Tensor,
         lstm_kernel: bool) -> torch.Tensor:
    """``layers`` in order, the LSTM on the route ``lstm_kernel`` picks."""
    for layer in layers:
        x = layer(x, lstm_kernel=lstm_kernel) if isinstance(layer, StreamableLSTM) else layer(x)
    return x


class SEANetResnetBlock(torch.nn.Module):
    """[act, conv(k, dilation), act, conv(1)] with a ``dim // compress``
    bottleneck, plus the identity (``true_skip``) or a 1x1-conv shortcut."""

    def __init__(self, dim: int, kernel_sizes: tp.Sequence[int] = (3, 1),
                 dilations: tp.Sequence[int] = (1, 1), activation: str = 'ELU',
                 activation_alpha: float = 1.0, norm: str = 'none',
                 causal: bool = False, pad_mode: str = 'reflect', compress: int = 2,
                 true_skip: bool = True, generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        hidden = dim // compress
        n = len(kernel_sizes)
        block: tp.List[torch.nn.Module] = []
        for i, (ks, dil) in enumerate(zip(kernel_sizes, dilations)):
            block.append(Activation(activation, activation_alpha))
            block.append(StreamableConv1d(
                dim if i == 0 else hidden, dim if i == n - 1 else hidden,
                kernel_size=ks, dilation=dil, norm=norm, causal=causal,
                pad_mode=pad_mode, generator=generator))
        self.block = torch.nn.ModuleList(block)
        self.shortcut: tp.Optional[torch.nn.Module] = None
        if not true_skip:
            self.shortcut = StreamableConv1d(dim, dim, kernel_size=1, norm=norm,
                                             causal=causal, pad_mode=pad_mode,
                                             generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for layer in self.block:
            y = layer(y)
        shortcut = x if self.shortcut is None else self.shortcut(x)
        return shortcut + y


class SEANetEncoder(torch.nn.Module):
    """Input conv, then per ratio (applied in reversed order) residual blocks,
    an activation and a strided conv that doubles the channels, then the
    optional LSTM, an activation and the final conv to ``dimension``.

    ``disable_norm_outer_blocks`` drops the norm of the first blocks, the
    input conv counting as block 1 and each ratio's stage as one more, up to
    ``n_blocks`` (``len(ratios) + 2``), which drops the final conv's too.

    The configuration is kept on the module, under the constructor's names:
    ``ops/seanet.encoder_stage_plan`` reads it to decide which stages the
    fused kernel takes, and ``ckpt/io.py`` writes it out."""

    def __init__(self, channels: int = 1, dimension: int = 128, n_filters: int = 32,
                 n_residual_layers: int = 3, ratios: tp.Sequence[int] = (8, 5, 4, 2),
                 activation: str = 'ELU', activation_alpha: float = 1.0,
                 norm: str = 'none', kernel_size: int = 7, last_kernel_size: int = 7,
                 residual_kernel_size: int = 3, dilation_base: int = 2,
                 causal: bool = False, pad_mode: str = 'reflect', true_skip: bool = True,
                 compress: int = 2, lstm: int = 0, disable_norm_outer_blocks: int = 0,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self.ratios = tuple(ratios)
        self.hop_length = int(np.prod(self.ratios))
        self.channels, self.dimension, self.n_filters = channels, dimension, n_filters
        self.kernel_size, self.last_kernel_size = kernel_size, last_kernel_size
        self.n_residual_layers, self.norm = n_residual_layers, norm
        self.activation, self.activation_alpha = activation, activation_alpha
        self.residual_kernel_size, self.dilation_base = residual_kernel_size, dilation_base
        self.causal, self.pad_mode = causal, pad_mode
        self.true_skip, self.compress, self.lstm = true_skip, compress, lstm
        self.disable_norm_outer_blocks = _check_outer_blocks(disable_norm_outer_blocks,
                                                             self.n_blocks)
        conv = dict(causal=causal, pad_mode=pad_mode, generator=generator)
        act = dict(activation=activation, activation_alpha=activation_alpha)
        mult = 1
        layers: tp.List[torch.nn.Module] = [StreamableConv1d(
            channels, n_filters, kernel_size, norm=self._block_norm(1), **conv)]
        for i, ratio in enumerate(reversed(self.ratios)):
            block_norm = self._block_norm(i + 2)
            for j in range(n_residual_layers):
                layers.append(SEANetResnetBlock(
                    mult * n_filters, kernel_sizes=(residual_kernel_size, 1),
                    dilations=(dilation_base ** j, 1), compress=compress,
                    true_skip=true_skip, norm=block_norm, **act, **conv))
            layers.append(Activation(activation, activation_alpha))
            layers.append(StreamableConv1d(mult * n_filters, mult * n_filters * 2,
                                           kernel_size=ratio * 2, stride=ratio,
                                           norm=block_norm, **conv))
            mult *= 2
        if lstm:
            layers.append(StreamableLSTM(mult * n_filters, num_layers=lstm,
                                         generator=generator))
        layers.append(Activation(activation, activation_alpha))
        layers.append(StreamableConv1d(mult * n_filters, dimension, last_kernel_size,
                                       norm=self._block_norm(self.n_blocks), **conv))
        self.model = torch.nn.ModuleList(layers)

    @property
    def n_blocks(self) -> int:
        return len(self.ratios) + 2

    def _block_norm(self, block: int) -> str:
        """The norm of block ``block`` (1-based, from the input)."""
        return 'none' if self.disable_norm_outer_blocks >= block else self.norm

    @property
    def enc_ratios(self) -> tp.Tuple[int, ...]:
        return tuple(reversed(self.ratios))

    @property
    def split_index(self) -> int:
        """The layer that ends the time-local conv front: the LSTM, or the
        final activation and conv when there is none."""
        for i, layer in enumerate(self.model):
            if isinstance(layer, StreamableLSTM):
                return i
        return len(self.model) - 2

    def front_corruption_radius(self) -> tp.Tuple[int, int]:
        """Corruption radius of the front, in front-output frames."""
        return corruption_radius(self.model, 0, self.split_index)

    def forward(self, x: torch.Tensor, fused_stages: int = 0,
                conv0_kernel: bool = False, start_layer: int = 0,
                stop_layer: tp.Optional[int] = None, lstm_kernel: bool = True) -> torch.Tensor:
        """[B, C, T] -> [B, dimension, T / hop_length].

        ``fused_stages > 0`` runs the input conv and the first N planned
        stages through K4; an ineligible config or length runs the module
        stack instead.  On a CUDA tensor the fused route's input conv is K5
        where the conv is a mono stride-1 one, so ``conv0_kernel`` adds
        nothing to it.  On a CPU tensor, as in the JAX package,
        ``conv0_kernel`` consumes layer 0 first and so turns the fused route
        off.  ``conv0_kernel`` without a fused route runs the input conv
        alone through K5.  ``start_layer`` / ``stop_layer`` run the layer
        slice ``[start_layer, stop_layer)`` alone, on the module stack.
        ``lstm_kernel`` picks the LSTM's route (:class:`StreamableLSTM`):
        True is K2, forward only; training passes False, with
        ``fused_stages=0`` and ``conv0_kernel=False``, as the JAX package's
        training forward runs."""
        with fp32_convs(x.dtype):
            if start_layer or stop_layer is not None:
                return _run(self.model[start_layer:stop_layer], x, lstm_kernel)
            start = 0
            if fused_stages and (x.is_cuda or not conv0_kernel):
                fused = fused_encoder_apply(self, x, fused_stages,
                                            self._conv0_kernel if x.is_cuda else None)
                if fused is not None:
                    x, start = fused
            if conv0_kernel and start == 0:
                y = self._conv0_kernel(x)
                if y is not None:
                    x, start = y, 1
            return _run(self.model[start:], x, lstm_kernel)

    def _conv0_kernel(self, x: torch.Tensor) -> tp.Optional[torch.Tensor]:
        """The input conv through K5 (None when it is not a mono stride-1
        conv): StreamableConv1d's exact padding, then the kernel on the padded
        signal, with the weight and bias in the input dtype."""
        mod = self.model[0]
        if (mod.in_channels != 1 or mod.stride != 1 or mod.dilation != 1
                or mod.norm == 'time_group_norm'):
            return None
        ks = mod.effective_kernel_size
        padding_total = ks - mod.stride
        extra = get_extra_padding_for_conv1d(x.shape[-1], ks, mod.stride, padding_total)
        if mod.causal:
            pads = (padding_total, extra)
        else:
            right = padding_total // 2
            pads = (padding_total - right, right + extra)
        p = mod.conv['conv']
        bias = p['bias'] if 'bias' in p else torch.zeros(mod.out_channels, device=x.device)
        return banded_mono_conv(pad1d(x, pads, mode=mod.pad_mode), p['weight'].to(x.dtype),
                                bias.to(x.dtype))


class SEANetDecoder(torch.nn.Module):
    """Mirror of the encoder: input conv, optional LSTM, then per ratio an
    activation, a transposed conv that halves the channels and residual
    blocks, then an activation and the final conv to ``channels``, and the
    optional ``final_activation`` (a name of ``nn/activations``, e.g.
    ``'Tanh'``) as the last layer.  ``disable_norm_outer_blocks`` counts
    blocks from the output: the final conv is block 1, the input conv block
    ``n_blocks``."""

    def __init__(self, channels: int = 1, dimension: int = 128, n_filters: int = 32,
                 n_residual_layers: int = 3, ratios: tp.Sequence[int] = (8, 5, 4, 2),
                 activation: str = 'ELU', activation_alpha: float = 1.0,
                 norm: str = 'none', kernel_size: int = 7, last_kernel_size: int = 7,
                 residual_kernel_size: int = 3, dilation_base: int = 2,
                 causal: bool = False, pad_mode: str = 'reflect', true_skip: bool = True,
                 compress: int = 2, lstm: int = 0, trim_right_ratio: float = 1.0,
                 final_activation: tp.Optional[str] = None,
                 disable_norm_outer_blocks: int = 0,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self.ratios = tuple(ratios)
        self.hop_length = int(np.prod(self.ratios))
        self.channels, self.dimension, self.n_filters = channels, dimension, n_filters
        self.kernel_size, self.last_kernel_size = kernel_size, last_kernel_size
        self.n_residual_layers, self.norm = n_residual_layers, norm
        self.activation, self.activation_alpha = activation, activation_alpha
        self.residual_kernel_size, self.dilation_base = residual_kernel_size, dilation_base
        self.causal, self.pad_mode = causal, pad_mode
        self.true_skip, self.compress, self.lstm = true_skip, compress, lstm
        self.trim_right_ratio, self.final_activation = trim_right_ratio, final_activation
        self.disable_norm_outer_blocks = _check_outer_blocks(disable_norm_outer_blocks,
                                                             self.n_blocks)
        n_blocks = self.n_blocks
        conv = dict(causal=causal, generator=generator)
        act = dict(activation=activation, activation_alpha=activation_alpha)
        mult = int(2 ** len(self.ratios))
        layers: tp.List[torch.nn.Module] = [StreamableConv1d(
            dimension, mult * n_filters, kernel_size, pad_mode=pad_mode,
            norm=self._block_norm(n_blocks), **conv)]
        if lstm:
            layers.append(StreamableLSTM(mult * n_filters, num_layers=lstm,
                                         generator=generator))
        for i, ratio in enumerate(self.ratios):
            block_norm = self._block_norm(n_blocks - (i + 1))
            layers.append(Activation(activation, activation_alpha))
            layers.append(StreamableConvTranspose1d(
                mult * n_filters, mult * n_filters // 2, kernel_size=ratio * 2,
                stride=ratio, trim_right_ratio=trim_right_ratio, norm=block_norm, **conv))
            for j in range(n_residual_layers):
                layers.append(SEANetResnetBlock(
                    mult * n_filters // 2, kernel_sizes=(residual_kernel_size, 1),
                    dilations=(dilation_base ** j, 1), compress=compress,
                    true_skip=true_skip, pad_mode=pad_mode, norm=block_norm, **act, **conv))
            mult //= 2
        layers.append(Activation(activation, activation_alpha))
        layers.append(StreamableConv1d(n_filters, channels, last_kernel_size,
                                       pad_mode=pad_mode, norm=self._block_norm(1), **conv))
        if final_activation is not None:
            layers.append(Activation(final_activation))
        self.model = torch.nn.ModuleList(layers)

    @property
    def n_blocks(self) -> int:
        return len(self.ratios) + 2

    def _block_norm(self, block: int) -> str:
        """The norm of block ``block`` (1-based, from the output)."""
        return 'none' if self.disable_norm_outer_blocks >= block else self.norm

    @property
    def split_index(self) -> int:
        """The first layer of the time-local upsampling tail: after the LSTM,
        or after the input conv when there is none."""
        for i, layer in enumerate(self.model):
            if isinstance(layer, StreamableLSTM):
                return i + 1
        return 1

    def tail_corruption_radius(self) -> tp.Tuple[int, int]:
        """Corruption radius of the tail, in output samples."""
        return corruption_radius(self.model, self.split_index, len(self.model))

    def forward(self, z: torch.Tensor, start_layer: int = 0,
                stop_layer: tp.Optional[int] = None, lstm_kernel: bool = True) -> torch.Tensor:
        """[B, dimension, T_frames] -> [B, channels, T_frames * hop_length];
        ``start_layer`` / ``stop_layer`` run the slice ``[start_layer, stop_layer)``;
        ``lstm_kernel`` as in :meth:`SEANetEncoder.forward`."""
        with fp32_convs(z.dtype):
            return _run(self.model[start_layer:stop_layer], z, lstm_kernel)
