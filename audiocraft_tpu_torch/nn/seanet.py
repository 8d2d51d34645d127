"""SEANet encoder and decoder, the EnCodec convolutional stacks
(counterpart of ``audiocraft_tpu/nn/seanet.py``).

Each stack is one ``model`` list in the order of the JAX package's
``_layers()``, which is the reference Sequential's order: activations take an
index too, so parameter names match the reference state dict
(``encoder.model.{i}.conv.conv.weight``, ``encoder.model.{i}.block.{1,3}...``,
``encoder.model.{i}.lstm.weight_ih_l0``).  An fp32 stack runs its cuDNN
convs without TF32 (``conv.fp32_convs``), whatever the caller's flag.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from ..ops.seanet import banded_mono_conv, fused_encoder_apply
from .activations import Activation
from .conv import (StreamableConv1d, StreamableConvTranspose1d, fp32_convs,
                   get_extra_padding_for_conv1d, pad1d)
from .lstm import StreamableLSTM


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

    The configuration is kept on the module: ``ops/seanet.encoder_stage_plan``
    reads it to decide which stages the fused kernel takes."""

    def __init__(self, channels: int = 1, dimension: int = 128, n_filters: int = 32,
                 n_residual_layers: int = 3, ratios: tp.Sequence[int] = (8, 5, 4, 2),
                 activation: str = 'ELU', activation_alpha: float = 1.0,
                 norm: str = 'none', kernel_size: int = 7, last_kernel_size: int = 7,
                 residual_kernel_size: int = 3, dilation_base: int = 2,
                 causal: bool = False, pad_mode: str = 'reflect', true_skip: bool = True,
                 compress: int = 2, lstm: int = 0,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self.ratios = tuple(ratios)
        self.hop_length = int(np.prod(self.ratios))
        self.channels, self.n_filters, self.kernel_size = channels, n_filters, kernel_size
        self.n_residual_layers, self.norm = n_residual_layers, norm
        self.activation, self.activation_alpha = activation, activation_alpha
        self.residual_kernel_size, self.dilation_base = residual_kernel_size, dilation_base
        self.causal, self.pad_mode = causal, pad_mode
        self.true_skip, self.compress = true_skip, compress
        conv = dict(causal=causal, pad_mode=pad_mode, norm=norm, generator=generator)
        act = dict(activation=activation, activation_alpha=activation_alpha)
        mult = 1
        layers: tp.List[torch.nn.Module] = [
            StreamableConv1d(channels, n_filters, kernel_size, **conv)]
        for ratio in reversed(self.ratios):
            for j in range(n_residual_layers):
                layers.append(SEANetResnetBlock(
                    mult * n_filters, kernel_sizes=(residual_kernel_size, 1),
                    dilations=(dilation_base ** j, 1), compress=compress,
                    true_skip=true_skip, **act, **conv))
            layers.append(Activation(activation, activation_alpha))
            layers.append(StreamableConv1d(mult * n_filters, mult * n_filters * 2,
                                           kernel_size=ratio * 2, stride=ratio, **conv))
            mult *= 2
        if lstm:
            layers.append(StreamableLSTM(mult * n_filters, num_layers=lstm,
                                         generator=generator))
        layers.append(Activation(activation, activation_alpha))
        layers.append(StreamableConv1d(mult * n_filters, dimension, last_kernel_size, **conv))
        self.model = torch.nn.ModuleList(layers)

    @property
    def enc_ratios(self) -> tp.Tuple[int, ...]:
        return tuple(reversed(self.ratios))

    def forward(self, x: torch.Tensor, fused_stages: int = 0,
                conv0_kernel: bool = False) -> torch.Tensor:
        """[B, C, T] -> [B, dimension, T / hop_length].

        ``conv0_kernel`` runs the mono input conv through K5 and consumes
        layer 0.  ``fused_stages > 0`` then runs the input conv and the first
        N planned stages through K4, but only while layer 0 is still to do;
        an ineligible config or length runs the module stack instead."""
        with fp32_convs(x.dtype):
            start = 0
            if conv0_kernel:
                y = self._conv0_kernel(x)
                if y is not None:
                    x, start = y, 1
            if fused_stages and start == 0:
                fused = fused_encoder_apply(self, x, fused_stages)
                if fused is not None:
                    x, start = fused
            for layer in self.model[start:]:
                x = layer(x)
        return x

    def _conv0_kernel(self, x: torch.Tensor) -> tp.Optional[torch.Tensor]:
        """The input conv through K5 (None when it is not a mono stride-1
        conv): StreamableConv1d's exact padding, then the kernel on the padded
        signal, with the weight and bias in the input dtype."""
        mod = self.model[0]
        if mod.in_channels != 1 or mod.stride != 1 or mod.dilation != 1:
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
    blocks, then an activation and the final conv to ``channels``."""

    def __init__(self, channels: int = 1, dimension: int = 128, n_filters: int = 32,
                 n_residual_layers: int = 3, ratios: tp.Sequence[int] = (8, 5, 4, 2),
                 activation: str = 'ELU', activation_alpha: float = 1.0,
                 norm: str = 'none', kernel_size: int = 7, last_kernel_size: int = 7,
                 residual_kernel_size: int = 3, dilation_base: int = 2,
                 causal: bool = False, pad_mode: str = 'reflect', true_skip: bool = True,
                 compress: int = 2, lstm: int = 0, trim_right_ratio: float = 1.0,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self.ratios = tuple(ratios)
        self.hop_length = int(np.prod(self.ratios))
        conv = dict(causal=causal, norm=norm, generator=generator)
        act = dict(activation=activation, activation_alpha=activation_alpha)
        mult = int(2 ** len(self.ratios))
        layers: tp.List[torch.nn.Module] = [StreamableConv1d(
            dimension, mult * n_filters, kernel_size, pad_mode=pad_mode, **conv)]
        if lstm:
            layers.append(StreamableLSTM(mult * n_filters, num_layers=lstm,
                                         generator=generator))
        for ratio in self.ratios:
            layers.append(Activation(activation, activation_alpha))
            layers.append(StreamableConvTranspose1d(
                mult * n_filters, mult * n_filters // 2, kernel_size=ratio * 2,
                stride=ratio, trim_right_ratio=trim_right_ratio, **conv))
            for j in range(n_residual_layers):
                layers.append(SEANetResnetBlock(
                    mult * n_filters // 2, kernel_sizes=(residual_kernel_size, 1),
                    dilations=(dilation_base ** j, 1), compress=compress,
                    true_skip=true_skip, pad_mode=pad_mode, **act, **conv))
            mult //= 2
        layers.append(Activation(activation, activation_alpha))
        layers.append(StreamableConv1d(n_filters, channels, last_kernel_size,
                                       pad_mode=pad_mode, **conv))
        self.model = torch.nn.ModuleList(layers)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """[B, dimension, T_frames] -> [B, channels, T_frames * hop_length]."""
        with fp32_convs(z.dtype):
            for layer in self.model:
                z = layer(z)
        return z
