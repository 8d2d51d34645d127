"""SEANet encoder and decoder, the EnCodec convolutional stacks
(counterpart of ``audiocraft_tpu/nn/seanet.py``).

Each stack is one ``model`` list in the order of the JAX package's
``_layers()``, which is the reference Sequential's order: activations take an
index too, so parameter names match the reference state dict
(``encoder.model.{i}.conv.conv.weight``, ``encoder.model.{i}.block.{1,3}...``,
``encoder.model.{i}.lstm.weight_ih_l0``).
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from .activations import Activation
from .conv import StreamableConv1d, StreamableConvTranspose1d
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
    optional LSTM, an activation and the final conv to ``dimension``."""

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, T] -> [B, dimension, T / hop_length]."""
        for layer in self.model:
            x = layer(x)
        return x


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
        for layer in self.model:
            z = layer(z)
        return z
