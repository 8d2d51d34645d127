"""The codec's adversary: the multi-scale STFT discriminator, the hinge
losses and feature matching (counterpart of ``audiocraft_tpu/adversarial.py``).

Per STFT scale (:class:`STFTDiscriminator`) a 2-D conv stack runs over the
complex spectrogram viewed as (real, imag) channels: an input conv,
frequency-dilated convs strided in time, a square conv and the output conv,
each but the last followed by a leaky ReLU (0.2); the activations after each
are the features.  The convs are cuDNN's (``F.conv2d``), padded
``((k - 1) * d) // 2`` before and ``((k - 1) * d + 1) // 2`` after on each
axis, as the JAX package pads them.  Parameters follow the JAX param tree:
``discriminators.{s}.convs.{i}.weight`` / ``.bias`` hold JAX's
``scale{s}/conv{i}`` (``ckpt/from_jax.discriminator_state_from_jax``);
the init is JAX's distribution (uniform in +-1/sqrt(fan_in)) from a
``torch.Generator``.

The losses take a ``group`` (``dist/mesh.py``): their batch means are the
global batch's, and feature matching's ratio is of global means, as the JAX
package computes them over a sharded batch.
"""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn.functional as F

from .dist.mesh import Group, global_mean
from .losses import stft
from .nn import init

__all__ = ['STFTDiscriminator', 'MultiScaleSTFTDiscriminator', 'hinge_d_loss', 'hinge_g_loss',
           'feature_matching_loss']

Logits = tp.List[torch.Tensor]
Features = tp.List[tp.List[torch.Tensor]]


def _conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            stride: tp.Tuple[int, int] = (1, 1),
            dilation: tp.Tuple[int, int] = (1, 1)) -> torch.Tensor:
    before = [((k - 1) * d) // 2 for k, d in zip(w.shape[2:], dilation)]
    after = [((k - 1) * d + 1) // 2 for k, d in zip(w.shape[2:], dilation)]
    if before != after:
        x = F.pad(x, (before[1], after[1], before[0], after[0]))
        before = [0, 0]
    return F.conv2d(x, w, b, stride=stride, padding=tuple(before), dilation=dilation)


class STFTDiscriminator(torch.nn.Module):
    """One STFT scale: waveform [B, C, T] -> (logits, features)."""

    def __init__(self, n_fft: int = 1024, hop_length: int = 256,
                 win_length: tp.Optional[int] = None, filters: int = 32, in_channels: int = 1,
                 out_channels: int = 1, max_filters: int = 1024, filters_scale: int = 1,
                 kernel_size: tp.Tuple[int, int] = (3, 9), dilations: tp.Sequence[int] = (1, 2, 4),
                 stride: tp.Tuple[int, int] = (1, 2), negative_slope: float = 0.2,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self.n_fft, self.hop_length = n_fft, hop_length
        self.win_length = win_length or n_fft
        self.dilations, self.stride = tuple(dilations), tuple(stride)
        self.negative_slope = negative_slope
        chans = [(2 * in_channels, filters)]
        in_chs = filters
        for i in range(len(dilations)):
            out_chs = min(filters * filters_scale ** (i + 1), max_filters)
            chans.append((in_chs, out_chs))
            in_chs = out_chs
        out_chs = min(filters * filters_scale ** (len(dilations) + 1), max_filters)
        chans += [(in_chs, out_chs), (out_chs, out_channels)]
        kh, kw = kernel_size
        kernels = [(kh, kw)] * (len(dilations) + 1) + [(kh, kh), (kh, kh)]
        convs = []
        for (cin, cout), (a, b) in zip(chans, kernels):
            bound = 1.0 / math.sqrt(cin * a * b)
            convs.append(torch.nn.ParameterDict({
                'weight': init.uniform((cout, cin, a, b), bound, generator),
                'bias': init.uniform((cout,), bound, generator)}))
        self.convs = torch.nn.ModuleList(convs)

    def forward(self, x: torch.Tensor) -> tp.Tuple[torch.Tensor, tp.List[torch.Tensor]]:
        if x.dim() != 3:
            raise ValueError(f"expected [B, C, T], got {tuple(x.shape)}")
        spec = stft(x, self.n_fft, self.hop_length, self.win_length)   # [B, C, F, T']
        z = torch.cat([spec.real, spec.imag], dim=1)
        feats = []
        n_dil = len(self.dilations)
        for i, p in enumerate(self.convs[:-1]):
            if 1 <= i <= n_dil:
                z = _conv2d(z, p['weight'], p['bias'], self.stride, (self.dilations[i - 1], 1))
            else:
                z = _conv2d(z, p['weight'], p['bias'])
            z = F.leaky_relu(z, self.negative_slope)
            feats.append(z)
        post = self.convs[-1]
        return _conv2d(z, post['weight'], post['bias']), feats


class MultiScaleSTFTDiscriminator(torch.nn.Module):
    """EnCodec's MS-STFT adversary: one :class:`STFTDiscriminator` a scale."""

    def __init__(self, filters: int = 32, in_channels: int = 1,
                 n_ffts: tp.Sequence[int] = (1024, 2048, 512),
                 hop_lengths: tp.Sequence[int] = (256, 512, 128),
                 win_lengths: tp.Sequence[int] = (1024, 2048, 512),
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self.discriminators = torch.nn.ModuleList(
            STFTDiscriminator(n_fft=n, hop_length=h, win_length=w, filters=filters,
                              in_channels=in_channels, generator=generator)
            for n, h, w in zip(n_ffts, hop_lengths, win_lengths))

    def forward(self, x: torch.Tensor) -> tp.Tuple[Logits, Features]:
        logits, feats = [], []
        for disc in self.discriminators:
            lg, ft = disc(x)
            logits.append(lg)
            feats.append(ft)
        return logits, feats


def hinge_d_loss(real_logits: Logits, fake_logits: Logits, group: Group = None) -> torch.Tensor:
    """The discriminator's hinge loss, the mean over scales."""
    total = 0.0
    for lr, lf in zip(real_logits, fake_logits):
        total = total + global_mean(F.relu(1.0 - lr), group) + global_mean(F.relu(1.0 + lf), group)
    return total / len(real_logits)


def hinge_g_loss(fake_logits: Logits, group: Group = None) -> torch.Tensor:
    """The generator's hinge loss, the mean over scales."""
    total = 0.0
    for lf in fake_logits:
        total = total - global_mean(lf, group)
    return total / len(fake_logits)


def feature_matching_loss(real_feats: Features, fake_feats: Features, eps: float = 1e-8,
                          group: Group = None) -> torch.Tensor:
    """L1 between the discriminator's activations on real and fake audio,
    each layer's over the mean magnitude of its real activations, the mean
    over layers and scales."""
    total, n = 0.0, 0
    for rs, fs in zip(real_feats, fake_feats):
        for r, f in zip(rs, fs):
            total = total + global_mean((r - f).abs(), group) / (global_mean(r.abs(), group) + eps)
            n += 1
    return total / max(n, 1)
