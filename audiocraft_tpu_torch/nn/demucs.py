"""Hybrid Transformer Demucs: stem separation for the melody and drums
conditioners (counterpart of ``audiocraft_tpu/nn/demucs.py``).

Two U-net branches, one over the waveform (1-D convs) and one over the
spectrogram (2-D convs over frequency, the complex bins as channels), meet
in a cross-domain transformer at the bottleneck; the spectral output goes
back through the inverse STFT and is summed with the time branch's.

Modules sit at the ``demucs`` package's state-dict names, which
``ckpt/demucs_import.htdemucs_state_schema`` lists: ``encoder.{i}.conv``,
``.rewrite``, ``.dconv.layers.{j}.{0,1,3,4,6}``; ``decoder.{i}.conv_tr`` and
``.rewrite``; ``crosstransformer.layers.{i}`` with the attention's packed
``in_proj_weight``; ``freq_emb.embedding.weight``; the channel up- and
downsamplers.  So a demucs state dict loads through ``load_state_dict``.

Numerics are the JAX graph's, fp32 throughout:

* ``_stft`` / ``_istft``: the periodic Hann window
  (``np.hanning(nfft + 1)[:-1]``), centre reflect padding, the ``rfft``
  scaled by ``1 / sqrt(nfft)`` with the Nyquist bin dropped; the inverse an
  overlap-add (``F.fold``) over the summed squared window, floored at 1e-8,
  of a spectrum whose DC bin is made real first, as the CPU FFTs read it.
* The mix is normalised by its mono mean and population std; the spectrum by
  its complex mean and the population std of its magnitudes, per item.
* The transposed convs run the stored kernel as JAX's
  ``lax.conv_transpose`` does (``transpose_kernel`` off): torch's
  ``conv_transpose`` with the kernel flipped along its taps.
* The cross-transformer's attention is the explicit fp32
  ``softmax(q k^T / sqrt(d)) v``, as in JAX, which runs no kernel there.

On the card every forward runs its convolutions with cuDNN's TF32 off
(``nn/conv.fp32_convs``), the caller's flag restored after.
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from . import init
from .conv import fp32_convs

Generator = tp.Optional[torch.Generator]


def _conv(cls, in_c: int, out_c: int, kernel, generator: Generator, **kw) -> torch.nn.Module:
    """A conv with weight and bias uniform in +-1/sqrt(fan_in), as JAX's
    ``_conv_init`` draws them."""
    kernel = tuple(kernel) if isinstance(kernel, (tuple, list)) else (kernel,)
    layer = cls(in_c, out_c, kernel if len(kernel) > 1 else kernel[0], device='meta', **kw)
    bound = 1.0 / math.sqrt(in_c * int(np.prod(kernel)))
    layer.weight = init.uniform((out_c, in_c) + kernel, bound, generator)
    layer.bias = init.uniform((out_c,), bound, generator)
    return layer


def _convtr(cls, in_c: int, out_c: int, kernel, generator: Generator, **kw) -> torch.nn.Module:
    kernel = tuple(kernel) if isinstance(kernel, (tuple, list)) else (kernel,)
    layer = cls(in_c, out_c, kernel if len(kernel) > 1 else kernel[0], device='meta', **kw)
    layer.weight = init.uniform((in_c, out_c) + kernel, 1.0 / math.sqrt(in_c * kernel[0]),
                                generator)
    layer.bias = init.constant((out_c,), 0.0)
    return layer


def _norm(cls, *args) -> torch.nn.Module:
    layer = cls(*args, device='meta')
    n = layer.weight.shape[0]
    layer.weight, layer.bias = init.constant((n,), 1.0), init.constant((n,), 0.0)
    return layer


def _linear(in_d: int, out_d: int, generator: Generator) -> torch.nn.Linear:
    bound = 1.0 / math.sqrt(in_d)
    return init.linear(in_d, out_d, True, bound, generator, bias_bound=bound)


def _glu(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=1)
    return a * torch.sigmoid(b)


def _fold_freq(fn, x: torch.Tensor) -> torch.Tensor:
    """Run a 1-D module over time for every frequency row: [B, C, F, T]."""
    B, C, Fr, T = x.shape
    y = fn(x.transpose(1, 2).reshape(B * Fr, C, T))
    return y.reshape(B, Fr, C, T).transpose(1, 2)


# ------------------------------------------------------------------- STFT

def _window(nfft: int, device) -> torch.Tensor:
    return torch.from_numpy(np.hanning(nfft + 1)[:-1].astype(np.float32)).to(device)


def _stft(x: torch.Tensor, nfft: int, hop: int) -> torch.Tensor:
    """x [B, C, T] -> complex [B, C, nfft // 2, frames]: centre reflect pad,
    periodic Hann window, ``rfft / sqrt(nfft)``, the Nyquist bin dropped."""
    B, C, T = x.shape
    xp = F.pad(x.reshape(B * C, 1, T), (nfft // 2, nfft // 2), mode='reflect')[:, 0]
    frames = xp.unfold(-1, nfft, hop) * _window(nfft, x.device)     # [BC, frames, nfft]
    spec = torch.fft.rfft(frames, dim=-1)[..., :-1] / math.sqrt(nfft)
    return spec.transpose(-1, -2).reshape(B, C, nfft // 2, -1)


def _istft(z: torch.Tensor, nfft: int, hop: int, length: int) -> torch.Tensor:
    """The inverse of :func:`_stft`: overlap-add over the summed squared
    window (floored at 1e-8), trimmed to ``length`` -> [B, C, length]."""
    B, C, Fr, TT = z.shape
    window = _window(nfft, z.device)
    spec = F.pad(z.reshape(B * C, Fr, TT).transpose(-1, -2), (0, 1))   # Nyquist bin 0
    # a C2R transform reads a Hermitian spectrum: the CPU's FFT (and JAX's)
    # drops the DC bin's imaginary part, cuFFT does not, so it is zeroed here
    dc = spec[..., :1].real
    spec = torch.cat([torch.complex(dc, torch.zeros_like(dc)), spec[..., 1:]], dim=-1)
    frames = torch.fft.irfft(spec, n=nfft, dim=-1) * math.sqrt(nfft) * window
    total = hop * (TT - 1) + nfft

    def overlap_add(cols: torch.Tensor) -> torch.Tensor:     # [N, nfft, TT] -> [N, total]
        return F.fold(cols, (1, total), (1, nfft), stride=(1, hop))[:, 0, 0]

    wav = overlap_add(frames.transpose(1, 2))
    wsq = overlap_add(window.square()[None, :, None].expand(1, nfft, TT))
    wav = wav / wsq.clamp_min(1e-8)
    return wav[:, nfft // 2:nfft // 2 + length].reshape(B, C, length)


# ------------------------------------------------------------------- layers

class LayerScale(torch.nn.Module):

    def __init__(self, dim: int, value: float = 1e-4):
        super().__init__()
        self.scale = init.constant((dim,), value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.scale[:, None] * x


class _GLU(torch.nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _glu(x)


class DConv(torch.nn.Module):
    """The dilated residual branch of every encoder layer: ``depth`` blocks
    of [conv k3 dilation 2^j, GroupNorm(1), GELU, conv 1x1 to 2C, GroupNorm(1),
    GLU, LayerScale 1e-4], each added to its input (``compress`` 8, the
    published htdemucs ``dconv_comp``).  x [B, C, T]."""

    def __init__(self, channels: int, compress: int = 8, depth: int = 2,
                 generator: Generator = None):
        super().__init__()
        hidden = channels // compress
        self.layers = torch.nn.ModuleList(
            torch.nn.Sequential(
                _conv(torch.nn.Conv1d, channels, hidden, 3, generator, dilation=2 ** j,
                      padding=2 ** j),
                _norm(torch.nn.GroupNorm, 1, hidden), torch.nn.GELU(),
                _conv(torch.nn.Conv1d, hidden, 2 * channels, 1, generator),
                _norm(torch.nn.GroupNorm, 1, 2 * channels), _GLU(), LayerScale(channels))
            for j in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.layers:
            x = x + block(x)
        return x


class HEncLayer(torch.nn.Module):
    """Encoder layer: conv k8 stride 4 (2-D over frequency in the spectral
    branch), GELU, the DConv branch, a 1x1 rewrite to 2C and GLU."""

    def __init__(self, chin: int, chout: int, freq: bool, kernel: int = 8, stride: int = 4,
                 generator: Generator = None):
        super().__init__()
        self.freq = freq
        pad = (kernel - stride) // 2
        if freq:
            self.conv = _conv(torch.nn.Conv2d, chin, chout, (kernel, 1), generator,
                              stride=(stride, 1), padding=(pad, 0))
            self.rewrite = _conv(torch.nn.Conv2d, chout, 2 * chout, (1, 1), generator)
        else:
            self.conv = _conv(torch.nn.Conv1d, chin, chout, kernel, generator, stride=stride,
                              padding=pad)
            self.rewrite = _conv(torch.nn.Conv1d, chout, 2 * chout, 1, generator)
        self.dconv = DConv(chout, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.gelu(self.conv(x))
        y = _fold_freq(self.dconv, y) if self.freq else self.dconv(y)
        return _glu(self.rewrite(y))


class HDecLayer(torch.nn.Module):
    """Decoder layer (the published ``dconv_mode=1``: no DConv here): the
    skip added, a k3 rewrite to 2C and GLU, the transposed conv k8 stride 4
    trimmed by 2 at each end, GELU but on the last layer."""

    def __init__(self, chin: int, chout: int, freq: bool, last: bool = False, kernel: int = 8,
                 stride: int = 4, generator: Generator = None):
        super().__init__()
        self.freq, self.last = freq, last
        self.trim = (kernel - stride) // 2
        if freq:
            self.rewrite = _conv(torch.nn.Conv2d, chin, 2 * chin, (3, 3), generator,
                                 padding=(1, 1))
            self.conv_tr = _convtr(torch.nn.ConvTranspose2d, chin, chout, (kernel, 1),
                                   generator, stride=(stride, 1))
        else:
            self.rewrite = _conv(torch.nn.Conv1d, chin, 2 * chin, 3, generator, padding=1)
            self.conv_tr = _convtr(torch.nn.ConvTranspose1d, chin, chout, kernel, generator,
                                   stride=stride)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        h = _glu(self.rewrite(x + skip))
        tr = self.conv_tr
        if self.freq:   # JAX's unflipped kernel: flip the taps for torch's transpose
            y = F.conv_transpose2d(h, tr.weight.flip(2), tr.bias, stride=tr.stride)
            y = y[:, :, self.trim:y.shape[2] - self.trim]
        else:
            y = F.conv_transpose1d(h, tr.weight.flip(2), tr.bias, stride=tr.stride)
            y = y[..., self.trim:y.shape[-1] - self.trim]
        return y if self.last else F.gelu(y)


# ------------------------------------------------------------ transformer

def _sin_embed(length: int, dim: int, device, max_period: float = 10000.0) -> torch.Tensor:
    """demucs ``create_sin_embedding``: [cos | sin] halves, the ``half - 1``
    denominator -> [length, dim]."""
    half = dim // 2
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    freqs = max_period ** (-torch.arange(half, dtype=torch.float32, device=device)
                           / max(half - 1, 1))
    args = pos * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _sin_embed_2d(dim: int, height: int, width: int, device,
                  max_period: float = 10000.0) -> torch.Tensor:
    """demucs ``create_2d_sin_embedding``: the first half of the channels
    encodes the width (time; sin, cos interleaved), the second the height
    (frequency) -> [dim, height, width]."""
    d = dim // 2
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * -(math.log(max_period) / d))
    pos_w = torch.arange(width, dtype=torch.float32, device=device)[:, None] * div   # [W, n]
    pos_h = torch.arange(height, dtype=torch.float32, device=device)[:, None] * div  # [H, n]
    pe = torch.zeros(dim, height, width, device=device)
    pe[0:d:2] = torch.sin(pos_w).T[:len(range(0, d, 2)), None, :]
    pe[1:d:2] = torch.cos(pos_w).T[:len(range(1, d, 2)), None, :]
    pe[d::2] = torch.sin(pos_h).T[:len(range(d, dim, 2)), :, None]
    pe[d + 1::2] = torch.cos(pos_h).T[:len(range(d + 1, dim, 2)), :, None]
    return pe


class _Attention(torch.nn.Module):
    """``nn.MultiheadAttention``'s weights (packed ``in_proj_weight`` [3D, D],
    ``out_proj``), computed as JAX's explicit fp32 softmax attention."""

    def __init__(self, dim: int, num_heads: int, generator: Generator):
        super().__init__()
        self.num_heads = num_heads
        q, k, v = (_linear(dim, dim, generator) for _ in range(3))
        self.in_proj_weight = torch.nn.Parameter(torch.cat([q.weight, k.weight, v.weight]),
                                                 requires_grad=False)
        self.in_proj_bias = torch.nn.Parameter(torch.cat([q.bias, k.bias, v.bias]),
                                               requires_grad=False)
        self.out_proj = _linear(dim, dim, generator)

    def forward(self, x: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        B, Tq, D = x.shape
        H = self.num_heads
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        q = F.linear(x, wq, bq).view(B, Tq, H, -1).transpose(1, 2)
        k = F.linear(kv, wk, bk).view(B, kv.shape[1], H, -1).transpose(1, 2)
        v = F.linear(kv, wv, bv).view(B, kv.shape[1], H, -1).transpose(1, 2)
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(D // H), dim=-1)
        return self.out_proj((att @ v).transpose(1, 2).reshape(B, Tq, D))


class CrossTransformerLayer(torch.nn.Module):
    """One pre-norm layer of one branch: self-attention (even layers,
    demucs ``MyTransformerEncoderLayer``: ``norm1`` attention, ``norm2``
    feed-forward) or cross-attention to the other branch (odd layers,
    ``CrossTransformerEncoderLayer``: ``norm1`` the queries, ``norm2`` the
    source, ``norm3`` the feed-forward); LayerScales ``gamma_1``/``gamma_2``
    at 1e-4, and ``norm_out``, a GroupNorm(1, D) over the (tokens, channels)
    block."""

    def __init__(self, dim: int, num_heads: int, cross: bool, hidden_scale: float = 4.0,
                 generator: Generator = None):
        super().__init__()
        self.cross = cross
        attn = _Attention(dim, num_heads, generator)
        if cross:
            self.cross_attn = attn
        else:
            self.self_attn = attn
        hidden = int(dim * hidden_scale)
        self.linear1 = _linear(dim, hidden, generator)
        self.linear2 = _linear(hidden, dim, generator)
        self.norm1 = _norm(torch.nn.LayerNorm, dim)
        self.norm2 = _norm(torch.nn.LayerNorm, dim)
        if cross:
            self.norm3 = _norm(torch.nn.LayerNorm, dim)
        self.norm_out = _norm(torch.nn.LayerNorm, dim)   # affine of the GroupNorm(1, D)
        self.gamma_1, self.gamma_2 = LayerScale(dim), LayerScale(dim)

    def forward(self, x: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        if self.cross:
            h = self.cross_attn(h, self.norm2(other))
            ff_norm = self.norm3
        else:
            h = self.self_attn(h, h)
            ff_norm = self.norm2
        x = x + self.gamma_1.scale * h
        x = x + self.gamma_2.scale * self.linear2(F.gelu(self.linear1(ff_norm(x))))
        mean = x.mean(dim=(1, 2), keepdim=True)
        var = x.var(dim=(1, 2), keepdim=True, unbiased=False)
        return (x - mean) * torch.rsqrt(var + 1e-5) * self.norm_out.weight + self.norm_out.bias


class CrossTransformer(torch.nn.Module):
    """The bottleneck transformer: ``depth`` layers a branch, even ones
    self-attention, odd ones cross-attention to the other branch's tokens
    as they were before the layer."""

    def __init__(self, dim: int, num_heads: int = 8, depth: int = 5,
                 generator: Generator = None):
        super().__init__()
        self.dim = dim
        self.norm_in = _norm(torch.nn.LayerNorm, dim)
        self.norm_in_t = _norm(torch.nn.LayerNorm, dim)
        self.layers = torch.nn.ModuleList()
        self.layers_t = torch.nn.ModuleList()
        for i in range(depth):
            self.layers.append(CrossTransformerLayer(dim, num_heads, i % 2 == 1,
                                                     generator=generator))
            self.layers_t.append(CrossTransformerLayer(dim, num_heads, i % 2 == 1,
                                                       generator=generator))

    def forward(self, xs: torch.Tensor, xt: torch.Tensor,
                spec_shape: tp.Tuple[int, int]) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        """xs [B, Tq * Fq, D] spectral tokens, time-major, xt [B, Lt, D]."""
        fq, tq = spec_shape
        pos_s = _sin_embed_2d(self.dim, fq, tq, xs.device).permute(2, 1, 0).reshape(tq * fq, -1)
        xs = self.norm_in(xs) + pos_s
        xt = self.norm_in_t(xt) + _sin_embed(xt.shape[1], self.dim, xt.device)
        for layer_s, layer_t in zip(self.layers, self.layers_t):
            xs, xt = layer_s(xs, xt), layer_t(xt, xs)
        return xs, xt


# ----------------------------------------------------------------- model

@dataclasses.dataclass(frozen=True)
class HTDemucsConfig:
    """The published htdemucs: 4 sources at 44.1 kHz stereo, 48 channels
    growing by 2 over depth 4, nfft 4096, a 5-layer cross-transformer at 512
    channels with 8 heads, 7.8 s segments."""
    sources: tp.Tuple[str, ...] = ('drums', 'bass', 'other', 'vocals')
    audio_channels: int = 2
    channels: int = 48
    growth: int = 2
    depth: int = 4
    nfft: int = 4096
    t_depth: int = 5
    t_heads: int = 8
    bottom_channels: int = 512
    sample_rate: int = 44100
    segment: float = 7.8
    #: the stored frequency embedding is applied as weight * emb_scale *
    #: freq_emb_weight (demucs ScaledEmbedding, HTDemucs freq_emb)
    freq_emb_weight: float = 0.2
    emb_scale: float = 10.0

    @property
    def hop(self) -> int:
        return self.nfft // 4

    @property
    def bottom_dim(self) -> int:
        return self.channels * self.growth ** (self.depth - 1)


class HTDemucs(torch.nn.Module):
    """mix [B, audio_channels, T] -> stems [B, n_sources, audio_channels, T]."""

    def __init__(self, cfg: HTDemucsConfig = HTDemucsConfig(), generator: Generator = None):
        super().__init__()
        self.cfg = c = cfg
        self.encoder, self.decoder = self._branch(True, generator)
        self.tencoder, self.tdecoder = self._branch(False, generator)
        self.crosstransformer = CrossTransformer(c.bottom_channels, c.t_heads, c.t_depth,
                                                 generator)
        self.freq_emb = torch.nn.Module()
        self.freq_emb.embedding = init.embedding(
            c.nfft // 8, c.channels, init.normal((c.nfft // 8, c.channels), 0.02, generator))
        self.has_resample = c.bottom_channels != c.bottom_dim
        if self.has_resample:
            for name, (i, o) in (('channel_upsampler', (c.bottom_dim, c.bottom_channels)),
                                 ('channel_downsampler', (c.bottom_channels, c.bottom_dim)),
                                 ('channel_upsampler_t', (c.bottom_dim, c.bottom_channels)),
                                 ('channel_downsampler_t', (c.bottom_channels, c.bottom_dim))):
                setattr(self, name, _conv(torch.nn.Conv1d, i, o, 1, generator))

    def _branch(self, freq: bool, generator: Generator
                ) -> tp.Tuple[torch.nn.ModuleList, torch.nn.ModuleList]:
        c = self.cfg
        chin = 2 * c.audio_channels if freq else c.audio_channels
        enc, ch = torch.nn.ModuleList(), c.channels
        for i in range(c.depth):
            enc.append(HEncLayer(chin if i == 0 else ch // c.growth, ch, freq,
                                 generator=generator))
            ch *= c.growth
        ch //= c.growth
        n_out = len(c.sources) * chin
        dec = torch.nn.ModuleList()
        for i in range(c.depth):
            last = i == c.depth - 1
            dec.append(HDecLayer(ch, n_out if last else ch // c.growth, freq, last=last,
                                 generator=generator))
            ch //= c.growth
        return enc, dec

    @property
    def device(self) -> torch.device:
        return self.freq_emb.embedding.weight.device

    @torch.no_grad()
    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        """T must be a multiple of 4 ** depth (:meth:`separate` pads)."""
        with fp32_convs(torch.float32):
            return self._forward(mix.float())

    def _forward(self, mix: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        B, _, T = mix.shape
        mono = mix.mean(dim=1, keepdim=True)
        mean = mono.mean(dim=(1, 2), keepdim=True)
        std = mono.std(dim=(1, 2), keepdim=True, unbiased=False) + 1e-5
        x_t = (mix - mean) / std

        z = _stft(x_t, c.nfft, c.hop)
        zm = z.mean(dim=(1, 2, 3), keepdim=True)
        zs = z.abs().std(dim=(1, 2, 3), keepdim=True, unbiased=False) + 1e-5
        z = (z - zm) / zs
        x_s = torch.cat([z.real, z.imag], dim=1)              # [B, 2C, F, frames]
        n_frames = x_s.shape[-1]

        skips_s, skips_t = [], []
        h_s, h_t = x_s, x_t
        for i, layer in enumerate(self.encoder):
            h_s = layer(h_s)
            if i == 0:
                fpos = self.freq_emb.embedding.weight[:h_s.shape[2]]       # [F1, C]
                h_s = h_s + c.freq_emb_weight * c.emb_scale * fpos.T[None, :, :, None]
            skips_s.append(h_s)
        for layer in self.tencoder:
            h_t = layer(h_t)
            skips_t.append(h_t)

        _, C, Fq, Tq = h_s.shape
        if self.has_resample:
            h_s = self.channel_upsampler(h_s.reshape(B, C, Fq * Tq)).reshape(B, -1, Fq, Tq)
            h_t = self.channel_upsampler_t(h_t)
            C = c.bottom_channels
        tok_s, tok_t = self.crosstransformer(h_s.permute(0, 3, 2, 1).reshape(B, Tq * Fq, C),
                                             h_t.transpose(1, 2), spec_shape=(Fq, Tq))
        h_s = tok_s.reshape(B, Tq, Fq, C).permute(0, 3, 2, 1)
        h_t = tok_t.transpose(1, 2)
        if self.has_resample:
            h_s = self.channel_downsampler(h_s.reshape(B, C, Fq * Tq)).reshape(B, -1, Fq, Tq)
            h_t = self.channel_downsampler_t(h_t)

        for layer in self.decoder:
            h_s = layer(h_s, skips_s.pop())
        for layer in self.tdecoder:
            h_t = layer(h_t, skips_t.pop())

        S, ch = len(c.sources), c.audio_channels
        spec = h_s.reshape(B, S, 2 * ch, h_s.shape[2], n_frames)
        z_out = torch.complex(spec[:, :, :ch], spec[:, :, ch:]) * zs[:, None] + zm[:, None]
        wav_s = _istft(z_out.reshape(B * S, ch, h_s.shape[2], n_frames), c.nfft, c.hop,
                       T).reshape(B, S, ch, T)
        return (wav_s + h_t.reshape(B, S, ch, T)) * std[:, None] + mean[:, None]

    @property
    def length_multiple(self) -> int:
        """:meth:`separate` pads to a multiple of 4 ** (depth + 1), as JAX's."""
        return 4 ** (self.cfg.depth + 1)

    def segment_length(self, segment: tp.Optional[float] = None) -> int:
        """Samples in one window: ``segment`` seconds (the config's by
        default) rounded up to :attr:`length_multiple`."""
        n = int((segment or self.cfg.segment) * self.cfg.sample_rate)
        return n + (-n) % self.length_multiple

    def separate(self, wav: torch.Tensor, segment: tp.Optional[float] = None,
                 overlap: float = 0.25) -> torch.Tensor:
        """demucs ``apply_model``: audio no longer than one window runs in one
        pass, padded to a multiple of 4 ** depth; longer audio runs as
        windows every ``(1 - overlap)`` of a window, blended by a triangular
        weight and normalised by the weights' sum (``segment`` in seconds,
        the config's by default).  A mono input is
        duplicated to the model's channels.  wav [B, C, T] at the model's
        rate -> [B, S, C, T]."""
        c = self.cfg
        wav = wav.to(self.device, torch.float32)
        B, ch, T = wav.shape
        if ch == 1 and c.audio_channels == 2:
            wav = wav.repeat(1, 2, 1)
        seg_len = self.segment_length(segment)
        if T <= seg_len:
            return self(F.pad(wav, (0, (-T) % self.length_multiple)))[..., :T]
        stride = max(int(seg_len * (1 - overlap)), 1)
        w = np.minimum(np.arange(1, seg_len + 1), np.arange(seg_len, 0, -1)).astype(np.float32)
        w = torch.from_numpy(w / w.max()).to(wav.device)
        padded = F.pad(wav, (0, seg_len))
        out = wav.new_zeros(B, len(c.sources), c.audio_channels, T + seg_len)
        acc = wav.new_zeros(T + seg_len)
        for start in range(0, T, stride):
            out[..., start:start + seg_len] += self(padded[..., start:start + seg_len]) * w
            acc[start:start + seg_len] += w
        return (out / acc.clamp_min(1e-8))[..., :T]


def make_stem_fn(model: HTDemucs, cond_sample_rate: int,
                 stems: tp.Sequence[str] = ('vocals', 'other')
                 ) -> tp.Callable[[tp.Any], np.ndarray]:
    """The conditioners' ``stem_fn`` hook (the reference's
    ``_get_stemmed_wav``): resample to the separator's rate and channels,
    separate on the model's device, sum the kept stems, mix back down to
    mono at the conditioner's rate.  wav [B, C, T] or [C, T] (numpy or a
    tensor) -> numpy [B, 1, T'] fp32, as a tokenize phase hands on."""
    from ..io.audio_utils import convert_audio

    idx = [model.cfg.sources.index(s) for s in stems]

    def stem_fn(wav) -> np.ndarray:
        x = wav if isinstance(wav, torch.Tensor) else torch.from_numpy(np.asarray(wav))
        x = x.to(model.device, torch.float32)
        if x.dim() == 2:
            x = x[None]
        x = convert_audio(x, cond_sample_rate, model.cfg.sample_rate, model.cfg.audio_channels)
        mix = model.separate(x)[:, idx].sum(dim=1)
        return convert_audio(mix, model.cfg.sample_rate, cond_sample_rate, 1).cpu().numpy()

    return stem_fn
