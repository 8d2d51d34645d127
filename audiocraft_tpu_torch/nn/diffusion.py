"""Diffusion components: 1d UNet, DDPM noise schedule, multi-band processor
(counterpart of ``audiocraft_tpu/nn/diffusion.py``, MultiBand-Diffusion's
decoder-upgrade pieces).

* :func:`split_bands`: the mel-spaced band split (julius.SplitBands math:
  windowed-sinc lowpass filters; the taps are the JAX package's numpy
  float64 math cast to fp32, copied here), an edge pad and one fp32 conv.
* :class:`MultiBandProcessor`: per-band energy matching to Gaussian noise,
  its running sums held as buffers and updated in place.
* :class:`DiffusionUnet`: conv encoder and decoder with GroupNorm ResBlocks,
  timestep embeddings, the codec condition added at the bottleneck (a 1x1
  conv, resampled to the bottleneck's length by the integer nearest map) or
  attended to by cross-attention, and a bottleneck that is a transformer, a
  BLSTM or zeros (then the condition reaches nothing, as in the JAX
  package).
* :class:`NoiseSchedule`: the power beta schedule, the training item, and
  the full and subsampled DDPM reverse processes, whose coefficient
  arithmetic runs in numpy and Python floats as in the JAX package.

Every conv runs in fp32 with cuDNN's TF32 off (``nn/conv.fp32_convs``).  The
BLSTM runs each direction through ``ops/lstm.lstm_layer`` (K2 on a CUDA
tensor, on the reversed sequence for the backward direction); K2 is forward
only, so a forward that needs a gradient passes ``lstm_kernel=False`` and
takes torch's LSTM, as ``StreamableLSTM(lstm_kernel=False)`` does.  Random
draws come from a ``torch.Generator``, or are passed in (``noise=``,
``noises=``, ``step=``) to replay another package's draws.
"""

from __future__ import annotations

import math
import typing as tp
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.lstm import lstm_layer
from . import init
from .conv import fp32_convs
from .lstm import lstm_stack_differentiable
from .transformer import StreamingTransformer, create_sin_embedding

Generator = tp.Optional[torch.Generator]


def _randn(like: torch.Tensor, generator: Generator) -> torch.Tensor:
    """A normal draw of ``like``'s shape and dtype on its device, made on
    the generator's device (torch's global generator when None)."""
    device = like.device if generator is None else generator.device
    return torch.randn(like.shape, generator=generator, dtype=like.dtype,
                       device=device).to(like.device)


# ------------------------------------------------------------------ band split

def _mel(f):
    return 2595 * np.log10(1 + f / 700)


def _mel_inv(m):
    return 700 * (10 ** (m / 2595) - 1)


@lru_cache(16)
def _lowpass_kernels(sample_rate: int, n_bands: int, zeros: int = 8
                     ) -> tp.Tuple[np.ndarray, int]:
    """FIR windowed-sinc lowpass bank at mel-spaced cutoffs
    (julius.SplitBands / LowPassFilters math): [n_bands - 1, 1, 2 half + 1]."""
    mels = np.linspace(_mel(0), _mel(sample_rate / 2), n_bands + 1)[1:-1]
    cutoffs = _mel_inv(mels) / sample_rate  # normalized (0, 0.5)
    half_size = int(zeros / min(cutoffs) / 2)
    window = np.hanning(4 * half_size + 1)[::2]
    t = np.arange(-half_size, half_size + 1, dtype=np.float64)
    kernels = [2 * cutoff * window * np.sinc(2 * cutoff * t) for cutoff in cutoffs]
    return np.stack(kernels)[:, None, :].astype(np.float32), half_size


def split_bands(x: torch.Tensor, sample_rate: int, n_bands: int) -> torch.Tensor:
    """x [B, C, T] -> [n_bands, B, C, T] summing back to x."""
    if n_bands == 1:
        return x[None]
    kernels, half = _lowpass_kernels(sample_rate, n_bands)
    B, C, T = x.shape
    flat = F.pad(x.reshape(B * C, 1, T), (half, half), mode='replicate')
    with fp32_convs(x.dtype):
        lows = F.conv1d(flat, torch.from_numpy(kernels).to(x.device, x.dtype))
    lows = lows.reshape(B, C, n_bands - 1, T).permute(2, 0, 1, 3)
    bands = [lows[0]] + [lows[i] - lows[i - 1] for i in range(1, n_bands - 1)]
    bands.append(x - lows[-1])
    return torch.stack(bands)


class MultiBandProcessor(torch.nn.Module):
    """Band-wise mean and energy matching of a signal to Gaussian noise
    (reference diffusion_schedule.py:35-110).  The running sums are buffers
    (``counts``, ``sum_x``, ``sum_x2``, ``sum_target_x2``): a projection
    given a ``generator`` or a ``noise`` draw adds the batch to them while
    ``counts < num_samples``."""

    def __init__(self, n_bands: int = 8, sample_rate: int = 24000, num_samples: int = 10_000,
                 power_std: float = 1.0):
        super().__init__()
        self.n_bands, self.sample_rate = n_bands, sample_rate
        self.num_samples, self.power_std = num_samples, power_std
        self.register_buffer('counts', torch.zeros(()))
        for name in ('sum_x', 'sum_x2', 'sum_target_x2'):
            self.register_buffer(name, torch.zeros(n_bands))

    def _stats(self) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        mean = self.sum_x / self.counts
        std = torch.sqrt(torch.clamp(self.sum_x2 / self.counts - mean ** 2, min=0))
        return mean, std, self.sum_target_x2 / self.counts

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 3:
            raise ValueError(f"expected [B, C, T], got {tuple(x.shape)}")
        return split_bands(x, self.sample_rate, self.n_bands)

    @torch.no_grad()
    def _update(self, bands: torch.Tensor, noise: torch.Tensor) -> None:
        ref_bands = self._split(noise)
        update = self.counts < self.num_samples
        for buf, value in ((self.counts, self.counts + bands.shape[1]),
                           (self.sum_x, self.sum_x + bands.mean(dim=(2, 3)).sum(1)),
                           (self.sum_x2, self.sum_x2 + bands.square().mean(dim=(2, 3)).sum(1)),
                           (self.sum_target_x2,
                            self.sum_target_x2 + ref_bands.square().mean(dim=(2, 3)).sum(1))):
            buf.copy_(torch.where(update, value, buf))

    def project_sample(self, x: torch.Tensor, generator: Generator = None,
                       noise: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, C, T] with each band's mean removed and its std matched to
        the noise's; with a ``generator`` (or a given ``noise`` of x's
        shape) the batch and a normal draw update the statistics first."""
        bands = self._split(x)
        if noise is None and generator is not None:
            noise = _randn(x, generator)
        if noise is not None:
            self._update(bands, noise)
        mean, std, target_std = self._stats()
        rescale = (target_std / torch.clamp(std, min=1e-12)) ** self.power_std
        bands = (bands - mean.view(-1, 1, 1, 1)) * rescale.view(-1, 1, 1, 1)
        return bands.sum(0)

    def return_sample(self, x: torch.Tensor) -> torch.Tensor:
        """The inverse of :meth:`project_sample` at the current statistics."""
        bands = self._split(x)
        mean, std, target_std = self._stats()
        rescale = (std / target_std) ** self.power_std
        return (bands * rescale.view(-1, 1, 1, 1) + mean.view(-1, 1, 1, 1)).sum(0)


# --------------------------------------------------------------------- unet

def _conv(cout: int, cin: int, kernel: int, bias: bool, generator: Generator) -> torch.nn.Conv1d:
    """A parameter holder in ``nn.Conv1d``'s layout, weight uniform in
    +-1/sqrt(fan in), bias zero (the forward calls ``F.conv1d`` itself)."""
    conv = torch.nn.Conv1d(cin, cout, kernel, bias=bias, device='meta')
    conv.weight = init.uniform((cout, cin, kernel), 1 / math.sqrt(cin * kernel), generator)
    if bias:
        conv.bias = init.constant((cout,), 0.0)
    return conv


def _group_norm(groups: int, ch: int) -> torch.nn.GroupNorm:
    norm = torch.nn.GroupNorm(groups, ch, eps=1e-5, device='meta')
    norm.weight, norm.bias = init.constant((ch,), 1.0), init.constant((ch,), 0.0)
    return norm


class ResBlock(torch.nn.Module):
    """GroupNorm, ReLU, dilated conv, twice, with a residual."""

    def __init__(self, ch: int, groups: int, kernel: int, dilation: int, generator: Generator):
        super().__init__()
        self.norm1, self.norm2 = _group_norm(groups, ch), _group_norm(groups, ch)
        self.conv1 = _conv(ch, ch, kernel, True, generator)
        self.conv2 = _conv(ch, ch, kernel, True, generator)
        self.dilation, self.pad = dilation, dilation * (kernel - 1) // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for norm, conv in ((self.norm1, self.conv1), (self.norm2, self.conv2)):
            h = F.conv1d(F.relu(norm(h)), conv.weight, conv.bias, padding=self.pad,
                         dilation=self.dilation)
        return x + h


class EncoderLayer(torch.nn.Module):
    """Strided conv (no bias), GroupNorm, ReLU, ResBlocks."""

    def __init__(self, cin: int, cout: int, unet: "DiffusionUnet", generator: Generator):
        super().__init__()
        self.conv = _conv(cout, cin, unet.kernel, False, generator)
        self.norm = _group_norm(unet.norm_groups, cout)
        self.res = torch.nn.ModuleList(ResBlock(cout, unet.norm_groups, unet.res_kernel, 2 ** j,
                                                generator) for j in range(unet.res_blocks))


class DecoderLayer(torch.nn.Module):
    """ResBlocks, GroupNorm, ReLU, transposed conv (no bias)."""

    def __init__(self, cin: int, cout: int, unet: "DiffusionUnet", generator: Generator):
        super().__init__()
        self.res = torch.nn.ModuleList(ResBlock(cout, unet.norm_groups, unet.res_kernel, 2 ** j,
                                                generator) for j in range(unet.res_blocks))
        self.norm = _group_norm(unet.norm_groups, cout)
        self.convtr = torch.nn.ConvTranspose1d(cout, cin, unet.kernel, bias=False,
                                               device='meta')
        self.convtr.weight = init.uniform((cout, cin, unet.kernel),
                                          1 / math.sqrt(cin * unet.kernel), generator)


class BLSTM(torch.nn.Module):
    """Two bidirectional LSTM layers of C units a direction and a 2C -> C
    linear.  Between the layers the two directions are summed back to C
    channels; the last layer's are concatenated into the linear (the JAX
    package's layout, not torch's stacked bidirectional LSTM)."""

    NAMES = ('w_ih_f', 'w_hh_f', 'b_ih_f', 'b_hh_f', 'w_ih_b', 'w_hh_b', 'b_ih_b', 'b_hh_b')

    def __init__(self, ch: int, generator: Generator, num_layers: int = 2):
        super().__init__()
        bound = 1 / math.sqrt(ch)
        self.layers = torch.nn.ModuleList(
            torch.nn.ParameterDict({name: init.uniform((4 * ch,) + ((ch,) if name[0] == 'w'
                                                                    else ()), bound, generator)
                                    for name in self.NAMES})
            for _ in range(num_layers))
        self.linear = init.linear(2 * ch, ch, True, 1 / math.sqrt(2 * ch), generator)

    def forward(self, x: torch.Tensor, lstm_kernel: bool = True) -> torch.Tensor:
        """[B, C, T] -> [B, C, T].  ``lstm_kernel`` True runs each direction
        of each layer through ``lstm_layer`` (K2 on the card; forward only),
        False through torch's differentiable LSTM."""
        C = x.shape[1]
        y = x.permute(2, 0, 1)  # [T, B, C]
        for i, p in enumerate(self.layers):
            fwd = self._direction(y, [p[n] for n in self.NAMES[:4]], lstm_kernel)
            bwd = self._direction(y.flip(0), [p[n] for n in self.NAMES[4:]], lstm_kernel).flip(0)
            y = torch.cat([fwd, bwd], dim=-1)
            if i < len(self.layers) - 1:
                y = y[..., :C] + y[..., C:]
        return self.linear(y).permute(1, 2, 0)

    @staticmethod
    def _direction(y: torch.Tensor, weights: tp.List[torch.Tensor],
                   lstm_kernel: bool) -> torch.Tensor:
        weights = [w.to(y.dtype) for w in weights]
        if lstm_kernel:
            return lstm_layer(y.contiguous(), *weights)
        return lstm_stack_differentiable(y, [weights])


class DiffusionUnet(torch.nn.Module):
    """The MultiBand-Diffusion UNet (reference unet.py:123-213): ``depth``
    strided conv layers (``hidden`` channels, times ``growth`` a layer, at
    most ``max_channels``), the bottleneck, and the mirrored transposed-conv
    layers with skips.  ``forward(x [B, chin, T], step, condition)``
    estimates the noise, [B, chin, T]."""

    def __init__(self, chin: int = 3, hidden: int = 24, depth: int = 3, growth: float = 2.0,
                 max_channels: int = 10_000, num_steps: int = 1000,
                 emb_all_layers: bool = False, cross_attention: bool = False,
                 bilstm: bool = False, use_transformer: bool = False,
                 codec_dim: tp.Optional[int] = None, kernel: int = 4, stride: int = 2,
                 norm_groups: int = 4, res_blocks: int = 1, res_kernel: int = 3,
                 generator: Generator = None):
        super().__init__()
        self.chin, self.hidden, self.depth = chin, hidden, depth
        self.growth, self.max_channels, self.num_steps = growth, max_channels, num_steps
        self.emb_all_layers, self.cross_attention = emb_all_layers, cross_attention
        self.kernel, self.stride, self.norm_groups = kernel, stride, norm_groups
        self.res_blocks, self.res_kernel = res_blocks, res_kernel
        self.embedding = init.normal((num_steps, hidden), 0.02, generator)
        self.embeddings = torch.nn.ParameterList()
        encoders, decoders = [], []
        for d, (cin, cout) in enumerate(self._dims()):
            encoders.append(EncoderLayer(cin, cout, self, generator))
            decoders.insert(0, DecoderLayer(cin, cout, self, generator))
            if emb_all_layers and d > 0:
                self.embeddings.append(init.normal((num_steps, cout), 0.02, generator))
        self.encoders = torch.nn.ModuleList(encoders)
        self.decoders = torch.nn.ModuleList(decoders)
        ch = self.bottleneck_dim
        self.bilstm = BLSTM(ch, generator) if bilstm else None
        self.transformer = None
        if use_transformer:
            self.transformer = StreamingTransformer(
                ch, 8, 6, bias_ff=False, bias_attn=False, norm_first=False, activation='relu',
                cross_attention=cross_attention, generator=generator)
        self.conv_codec = _conv(ch, codec_dim, 1, True, generator) if codec_dim else None

    def _dims(self) -> tp.List[tp.Tuple[int, int]]:
        dims = []
        chin, hidden = self.chin, self.hidden
        for _ in range(self.depth):
            dims.append((chin, hidden))
            chin = hidden
            hidden = min(int(chin * self.growth), self.max_channels)
        return dims

    @property
    def bottleneck_dim(self) -> int:
        return self._dims()[-1][1]

    def forward(self, x: torch.Tensor, step: tp.Union[int, torch.Tensor],
                condition: tp.Optional[torch.Tensor] = None,
                lstm_kernel: bool = True) -> torch.Tensor:
        """``step`` an int or [B] (or broadcastable) ints; ``condition`` the
        codec latent [B, codec_dim, T_codec] when ``codec_dim`` is set;
        ``lstm_kernel`` the BLSTM's route (see :class:`BLSTM`)."""
        with fp32_convs(x.dtype):
            return self._forward(x, step, condition, lstm_kernel)

    def _forward(self, x, step, condition, lstm_kernel):
        B = x.shape[0]
        steps = torch.as_tensor(step, dtype=torch.long, device=x.device).expand(B)
        pad_k = (self.kernel - self.stride) // 2
        skips = []
        z = x
        for idx, enc in enumerate(self.encoders):
            z = F.pad(z, (0, (self.stride - z.shape[-1] % self.stride) % self.stride))
            z = F.conv1d(z, enc.conv.weight, stride=self.stride, padding=pad_k)
            z = F.relu(enc.norm(z))
            for res in enc.res:
                z = res(z)
            if idx == 0:
                z = z + self.embedding[steps][:, :, None]
            elif self.emb_all_layers:
                z = z + self.embeddings[idx - 1][steps][:, :, None]
            skips.append(z)

        cross_src = None
        if self.conv_codec is not None:
            if condition is None:
                raise ValueError("the model is defined for conditional generation")
            cond = F.conv1d(condition, self.conv_codec.weight, self.conv_codec.bias)
            if not self.cross_attention:
                # nearest resample to the bottleneck length by the integer map
                T_src, T_dst = cond.shape[-1], z.shape[-1]
                idx_map = torch.arange(T_dst, device=z.device) * T_src // T_dst
                z = z + cond.index_select(-1, idx_map)
            else:
                cross_src = cond.transpose(1, 2)
                positions = torch.arange(cross_src.shape[1], device=z.device).view(1, -1, 1)
                cross_src = cross_src + create_sin_embedding(
                    positions, cross_src.shape[-1]).to(cross_src.dtype)

        if self.transformer is not None:
            z = self.transformer(z.transpose(1, 2), cross_attention_src=cross_src).transpose(1, 2)
        elif self.bilstm is not None:
            z = self.bilstm(z, lstm_kernel)
        else:
            z = torch.zeros_like(z)

        for dec in self.decoders:
            s = skips.pop()
            z = z[:, :, :s.shape[2]] + s
            for res in dec.res:
                z = res(z)
            z = F.relu(dec.norm(z))
            z = F.conv_transpose1d(z, dec.convtr.weight, stride=self.stride)
            if pad_k:
                z = z[:, :, pad_k:-pad_k]
        return z[:, :, :x.shape[2]]


# ------------------------------------------------------------------- schedule

class NoiseSchedule:
    """DDPM noise schedule (reference diffusion_schedule.py:112-272): betas
    ``linspace(beta_t0 ** (1 / beta_exp), beta_t1 ** (1 / beta_exp),
    num_steps) ** beta_exp`` in fp32; the reverse processes' coefficients in
    numpy fp32 and Python floats, their tensors where ``initial`` lies."""

    def __init__(self, beta_t0: float = 1e-4, beta_t1: float = 0.02, num_steps: int = 1000,
                 variance: str = 'beta', clip: float = 5.0, rescale: float = 1.0,
                 beta_exp: float = 1.0, noise_scale: float = 1.0):
        self.beta_t0, self.beta_t1, self.num_steps = beta_t0, beta_t1, num_steps
        self.variance, self.clip, self.rescale = variance, clip, rescale
        self.beta_exp, self.noise_scale = beta_exp, noise_scale

    @property
    def betas(self) -> torch.Tensor:
        return torch.linspace(self.beta_t0 ** (1 / self.beta_exp),
                              self.beta_t1 ** (1 / self.beta_exp), self.num_steps,
                              dtype=torch.float32) ** self.beta_exp

    def get_alpha_bar(self, step: tp.Optional[int] = None) -> torch.Tensor:
        if step is None:
            return torch.cumprod(1 - self.betas, 0)
        return torch.prod(1 - self.betas[:step + 1])

    def get_training_item(self, x: torch.Tensor, generator: Generator = None,
                          tensor_step: bool = True, step: tp.Optional[torch.Tensor] = None,
                          noise: tp.Optional[torch.Tensor] = None
                          ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(noisy, noise, step) for training (reference
        diffusion_schedule.py:170-191); ``step`` ([B], or a 0-d tensor
        without ``tensor_step``) and ``noise`` (x's shape) are drawn from
        ``generator`` unless given."""
        if step is None:
            step = torch.randint(0, self.num_steps, (x.shape[0],) if tensor_step else (),
                                 generator=generator,
                                 device=x.device if generator is None else generator.device)
        if noise is None:
            noise = _randn(x, generator)
        step, noise = step.to(x.device), noise.to(x.device)
        alpha_bar = self.get_alpha_bar().to(x.device)[step]
        if tensor_step:
            alpha_bar = alpha_bar.view(-1, 1, 1)
        noisy = (torch.sqrt(alpha_bar) / self.rescale) * x \
            + torch.sqrt(1 - alpha_bar) * noise * self.noise_scale
        return noisy, noise, step

    @staticmethod
    def _noise(like: torch.Tensor, generator: Generator,
               noises: tp.Optional[tp.Iterator[torch.Tensor]]) -> torch.Tensor:
        if noises is not None:
            return next(noises).to(like.device, like.dtype)
        return _randn(like, generator)

    def generate_subsampled(self, model_fn: tp.Callable, initial: torch.Tensor,
                            step_list: tp.Optional[tp.List[int]] = None,
                            condition: tp.Optional[torch.Tensor] = None,
                            generator: Generator = None,
                            noises: tp.Optional[tp.Sequence[torch.Tensor]] = None
                            ) -> torch.Tensor:
        """Subsampled DDPM reverse process (reference
        diffusion_schedule.py:240-272); ``model_fn(x, step, condition)`` is
        the noise estimate.  The default step list is every 50th step from
        the last, and 0 (21 entries, 20 model calls at 1000 steps).  The
        normal draws come from ``generator`` (on its device) or, in order,
        from ``noises``."""
        if step_list is None:
            step_list = list(range(self.num_steps))[::-50] + [0]
        noise_iter = None if noises is None else iter(noises)
        alpha_bars = np.cumprod(1 - self.betas.numpy())
        ab_sub = alpha_bars[list(reversed(step_list))]
        alphas_sub = np.concatenate(([ab_sub[0]], ab_sub[1:] / ab_sub[:-1]))
        betas_sub = 1 - alphas_sub

        alpha_bar = alpha_bars[self.num_steps - 1]
        current = initial * self.noise_scale
        previous = current
        for idx, step in enumerate(step_list[:-1]):
            estimate = model_fn(current, step, condition) * self.noise_scale
            alpha = 1 - betas_sub[-1 - idx]
            previous = (current - float((1 - alpha) / math.sqrt(1 - alpha_bar)) * estimate) \
                / math.sqrt(alpha)
            previous_alpha_bar = alpha_bars[step_list[idx + 1]]
            if step == step_list[-2]:
                sigma2 = 0.0
                previous_alpha_bar = 1.0
            else:
                sigma2 = (1 - previous_alpha_bar) / (1 - alpha_bar) * (1 - alpha)
            if sigma2 > 0:
                previous = previous + math.sqrt(sigma2) * self._noise(
                    previous, generator, noise_iter) * self.noise_scale
            if self.clip:
                previous = previous.clamp(-self.clip, self.clip)
            current = previous
            alpha_bar = previous_alpha_bar
            if step == 0:
                previous = previous * self.rescale
        return previous

    def generate(self, model_fn: tp.Callable, initial: torch.Tensor,
                 condition: tp.Optional[torch.Tensor] = None, generator: Generator = None,
                 noises: tp.Optional[tp.Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """Full DDPM reverse process over every step (reference
        diffusion_schedule.py:194-238); draws as in :meth:`generate_subsampled`."""
        noise_iter = None if noises is None else iter(noises)
        betas = self.betas.numpy()
        alpha_bars = np.cumprod(1 - betas)
        alpha_bar = alpha_bars[self.num_steps - 1]
        current = previous = initial
        for step in range(self.num_steps)[::-1]:
            estimate = model_fn(current, step, condition)
            alpha = 1 - betas[step]
            previous = (current - float((1 - alpha) / math.sqrt(1 - alpha_bar)) * estimate) \
                / math.sqrt(alpha)
            previous_alpha_bar = alpha_bars[step - 1] if step > 0 else 1.0
            if step == 0:
                sigma2 = 0.0
            elif self.variance == 'beta':
                sigma2 = 1 - alpha
            elif self.variance == 'beta_tilde':
                sigma2 = (1 - previous_alpha_bar) / (1 - alpha_bar) * (1 - alpha)
            else:
                sigma2 = 0.0
            if sigma2 > 0:
                previous = previous + math.sqrt(sigma2) * self._noise(
                    previous, generator, noise_iter) * self.noise_scale
            if self.clip:
                previous = previous.clamp(-self.clip, self.clip)
            current = previous
            alpha_bar = previous_alpha_bar
            if step == 0:
                previous = previous * self.rescale
        return previous
