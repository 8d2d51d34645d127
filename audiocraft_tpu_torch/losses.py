"""Training losses for the codec: spectra, the multi-scale mel loss, SI-SNR
and the gradient balancer (counterpart of ``audiocraft_tpu/losses.py``).

* :func:`stft` is the JAX package's: reflect padding built from flipped
  slices (whose backward has no atomics, so a step is deterministic on the
  card), the periodic Hann window (``np.hanning(n + 1)[:-1]``), zero-padded
  to ``n_fft``, frames by ``unfold`` and ``normalized`` dividing by
  ``sqrt(n_fft)``, as ``torch.stft(normalized=True)`` does.
* :func:`mel_filterbank` is the HTK-scale filterbank (torchaudio's
  ``melscale_fbanks(mel_scale='htk', norm=None)``), computed in numpy.
* The balancer is the JAX package's functional one
  (:func:`balanced_cotangent`): each loss is differentiated with respect to
  the reconstruction only (``torch.autograd.grad`` on a detached leaf), the
  EMA-smoothed gradient norms rescale each to its share, and the caller
  runs one backward of the summed cotangent through the generator.

Every batch mean takes a ``group`` (``dist/mesh.py``): with one, it is the
mean over the global batch and the losses have their global values on every
rank; the balancer's norms are the global gradient's (squared norms summed
over the group).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import typing as tp

import numpy as np
import torch

from .dist.mesh import Group, all_sum, global_mean

__all__ = ['stft', 'mel_filterbank', 'mel_spectrogram', 'MultiScaleMelSpectrogramLoss',
           'sisnr', 'Balancer', 'balanced_cotangent']


@functools.lru_cache(maxsize=None)
def _window(n_fft: int, win_length: int, device: torch.device) -> torch.Tensor:
    window = np.hanning(win_length + 1)[:-1].astype(np.float32)
    lpad = (n_fft - win_length) // 2
    return torch.from_numpy(np.pad(window, (lpad, n_fft - win_length - lpad))).to(device)


@functools.lru_cache(maxsize=None)
def _filterbank(sample_rate: int, n_fft: int, n_mels: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels).copy()).to(device)


def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect ``pad`` samples at both ends of the last axis (flipped slices)."""
    return torch.cat([x[..., 1:pad + 1].flip(-1), x, x[..., -pad - 1:-1].flip(-1)], dim=-1)


def stft(x: torch.Tensor, n_fft: int, hop_length: int, win_length: tp.Optional[int] = None,
         center: bool = True, normalized: bool = True) -> torch.Tensor:
    """[..., T] real -> complex [..., F, T'] (torch.stft semantics)."""
    win_length = win_length or n_fft
    window = _window(n_fft, win_length, x.device)
    if center:
        x = _reflect_pad(x, n_fft // 2)
    frames = x.unfold(-1, n_fft, hop_length) * window       # [..., T', n_fft]
    spec = torch.fft.rfft(frames, dim=-1)
    if normalized:
        spec = spec / math.sqrt(n_fft)
    return spec.transpose(-1, -2)


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + f / 700.0)   # HTK


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: tp.Optional[float] = None) -> np.ndarray:
    """Triangular HTK-scale filterbank [n_mels, n_fft // 2 + 1] fp32."""
    fmax = fmax or sample_rate / 2
    freqs = np.linspace(0, sample_rate / 2, n_fft // 2 + 1)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(np.asarray(fmin)), _hz_to_mel(np.asarray(fmax)),
                                     n_mels + 2))
    fb = np.zeros((n_mels, len(freqs)), np.float32)
    for m in range(n_mels):
        lo, ctr, hi = mel_pts[m], mel_pts[m + 1], mel_pts[m + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        fb[m] = np.maximum(0.0, np.minimum(up, down))
    fb.setflags(write=False)
    return fb


def mel_spectrogram(x: torch.Tensor, sample_rate: int, n_fft: int, hop_length: int,
                    n_mels: int, log: bool = False, floor_level: float = 1e-5) -> torch.Tensor:
    """[B, C, T] -> power mel [B, C, n_mels, T'] (``log``: log10 of floor + mel)."""
    spec = stft(x, n_fft, hop_length, normalized=True)
    power = spec.real.square() + spec.imag.square()
    fb = _filterbank(sample_rate, n_fft, n_mels, x.device)
    mel = torch.einsum('mf,...ft->...mt', fb, power)
    return torch.log10(floor_level + mel) if log else mel


@dataclasses.dataclass(frozen=True)
class MultiScaleMelSpectrogramLoss:
    """EnCodec's multi-scale mel loss: over STFT sizes 2^range_start ..
    2^range_end (hop a quarter), L1 on the mel plus alpha_i times the RMS of
    the log-mel difference, alpha_i = sqrt(2^i / 2 - 1); the mean over scales."""
    sample_rate: int
    range_start: int = 6
    range_end: int = 11
    n_mels: int = 64
    floor_level: float = 1e-5

    def __call__(self, x: torch.Tensor, y: torch.Tensor, group: Group = None) -> torch.Tensor:
        total = x.new_zeros((), dtype=torch.float32)
        n = 0
        for i in range(self.range_start, self.range_end + 1):
            n_fft, hop = 2 ** i, 2 ** i // 4
            alpha = math.sqrt(2 ** i / 2 - 1)
            mx = mel_spectrogram(x, self.sample_rate, n_fft, hop, self.n_mels)
            my = mel_spectrogram(y, self.sample_rate, n_fft, hop, self.n_mels)
            lx = torch.log10(self.floor_level + mx)
            ly = torch.log10(self.floor_level + my)
            total = total + global_mean((mx - my).abs(), group) \
                + alpha * torch.sqrt(global_mean((lx - ly).square(), group) + 1e-12)
            n += 1
        return total / n


def sisnr(estimate: torch.Tensor, reference: torch.Tensor, eps: float = 1e-8,
          group: Group = None) -> torch.Tensor:
    """Negative scale-invariant SNR over the last axis, the batch mean (a loss)."""
    ref = reference - reference.mean(-1, keepdim=True)
    est = estimate - estimate.mean(-1, keepdim=True)
    dot = (ref * est).sum(-1, keepdim=True)
    proj = dot * ref / (ref.square().sum(-1, keepdim=True) + eps)
    noise = est - proj
    ratio = proj.square().sum(-1) / (noise.square().sum(-1) + eps)
    return -global_mean(10.0 * torch.log10(ratio + eps), group)


@dataclasses.dataclass(frozen=True)
class Balancer:
    """The gradient balancer's configuration: ``weights[name]`` is the share
    of the total gradient norm at the model output that loss ``name`` may
    take; an EMA of each loss's gradient norm (bias-corrected) rescales it."""
    weights: tp.Dict[str, float]
    rescale_total: float = 1.0
    ema_decay: float = 0.999
    epsilon: float = 1e-12

    def init_state(self, device: tp.Union[str, torch.device, None] = None
                   ) -> tp.Dict[str, torch.Tensor]:
        """Zero norms and a zero count: ``{name: 0-d tensor, '_count': 0-d}``."""
        return {name: torch.zeros((), device=device) for name in [*self.weights, '_count']}


LossFn = tp.Callable[[torch.Tensor], torch.Tensor]
GroupFn = tp.Callable[[torch.Tensor], tp.Dict[str, torch.Tensor]]


def balanced_cotangent(balancer: Balancer, recon: torch.Tensor,
                       loss_fns: tp.Mapping[str, LossFn], state: tp.Mapping[str, torch.Tensor],
                       grouped_fns: tp.Sequence[GroupFn] = (), group: Group = None
                       ) -> tp.Tuple[torch.Tensor, tp.Dict[str, torch.Tensor],
                                     tp.Dict[str, torch.Tensor]]:
    """The balanced cotangent at ``recon``: (cotangent, new state, metrics).

    Each ``loss_fns[name]`` maps the reconstruction to a scalar; its gradient
    is taken at a detached copy of ``recon`` (no generator backward).  Each of
    ``grouped_fns`` returns several named losses from one forward (the
    adversarial and feature losses share one discriminator pass) and each of
    them gets its own gradient from that graph.  The caller pulls the
    cotangent back through the generator once.  Metrics hold each loss and
    its gradient's norm (``{name}_norm``)."""
    total_w = sum(balancer.weights.values())
    count = state['_count'] + 1
    decay = balancer.ema_decay
    leaf = recon.detach().requires_grad_(True)
    cot = torch.zeros_like(leaf)
    new_state: tp.Dict[str, torch.Tensor] = {'_count': count}
    metrics: tp.Dict[str, torch.Tensor] = {}

    def accumulate(name: str, loss: torch.Tensor, g: torch.Tensor) -> None:
        nonlocal cot
        norm = all_sum(g.square().sum(), group).sqrt()
        ema = state[name] * decay + norm * (1 - decay)
        new_state[name] = ema
        ema_hat = ema / (1 - decay ** count)   # bias-corrected
        share = balancer.weights[name] / total_w * balancer.rescale_total
        cot = cot + g * (share / (ema_hat + balancer.epsilon))
        metrics[name] = loss.detach()
        metrics[f'{name}_norm'] = norm

    with torch.enable_grad():
        for name, fn in loss_fns.items():
            loss = fn(leaf)
            accumulate(name, loss, torch.autograd.grad(loss, leaf)[0])
        for fn in grouped_fns:
            losses = fn(leaf)
            names = list(losses)
            for j, name in enumerate(names):
                g = torch.autograd.grad(losses[name], leaf, retain_graph=j < len(names) - 1)[0]
                accumulate(name, losses[name], g)
    return cot, new_state, metrics
