"""Sinc resampling with the math of julius.ResampleFrac
(counterpart of ``audiocraft_tpu/io/resample.py``: ``resample_frac`` only).

The filter bank is built on the host in numpy exactly as julius does
(windowed sinc, ``zeros=24`` taps, cutoff at the lower Nyquist), then applied
as one strided ``conv1d`` over the zero-padded signal.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(32)
def _kernels(old_sr: int, new_sr: int, zeros: int = 24, rolloff: float = 0.945) -> np.ndarray:
    """[new_sr, 1, kernel_width] filter bank (julius.resample.ResampleFrac)."""
    gcd = math.gcd(old_sr, new_sr)
    old_sr //= gcd
    new_sr //= gcd
    sr = min(new_sr, old_sr) * rolloff
    width = math.ceil(zeros * old_sr / sr)
    idx = np.arange(-width, width + old_sr, dtype=np.float64)
    kernels = []
    for i in range(new_sr):
        t = np.clip((-i / new_sr + idx / old_sr) * sr, -zeros, zeros)
        window = np.cos(t / zeros / 2 * np.pi) ** 2
        kernels.append(np.sinc(t) * window)
    return (np.stack(kernels) * (sr / old_sr))[:, None, :].astype(np.float32)


def resample_frac(x: torch.Tensor, old_sr: int, new_sr: int, zeros: int = 24,
                  rolloff: float = 0.945) -> torch.Tensor:
    """Resample the last axis of ``x`` from ``old_sr`` to ``new_sr``."""
    if old_sr == new_sr:
        return x
    gcd = math.gcd(old_sr, new_sr)
    old_sr_r, new_sr_r = old_sr // gcd, new_sr // gcd
    length = x.shape[-1]
    shape = x.shape[:-1]
    x2 = x.reshape(-1, 1, length)
    kernels = torch.from_numpy(_kernels(old_sr, new_sr, zeros, rolloff)).to(x2)
    width = (kernels.shape[-1] - old_sr_r) // 2
    x2 = F.pad(x2, (width, width + old_sr_r))
    ys = F.conv1d(x2, kernels, stride=old_sr_r)               # [N, new_sr_r, frames]
    y = ys.transpose(1, 2).reshape(x2.shape[0], -1)
    target_length = int(math.ceil(new_sr_r * length / old_sr_r))
    return y[..., :target_length].reshape(*shape, target_length)
