"""Music-like audio made on the device from a seed.

Each clip holds ``notes`` harmonic notes (fundamentals drawn over
``midi_range``, ``harmonics`` partials at 1/k amplitude, an attack and an
exponential decay, start and length drawn over the clip) and ``bursts``
noise bursts with the same envelope, scaled to an RMS level drawn from
``level_dbfs``.  The counts are fixed, so every seed gives the same amount
of work; the seed draws pitches, times and levels.
"""

from __future__ import annotations

import math
import typing as tp

import torch


def music_batch(gen: torch.Generator, batch: int, samples: int, sample_rate: int,
                params: tp.Mapping[str, tp.Any]) -> torch.Tensor:
    """[batch, 1, samples] fp32 on the generator's device."""
    device = gen.device

    def draw(*shape: int) -> torch.Tensor:
        return torch.rand(*shape, generator=gen, device=device)

    t = torch.arange(samples, device=device, dtype=torch.float32) / sample_rate
    seconds = samples / sample_rate
    out = torch.zeros(batch, samples, device=device)
    attack = float(params.get('attack_s', 0.01))

    def envelope(start: torch.Tensor, length: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
        rel = t[None] - start[:, None]
        on = (rel >= 0) & (rel < length[:, None])
        return torch.where(on, torch.clamp(rel / attack, max=1.0)
                           * torch.exp(-rel.clamp(min=0) / decay[:, None]), 0.0)

    lo, hi = params['midi_range']
    for _ in range(int(params['notes'])):
        midi = lo + (hi - lo) * draw(batch)
        f0 = 440.0 * 2.0 ** ((midi - 69.0) / 12.0)
        start = draw(batch) * seconds * 0.9
        length = (0.2 + 0.8 * draw(batch)) * seconds * 0.5
        env = envelope(start, length, 0.1 + 0.9 * draw(batch))
        phase = 2 * math.pi * draw(batch)
        for k in range(1, int(params['harmonics']) + 1):
            out += env * torch.sin(2 * math.pi * k * f0[:, None] * t[None] + k * phase[:, None]) / k
    for _ in range(int(params['bursts'])):
        start = draw(batch) * seconds * 0.95
        length = (0.02 + 0.2 * draw(batch)) * seconds * 0.1
        noise = torch.randn(batch, samples, generator=gen, device=device)
        out += 0.5 * envelope(start, length, 0.05 + 0.2 * draw(batch)) * noise
    lo_db, hi_db = params['level_dbfs']
    level = 10.0 ** ((lo_db + (hi_db - lo_db) * draw(batch)) / 20.0)
    rms = out.square().mean(1, keepdim=True).sqrt().clamp(min=1e-6)
    return (out * (level[:, None] / rms))[:, None]
