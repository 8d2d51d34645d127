"""Rotary positional embedding (RoPE) with optional xPos decay
(counterpart of ``audiocraft_tpu/nn/rope.py``).

The cos/sin form of the reference's complex rotation: for each feature pair
``(x0, x1)`` and rotation ``r = cos + i sin`` the reference computes ``x * (r
* decay * scale + (1 - scale))``, written out here in real arithmetic, in
fp32 and cast back to the input's dtype.  Keys take the inverted xPos decay.

Positions are a tensor on the input's device: a cached decode step passes
``arange(T) + cache.index``, the index being a 0-d device tensor, so the
angles are computed on the device inside a captured CUDA graph and a replay
rotates at the position the index holds then.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RotaryEmbedding:
    dim: int  # per-head dim (twice the number of frequencies)
    max_period: float = 10000.0
    xpos: bool = False
    scale: float = 1.0
    xpos_smoothing: float = 0.4
    xpos_base_scale: int = 512

    def frequencies(self, device: torch.device) -> torch.Tensor:
        adim = torch.arange(0, self.dim, 2, dtype=torch.float32, device=device)[:self.dim // 2]
        return 1.0 / (self.max_period ** (adim / self.dim))

    def decay_rates(self, device: torch.device) -> torch.Tensor:
        half_dim = self.dim // 2
        adim = torch.arange(half_dim, dtype=torch.float32, device=device)
        return (adim / half_dim + self.xpos_smoothing) / (1.0 + self.xpos_smoothing)

    def rotate(self, x: torch.Tensor, positions: torch.Tensor,
               invert_decay: bool = False) -> torch.Tensor:
        """x [B, T, H, D] rotated at ``positions`` [T] (a device tensor)."""
        pos = positions.float()[:, None]
        angles = pos * self.frequencies(x.device)[None, :]          # [T, D/2]
        cos, sin = torch.cos(angles), torch.sin(angles)
        s = self.scale
        if self.xpos:
            decay = self.decay_rates(x.device)[None, :] ** (pos / self.xpos_base_scale)
            if invert_decay:
                decay = 1.0 / decay
            rot_re, rot_im = cos * decay * s + (1.0 - s), sin * decay * s
        else:
            rot_re, rot_im = cos * s + (1.0 - s), sin * s
        rot_re, rot_im = rot_re[None, :, None, :], rot_im[None, :, None, :]
        xf = x.float().unflatten(-1, (-1, 2))
        x0, x1 = xf[..., 0], xf[..., 1]
        out = torch.stack([x0 * rot_re - x1 * rot_im, x0 * rot_im + x1 * rot_re], dim=-1)
        return out.flatten(-2).to(x.dtype)
