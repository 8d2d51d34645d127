"""Stereo by per-channel encoding and interleaved codes
(counterpart of ``audiocraft_tpu/codec/stereo.py``).

:class:`InterleaveStereoCompressionModel` wraps a mono ``EncodecModel``.  The
two channels run through it as one doubled batch ``[2B, 1, T]`` (left rows
first), so the mono codec's kernels see twice the batch in one launch each,
and the codes interleave on the codebook axis ``[B, 2K, T]`` (left and right
of codebook k at rows 2k and 2k + 1) or, with ``per_timestep``, on the time
axis ``[B, K, 2T]``.  The wrapper holds no parameters of its own: its state
dict is the wrapped codec's under ``model.``.
"""

from __future__ import annotations

import typing as tp

import torch

from .encodec import EncodecModel


class InterleaveStereoCompressionModel(torch.nn.Module):

    def __init__(self, model: EncodecModel, per_timestep: bool = False):
        super().__init__()
        if model.channels != 1:
            raise ValueError("the wrapped model is expected to be for monophonic audio")
        self.model = model
        self.per_timestep = per_timestep

    @property
    def total_codebooks(self) -> int:
        return self.model.total_codebooks

    @property
    def num_codebooks(self) -> int:
        """Codebooks after interleaving: twice the mono codec's on the
        codebook axis, as many on the time axis."""
        return self.model.num_codebooks * (1 if self.per_timestep else 2)

    def set_num_codebooks(self, n: int) -> None:
        """Use the first ``n`` codebooks of the wrapped codec from now on (in
        place on the wrapped codec; the JAX package returns a new wrapper)."""
        self.model.set_num_codebooks(n)

    @property
    def num_virtual_steps(self) -> int:
        return 2 if self.per_timestep else 1

    @property
    def frame_rate(self) -> float:
        return self.model.frame_rate * self.num_virtual_steps

    @property
    def sample_rate(self) -> int:
        return self.model.sample_rate

    @property
    def channels(self) -> int:
        return 2

    @property
    def cardinality(self) -> int:
        return self.model.cardinality

    @torch.no_grad()
    def encode(self, x: torch.Tensor, **kw) -> tp.Tuple[torch.Tensor, tp.Optional[torch.Tensor]]:
        """x [B, 2, T] -> (codes, scale [B, 2] or None); ``kw`` goes to the
        mono codec's ``encode`` (its route and dtype)."""
        B, C, _ = x.shape
        if C != 2:
            raise ValueError(f"expecting stereo audio but audio num channels is {C}")
        codes, scales = self.model.encode(torch.cat([x[:, 0:1], x[:, 1:2]], dim=0), **kw)
        stacked = torch.stack([codes[:B], codes[B:]], dim=0)       # [2, B, K, T]
        scale = None if scales is None else torch.stack([scales[:B], scales[B:]], dim=1)
        if self.per_timestep:
            out = stacked.permute(1, 2, 3, 0).reshape(B, stacked.shape[2], -1)
        else:
            out = stacked.permute(1, 2, 0, 3).reshape(B, -1, stacked.shape[3])
        return out.contiguous(), scale

    def get_left_right_codes(self, codes: torch.Tensor
                             ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        """Interleaved codes -> (left, right), each [B, K, T] of the mono codec."""
        B, K, T = codes.shape
        if self.per_timestep:
            stacked = codes.reshape(B, K, T // 2, 2).permute(3, 0, 1, 2)
        else:
            stacked = codes.reshape(B, K // 2, 2, T).permute(2, 0, 1, 3)
        return stacked[0], stacked[1]

    def both_channels(self, codes: torch.Tensor, scale: tp.Optional[torch.Tensor]
                      ) -> tp.Tuple[torch.Tensor, tp.Optional[torch.Tensor]]:
        """The mono codec's codes of both channels as one doubled batch."""
        B, K, T = codes.shape
        if T % self.num_virtual_steps or K != self.num_codebooks:
            raise ValueError(f"codes {tuple(codes.shape)} do not interleave "
                             f"{self.num_codebooks} codebooks per_timestep={self.per_timestep}")
        left, right = self.get_left_right_codes(codes)
        scales = None
        if scale is not None:
            if tuple(scale.shape[:2]) != (B, 2):
                raise ValueError(f"stereo scale {tuple(scale.shape)} is not [{B}, 2]")
            scales = torch.cat([scale[:, 0], scale[:, 1]], dim=0)
        return torch.cat([left, right], dim=0).contiguous(), scales

    @staticmethod
    def stereo_audio(audio: torch.Tensor) -> torch.Tensor:
        """The mono codec's doubled batch [2B, 1, T] -> [B, 2, T]."""
        B = audio.shape[0] // 2
        return torch.cat([audio[:B], audio[B:]], dim=1)

    @torch.no_grad()
    def decode(self, codes: torch.Tensor, scale: tp.Optional[torch.Tensor] = None,
               **kw) -> torch.Tensor:
        """Interleaved codes -> waveform [B, 2, T] fp32."""
        both, scales = self.both_channels(codes, scale)
        return self.stereo_audio(self.model.decode(both, scales, **kw))
