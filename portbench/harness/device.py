"""The device a run uses: synchronising, peak memory, and what the result
line says of the card."""

from __future__ import annotations

import shutil
import subprocess
import typing as tp

import torch


class Device:
    """A CUDA card, or the CPU for the harness's own tests (never for a
    measured run: ``run.py`` refuses to run without a card)."""

    def __init__(self, device: tp.Union[str, torch.device] = 'cuda'):
        self.torch = torch.device(device)
        self.cuda = self.torch.type == 'cuda'

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.torch)

    def reset_peak(self) -> None:
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.torch)

    def peak_bytes(self) -> int:
        return int(torch.cuda.max_memory_allocated(self.torch)) if self.cuda else 0

    def free(self) -> None:
        if self.cuda:
            torch.cuda.empty_cache()

    def generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.torch).manual_seed(int(seed))

    def describe(self) -> dict:
        if not self.cuda:
            return {'platform': 'cpu', 'kind': 'cpu', 'count': 1, 'memory_peak_bytes': 0}
        return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(self.torch),
                'count': 1, 'memory_peak_bytes': self.peak_bytes()}


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them ('' without it)."""
    smi = shutil.which('nvidia-smi')
    if smi is None:
        return ''
    try:
        out = subprocess.run([smi, '--query-gpu=name,power.limit', '--format=csv,noheader'],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return ''
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ''
