"""Seeded random initialisation shared by the port's modules."""

from __future__ import annotations

import typing as tp

import torch


def uniform(shape: tp.Sequence[int], bound: float,
            generator: tp.Optional[torch.Generator]) -> torch.nn.Parameter:
    """fp32 parameter drawn uniformly from [-bound, bound) on the CPU.

    ``generator=None`` draws from a fresh generator seeded with 0, never from
    torch's global one; builders pass one generator through the whole model so
    that a seed fixes every weight.
    """
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    data = torch.rand(tuple(shape), generator=generator) * (2 * bound) - bound
    return torch.nn.Parameter(data, requires_grad=False)
