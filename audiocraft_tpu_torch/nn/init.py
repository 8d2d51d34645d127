"""Seeded random initialisation shared by the port's modules.

Every draw is made on the CPU from a ``torch.Generator``; ``generator=None``
draws from a fresh generator seeded with 0, never from torch's global one.
Builders pass one generator through the whole model, so a seed fixes every
weight on every device.

Under :func:`allocate_only` the functions draw nothing and allocate on the
given device: for a module whose every weight is loaded next (a checkpoint
directory), built where it will run.
"""

from __future__ import annotations

import contextlib
import math
import typing as tp

import torch

Generator = tp.Optional[torch.Generator]


_ALLOCATE_ON: tp.Optional[torch.device] = None


@contextlib.contextmanager
def allocate_only(device: tp.Union[str, torch.device]) -> tp.Iterator[None]:
    """Inside, :func:`uniform`, :func:`normal` and :func:`constant` return
    uninitialised parameters on ``device`` and draw nothing."""
    global _ALLOCATE_ON
    saved, _ALLOCATE_ON = _ALLOCATE_ON, torch.device(device)
    try:
        yield
    finally:
        _ALLOCATE_ON = saved


def _empty(shape: tp.Sequence[int]) -> tp.Optional[torch.nn.Parameter]:
    return None if _ALLOCATE_ON is None else _param(torch.empty(tuple(shape),
                                                                device=_ALLOCATE_ON))


def _gen(generator: Generator) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


def _param(data: torch.Tensor) -> torch.nn.Parameter:
    return torch.nn.Parameter(data, requires_grad=False)


def uniform(shape: tp.Sequence[int], bound: float, generator: Generator) -> torch.nn.Parameter:
    """fp32 parameter drawn uniformly from [-bound, bound)."""
    empty = _empty(shape)
    if empty is not None:
        return empty
    data = torch.rand(tuple(shape), generator=_gen(generator)) * (2 * bound) - bound
    return _param(data)


def normal(shape: tp.Sequence[int], std: float, generator: Generator,
           truncate: tp.Optional[float] = None) -> torch.nn.Parameter:
    """fp32 parameter ``std * N(0, 1)``, optionally truncated to
    [-truncate, truncate] standard deviations before the scaling."""
    empty = _empty(shape)
    if empty is not None:
        return empty
    if truncate is None:
        data = torch.randn(tuple(shape), generator=_gen(generator))
    else:  # inverse CDF of the truncated normal
        lo = 0.5 * (1.0 + math.erf(-truncate / math.sqrt(2.0)))
        u = torch.rand(tuple(shape), generator=_gen(generator)) * (1.0 - 2.0 * lo) + lo
        data = (torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)).clamp_(-truncate, truncate)
    return _param(data * std)


def constant(shape: tp.Sequence[int], value: float) -> torch.nn.Parameter:
    return _param(torch.full(tuple(shape), float(value), device=_ALLOCATE_ON))


def linear(in_features: int, out_features: int, bias: bool, bound: float,
           generator: Generator, bias_bound: tp.Optional[float] = None) -> torch.nn.Linear:
    """``nn.Linear`` with weight uniform in [-bound, bound) and bias zero, or
    uniform in [-bias_bound, bias_bound) when given (torch's own init, which
    draws from the global generator, is skipped)."""
    layer = torch.nn.Linear(in_features, out_features, bias=bias, device='meta')
    layer.weight = uniform((out_features, in_features), bound, generator)
    if bias:
        layer.bias = (constant((out_features,), 0.0) if bias_bound is None
                      else uniform((out_features,), bias_bound, generator))
    return layer


def embedding(num: int, dim: int, weight: torch.nn.Parameter) -> torch.nn.Embedding:
    """``nn.Embedding`` holding ``weight`` [num, dim]."""
    layer = torch.nn.Embedding(num, dim, device='meta')
    layer.weight = weight
    return layer
