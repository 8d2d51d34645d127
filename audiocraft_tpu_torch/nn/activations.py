"""Activations (counterpart of ``audiocraft_tpu/nn/activations.py``).

Ported so far: ELU (the EnCodec configs), the transformer feed-forward
activations (exact GELU and ReLU), and SiLU, tanh and sigmoid, which a SEANet
decoder's ``final_activation`` may name.  The gated units wait for a config
that uses them.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F


def elu(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    return F.elu(x, alpha)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)  # exact (erf) form, as jax.nn.gelu(approximate=False)


_ACTIVATIONS: tp.Dict[str, tp.Callable[..., torch.Tensor]] = {
    'elu': elu, 'gelu': gelu, 'relu': F.relu, 'silu': F.silu, 'tanh': torch.tanh,
    'sigmoid': torch.sigmoid}


def get_activation_fn(name: str) -> tp.Callable[..., torch.Tensor]:
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise RuntimeError(f"activation should be one of {sorted(_ACTIVATIONS)}, not {name}")


class Activation(torch.nn.Module):
    """An activation layer named as SEANet configs name it (torch class names,
    e.g. ``'ELU'``); it holds no parameters but takes an index in the layer
    list, as in the reference state-dict layout.  ``alpha`` is ELU's; the
    other activations take none."""

    def __init__(self, name: str = 'ELU', alpha: float = 1.0):
        super().__init__()
        self.name = name.lower()
        self.fn = get_activation_fn(self.name)
        self.alpha = alpha

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x, self.alpha) if self.name == 'elu' else self.fn(x)
