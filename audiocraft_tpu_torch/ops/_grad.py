"""The forward-only kernels' guard.

K2 (``lstm_layer``), K4 (``fused_stage``), K5 (``banded_mono_conv``) and K6
(``mono_input_conv``) write their outputs through raw pointers, so an output
has no ``grad_fn``: a graph through one of them would end there without a
word, and the weights and inputs before it would get no gradient.  Their
wrappers therefore refuse any tensor that requires a gradient while grad mode
is on, on the card and on the CPU alike (where the plain version would run),
so a caller learns it on the CPU before it does on the card.  Training takes
the differentiable routes instead: ``lstm_kernel=False`` and the module stack
(``fused_stages=0``, ``conv0_kernel=False``).
"""

from __future__ import annotations

import typing as tp

import torch


def refuse_grad(what: str, tensors: tp.Iterable[tp.Optional[torch.Tensor]], route: str) -> None:
    """Raise when grad mode is on and one of ``tensors`` requires a gradient."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what} has no backward and would cut the autograd graph; call it "
                           f"under torch.no_grad(), or take the differentiable route ({route})")
