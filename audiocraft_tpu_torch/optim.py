"""Optimizers, learning-rate schedules and the weight EMA for training
(counterpart of ``audiocraft_tpu/optim.py``, which builds them on optax).

The update rules are optax's, written out, because ``torch.optim`` differs
in places that change the numbers:

* Adam and AdamW: ``mu_hat / (sqrt(nu_hat) + eps)`` with the bias
  corrections of step ``t = count + 1``; AdamW adds the decoupled decay to
  the update, ``p - lr * (u + wd * p)``.
* The learning rate of a schedule is read at the update's count, from 0 for
  the first update.
* ``clip_by_global_norm``: ``g / norm * max_norm`` only where
  ``norm >= max_norm`` (``torch.nn.utils.clip_grad_norm_`` divides by
  ``norm + 1e-6`` instead).

Schedules are plain ``step -> lr`` functions.  Updates run in place on the
parameters and the state, with ``torch._foreach`` ops over all tensors at
once, so an update costs a few kernel launches rather than a few per tensor.
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp

import torch

__all__ = ['cosine_schedule', 'inverse_sqrt_schedule', 'linear_warmup',
           'polynomial_decay_schedule', 'get_lr_schedule', 'make_optimizer', 'Optimizer',
           'OptState', 'ema_update']

Schedule = tp.Callable[[int], float]
Tensors = tp.Sequence[torch.Tensor]


def linear_warmup(base_lr: float, warmup_steps: int) -> Schedule:
    """lr ramps 0 -> base_lr over ``warmup_steps``, then holds."""
    def fn(step: int) -> float:
        if warmup_steps <= 0:
            return base_lr
        return base_lr * min(1.0, (step + 1) / warmup_steps)
    return fn


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    lr_min_ratio: float = 0.0, cycle_length: float = 1.0) -> Schedule:
    """Linear warm-up, then cosine decay to ``lr_min_ratio * base_lr`` at
    ``total_steps`` (half a cosine cycle scaled by ``cycle_length``)."""
    def fn(step: int) -> float:
        if step < warmup_steps:
            return base_lr * min((step + 1) / max(warmup_steps, 1), 1.0)
        progress = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        progress = min(max(progress, 0.0), 1.0)
        return base_lr * (lr_min_ratio + (1 - lr_min_ratio) * 0.5 * (
            1 + math.cos(math.pi * progress / cycle_length)))
    return fn


def inverse_sqrt_schedule(base_lr: float, warmup_steps: int) -> Schedule:
    """Linear warm-up, then ``base_lr * sqrt(warmup / step)``."""
    def fn(step: int) -> float:
        if step < warmup_steps:
            return base_lr * (step + 1) / max(warmup_steps, 1)
        return base_lr * math.sqrt(max(warmup_steps, 1) / max(step + 1, 1.0))
    return fn


def polynomial_decay_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                              end_lr: float = 0.0, power: float = 1.0) -> Schedule:
    """Linear warm-up, then polynomial decay to ``end_lr`` at ``total_steps``."""
    def fn(step: int) -> float:
        if step < warmup_steps:
            return base_lr * (step + 1) / max(warmup_steps, 1)
        progress = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        progress = min(max(progress, 0.0), 1.0)
        return (base_lr - end_lr) * (1 - progress) ** power + end_lr
    return fn


def get_lr_schedule(name: tp.Optional[str], base_lr: float, warmup_steps: int = 0,
                    total_steps: int = 1, **kw) -> tp.Union[float, Schedule]:
    """'cosine', 'inverse_sqrt', 'polynomial', 'linear_warmup', or None /
    'constant' for a plain float."""
    if name is None or name == 'constant':
        return base_lr
    if name == 'cosine':
        return cosine_schedule(base_lr, warmup_steps, total_steps, **kw)
    if name == 'inverse_sqrt':
        return inverse_sqrt_schedule(base_lr, warmup_steps)
    if name == 'polynomial':
        return polynomial_decay_schedule(base_lr, warmup_steps, total_steps, **kw)
    if name == 'linear_warmup':
        return linear_warmup(base_lr, warmup_steps)
    raise ValueError(f"unknown lr schedule {name!r}")


@dataclasses.dataclass
class OptState:
    count: int                # updates applied so far
    mu: tp.List[torch.Tensor]  # first moments, one per parameter
    nu: tp.List[torch.Tensor]  # second moments


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Adam (``weight_decay`` 0) or AdamW, after optional global-norm clipping."""
    lr: tp.Union[float, Schedule]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    max_grad_norm: tp.Optional[float] = None

    def init(self, params: Tensors) -> OptState:
        return OptState(0, [torch.zeros_like(p) for p in params],
                        [torch.zeros_like(p) for p in params])

    def lr_at(self, count: int) -> float:
        return self.lr(count) if callable(self.lr) else self.lr

    @torch.no_grad()
    def update(self, grads: Tensors, state: OptState, params: Tensors) -> None:
        """One update of ``params`` and ``state``, in place."""
        grads = list(grads)
        if self.max_grad_norm is not None:
            grads = clip_by_global_norm(grads, self.max_grad_norm)
        t = state.count + 1
        torch._foreach_mul_(state.mu, self.b1)
        torch._foreach_add_(state.mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(state.nu, self.b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1 - self.b2)
        denom = torch._foreach_div(state.nu, 1 - self.b2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(state.mu, 1 - self.b1 ** t)
        torch._foreach_div_(updates, denom)
        if self.weight_decay:
            torch._foreach_add_(updates, list(params), alpha=self.weight_decay)
        torch._foreach_add_(list(params), updates, alpha=-self.lr_at(state.count))
        state.count = t


def clip_by_global_norm(grads: Tensors, max_norm: float) -> tp.List[torch.Tensor]:
    """optax's ``clip_by_global_norm``: unchanged below ``max_norm``, else
    ``g / norm * max_norm``."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm.to(g.dtype) * max_norm) for g in grads]


def make_optimizer(name: str = 'adamw', lr: tp.Union[float, Schedule] = 3e-4,
                   betas: tp.Tuple[float, float] = (0.9, 0.95), eps: float = 1e-8,
                   weight_decay: float = 0.0,
                   max_grad_norm: tp.Optional[float] = None) -> Optimizer:
    """'adam' or 'adamw' with optional clipping and a constant or scheduled
    learning rate ('adam' takes no weight decay, as ``optax.adam``)."""
    if name not in ('adam', 'adamw'):
        raise ValueError(f"unknown optimizer {name!r}")
    return Optimizer(lr, betas[0], betas[1], eps, weight_decay if name == 'adamw' else 0.0,
                     max_grad_norm)


@torch.no_grad()
def ema_update(ema_params: Tensors, params: Tensors, decay: float) -> None:
    """One EMA step, in place: ema = decay * ema + (1 - decay) * p; tensors
    that are not floating point take p."""
    floats = [(e, p) for e, p in zip(ema_params, params) if e.is_floating_point()]
    for e, p in zip(ema_params, params):
        if not e.is_floating_point():
            e.copy_(p)
    if floats:
        ema = [e for e, _ in floats]
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, [p.to(e.dtype) for e, p in floats], alpha=1.0 - decay)
