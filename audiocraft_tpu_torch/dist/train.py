"""The LM training step: masked cross-entropy over the codebook pattern
(counterpart of ``audiocraft_tpu/dist/train.py:lm_loss`` and
``make_lm_train_step``).

Mixed precision as the JAX package does it: with ``compute_dtype`` the
forward and backward run on bf16 copies of the parameters and of the
condition tensors (``torch.func.functional_call``), so the gradients reach
the fp32 master parameters through the casts; the cross-entropy is fp32 and
the optimizer state stays fp32.  ``torch.autocast`` is not the same: it
keeps other operations in fp32.

The condition tensors are an input of the step, computed by the caller
under ``no_grad``: the step trains the LM only.  On the card every
self-attention goes through the flash kernels, forward (K3f) and backward
(K3b).

Not ported yet: the data-parallel step over several cards
(``make_lm_train_step_dp``) and the EnCodec training steps.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F

from ..cond.fuser import ConditionType
from ..lm.model import LMModel

Conditions = tp.Mapping[str, ConditionType]
Metrics = tp.Dict[str, torch.Tensor]


class _Predictions(torch.nn.Module):
    """``lm.compute_predictions`` as a module's forward, for ``functional_call``."""

    def __init__(self, lm: LMModel):
        super().__init__()
        self.lm = lm

    def forward(self, codes, condition_tensors):
        return self.lm.compute_predictions(codes, condition_tensors)


def lm_loss(model: LMModel, codes: torch.Tensor, condition_tensors: Conditions,
            compute_dtype: tp.Optional[str] = None) -> torch.Tensor:
    """Mean cross-entropy of ``codes`` [B, K, T] over the frames the pattern
    predicts: NaN logits to 0, masked, fp32 log-softmax."""
    if compute_dtype is None:
        out = model.compute_predictions(codes, condition_tensors)
    else:
        dtype = getattr(torch, compute_dtype)
        params = {f'lm.{name}': p.to(dtype) if p.is_floating_point() else p
                  for name, p in model.named_parameters()}
        conds = {name: (c.to(dtype), m) for name, (c, m) in condition_tensors.items()}
        out = torch.func.functional_call(_Predictions(model), params, (codes, conds))
    logits = torch.where(out.mask[..., None], torch.nan_to_num(out.logits), 0.0).float()
    logp = F.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, codes.long()[..., None])[..., 0]   # [B, K, T]
    mask = out.mask.to(logp.dtype)
    return (ce * mask).sum() / mask.sum().clamp_min(1)


def lm_loss_and_grads(model: LMModel, codes: torch.Tensor, condition_tensors: Conditions,
                      compute_dtype: tp.Optional[str] = None
                      ) -> tp.Tuple[torch.Tensor, tp.List[torch.Tensor]]:
    """:func:`lm_loss` and its gradients, one per ``model.parameters()`` (zeros
    for a parameter the loss does not reach), without an update.  The
    parameters must require gradients (:func:`make_lm_train_step` turns
    them on)."""
    loss = lm_loss(model, codes, condition_tensors, compute_dtype=compute_dtype)
    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), list(grads)


GradsOf = tp.Callable[[torch.Tensor, Conditions],
                      tp.Tuple[torch.Tensor, tp.List[torch.Tensor]]]


def _accumulated_grads(grads_of: GradsOf, codes: torch.Tensor, condition_tensors: Conditions,
                       grad_accum: int) -> tp.Tuple[torch.Tensor, tp.List[torch.Tensor]]:
    """Mean loss and gradients over ``grad_accum`` sequential microbatches,
    summed in the gradients' own dtype (the parameters')."""
    if grad_accum == 1:
        return grads_of(codes, condition_tensors)
    B = codes.shape[0]
    if B % grad_accum:
        raise ValueError(f"batch {B} is not divisible by grad_accum {grad_accum}")
    mb = B // grad_accum
    lsum, gsum = None, None
    for i in range(grad_accum):
        part = slice(i * mb, (i + 1) * mb)
        loss, grads = grads_of(codes[part], {name: (c[part], m[part])
                                             for name, (c, m) in condition_tensors.items()})
        if gsum is None:
            lsum, gsum = loss, list(grads)
        else:
            lsum = lsum + loss
            torch._foreach_add_(gsum, grads)
    torch._foreach_div_(gsum, grad_accum)
    return lsum / grad_accum, gsum


def make_lm_train_step(model: LMModel, optimizer, compute_dtype: tp.Optional[str] = None,
                       grad_accum: int = 1
                       ) -> tp.Callable[[tp.Any, torch.Tensor, Conditions], Metrics]:
    """``step(opt_state, codes, condition_tensors) -> {'loss', 'ce'}``: one
    optimizer update of ``model``'s parameters from the batch, in place.
    ``opt_state`` comes from ``optimizer.init(model.parameters())``.

    ``grad_accum=A`` splits the batch into A sequential microbatches and
    averages their gradients: activation memory drops A times at the same
    effective batch, and the result is the full batch's (the pattern's mask
    does not depend on the batch).  Turns gradients on for ``model``, which
    the builders freeze for serving."""
    model.requires_grad_(True)
    params = list(model.parameters())

    def grads_of(codes, condition_tensors):
        return lm_loss_and_grads(model, codes, condition_tensors, compute_dtype)

    def step(opt_state, codes: torch.Tensor, condition_tensors: Conditions) -> Metrics:
        loss, grads = _accumulated_grads(grads_of, codes, condition_tensors, grad_accum)
        optimizer.update(grads, opt_state, params)
        return {'loss': loss, 'ce': loss}

    return step
