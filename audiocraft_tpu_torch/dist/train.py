"""Training steps: EnCodec reconstruction and GAN training, and the LM's
cross-entropy, on one process or a data-parallel group (counterpart of
``audiocraft_tpu/dist/train.py``).

The codec steps (:func:`encodec_loss`, :func:`make_encodec_train_step`,
:func:`make_encodec_gan_train_step`) run ``EncodecModel.forward`` in
training: the module stack with the differentiable LSTM route, the
quantizer's EMA updated in place in its buffers.  The GAN step is the JAX
package's: the discriminator updates on the detached reconstruction, the
balancer builds the generator's cotangent at the reconstruction (each loss
differentiated there only; the adversarial and feature losses share one
discriminator pass), and one backward carries it, with the penalty's
weight, through the generator.  ``on_part(name)``, when given, is called
after each part of the GAN step ('generator forward', 'discriminator
update', 'balancer', 'generator backward', 'optimizer'), for a caller that
times them.  An fp32 step (``compute_dtype`` None) runs without TF32 in
cuDNN, backward included (``nn/conv.fp32_convs``).

With a ``group`` (``dist/mesh.py``) each rank takes its shard of the batch
and the step computes what the JAX step computes over the global batch on a
``('data',)`` mesh: the losses and the penalty are global means, the
balancer's norms the global gradient's, the EMA statistics summed and
k-means and expiry over the gathered rows, and the parameter gradients the
sum of the ranks' shares.  Every rank draws from an identically seeded
generator, so the ranks hold the same codebooks and weights.

The LM step's mixed precision is the JAX package's: with ``compute_dtype``
the forward and backward run on bf16 copies of the parameters and of the
condition tensors (``torch.func.functional_call``), so the gradients reach
the fp32 master parameters through the casts; the cross-entropy is fp32 and
the optimizer state stays fp32.  ``torch.autocast`` is not the same: it
keeps other operations in fp32.  The condition tensors are an input of the
step, computed by the caller under ``no_grad``: the step trains the LM only.
On the card every self-attention goes through the flash kernels, forward
(K3f) and backward (K3b).  With a ``group``, :func:`make_lm_train_step` is
the JAX package's ``make_lm_train_step_dp`` (a ``shard_map`` step): each
rank's accumulated gradients and loss, then their means over the group.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F

from ..codec.encodec import EncodecModel
from ..cond.fuser import ConditionType
from ..lm.model import LMModel
from ..nn.conv import fp32_convs
from ..quant.vq import Draws
from .mesh import Group, all_sum, global_mean, mean_grads, sum_grads, world_size

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
                       grad_accum: int = 1, group: Group = None
                       ) -> tp.Callable[[tp.Any, torch.Tensor, Conditions], Metrics]:
    """``step(opt_state, codes, condition_tensors) -> {'loss', 'ce'}``: one
    optimizer update of ``model``'s parameters from the batch, in place.
    ``opt_state`` comes from ``optimizer.init(model.parameters())``.

    ``grad_accum=A`` splits the batch into A sequential microbatches and
    averages their gradients: activation memory drops A times at the same
    effective batch, and the result is the full batch's (the pattern's mask
    does not depend on the batch).  With a ``group`` each rank passes its
    shard of the codes and condition tensors (``mesh.shard_batch``), and the
    gradients and the loss are then averaged over the group, so every rank
    applies the one-process step's update on the whole batch.  Turns
    gradients on for ``model``, which the builders freeze for serving."""
    model.requires_grad_(True)
    params = list(model.parameters())

    def grads_of(codes, condition_tensors):
        return lm_loss_and_grads(model, codes, condition_tensors, compute_dtype)

    def step(opt_state, codes: torch.Tensor, condition_tensors: Conditions) -> Metrics:
        loss, grads = _accumulated_grads(grads_of, codes, condition_tensors, grad_accum)
        grads = mean_grads(grads, group)
        loss = all_sum(loss, group) / world_size(group)
        optimizer.update(grads, opt_state, params)
        return {'loss': loss, 'ce': loss}

    return step


# ------------------------------------------------------------------ the codec


def _compute_dtype(compute_dtype: tp.Optional[str]) -> torch.dtype:
    return torch.float32 if compute_dtype is None else getattr(torch, compute_dtype)


def encodec_loss(model: EncodecModel, x: torch.Tensor,
                 generator: tp.Optional[torch.Generator] = None,
                 draws: tp.Optional[Draws] = None, commit_weight: float = 1.0,
                 expiry: str = 'effective', compute_dtype: tp.Optional[str] = None,
                 group: Group = None) -> tp.Tuple[torch.Tensor, Metrics]:
    """Reconstruction (L1 + L2) plus the weighted commitment penalty of one
    training forward, and its parts ``{'l1', 'l2', 'penalty'}``.  Training
    defaults to ``expiry='effective'``, as the JAX package's does: the
    reference's literal expiry changes nothing within a step."""
    res = model(x, training=True, generator=generator, draws=draws, group=group,
                expiry=expiry, compute_dtype=compute_dtype)
    l1 = global_mean((res.x - x).abs(), group)
    l2 = global_mean((res.x - x).square(), group)
    loss = l1 + l2 + commit_weight * res.penalty
    return loss, {'l1': l1.detach(), 'l2': l2.detach(), 'penalty': res.penalty.detach()}


def _mark(on_part: tp.Optional[tp.Callable[[str], None]], name: str) -> None:
    if on_part is not None:
        on_part(name)


def _train_params(module: torch.nn.Module) -> tp.List[torch.Tensor]:
    module.requires_grad_(True)
    return list(module.parameters())


def make_encodec_train_step(model: EncodecModel, optimizer,
                            compute_dtype: tp.Optional[str] = None, commit_weight: float = 1.0,
                            expiry: str = 'effective', group: Group = None):
    """``step(opt_state, x, generator=None, draws=None, on_part=None) ->
    {'loss', 'l1', 'l2', 'penalty'}``: one optimizer update of the codec's
    weights from the batch ``x`` [B, C, T] (this rank's shard with a
    ``group``), the codebooks updated by EMA, in place.  ``opt_state`` comes
    from ``optimizer.init(model.parameters())``.  ``compute_dtype='bfloat16'``
    is mixed precision: bf16 SEANet forward and backward, fp32 masters,
    optimizer, losses and quantizer.  ``on_part`` is called after 'forward',
    'backward' and 'optimizer'."""
    params = _train_params(model)

    def step(opt_state, x: torch.Tensor, generator: tp.Optional[torch.Generator] = None,
             draws: tp.Optional[Draws] = None,
             on_part: tp.Optional[tp.Callable[[str], None]] = None) -> Metrics:
        with fp32_convs(_compute_dtype(compute_dtype)):
            loss, metrics = encodec_loss(model, x, generator, draws, commit_weight, expiry,
                                         compute_dtype, group)
            _mark(on_part, 'forward')
            grads = sum_grads(torch.autograd.grad(loss, params, allow_unused=True,
                                                  materialize_grads=True), group)
            _mark(on_part, 'backward')
        optimizer.update(grads, opt_state, params)
        _mark(on_part, 'optimizer')
        return {'loss': loss.detach(), **metrics}

    return step


GAN_WEIGHTS = {'l1': 0.1, 'l2': 1.0, 'msspec': 3.0, 'adv': 4.0, 'feat': 4.0}


def make_encodec_gan_train_step(model: EncodecModel, disc: torch.nn.Module, g_optimizer,
                                d_optimizer, balancer=None, commit_weight: float = 1.0,
                                expiry: str = 'effective',
                                compute_dtype: tp.Optional[str] = None, group: Group = None):
    """The EnCodec recipe: reconstruction, multi-scale mel, hinge
    adversarial and feature matching, combined by the balancer (default: the
    JAX package's weights, :data:`GAN_WEIGHTS`), against ``disc``.

    ``step(g_opt_state, d_opt_state, bal_state, x, generator=None,
    draws=None, on_part=None) -> metrics`` updates the codec, its
    codebooks, the discriminator, both optimizer states and ``bal_state``
    (from ``balancer.init_state()``) in place; the metrics hold each loss,
    its gradient norm, ``d_loss`` and ``penalty``."""
    from ..adversarial import feature_matching_loss, hinge_d_loss, hinge_g_loss
    from ..losses import Balancer, MultiScaleMelSpectrogramLoss, balanced_cotangent

    balancer = balancer or Balancer(weights=dict(GAN_WEIGHTS))
    msspec = MultiScaleMelSpectrogramLoss(sample_rate=model.sample_rate)
    g_params, d_params = _train_params(model), _train_params(disc)

    def step(g_opt_state, d_opt_state, bal_state: tp.Dict[str, torch.Tensor], x: torch.Tensor,
             generator: tp.Optional[torch.Generator] = None, draws: tp.Optional[Draws] = None,
             on_part: tp.Optional[tp.Callable[[str], None]] = None) -> Metrics:
        with fp32_convs(_compute_dtype(compute_dtype)):
            res = model(x, training=True, generator=generator, draws=draws, group=group,
                        expiry=expiry, compute_dtype=compute_dtype)
            recon, penalty = res.x, res.penalty
            _mark(on_part, 'generator forward')

            recon_d = recon.detach()
            d_loss = hinge_d_loss(disc(x)[0], disc(recon_d)[0], group)
            d_grads = torch.autograd.grad(d_loss, d_params)
            d_optimizer.update(sum_grads(d_grads, group), d_opt_state, d_params)
            _mark(on_part, 'discriminator update')

            with torch.no_grad():
                real_feats = disc(x)[1]

            def disc_group(r):
                fake_logits, fake_feats = disc(r)
                return {'adv': hinge_g_loss(fake_logits, group),
                        'feat': feature_matching_loss(real_feats, fake_feats, group=group)}

            loss_fns = {'l1': lambda r: global_mean((r - x).abs(), group),
                        'l2': lambda r: global_mean((r - x).square(), group),
                        'msspec': lambda r: msspec(r, x, group)}
            cot, new_bal, metrics = balanced_cotangent(balancer, recon_d, loss_fns, bal_state,
                                                       grouped_fns=(disc_group,), group=group)
            bal_state.update(new_bal)
            _mark(on_part, 'balancer')

            g_grads = torch.autograd.grad([recon, penalty], g_params,
                                          [cot, torch.full_like(penalty, commit_weight)],
                                          allow_unused=True, materialize_grads=True)
            g_grads = sum_grads(g_grads, group)
            _mark(on_part, 'generator backward')
        g_optimizer.update(g_grads, g_opt_state, g_params)
        _mark(on_part, 'optimizer')
        return {**metrics, 'd_loss': d_loss.detach(), 'penalty': penalty.detach()}

    return step
