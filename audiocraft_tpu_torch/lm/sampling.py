"""Token sampling: greedy, temperature, top-k, top-p
(counterpart of ``audiocraft_tpu/lm/sampling.py``).

Same semantics as the JAX package and the reference: top-k keeps values >=
the k-th largest and renormalises; top-p sorts descending (stable, so equal
probabilities keep the lower index first), keeps the smallest prefix whose
``cumsum - p_i <= p``, renormalises, samples in sorted space and maps back.
Greedy is a first-index argmax.  Draws come from an explicit
``torch.Generator``: uniforms drawn on the generator's device and inverted
through the CDF, so one CPU generator gives the same draws for tensors on any
device.  The JAX package's draws differ by construction; only greedy tokens
and the filtered distributions compare exactly.

A decode loop draws its uniforms up front (:func:`draw_uniforms`, the
counterpart of the JAX package's ``keys = jax.random.split(key, S)``) and
hands each step its row (``u=``): a step captured as a CUDA graph must not
draw, since a draw inside a graph runs once, at capture, and every replay
would reuse its numbers.  The rows are drawn one step at a time, in the
loop's order and shape, so they are the numbers the per-step draws give.
"""

from __future__ import annotations

import typing as tp

import torch


def draw_uniforms(generator: torch.Generator, steps: int, shape: tp.Sequence[int],
                  device: tp.Union[str, torch.device, None] = None) -> torch.Tensor:
    """[steps, *shape, 1] uniforms, row i being what :func:`multinomial`
    draws at the i-th call on probabilities of ``shape + (card,)``."""
    draws = [torch.rand(tuple(shape) + (1,), generator=generator, device=generator.device)
             for _ in range(steps)]
    if not draws:
        return torch.zeros((0,) + tuple(shape) + (1,), device=device)
    return torch.stack(draws).to(device)


def multinomial(probs: torch.Tensor, generator: tp.Optional[torch.Generator] = None,
                u: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
    """One index per row of probabilities on the last axis (rows need not sum
    to one); indices of zero probability are never drawn.  ``u`` (shape
    ``probs.shape[:-1] + (1,)``) gives the uniforms drawn up front; without
    it they are drawn from ``generator``."""
    cdf = probs.float().cumsum(-1)
    if u is None:
        u = torch.rand(probs.shape[:-1] + (1,), generator=generator, device=generator.device)
    u = u.to(probs.device) * cdf[..., -1:]
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    return idx.clamp_max(probs.shape[-1] - 1)[..., 0]


def top_k_filter(probs: torch.Tensor, k: int) -> torch.Tensor:
    """Keep probabilities >= the k-th largest, renormalised (k beyond the
    vocabulary keeps everything)."""
    k = min(k, probs.shape[-1])
    kth = torch.topk(probs, k, dim=-1).values[..., -1:]
    probs = probs * (probs >= kth)
    return probs / probs.sum(-1, keepdim=True)


def top_p_filter(probs: torch.Tensor, p: float):
    """(renormalised sorted probabilities, sort indices) of the top-p nucleus."""
    probs_sort, sort_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    probs_sum = probs_sort.cumsum(-1)
    probs_sort = torch.where((probs_sum - probs_sort) > p, 0.0, probs_sort)
    return probs_sort / probs_sort.sum(-1, keepdim=True), sort_idx


def sample_top_k(probs: torch.Tensor, k: int, generator: tp.Optional[torch.Generator] = None,
                 u: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
    return multinomial(top_k_filter(probs, k), generator, u)


def sample_top_p(probs: torch.Tensor, p: float, generator: tp.Optional[torch.Generator] = None,
                 u: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
    probs_sort, sort_idx = top_p_filter(probs, p)
    next_sorted = multinomial(probs_sort, generator, u)
    return torch.gather(sort_idx, -1, next_sorted[..., None])[..., 0]


def samples(use_sampling: bool, temp: float) -> bool:
    """Whether :func:`sample_token` draws (else it takes the argmax)."""
    return use_sampling and temp > 0.0


def sample_token(logits: torch.Tensor, use_sampling: bool, temp: float, top_k: int,
                 top_p: float, generator: tp.Optional[torch.Generator] = None,
                 u: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits [..., card] -> token indices [...]; ``u`` as in :func:`multinomial`."""
    if samples(use_sampling, temp):
        probs = torch.softmax(logits / temp, dim=-1)
        if top_p > 0.0:
            return sample_top_p(probs, top_p, generator, u)
        if top_k > 0:
            return sample_top_k(probs, top_k, generator, u)
        return multinomial(probs, generator, u)
    return torch.argmax(logits, dim=-1)
