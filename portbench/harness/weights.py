"""Seeded weights, made on the device.

The draw rules are data, a configuration's ``assumed.weights``: a list of
``[pattern, rule, value]`` over the state dict's names, the first pattern
that matches (``re.search``) deciding.  Rules:

* ``const``: every element is ``value``;
* ``std``: normal, standard deviation ``value``;
* ``fan_in``: normal, ``value / sqrt(fan_in)`` (fan_in: the product of a
  weight's dims after the first);
* ``convtr_fan_in``: the same with a transposed conv's fan_in (its dims 0 and 2);
* ``width``: normal, ``value / sqrt(last dim)``;
* ``bias_of``: normal, ``value / sqrt(fan_in)`` of the weight beside the bias;
* ``codebook``: left for :func:`seed_codebooks`;
* ``skip``: not drawn (left as the module holds it).

All normal draws come from one ``torch.randn`` on the device, from a
generator seeded with the run's seed, in the order of the state dict, so a
seed gives the same weights in every run.
"""

from __future__ import annotations

import math
import re
import typing as tp

import torch

Rule = tp.Sequence[tp.Any]


def _rule(name: str, rules: tp.Sequence[Rule]) -> tp.Tuple[str, float]:
    for pattern, kind, value in rules:
        if re.search(pattern, name):
            return kind, float(value)
    raise KeyError(f'no weight rule matches {name!r}')


def _fan_in(shape: tp.Sequence[int]) -> int:
    return int(math.prod(shape[1:])) if len(shape) > 1 else int(shape[0])


def seeded_state(shapes: tp.Mapping[str, torch.Size], rules: tp.Sequence[Rule], seed: int,
                 device: torch.device) -> tp.Dict[str, torch.Tensor]:
    """fp32 tensors for every name of ``shapes`` whose rule draws or sets one."""
    plan: tp.List[tp.Tuple[str, str, float]] = []
    total = 0
    for name, shape in shapes.items():
        kind, value = _rule(name, rules)
        if kind in ('skip', 'codebook'):
            continue
        if kind == 'const':
            scale = value
        elif kind == 'std':
            scale = value
        elif kind == 'fan_in':
            scale = value / math.sqrt(_fan_in(shape))
        elif kind == 'convtr_fan_in':
            scale = value / math.sqrt(shape[0] * shape[2])
        elif kind == 'width':
            scale = value / math.sqrt(shape[-1])
        elif kind == 'bias_of':
            weight = re.sub(r'bias(_\w+)?$', lambda m: 'weight' + (m.group(1) or ''), name)
            scale = value / math.sqrt(_fan_in(shapes[weight]))
        else:
            raise ValueError(f'unknown weight rule {kind!r} for {name!r}')
        plan.append((name, kind, scale))
        if kind != 'const':
            total += int(math.prod(shapes[name]))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    out: tp.Dict[str, torch.Tensor] = {}
    offset = 0
    for name, kind, scale in plan:
        shape = tuple(shapes[name])
        if kind == 'const':
            out[name] = torch.full(shape, scale, device=device)
            continue
        n = int(math.prod(shape))
        out[name] = flat[offset:offset + n].view(shape).mul_(scale)
        offset += n
    return out


def seed_codebooks(latent: torch.Tensor, bins: int, n_q: int, seed: int,
                   prefix: str = 'quantizer.vq.layers') -> tp.Dict[str, torch.Tensor]:
    """Codebooks from a latent [B, D, T] of seeded audio, as a k-means start
    would begin: the frames are dealt at random into ``n_q`` groups of
    ``bins``, and codebook q takes its group's residual after codebooks
    0..q-1, so that no codebook holds a frame an earlier one took (a zero
    residual) and codes spread over every codebook (a fresh codebook is
    zeros, on which every frame takes code 0).  Returns the codebook buffers
    under their state-dict names."""
    residual = latent.transpose(1, 2).reshape(-1, latent.shape[1]).float()
    if residual.shape[0] < n_q * bins:
        raise ValueError(f'{residual.shape[0]} frames cannot seed {n_q} x {bins} codes')
    gen = torch.Generator(device=latent.device).manual_seed(int(seed) + 1)
    order = torch.randperm(residual.shape[0], generator=gen, device=latent.device)
    out: tp.Dict[str, torch.Tensor] = {}
    for q in range(n_q):
        embed = residual[order[q * bins:(q + 1) * bins]].clone()
        dist = (residual.square().sum(1, keepdim=True) - 2 * residual @ embed.t()
                + embed.square().sum(1)[None])
        residual = residual - embed[dist.argmin(1)]
        name = f'{prefix}.{q}._codebook'
        out[f'{name}.embed'] = embed
        out[f'{name}.embed_avg'] = embed.clone()
        out[f'{name}.cluster_size'] = torch.zeros(bins, device=latent.device)
        out[f'{name}.inited'] = torch.ones(1, device=latent.device)
    return out
