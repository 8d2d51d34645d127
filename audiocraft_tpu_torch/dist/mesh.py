"""The data-parallel process group and its reductions
(counterpart of ``audiocraft_tpu/dist/mesh.py``'s ``('data',)`` axis).

The JAX package writes global-view code over a 1-D ``('data',)`` mesh, and
GSPMD computes every mean, norm and sample of a step over the global batch.
Here each rank runs its own shard, so a step reproduces the global numbers
with these helpers over a ``group`` (a ``torch.distributed`` process group;
None is one process, where every helper is the identity):

* :func:`global_sum` sums a tensor over the group with the partial
  derivative as its backward (the identity): a loss written as a function of
  global sums has the global loss's value on every rank, and its backward
  gives each rank's share of the global gradient; :func:`sum_grads` then adds
  the shares.  :func:`global_mean` is the global batch's mean.
* :func:`all_sum` sums statistics that carry no gradient (the EMA counts,
  the balancer's squared norms); :func:`mean_grads` averages gradients (the
  LM step's ``pmean``).
* :func:`gather_rows` concatenates the ranks' rows in rank order, the
  global batch's order, for k-means and dead-code expiry.
* :func:`shard_batch` takes a rank's contiguous part of the global batch.

:func:`make_data_group` joins the group (gloo on the CPU, NCCL on CUDA) from
explicit arguments or ``torchrun``'s environment variables.  The
tensor-parallel ``'model'`` axis is not ported.
"""

from __future__ import annotations

import os
import typing as tp

import torch
import torch.distributed as dist

Group = tp.Optional[tp.Any]   # a torch.distributed ProcessGroup, or None for one process


def world_size(group: Group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group: Group) -> int:
    return 0 if group is None else dist.get_rank(group)


def make_data_group(backend: tp.Optional[str] = None, init_method: tp.Optional[str] = None,
                    world: tp.Optional[int] = None, process_rank: tp.Optional[int] = None) -> Group:
    """The data-parallel group over every process: joins it first when this
    process has not (``init_method`` / ``world`` / ``process_rank``, or else
    ``torchrun``'s ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK``).  ``backend`` defaults to NCCL with a CUDA card, gloo without."""
    if not dist.is_initialized():
        backend = backend or ('nccl' if torch.cuda.is_available() else 'gloo')
        if init_method is None:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, init_method=init_method, world_size=world,
                                    rank=process_rank)
    return dist.group.WORLD


def in_torchrun() -> bool:
    """True when ``torchrun`` (or the same environment) launched this process."""
    return all(k in os.environ for k in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT'))


def shard_batch(x: torch.Tensor, group: Group) -> torch.Tensor:
    """This rank's contiguous part of the global batch ``x`` [B, ...]."""
    n = world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} does not divide over {n} ranks")
    b = x.shape[0] // n
    return x[rank(group) * b:(rank(group) + 1) * b]


def all_sum(t: torch.Tensor, group: Group) -> torch.Tensor:
    """``t`` summed over the group (no gradient)."""
    if group is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=group)
    return t


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def global_sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``x`` summed over the group; the backward is the partial derivative
    of the sum in this rank's term (the identity)."""
    return x if group is None else _GlobalSum.apply(x, group)


def global_mean(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The mean of ``x`` over the global batch (equal shards on every rank),
    as ``global_sum(sum) / count``, the same arithmetic with and without a
    group."""
    return global_sum(x.sum(), group) / (x.numel() * world_size(group))


def gather_rows(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The ranks' ``x`` [N, ...] (equal N) concatenated in rank order."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(world_size(group))]
    dist.all_gather(parts, x.detach().contiguous(), group=group)
    return torch.cat(parts)


def _flat_all_reduce(tensors: tp.Sequence[torch.Tensor], group: Group) -> tp.List[torch.Tensor]:
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, start = [], 0
    for t in tensors:
        out.append(flat[start:start + t.numel()].view_as(t))
        start += t.numel()
    return out


def sum_grads(grads: tp.Sequence[torch.Tensor], group: Group) -> tp.List[torch.Tensor]:
    """Each rank's gradient shares added over the group (one all-reduce)."""
    return list(grads) if group is None else _flat_all_reduce(grads, group)


def mean_grads(grads: tp.Sequence[torch.Tensor], group: Group) -> tp.List[torch.Tensor]:
    """The gradients averaged over the group (JAX's ``pmean``)."""
    if group is None:
        return list(grads)
    out = _flat_all_reduce(grads, group)
    torch._foreach_div_(out, world_size(group))
    return out
