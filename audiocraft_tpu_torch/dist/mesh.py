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
  global batch's order, for k-means and dead-code expiry;
  :func:`gather_parts` is the ranks' tensors as a list, in rank order.
* :func:`shard_batch` takes a rank's contiguous part of the global batch.

:func:`make_data_group` joins the group (gloo on the CPU, NCCL on CUDA) from
explicit arguments or ``torchrun``'s environment variables.

The tensor-parallel ``'model'`` axis: :func:`make_mesh` splits the world
into this rank's data group and model group, rank ``d * n_model + m`` at
data index d and model index m (the JAX package's device order), and
:func:`shard_lm` splits an ``LMModel`` over a model group in place, the
parameters that the JAX package's ``lm_param_sharding`` shards.  GSPMD cuts
``in_proj_weight`` [3E, E] into contiguous row blocks and inserts the
collectives; here each rank keeps whole heads, its share of the q, k and v
rows taken separately (the kv heads split when ``kv_repeat > 1``), and the
forward carries the collectives explicitly: an identity whose backward
all-reduces at the input of each column-parallel product (the attention's
q, k, v projection, ``linear1``, the output heads), an all-reduce whose
backward is the identity after each row-parallel one (``out_proj``,
``linear2``; their bias added once, after it), and an ``all_gather`` of the
logits over cardinality, around the model's own ``apply_heads`` (in a
subclass that :func:`shard_lm` gives the instance).  Norms, embeddings and conditioners stay replicated.
The forward and its gradients equal the unsharded model's.  Decode with a
model group (caches, precomputed cross K/V) and quantizing a split model
are not carried: both raise.
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


def gather_parts(x: torch.Tensor, group: Group) -> tp.List[torch.Tensor]:
    """Every rank's ``x`` (equal shapes), in rank order (no gradient)."""
    if group is None:
        return [x]
    parts = [torch.empty_like(x) for _ in range(world_size(group))]
    dist.all_gather(parts, x.detach().contiguous(), group=group)
    return parts


def gather_rows(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The ranks' ``x`` [N, ...] (equal N) concatenated in rank order."""
    return x if group is None else torch.cat(gather_parts(x, group))


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


def make_mesh(n_data: tp.Optional[int] = None, n_model: int = 1,
              backend: tp.Optional[str] = None, init_method: tp.Optional[str] = None,
              world: tp.Optional[int] = None,
              process_rank: tp.Optional[int] = None) -> tp.Tuple[Group, Group]:
    """(data group, model group) of this rank in an ``n_data x n_model``
    mesh over every process (joined first as :func:`make_data_group` does):
    rank ``d * n_model + m`` sits at data index d and model index m.  Every
    process calls it, as ``dist.new_group`` asks."""
    make_data_group(backend, init_method, world, process_rank)
    n_world, me = dist.get_world_size(), dist.get_rank()
    n_data = n_world // n_model if n_data is None else n_data
    if n_data * n_model != n_world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs {n_data * n_model} processes, "
                         f"not {n_world}")
    data_group = model_group = None
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if me % n_model == m:
            data_group = g
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if me // n_model == d:
            model_group = g
    return data_group, model_group


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        return torch.cat(gather_parts(x, group), dim=-1)

    @staticmethod
    def backward(ctx, grad):
        r, w = dist.get_rank(ctx.group), ctx.width
        return grad[..., r * w:(r + 1) * w], None


def copy_to_group(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``x`` (replicated over the model group); the backward all-reduces its
    gradient, whose shares the ranks' column blocks computed."""
    return x if group is None else _CopyToGroup.apply(x, group)


def gather_last(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The ranks' ``x`` concatenated in rank order along the last axis; the
    backward takes this rank's slice."""
    return x if group is None else _GatherLast.apply(x, group)


class ColumnParallelLinear(torch.nn.Module):
    """This rank's rows of an ``nn.Linear`` (and of its bias): a replicated
    input, this rank's block of the output (``linear1``)."""

    def __init__(self, weight: torch.Tensor, bias: tp.Optional[torch.Tensor], group: Group):
        super().__init__()
        self.weight = torch.nn.Parameter(weight, requires_grad=weight.requires_grad)
        self.bias = None if bias is None else torch.nn.Parameter(
            bias, requires_grad=bias.requires_grad)
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.linear(copy_to_group(x, self.group), self.weight, self.bias)


class RowParallelLinear(torch.nn.Module):
    """This rank's input columns of an ``nn.Linear``: the ranks' partial
    products summed over the group, then the whole bias, once."""

    def __init__(self, weight: torch.Tensor, bias: tp.Optional[torch.Tensor], group: Group):
        super().__init__()
        self.weight = torch.nn.Parameter(weight, requires_grad=weight.requires_grad)
        self.bias = bias
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = global_sum(torch.nn.functional.linear(x, self.weight), self.group)
        return y if self.bias is None else y + self.bias


def _part(w: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    """Block i of n of ``w`` along ``dim``, copied."""
    size = w.shape[dim] // n
    return w.narrow(dim, i * size, size).clone()


def _copy_attention_inputs(group: Group):
    def hook(module, args, kwargs):
        kwargs = {k: copy_to_group(v, group) if k in ('key', 'value') and v is not None else v
                  for k, v in kwargs.items()}
        return (copy_to_group(args[0], group),) + tuple(args[1:]), kwargs
    return hook


def _shard_attention(attn: torch.nn.Module, group: Group, n: int, i: int) -> None:
    E, kv = attn.embed_dim, attn.kv_dim
    if attn.num_heads % n or attn.num_kv_heads % n:
        raise ValueError(f"{attn.num_heads} heads ({attn.num_kv_heads} kv heads) do not split "
                         f"over {n} ranks")
    if attn.q_layer_norm is not None:
        raise ValueError("qk_layer_norm normalises over every head; it is not sharded")

    def qkv_rows(w: torch.Tensor) -> torch.Tensor:
        return torch.cat([_part(w[:E], 0, n, i), _part(w[E:E + kv], 0, n, i),
                          _part(w[E + kv:], 0, n, i)])

    w = attn.in_proj_weight
    attn.in_proj_weight = torch.nn.Parameter(qkv_rows(w), requires_grad=w.requires_grad)
    if attn.in_proj_bias is not None:
        b = attn.in_proj_bias
        attn.in_proj_bias = torch.nn.Parameter(qkv_rows(b), requires_grad=b.requires_grad)
    attn.embed_dim, attn.num_heads = E // n, attn.num_heads // n
    out = attn.out_proj
    attn.out_proj = RowParallelLinear(_part(out.weight, 1, n, i), out.bias, group)
    attn.register_forward_pre_hook(_copy_attention_inputs(group), with_kwargs=True)


def _shard_heads(lm: torch.nn.Module, group: Group, n: int, i: int) -> None:
    """Keep this rank's cardinality rows of each output head (still an
    ``nn.Linear``) and give ``lm`` a subclass of its own class whose
    ``apply_heads`` copies its input to the group and gathers the logits
    over cardinality (a subclass, not a method bound to the instance, which
    would hold ``lm`` in a reference cycle past its last use)."""
    for head in lm.linears:
        head.weight = torch.nn.Parameter(_part(head.weight, 0, n, i),
                                         requires_grad=head.weight.requires_grad)
        if head.bias is not None:
            head.bias = torch.nn.Parameter(_part(head.bias, 0, n, i),
                                           requires_grad=head.bias.requires_grad)
        head.out_features = head.weight.shape[0]

    base = type(lm)

    class ModelGroupLM(base):
        def apply_heads(self, out: torch.Tensor) -> torch.Tensor:
            return gather_last(base.apply_heads(self, copy_to_group(out, group)), group)

    ModelGroupLM.__name__ = ModelGroupLM.__qualname__ = f'ModelGroup{base.__name__}'
    lm.__class__ = ModelGroupLM


def _no_decode(*args, **kwargs):
    raise ValueError("decode with a model group is not carried: a model split by shard_lm "
                     "runs the full-sequence forward only")


def shard_lm(lm: torch.nn.Module, group: Group) -> torch.nn.Module:
    """Split ``lm`` (an ``LMModel``) over the model ``group`` in place and
    return it: each rank keeps its heads of every attention (self and
    cross), its rows of ``linear1``, its columns of ``linear2`` and its
    cardinality rows of the output heads; the forward gives the unsharded
    logits on every rank (see the module note).  Quantized weights and
    ``qk_layer_norm`` are refused; so are the split model's decode caches
    and cross K/V, and ``lm/quantize`` refuses its parallel layers."""
    from ..nn.transformer import QuantizedWeight
    n, i = world_size(group), rank(group)
    if lm.card % n:
        raise ValueError(f"cardinality {lm.card} does not split over {n} ranks")
    if any(isinstance(m, QuantizedWeight) for m in lm.modules()):
        raise ValueError("shard_lm takes float weights: a quantized model is not split")
    for layer in lm.transformer.layers:
        for attn in (layer.self_attn, layer.cross_attention):
            if attn is not None:
                _shard_attention(attn, group, n, i)
        l1, l2 = layer.linear1, layer.linear2
        layer.linear1 = ColumnParallelLinear(
            _part(l1.weight, 0, n, i), None if l1.bias is None else _part(l1.bias, 0, n, i),
            group)
        layer.linear2 = RowParallelLinear(_part(l2.weight, 1, n, i), l2.bias, group)
    _shard_heads(lm, group, n, i)
    lm.transformer.init_cache = lm.transformer.precompute_cross_kv = _no_decode
    return lm

