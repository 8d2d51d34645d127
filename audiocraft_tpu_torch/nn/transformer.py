"""Streaming transformer with a KV cache
(counterpart of ``audiocraft_tpu/nn/transformer.py``).

Modules keep the reference audiocraft state-dict names
(``layers.{i}.self_attn.in_proj_weight``, ``...cross_attention...``,
``...norm1/norm2/norm_cross``, ``...linear1/linear2``,
``...layer_scale_1.scale``), so a port ``state_dict()`` goes through the JAX
package's ``ckpt/torch_import.import_lm`` unchanged.

Numerics follow the JAX package: projections in the input dtype, layer norms
in fp32 and cast back, attention with q pre-scaled, fp32 scores, softmax and
products, cast back.  Full-sequence self-attention with no extra mask, no
``past_context`` and no cache goes to the hand-written kernel
(``ops/attention.py``) when ``attn_kernel`` routes it and the head is at most
``MAX_HEAD_DIM`` wide; every other call (MAGNeT's banded stages,
cross-attention, ``past_context`` windows, wider heads, every call with a
cache) stays on the plain masked path, as in the JAX package.  The kernel
route is differentiable: on the card its gradient comes from the backward
kernels (K3b), so training takes it too.

The KV cache (:class:`KVCache`) is a fixed-capacity buffer per layer,
written in place at the stack's position ``index``: a 0-d int64 tensor on
the cache's device, one for the whole stack, which the stack advances after
its layers.  Nothing reads it back to the host, so a decode step reads and
writes only device tensors at fixed addresses and can be captured once as a
CUDA graph and replayed (``lm/model.py``).  Attention over a cache reads the
whole capacity and masks it by position (``delta >= 0``, and ``delta <=
past_context`` where set), as the JAX package does; :func:`grow_cache` pads
the capacity.  ``KVCache.create(quantized=True)`` stores int8 with fp32
scales per position and head (:func:`_kv_quantize`, attended by
``_attend_int8``).  Projections read plain weights or the weight-only int8
and int4 leaves of ``lm/quantize.py`` (:func:`linear_w`).

``checkpointing`` rematerialises each layer in the backward
(``torch.utils.checkpoint``, ``use_reentrant=False``; the kernel route's
``autograd.Function`` runs K3f again there), as the JAX package's
``jax.checkpoint`` per layer does: the same gradients, less activation
memory.  It applies to a full-sequence forward with grad on, without a
cache.  The JAX package's ``scan_layers`` (a ``lax.scan`` over stacked layer
params, a compile-size option of XLA) has no counterpart here: the stack is
a Python loop, and ``ckpt/from_jax.py`` reads the stacked params such a JAX
model holds.

Positions: ``positional_embedding`` 'sin' adds the sinusoidal embedding
(times ``positional_scale``, of ``max_period``) to the stack's input;
'rope' rotates each self-attention's q and k (``nn/rope.py``, with
``xpos``); 'sin_rope' does both.  Cross-attention takes no rope.  Under a
cache the positions start at its index, a device tensor, so a captured
decode step rotates at the position it replays at.

``kv_repeat = r > 1`` shares each key and value head between r query heads:
``in_proj_weight`` is [E + 2 E / r, E], the caches (int8 and their scales
too) hold ``num_heads / r`` heads, and k and v are repeated head by head
(``repeat_interleave``) before every attention route, K3f included, which
takes equal head counts.
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..ops.attention import (additive_mask, causal_mask, fused_attention, kernel_route,
                             plain_attention)
from . import init
from .activations import get_activation_fn
from .rope import RotaryEmbedding

CrossKV = tp.Tuple[torch.Tensor, torch.Tensor]


def create_sin_embedding(positions: torch.Tensor, dim: int,
                         max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding [B, T, C] of positions [B, T, 1] (note the
    ``half_dim - 1`` denominator of the reference)."""
    if dim % 2:
        raise ValueError(f"sin embedding needs an even dim, not {dim}")
    half_dim = dim // 2
    positions = positions.float()
    adim = torch.arange(half_dim, dtype=torch.float32, device=positions.device).view(1, 1, -1)
    phase = positions / (max_period ** (adim / (half_dim - 1)))
    return torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1)


class LayerNorm(torch.nn.Module):
    """Layer norm computed in fp32 and cast back to the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.weight = init.constant((dim,), 1.0)
        self.bias = init.constant((dim,), 0.0)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), x.shape[-1:], self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


class LayerScale(torch.nn.Module):

    def __init__(self, dim: int, value: float):
        super().__init__()
        self.scale = init.constant((dim,), value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.scale * x


@dataclasses.dataclass
class KVCache:
    """Fixed-capacity KV cache of one attention module, written in place.

    ``k``, ``v`` [B, Tmax, H, Dh] in the compute dtype, or int8 with fp32
    scales ``k_scale``, ``v_scale`` [B, Tmax, H] when quantized.  ``index``
    is the number of valid positions, a 0-d int64 tensor on the cache's
    device that every layer of a stack shares (``StreamingTransformer``
    advances it once per forward)."""
    k: torch.Tensor
    v: torch.Tensor
    index: torch.Tensor
    k_scale: tp.Optional[torch.Tensor] = None
    v_scale: tp.Optional[torch.Tensor] = None

    @classmethod
    def create(cls, batch: int, capacity: int, num_heads: int, head_dim: int,
               dtype: torch.dtype = torch.float32, quantized: bool = False,
               device: tp.Union[str, torch.device, None] = None,
               index: tp.Optional[torch.Tensor] = None) -> "KVCache":
        if index is None:
            index = torch.zeros((), dtype=torch.long, device=device)
        shape = (batch, capacity, num_heads, head_dim)
        if quantized:
            return cls(k=torch.zeros(shape, dtype=torch.int8, device=device),
                       v=torch.zeros(shape, dtype=torch.int8, device=device), index=index,
                       k_scale=torch.zeros(shape[:3], device=device),
                       v_scale=torch.zeros(shape[:3], device=device))
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device), index=index)

    @property
    def capacity(self) -> int:
        return self.k.shape[1]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def tensors(self) -> tp.List[torch.Tensor]:
        return [t for t in (self.k, self.v, self.k_scale, self.v_scale) if t is not None]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors())


def grow_cache(caches: tp.Sequence[KVCache], new_capacity: int,
               out: tp.Optional[tp.Sequence[KVCache]] = None) -> tp.List[KVCache]:
    """Pad the time axis of every cache to ``new_capacity`` with zeros; the
    shared ``index`` is kept (the same tensor).  With ``out`` (caches of that
    capacity) the padded caches are written into it in place, so a decode
    step captured over ``out`` stays valid.

    Exact: a padded position is never attended (its delta to any query is
    negative, so its logit is -inf), and on the int8 path its scales are 0,
    so the softmax and the tokens equal the full-capacity ones."""
    grown = []
    for i, c in enumerate(caches):
        pad = new_capacity - c.capacity
        if pad < 0:
            raise ValueError(f"cannot shrink a cache of {c.capacity} to {new_capacity}")
        if out is None:
            grown.append(KVCache(
                k=F.pad(c.k, (0, 0, 0, 0, 0, pad)), v=F.pad(c.v, (0, 0, 0, 0, 0, pad)),
                index=c.index,
                k_scale=None if c.k_scale is None else F.pad(c.k_scale, (0, 0, 0, pad)),
                v_scale=None if c.v_scale is None else F.pad(c.v_scale, (0, 0, 0, pad))))
            continue
        dst = out[i]
        if dst.capacity != new_capacity or dst.index is not c.index:
            raise ValueError("out must hold caches of the new capacity sharing the index")
        for src_t, dst_t in zip(c.tensors(), dst.tensors()):
            dst_t[:, c.capacity:].zero_()
            dst_t[:, :c.capacity].copy_(src_t)
        grown.append(dst)
    return grown


def _kv_quantize(x: torch.Tensor) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per (batch, position, head): x [B, T, H, D] ->
    (int8 [B, T, H, D], fp32 scale [B, T, H])."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1) / 127.0).clamp_min(1e-20)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


class QuantizedWeight(torch.nn.Module):
    """A weight-only quantized [out, in] matrix (see ``lm/quantize.py``), held
    as buffers: int8 ``q`` [out, in] with a scale ``s`` [out] per output row,
    or int4 nibbles packed two a byte in ``q4p`` [out, in / 2] with ``s``
    [out, in / group] per input group.  ``prepare()`` unpacks int4 once per
    generate, for its decode steps to read (the JAX package's
    ``prepare_for_decode``)."""

    def __init__(self, leaf: tp.Mapping[str, torch.Tensor]):
        super().__init__()
        if set(leaf) not in ({'q', 's'}, {'q4p', 's'}):
            raise ValueError(f"a quantized leaf holds q and s, or q4p and s, not {sorted(leaf)}")
        for name, value in leaf.items():
            self.register_buffer(name, value)
        self.register_buffer('q4', None, persistent=False)

    @property
    def mode(self) -> str:
        return 'int8' if hasattr(self, 'q') else 'int4'

    def prepare(self) -> None:
        if self.mode != 'int4':
            return
        from ..lm.quantize import unpack_int4
        if self.q4 is None:
            self.q4 = unpack_int4(self.q4p)
        else:   # in place: graphs captured over q4 read the packed weights' new values
            self.q4.copy_(unpack_int4(self.q4p))

    def int4_values(self) -> torch.Tensor:
        if self.q4 is not None:
            return self.q4
        from ..lm.quantize import unpack_int4
        return unpack_int4(self.q4p)

    def matmul(self, x: torch.Tensor, rows: tp.Optional[slice] = None) -> torch.Tensor:
        """``x @ W[rows].T`` with fp32 sums: int8 scales the product by row,
        int4 sums the groups' products scaled by group.  fp32 result."""
        s = self.s if rows is None else self.s[rows]
        if self.mode == 'int8':
            q = self.q if rows is None else self.q[rows]
            return F.linear(x.float(), q.float()) * s.float()
        q = self.int4_values()
        q = q if rows is None else q[rows]
        o_dim, i_dim = q.shape
        g = s.shape[-1]
        xg = x.float().reshape(*x.shape[:-1], g, i_dim // g)
        t = torch.einsum('...gl,ogl->...og', xg, q.float().reshape(o_dim, g, i_dim // g))
        return torch.einsum('...og,og->...o', t, s.float())


class QuantizedLinear(torch.nn.Module):
    """An ``nn.Linear`` whose weight is a :class:`QuantizedWeight`; the bias
    stays floating point."""

    def __init__(self, weight: QuantizedWeight, bias: tp.Optional[torch.Tensor]):
        super().__init__()
        self.weight = weight
        self.bias = bias if bias is None else torch.nn.Parameter(bias, requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear_w(x, self.weight, self.bias)


def linear_w(x: torch.Tensor, w: tp.Union[torch.Tensor, QuantizedWeight],
             bias: tp.Optional[torch.Tensor] = None,
             rows: tp.Optional[slice] = None) -> torch.Tensor:
    """``x @ W[rows].T (+ bias)`` where W is a plain matrix or a
    :class:`QuantizedWeight`, with the JAX package's numerics: int8 runs the
    product in x's dtype on the integer values and scales the rounded result
    by row; int4 sums each group's product in fp32 and casts back."""
    if isinstance(w, QuantizedWeight):
        if w.mode == 'int8':
            q, s = (w.q, w.s) if rows is None else (w.q[rows], w.s[rows])
            y = F.linear(x, q.to(x.dtype))
            y = y * s.to(y.dtype)
        else:
            y = w.matmul(x, rows).to(x.dtype)
        return y if bias is None else y + bias
    return F.linear(x, w if rows is None else w[rows], bias)


class StreamingMultiheadAttention(torch.nn.Module):
    """Multi-head self- or cross-attention with a fused ``in_proj_weight``
    [E + 2 E / kv_repeat, E] (rows q, k, v).  ``attn_kernel``: see
    :func:`ops.attention.kernel_route`; ``rope`` rotates self-attention's q
    and k; ``kv_repeat`` shares each k, v head between that many q heads."""

    def __init__(self, embed_dim: int, num_heads: int, bias: bool = True, causal: bool = False,
                 past_context: tp.Optional[int] = None, cross_attention: bool = False,
                 qk_layer_norm: bool = False, attn_kernel: tp.Union[bool, str] = False,
                 rope: tp.Optional[RotaryEmbedding] = None, kv_repeat: int = 1,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of {num_heads} heads")
        if num_heads % kv_repeat:
            raise ValueError(f"{num_heads} heads do not share kv heads by {kv_repeat}")
        if past_context is not None and not causal:
            raise ValueError("past_context needs causal attention")
        if cross_attention and (causal or rope is not None or kv_repeat != 1):
            raise ValueError("cross-attention is not causal and takes no rope and no kv_repeat")
        if qk_layer_norm and kv_repeat != 1:
            raise ValueError("qk_layer_norm needs kv_repeat == 1")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.causal, self.past_context = causal, past_context
        self.cross_attention, self.attn_kernel = cross_attention, attn_kernel
        self.rope, self.kv_repeat = rope, kv_repeat
        bound = 1.0 / math.sqrt(embed_dim)
        out_dim = embed_dim + 2 * self.kv_dim
        self.in_proj_weight = init.uniform((out_dim, embed_dim), bound, generator)
        self.in_proj_bias = init.constant((out_dim,), 0.0) if bias else None
        self.out_proj = init.linear(embed_dim, embed_dim, bias, bound, generator)
        self.q_layer_norm = LayerNorm(embed_dim) if qk_layer_norm else None
        self.k_layer_norm = LayerNorm(embed_dim) if qk_layer_norm else None

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def num_kv_heads(self) -> int:
        return self.num_heads // self.kv_repeat

    @property
    def kv_dim(self) -> int:
        return self.head_dim * self.num_kv_heads

    def _proj(self, x: torch.Tensor, part: int) -> torch.Tensor:
        """Rows of ``in_proj_weight`` for q (0), k (1) or v (2)."""
        E = self.embed_dim
        rows = slice(part * E, (part + 1) * E)
        b = self.in_proj_bias[rows] if self.in_proj_bias is not None else None
        return linear_w(x, self.in_proj_weight, b, rows=rows)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        return x.unflatten(-1, (-1, self.head_dim))

    def _repeat_kv(self, *xs: torch.Tensor) -> tp.List[torch.Tensor]:
        """Each kv head repeated for the ``kv_repeat`` q heads that share it
        (axis 2, head by head)."""
        if self.kv_repeat == 1:
            return list(xs)
        return [x.repeat_interleave(self.kv_repeat, dim=2) for x in xs]

    def precompute_cross_kv(self, source: torch.Tensor) -> CrossKV:
        """Project the condition's K and V once, for every forward of a generate."""
        if self.k_layer_norm is not None:
            raise ValueError("qk_layer_norm with precomputed cross K/V is unsupported")
        return self._heads(self._proj(source, 1)), self._heads(self._proj(source, 2))

    def _self_mask(self, t: int, device: torch.device,
                   attn_mask: tp.Optional[torch.Tensor]) -> tp.Optional[torch.Tensor]:
        if not self.causal:
            return attn_mask
        mask = causal_mask(t, device, self.past_context)
        return mask if attn_mask is None else mask + attn_mask

    def _attend_int8(self, q: torch.Tensor, cache: KVCache,
                     mask: torch.Tensor) -> torch.Tensor:
        """Attention over an int8 cache: the integer values enter both
        products in q's dtype with fp32 sums; the K scales multiply the
        logits, the V scales fold into the probabilities (rounded to q's
        dtype before the second product, as in the JAX package)."""
        dtype = q.dtype
        scale = 1.0 / math.sqrt(self.head_dim)
        kq, vq, ks, vs = self._repeat_kv(cache.k, cache.v, cache.k_scale, cache.v_scale)
        qs = (q * scale).float().transpose(1, 2)                        # [B, H, Tq, D]
        logits = torch.matmul(qs, kq.float().permute(0, 2, 3, 1))       # [B, H, Tq, Tk]
        logits = logits * ks.transpose(1, 2)[:, :, None, :] + mask
        w = torch.softmax(logits, dim=-1)
        wv = (w * vs.transpose(1, 2)[:, :, None, :]).to(dtype).float()
        out = torch.matmul(wv, vq.float().transpose(1, 2))             # [B, H, Tq, D]
        return out.transpose(1, 2).to(dtype)

    def _attend_cache(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cache: KVCache,
                      attn_mask: tp.Optional[torch.Tensor]) -> torch.Tensor:
        """Write the new k, v at the cache's index, then attend over the
        whole capacity, masked by position."""
        Tq = q.shape[1]
        pos = cache.index + torch.arange(Tq, device=q.device)           # positions written
        if cache.quantized:
            kq, ks = _kv_quantize(k)
            vq, vs = _kv_quantize(v)
            for dst, src in ((cache.k, kq), (cache.v, vq), (cache.k_scale, ks),
                             (cache.v_scale, vs)):
                dst.index_copy_(1, pos, src)
        else:
            cache.k.index_copy_(1, pos, k.to(cache.k.dtype))
            cache.v.index_copy_(1, pos, v.to(cache.v.dtype))
        delta = pos[:, None] - torch.arange(cache.capacity, device=q.device)[None, :]
        valid = delta >= 0
        if self.past_context is not None:
            valid &= delta <= self.past_context
        mask = additive_mask(valid)                                     # [1, 1, Tq, Tk]
        if attn_mask is not None:
            mask = mask + attn_mask
        if cache.quantized:
            return self._attend_int8(q, cache, mask)
        k_all, v_all = self._repeat_kv(cache.k, cache.v)
        return plain_attention(q, k_all, v_all, mask, 1.0 / math.sqrt(self.head_dim))

    def forward(self, query: torch.Tensor, key: tp.Optional[torch.Tensor] = None,
                value: tp.Optional[torch.Tensor] = None,
                cross_kv: tp.Optional[CrossKV] = None,
                attn_mask: tp.Optional[torch.Tensor] = None,
                cache: tp.Optional[KVCache] = None) -> torch.Tensor:
        """With a ``cache`` (self-attention only) the new keys and values are
        written into it at its index, which the caller advances."""
        B, Tq, _ = query.shape
        E = self.embed_dim   # this rank's share under a model group (dist/mesh.shard_lm)
        scale = 1.0 / math.sqrt(self.head_dim)
        if self.cross_attention:
            if cache is not None:
                raise ValueError("cross-attention takes no cache")
            q = self._proj(query, 0)
            if self.q_layer_norm is not None:
                q = self.q_layer_norm(q)
            if cross_kv is not None:
                k, v = cross_kv
            else:
                if key is None or value is None:
                    raise ValueError("cross-attention needs key and value, or cross_kv")
                k = self._proj(key, 1)
                if self.k_layer_norm is not None:
                    k = self.k_layer_norm(k)
                k, v = self._heads(k), self._heads(self._proj(value, 2))
            out = plain_attention(self._heads(q), k, v, attn_mask, scale)
        else:
            # fused qkv projection; q, k, v stay strided views of it
            q, k, v = linear_w(query, self.in_proj_weight, self.in_proj_bias).split(
                [E, self.kv_dim, self.kv_dim], dim=-1)
            if self.q_layer_norm is not None:
                q, k = self.q_layer_norm(q), self.k_layer_norm(k)
            q, k, v = self._heads(q), self._heads(k), self._heads(v)
            if self.rope is not None:
                # positions from the cache's index, a device tensor
                pos = torch.arange(Tq, device=query.device)
                if cache is not None:
                    pos = pos + cache.index
                q = self.rope.rotate(q, pos)
                k = self.rope.rotate(k, pos, invert_decay=True)
            if cache is not None:
                out = self._attend_cache(q, k, v, cache, attn_mask)
            elif (attn_mask is None and Tq > 1 and self.past_context is None
                    and kernel_route(self.attn_kernel, self.head_dim)):
                k, v = self._repeat_kv(k, v)
                out = fused_attention(q, k, v, causal=self.causal, sm_scale=scale)
            else:
                k, v = self._repeat_kv(k, v)
                out = plain_attention(q, k, v, self._self_mask(Tq, query.device, attn_mask),
                                      scale)
        return self.out_proj(out.reshape(B, Tq, E))


class StreamingTransformerLayer(torch.nn.Module):
    """Self-attention, optional cross-attention and feed-forward, each with a
    residual, in pre-norm (``norm_first``) or post-norm order."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int = 2048,
                 bias_ff: bool = True, bias_attn: bool = True, causal: bool = False,
                 past_context: tp.Optional[int] = None, qk_layer_norm: bool = False,
                 qk_layer_norm_cross: bool = False, cross_attention: bool = False,
                 layer_scale: tp.Optional[float] = None, norm_first: bool = True,
                 activation: str = 'gelu', attn_kernel: tp.Union[bool, str] = False,
                 rope: tp.Optional[RotaryEmbedding] = None, kv_repeat: int = 1,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        D, Fd = d_model, dim_feedforward
        self.self_attn = StreamingMultiheadAttention(
            D, num_heads, bias=bias_attn, causal=causal, past_context=past_context,
            qk_layer_norm=qk_layer_norm, attn_kernel=attn_kernel, rope=rope,
            kv_repeat=kv_repeat, generator=generator)
        self.linear1 = init.linear(D, Fd, bias_ff, 1.0 / math.sqrt(D), generator)
        self.linear2 = init.linear(Fd, D, bias_ff, 1.0 / math.sqrt(Fd), generator)
        self.norm1, self.norm2 = LayerNorm(D), LayerNorm(D)
        self.cross_attention: tp.Optional[StreamingMultiheadAttention] = None
        self.norm_cross: tp.Optional[LayerNorm] = None
        if cross_attention:
            self.cross_attention = StreamingMultiheadAttention(
                D, num_heads, bias=bias_attn, cross_attention=True,
                qk_layer_norm=qk_layer_norm_cross, generator=generator)
            self.norm_cross = LayerNorm(D)
        scale = (lambda: torch.nn.Identity()) if layer_scale is None \
            else (lambda: LayerScale(D, layer_scale))
        self.layer_scale_1, self.layer_scale_2 = scale(), scale()
        self.layer_scale_cross = scale() if cross_attention else None
        self.norm_first = norm_first
        self.activation = get_activation_fn(activation)

    def _ff(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(self.activation(self.linear1(x)))

    def forward(self, x: torch.Tensor, cross_attention_src: tp.Optional[torch.Tensor] = None,
                cross_kv: tp.Optional[CrossKV] = None,
                attn_mask: tp.Optional[torch.Tensor] = None,
                cache: tp.Optional[KVCache] = None) -> torch.Tensor:
        has_cross = cross_attention_src is not None or cross_kv is not None
        if has_cross != (self.cross_attention is not None):
            raise ValueError("a condition for cross-attention must be given exactly when the "
                             "layer has cross-attention")

        def cross(q):
            return self.cross_attention(q, key=cross_attention_src, value=cross_attention_src,
                                        cross_kv=cross_kv)

        def self_attn(q):
            return self.self_attn(q, attn_mask=attn_mask, cache=cache)

        if self.norm_first:
            x = x + self.layer_scale_1(self_attn(self.norm1(x)))
            if has_cross:
                x = x + self.layer_scale_cross(cross(self.norm_cross(x)))
            return x + self.layer_scale_2(self._ff(self.norm2(x)))
        src = x  # post-norm cross-attention queries the layer's input
        x = self.norm1(x + self.layer_scale_1(self_attn(x)))
        if has_cross:
            x = self.norm_cross(x + self.layer_scale_cross(cross(src)))
        return self.norm2(x + self.layer_scale_2(self._ff(x)))


def _checkpointed(layer: torch.nn.Module, x: torch.Tensor, kw: dict) -> torch.Tensor:
    """``layer(x, **kw)`` rematerialised in the backward.  The layer's
    weights enter as inputs of the checkpoint, so the recompute reads the
    tensors the forward read: under ``torch.func.functional_call`` (the
    train step's bf16 copies) those are gone from the module by then."""
    names, weights = zip(*layer.named_parameters())

    def run(y, *values):
        return torch.func.functional_call(layer, dict(zip(names, values)), (y,), kw)

    return torch.utils.checkpoint.checkpoint(run, x, *weights, use_reentrant=False)


class StreamingTransformer(torch.nn.Module):
    """A stack of :class:`StreamingTransformerLayer` with sinusoidal
    positions, rotary ones or both (``positional_embedding`` 'sin', 'rope'
    or 'sin_rope'; see the module note)."""

    def __init__(self, d_model: int, num_heads: int, num_layers: int,
                 dim_feedforward: int = 2048, bias_ff: bool = True, bias_attn: bool = True,
                 causal: bool = False, past_context: tp.Optional[int] = None,
                 cross_attention: bool = False, layer_scale: tp.Optional[float] = None,
                 positional_embedding: str = 'sin', max_period: float = 10000.0,
                 positional_scale: float = 1.0, xpos: bool = False,
                 qk_layer_norm: bool = False, qk_layer_norm_cross: bool = False,
                 kv_repeat: int = 1, norm_first: bool = True, activation: str = 'gelu',
                 attn_kernel: tp.Union[bool, str] = False, checkpointing: bool = False,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        if positional_embedding not in ('sin', 'rope', 'sin_rope'):
            raise ValueError(f"positional_embedding {positional_embedding!r}: "
                             "'sin', 'rope' or 'sin_rope'")
        self.checkpointing = checkpointing
        self.positional_embedding = positional_embedding
        self.max_period, self.positional_scale = max_period, positional_scale
        rope = None
        if positional_embedding in ('rope', 'sin_rope'):
            rope = RotaryEmbedding(d_model // num_heads, max_period=max_period, xpos=xpos,
                                   scale=positional_scale)
        self.layers = torch.nn.ModuleList(
            StreamingTransformerLayer(
                d_model, num_heads, dim_feedforward, bias_ff=bias_ff, bias_attn=bias_attn,
                causal=causal, past_context=past_context, qk_layer_norm=qk_layer_norm,
                qk_layer_norm_cross=qk_layer_norm_cross, cross_attention=cross_attention,
                layer_scale=layer_scale, norm_first=norm_first, activation=activation,
                attn_kernel=attn_kernel, rope=rope, kv_repeat=kv_repeat, generator=generator)
            for _ in range(num_layers))

    @property
    def num_heads(self) -> int:
        return self.layers[0].self_attn.num_heads

    @property
    def head_dim(self) -> int:
        return self.layers[0].self_attn.head_dim

    @property
    def num_kv_heads(self) -> int:
        return self.layers[0].self_attn.num_kv_heads

    def init_cache(self, batch: int, capacity: int, dtype: torch.dtype = torch.float32,
                   kv_dtype: tp.Optional[str] = None,
                   device: tp.Union[str, torch.device, None] = None) -> tp.List[KVCache]:
        """One cache a layer, sharing one index.  ``kv_dtype='int8'`` stores
        them quantized; None keeps float caches in ``dtype``."""
        if kv_dtype not in (None, 'int8'):
            raise ValueError(f"kv_dtype {kv_dtype!r}: None or 'int8'")
        index = torch.zeros((), dtype=torch.long, device=device)
        return [KVCache.create(batch, capacity, self.num_kv_heads, self.head_dim, dtype,
                               quantized=kv_dtype == 'int8', device=device, index=index)
                for _ in self.layers]

    def precompute_cross_kv(self, source: torch.Tensor) -> tp.List[CrossKV]:
        return [layer.cross_attention.precompute_cross_kv(source) for layer in self.layers]

    def forward(self, x: torch.Tensor, cross_attention_src: tp.Optional[torch.Tensor] = None,
                cross_kv: tp.Optional[tp.Sequence[CrossKV]] = None,
                attn_mask: tp.Optional[torch.Tensor] = None,
                caches: tp.Optional[tp.Sequence[KVCache]] = None) -> torch.Tensor:
        """With ``caches`` (from :meth:`init_cache`) positions start at their
        index, each layer appends to its cache, and the index advances by T."""
        B, T, C = x.shape
        if self.positional_embedding in ('sin', 'sin_rope'):
            positions = torch.arange(T, device=x.device).view(1, -1, 1)
            if caches is not None:
                positions = positions + caches[0].index
            emb = create_sin_embedding(positions, C, self.max_period).to(x.dtype)
            x = x + (emb if self.positional_scale == 1.0 else self.positional_scale * emb)
        remat = self.checkpointing and caches is None and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            kw = dict(cross_attention_src=cross_attention_src,
                      cross_kv=None if cross_kv is None else cross_kv[i], attn_mask=attn_mask,
                      cache=None if caches is None else caches[i])
            if remat:
                x = _checkpointed(layer, x, kw)
            else:
                x = layer(x, **kw)
        if caches is not None:
            caches[0].index.add_(T)
        return x
