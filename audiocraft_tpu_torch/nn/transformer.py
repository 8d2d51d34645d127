"""Streaming transformer without a cache
(counterpart of ``audiocraft_tpu/nn/transformer.py``).

Modules keep the reference audiocraft state-dict names
(``layers.{i}.self_attn.in_proj_weight``, ``...cross_attention...``,
``...norm1/norm2/norm_cross``, ``...linear1/linear2``,
``...layer_scale_1.scale``), so a port ``state_dict()`` goes through the JAX
package's ``ckpt/torch_import.import_lm`` unchanged.

Numerics follow the JAX package: projections in the input dtype, layer norms
in fp32 and cast back, attention with q pre-scaled, fp32 scores, softmax and
products, cast back.  Full-sequence self-attention with no extra mask and no
``past_context`` goes to the hand-written kernel (``ops/attention.py``) when
``attn_kernel`` routes it and the head is at most ``MAX_HEAD_DIM`` wide;
every other call (MAGNeT's banded stages, cross-attention, ``past_context``
windows, wider heads) stays on the plain masked path, as in the JAX
package.  The kernel route is differentiable: on the card its gradient comes
from the backward kernels (K3b), so training takes it too.

Not ported yet: the KV cache and its growth, int8 KV, RoPE (and the
positional options beside 'sin'), ``kv_repeat > 1``, scanned and
checkpointed (rematerialised) layers.
"""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn.functional as F

from ..ops.attention import causal_mask, fused_attention, kernel_route, plain_attention
from . import init
from .activations import get_activation_fn

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


class StreamingMultiheadAttention(torch.nn.Module):
    """Multi-head self- or cross-attention with a fused ``in_proj_weight``
    [3E, E] (rows q, k, v).  ``attn_kernel``: see :func:`ops.attention.kernel_route`."""

    def __init__(self, embed_dim: int, num_heads: int, bias: bool = True, causal: bool = False,
                 past_context: tp.Optional[int] = None, cross_attention: bool = False,
                 qk_layer_norm: bool = False, attn_kernel: tp.Union[bool, str] = False,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of {num_heads} heads")
        if past_context is not None and not causal:
            raise ValueError("past_context needs causal attention")
        if cross_attention and causal:
            raise ValueError("cross-attention is not causal")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.causal, self.past_context = causal, past_context
        self.cross_attention, self.attn_kernel = cross_attention, attn_kernel
        bound = 1.0 / math.sqrt(embed_dim)
        self.in_proj_weight = init.uniform((3 * embed_dim, embed_dim), bound, generator)
        self.in_proj_bias = init.constant((3 * embed_dim,), 0.0) if bias else None
        self.out_proj = init.linear(embed_dim, embed_dim, bias, bound, generator)
        self.q_layer_norm = LayerNorm(embed_dim) if qk_layer_norm else None
        self.k_layer_norm = LayerNorm(embed_dim) if qk_layer_norm else None

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    def _proj(self, x: torch.Tensor, part: int) -> torch.Tensor:
        """Rows of ``in_proj_weight`` for q (0), k (1) or v (2)."""
        E = self.embed_dim
        rows = slice(part * E, (part + 1) * E)
        b = self.in_proj_bias[rows] if self.in_proj_bias is not None else None
        return F.linear(x, self.in_proj_weight[rows], b)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        return x.unflatten(-1, (self.num_heads, self.head_dim))

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

    def forward(self, query: torch.Tensor, key: tp.Optional[torch.Tensor] = None,
                value: tp.Optional[torch.Tensor] = None,
                cross_kv: tp.Optional[CrossKV] = None,
                attn_mask: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        B, Tq, E = query.shape
        scale = 1.0 / math.sqrt(self.head_dim)
        if self.cross_attention:
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
            q, k, v = F.linear(query, self.in_proj_weight, self.in_proj_bias).split(E, dim=-1)
            if self.q_layer_norm is not None:
                q, k = self.q_layer_norm(q), self.k_layer_norm(k)
            q, k, v = self._heads(q), self._heads(k), self._heads(v)
            if (attn_mask is None and Tq > 1 and self.past_context is None
                    and kernel_route(self.attn_kernel, self.head_dim)):
                out = fused_attention(q, k, v, causal=self.causal, sm_scale=scale)
            else:
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
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        D, Fd = d_model, dim_feedforward
        self.self_attn = StreamingMultiheadAttention(
            D, num_heads, bias=bias_attn, causal=causal, past_context=past_context,
            qk_layer_norm=qk_layer_norm, attn_kernel=attn_kernel, generator=generator)
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
                attn_mask: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        has_cross = cross_attention_src is not None or cross_kv is not None
        if has_cross != (self.cross_attention is not None):
            raise ValueError("a condition for cross-attention must be given exactly when the "
                             "layer has cross-attention")

        def cross(q):
            return self.cross_attention(q, key=cross_attention_src, value=cross_attention_src,
                                        cross_kv=cross_kv)

        if self.norm_first:
            x = x + self.layer_scale_1(self.self_attn(self.norm1(x), attn_mask=attn_mask))
            if has_cross:
                x = x + self.layer_scale_cross(cross(self.norm_cross(x)))
            return x + self.layer_scale_2(self._ff(self.norm2(x)))
        src = x  # post-norm cross-attention queries the layer's input
        x = self.norm1(x + self.layer_scale_1(self.self_attn(x, attn_mask=attn_mask)))
        if has_cross:
            x = self.norm_cross(x + self.layer_scale_cross(cross(src)))
        return self.norm2(x + self.layer_scale_2(self._ff(x)))


class StreamingTransformer(torch.nn.Module):
    """A stack of :class:`StreamingTransformerLayer` with sinusoidal positions
    (max period 10000, scale 1)."""

    def __init__(self, d_model: int, num_heads: int, num_layers: int,
                 dim_feedforward: int = 2048, bias_ff: bool = True, bias_attn: bool = True,
                 causal: bool = False, past_context: tp.Optional[int] = None,
                 cross_attention: bool = False, layer_scale: tp.Optional[float] = None,
                 qk_layer_norm: bool = False, qk_layer_norm_cross: bool = False,
                 norm_first: bool = True, activation: str = 'gelu',
                 attn_kernel: tp.Union[bool, str] = False,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self.layers = torch.nn.ModuleList(
            StreamingTransformerLayer(
                d_model, num_heads, dim_feedforward, bias_ff=bias_ff, bias_attn=bias_attn,
                causal=causal, past_context=past_context, qk_layer_norm=qk_layer_norm,
                qk_layer_norm_cross=qk_layer_norm_cross, cross_attention=cross_attention,
                layer_scale=layer_scale, norm_first=norm_first, activation=activation,
                attn_kernel=attn_kernel, generator=generator)
            for _ in range(num_layers))

    def precompute_cross_kv(self, source: torch.Tensor) -> tp.List[CrossKV]:
        return [layer.cross_attention.precompute_cross_kv(source) for layer in self.layers]

    def forward(self, x: torch.Tensor, cross_attention_src: tp.Optional[torch.Tensor] = None,
                cross_kv: tp.Optional[tp.Sequence[CrossKV]] = None,
                attn_mask: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, C = x.shape
        positions = torch.arange(T, device=x.device).view(1, -1, 1)
        x = x + create_sin_embedding(positions, C).to(x.dtype)
        for i, layer in enumerate(self.layers):
            x = layer(x, cross_attention_src=cross_attention_src,
                      cross_kv=None if cross_kv is None else cross_kv[i], attn_mask=attn_mask)
        return x
