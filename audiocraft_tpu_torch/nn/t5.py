"""T5 text encoder, the backbone of the T5 conditioner
(counterpart of ``audiocraft_tpu/nn/t5.py``).

The standard T5 encoder: RMS layer norm without mean subtraction or bias
(eps 1e-6), a relative-position bucket bias computed by block 0 and shared by
every block, unscaled dot-product attention, ReLU (classic) or gated-GeLU
(flan / v1.1) feed-forward, final layer norm.  Parameter names are the HF
``T5EncoderModel`` names (``shared.weight``,
``encoder.block.{i}.layer.0.SelfAttention.q.weight``, ...), which the JAX
package's ``ckpt/torch_import.import_t5`` reads.

Its attention carries the position bias, so it runs on the plain path (fp32
scores from upcast operands, as the JAX package asks for fp32 results), not
on the flash kernel.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from . import init


def relative_position_bucket(relative_position: np.ndarray, num_buckets: int = 32,
                             max_distance: int = 128) -> np.ndarray:
    """Bidirectional T5 relative position bucketing (host side)."""
    ret = np.zeros_like(relative_position)
    n = num_buckets // 2
    ret += (relative_position > 0).astype(np.int64) * n
    rp = np.abs(relative_position)
    max_exact = n // 2
    is_small = rp < max_exact
    val_if_large = max_exact + (
        np.log(np.maximum(rp, 1) / max_exact)
        / np.log(max_distance / max_exact) * (n - max_exact)).astype(np.int64)
    val_if_large = np.minimum(val_if_large, n - 1)
    ret += np.where(is_small, rp, val_if_large)
    return ret


@dataclasses.dataclass(frozen=True)
class T5EncoderConfig:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    gated_act: bool = False  # True for flan-t5 / t5-v1.1 (gated gelu)

    @classmethod
    def for_name(cls, name: str) -> "T5EncoderConfig":
        return cls(**_BY_NAME[name])


_BY_NAME = {
    't5-small': dict(d_model=512, d_ff=2048, num_layers=6, num_heads=8),
    't5-base': dict(d_model=768, d_ff=3072, num_layers=12, num_heads=12),
    't5-large': dict(d_model=1024, d_ff=4096, num_layers=24, num_heads=16),
    'google/flan-t5-small': dict(d_model=512, d_ff=1024, num_layers=8, num_heads=6,
                                 gated_act=True),
    'google/flan-t5-base': dict(d_model=768, d_ff=2048, num_layers=12, num_heads=12,
                                gated_act=True),
    'google/flan-t5-large': dict(d_model=1024, d_ff=2816, num_layers=24, num_heads=16,
                                 gated_act=True),
}


class T5LayerNorm(torch.nn.Module):
    """RMS norm: x / sqrt(mean(x^2) + eps) in fp32, cast back, times weight."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = init.constant((dim,), 1.0)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().square().mean(-1, keepdim=True)
        return (x.float() * torch.rsqrt(var + self.eps)).to(x.dtype) * self.weight


def _dense(in_d: int, out_d: int, std: float, gen: tp.Optional[torch.Generator]):
    layer = torch.nn.Linear(in_d, out_d, bias=False, device='meta')
    layer.weight = init.normal((out_d, in_d), std, gen)
    return layer


class _Attention(torch.nn.Module):

    def __init__(self, c: T5EncoderConfig, has_bias: bool, gen):
        super().__init__()
        inner = c.num_heads * c.d_kv
        self.q = _dense(c.d_model, inner, (c.d_model * c.d_kv) ** -0.5, gen)
        self.k = _dense(c.d_model, inner, c.d_model ** -0.5, gen)
        self.v = _dense(c.d_model, inner, c.d_model ** -0.5, gen)
        self.o = _dense(inner, c.d_model, inner ** -0.5, gen)
        if has_bias:
            self.relative_attention_bias = init.embedding(
                c.relative_attention_num_buckets, c.num_heads,
                init.normal((c.relative_attention_num_buckets, c.num_heads), 0.1, gen))


class _SelfAttentionLayer(torch.nn.Module):

    def __init__(self, c: T5EncoderConfig, has_bias: bool, gen):
        super().__init__()
        self.SelfAttention = _Attention(c, has_bias, gen)
        self.layer_norm = T5LayerNorm(c.d_model)


class _DenseReluDense(torch.nn.Module):

    def __init__(self, c: T5EncoderConfig, gen):
        super().__init__()
        if c.gated_act:
            self.wi_0 = _dense(c.d_model, c.d_ff, c.d_model ** -0.5, gen)
            self.wi_1 = _dense(c.d_model, c.d_ff, c.d_model ** -0.5, gen)
        else:
            self.wi = _dense(c.d_model, c.d_ff, c.d_model ** -0.5, gen)
        self.wo = _dense(c.d_ff, c.d_model, c.d_ff ** -0.5, gen)
        self.gated = c.gated_act

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        if self.gated:
            hidden = F.gelu(self.wi_0(h), approximate='tanh') * self.wi_1(h)
        else:
            hidden = F.relu(self.wi(h))
        return self.wo(hidden)


class _FFLayer(torch.nn.Module):

    def __init__(self, c: T5EncoderConfig, gen):
        super().__init__()
        self.DenseReluDense = _DenseReluDense(c, gen)
        self.layer_norm = T5LayerNorm(c.d_model)


class _Block(torch.nn.Module):

    def __init__(self, c: T5EncoderConfig, has_bias: bool, gen):
        super().__init__()
        self.layer = torch.nn.ModuleList([_SelfAttentionLayer(c, has_bias, gen),
                                          _FFLayer(c, gen)])


class _Stack(torch.nn.Module):

    def __init__(self, c: T5EncoderConfig, gen):
        super().__init__()
        self.block = torch.nn.ModuleList(_Block(c, i == 0, gen) for i in range(c.num_layers))
        self.final_layer_norm = T5LayerNorm(c.d_model)


class T5Encoder(torch.nn.Module):
    """``input_ids`` [B, T] int and ``attention_mask`` [B, T] (1 valid, 0 pad)
    -> hidden states [B, T, d_model] in the weights' dtype."""

    def __init__(self, config: T5EncoderConfig,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        c = self.config = config
        self.shared = init.embedding(c.vocab_size, c.d_model,
                                     init.normal((c.vocab_size, c.d_model), 1.0, generator))
        self.encoder = _Stack(c, generator)

    def position_bias(self, length: int) -> torch.Tensor:
        """[1, H, T, T] bias from the bucketed relative positions."""
        c = self.config
        pos = np.arange(length)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None],  # memory - query
                                           c.relative_attention_num_buckets,
                                           c.relative_attention_max_distance)
        table = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight
        idx = torch.from_numpy(buckets).to(table.device)
        return table[idx].permute(2, 0, 1)[None]

    def forward(self, input_ids: torch.Tensor,
                attention_mask: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.config
        B, T = input_ids.shape
        x = self.shared(input_ids)
        bias = self.position_bias(T).float()
        if attention_mask is not None:
            neg = torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9)
            bias = bias + neg
        for block in self.encoder.block:
            sa, ff = block.layer
            att = sa.SelfAttention
            h = sa.layer_norm(x)
            q, k, v = (p(h).unflatten(-1, (c.num_heads, c.d_kv)) for p in (att.q, att.k, att.v))
            # fp32 scores from upcast operands (exact for bf16 inputs)
            logits = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) + bias
            w = torch.softmax(logits, dim=-1).to(x.dtype)
            out = torch.einsum('bhqk,bkhd->bqhd', w, v).flatten(2)
            x = x + att.o(out)
            x = x + ff.DenseReluDense(ff.layer_norm(x))
        return self.encoder.final_layer_norm(x)
