"""Plain T5 encoder and the description conditioner's projection.

The published T5 encoder (t5-base: d_model 768, 12 layers, 12 heads of 64,
d_ff 3072, ReLU feed-forward): RMS norms without bias (eps 1e-6), a
bidirectional relative-position bias (32 buckets, max distance 128) from the
first block's table added to every block's unscaled attention logits, padding
keys masked, a final RMS norm.  The conditioner projects the hidden states
to the LM's width and zeroes the padding positions.  ``state`` holds the
conditioner's tensors under its own names (``t5.shared.weight``,
``t5.encoder.block.0.layer.0.SelfAttention.q.weight``, ...,
``output_proj.weight``).
"""

from __future__ import annotations

import math
import typing as tp

import torch

from .precision import Precision

State = tp.Mapping[str, torch.Tensor]


def position_buckets(length: int, num_buckets: int, max_distance: int,
                     device: torch.device) -> torch.Tensor:
    """[T, T] bucket of ``key - query`` (T5's bidirectional bucketing),
    worked out on the host in float64: the logarithm lands exactly on the
    bucket edges at distances 16, 32 and 64, where a device's log can fall
    an ulp short and truncate into the bucket below."""
    pos = torch.arange(length)
    rel = pos[None, :] - pos[:, None]
    n = num_buckets // 2
    out = (rel > 0).long() * n
    rp = rel.abs()
    exact = n // 2
    large = exact + (torch.log(rp.clamp(min=1).double() / exact)
                     / math.log(max_distance / exact) * (n - exact)).long()
    large = large.clamp(max=n - 1)
    return (out + torch.where(rp < exact, rp, large)).to(device)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def t5_encode(state: State, cfg: dict, ids: torch.Tensor, mask: torch.Tensor,
              p: Precision = Precision()) -> torch.Tensor:
    """ids, mask [B, T] -> hidden states [B, T, d_model] fp32."""
    H, dk = cfg['num_heads'], cfg['d_kv']
    B, T = ids.shape
    with p.context():
        x = state['t5.shared.weight'].float()[ids.long()]
        table = state['t5.encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight']
        buckets = position_buckets(T, cfg['relative_attention_num_buckets'],
                                   cfg['relative_attention_max_distance'], ids.device)
        bias = table.float()[buckets].permute(2, 0, 1)[None]           # [1, H, T, T]
        bias = bias + torch.where(mask[:, None, None, :] > 0, 0.0, -1e9)
        for i in range(cfg['num_layers']):
            pre = f't5.encoder.block.{i}.layer'
            h = _rms(x, state[f'{pre}.0.layer_norm.weight'])
            q, k, v = (p.linear(h, state[f'{pre}.0.SelfAttention.{n}.weight']).view(B, T, H, dk)
                       for n in 'qkv')
            logits = torch.einsum('bqhd,bkhd->bhqk', p.operand(q), p.operand(k)) + bias
            w = torch.softmax(logits, dim=-1)
            out = torch.einsum('bhqk,bkhd->bqhd', p.operand(w), p.operand(v)).reshape(B, T, H * dk)
            x = x + p.linear(out, state[f'{pre}.0.SelfAttention.o.weight'])
            h = _rms(x, state[f'{pre}.1.layer_norm.weight'])
            hidden = torch.relu(p.linear(h, state[f'{pre}.1.DenseReluDense.wi.weight']))
            x = x + p.linear(hidden, state[f'{pre}.1.DenseReluDense.wo.weight'])
        return _rms(x, state['t5.encoder.final_layer_norm.weight'])


def condition(state: State, cfg: dict, ids: torch.Tensor, mask: torch.Tensor,
              p: Precision = Precision()) -> torch.Tensor:
    """The description's condition [B, T, output_dim] fp32: T5, the output
    projection, the padding zeroed."""
    with p.context():
        h = t5_encode(state, cfg, ids, mask, p)
        out = p.linear(h, state['output_proj.weight'], state.get('output_proj.bias'))
    return out * mask[..., None].float()
