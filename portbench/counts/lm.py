"""Model FLOPs of MusicGen's text conditioning and decode, from shapes.

* T5: per token and layer, the q, k, v and o projections and the two
  feed-forward products (``2 (4 d inner + 2 d d_ff)``), and the attention's
  two products over the text (``2 * 2 * L * inner``); the output projection
  to the LM's width.
* A generate of ``frames`` frames runs ``frames + n_q - 1`` forward steps
  (the delay pattern's steps after the first) for each model row (a
  description and its null condition under 1-pass guidance).  Per row and
  step: two operations per weight of the layers' matrices a row touches
  (self-attention's in and out projections, cross-attention's query and out
  projections, the feed-forward: ``14 d^2`` a layer at hidden scale 4) and of
  the heads (``n_q d card``); attention over the positions filled so far and
  over the condition's ``cond_len`` positions, ``2 * 2 * positions * d`` a
  layer.  The condition's cross keys and values are projected once a
  generate (``2 * 2 * cond_len * d^2`` a layer and row).
"""

from __future__ import annotations


def t5_flops(t5: dict, out_dim: int, length: int) -> float:
    """FLOPs of conditioning on one text of ``length`` ids."""
    d, inner, ff = t5['d_model'], t5['num_heads'] * t5['d_kv'], t5['d_ff']
    per_layer = 2.0 * length * (4 * d * inner + 2 * d * ff) + 2.0 * 2 * length * length * inner
    return t5['num_layers'] * per_layer + 2.0 * length * d * out_dim


def decode_flops(lm: dict, frames: int, cond_len: int) -> float:
    """FLOPs of one model row's whole generate."""
    d, layers = lm['dim'], lm['num_layers']
    matrices = (3 + 1 + 1 + 1) * d * d + 2 * lm['hidden_scale'] * d * d
    steps = frames + lm['n_q'] - 1
    per_step = 2.0 * (layers * matrices + lm['n_q'] * d * lm['card'])
    # positions 1 .. steps attended at steps 1 .. steps
    self_attn = layers * 2.0 * 2 * d * steps * (steps + 1) / 2
    cross = layers * (2.0 * 2 * cond_len * d * steps + 2.0 * 2 * cond_len * d * d)
    return steps * per_step + self_attn + cross
