"""Plain MusicGen language model: a full forward pass over a token sequence.

The published MusicGen transformer (facebook/musicgen-small: width 1024, 24
pre-norm layers, 16 heads, feed-forward 4096 with exact GELU, no biases):
the codebooks' embeddings summed, the sinusoidal position embedding added
(cosines then sines, periods ``10000 ** (i / (half - 1))``), per layer causal
self-attention, cross-attention to the condition and the feed-forward, each
behind a layer norm (eps 1e-5) and added back; a final layer norm; one fp32
head per codebook.  The cross-attention attends every position of the
condition, padding included, as the published model does (the condition is
zero there).  ``state`` holds the LM's tensors under the published names
(``emb.0.weight``, ``transformer.layers.0.self_attn.in_proj_weight``, ...).

The delay pattern of the codebook streams (codebook q delayed by q steps
behind an initial empty step) is rebuilt here from the configuration.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F

from .precision import Precision

State = tp.Mapping[str, torch.Tensor]


def sin_embedding(length: int, dim: int, device: torch.device,
                  max_period: float = 10000.0) -> torch.Tensor:
    half = dim // 2
    pos = torch.arange(length, device=device, dtype=torch.float32)[:, None]
    adim = torch.arange(half, device=device, dtype=torch.float32)[None]
    phase = pos / (max_period ** (adim / (half - 1)))
    return torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1)


def _norm(x: torch.Tensor, state: State, name: str) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], state[f'{name}.weight'].float(),
                        state[f'{name}.bias'].float(), 1e-5)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
               causal: bool, p: Precision) -> torch.Tensor:
    B, Tq, E = q.shape
    Tk = k.shape[1]
    d = E // heads
    q = q.view(B, Tq, heads, d).transpose(1, 2) / d ** 0.5
    k = k.view(B, Tk, heads, d).transpose(1, 2)
    v = v.view(B, Tk, heads, d).transpose(1, 2)
    logits = p.matmul(q, k.transpose(-1, -2))
    if causal:
        logits = logits.masked_fill(torch.ones(Tq, Tk, dtype=torch.bool, device=q.device)
                                    .triu(1), float('-inf'))
    return p.matmul(torch.softmax(logits, -1), v).transpose(1, 2).reshape(B, Tq, E)


def _proj(x: torch.Tensor, state: State, name: str, rows: slice, p: Precision) -> torch.Tensor:
    w = state[f'{name}.in_proj_weight'][rows]
    b = state.get(f'{name}.in_proj_bias')
    return p.linear(x, w, None if b is None else b[rows])


def _out(x: torch.Tensor, state: State, name: str, p: Precision) -> torch.Tensor:
    return p.linear(x, state[f'{name}.out_proj.weight'], state.get(f'{name}.out_proj.bias'))


def _rows(dim: int) -> tp.Tuple[slice, slice, slice]:
    """The query, key and value rows of an ``in_proj_weight``."""
    return slice(0, dim), slice(dim, 2 * dim), slice(2 * dim, 3 * dim)


def _embed(state: State, dim: int, sequence: torch.Tensor) -> torch.Tensor:
    """The codebooks' embeddings summed and the position embedding added:
    sequence [B, K, S] -> [B, S, dim] fp32."""
    K, S = sequence.shape[1:]
    x = sum(state[f'emb.{k}.weight'].float()[sequence[:, k].long()] for k in range(K))
    return x + sin_embedding(S, dim, sequence.device)[None]


def first_layer_kv(state: State, cfg: dict, sequence: torch.Tensor,
                   p: Precision = Precision()) -> torch.Tensor:
    """The first layer's self-attention keys and values at every step of
    sequence [B, K, S]: [2, B, S, dim] fp32.  They depend on the tokens
    alone (not on the condition): what a decode caches there for step s is
    the projection of step s's token and position."""
    dim = cfg['dim']
    with p.context():
        h = _norm(_embed(state, dim, sequence), state, 'transformer.layers.0.norm1')
        sa = 'transformer.layers.0.self_attn'
        return torch.stack([_proj(h, state, sa, r, p) for r in _rows(dim)[1:]])


def forward(state: State, cfg: dict, sequence: torch.Tensor, condition: torch.Tensor,
            p: Precision = Precision()) -> torch.Tensor:
    """sequence [B, K, S] (the special token ``card`` where the pattern has
    none), condition [B, L, dim] -> logits [B, K, S, card] fp32; logits at
    step s predict step s + 1."""
    dim, heads = cfg['dim'], cfg['num_heads']
    K = sequence.shape[1]
    E = _rows(dim)
    with p.context():
        x = _embed(state, dim, sequence)
        cond = condition.float()
        for i in range(cfg['num_layers']):
            pre = f'transformer.layers.{i}'
            h = _norm(x, state, f'{pre}.norm1')
            sa = f'{pre}.self_attn'
            att = _attention(*(_proj(h, state, sa, r, p) for r in E), heads, True, p)
            x = x + _out(att, state, sa, p)
            h = _norm(x, state, f'{pre}.norm_cross')
            ca = f'{pre}.cross_attention'
            att = _attention(_proj(h, state, ca, E[0], p), _proj(cond, state, ca, E[1], p),
                             _proj(cond, state, ca, E[2], p), heads, False, p)
            x = x + _out(att, state, ca, p)
            h = _norm(x, state, f'{pre}.norm2')
            ff = F.gelu(p.linear(h, state[f'{pre}.linear1.weight'],
                                 state.get(f'{pre}.linear1.bias')))
            x = x + p.linear(ff, state[f'{pre}.linear2.weight'], state.get(f'{pre}.linear2.bias'))
        x = _norm(x, state, 'out_norm')
        return torch.stack([p.linear(x, state[f'linears.{k}.weight'],
                                     state.get(f'linears.{k}.bias')) for k in range(K)], dim=1)


def cfg_logits(state: State, cfg: dict, sequence: torch.Tensor, condition: torch.Tensor,
               null_condition: torch.Tensor, coef: float,
               p: Precision = Precision()) -> torch.Tensor:
    """Classifier-free guidance: ``null + coef * (cond - null)`` of the two
    forwards, [B, K, S, card]."""
    both = forward(state, cfg, torch.cat([sequence, sequence]),
                   torch.cat([condition, null_condition]), p)
    cond, null = both.chunk(2)
    return null + (cond - null) * coef


def delay_sequence(codes: torch.Tensor, card: int) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """codes [B, K, T] -> (the delayed sequence [B, K, T + K], valid [K, T + K]):
    step 0 empty, then codebook q's frame ``s - 1 - q`` at step s; the special
    token ``card`` where a codebook has no frame."""
    B, K, T = codes.shape
    S = T + K
    seq = torch.full((B, K, S), card, dtype=torch.long, device=codes.device)
    valid = torch.zeros(K, S, dtype=torch.bool, device=codes.device)
    for q in range(K):
        seq[:, q, 1 + q:1 + q + T] = codes[:, q]
        valid[q, 1 + q:1 + q + T] = True
    return seq, valid


def logit_gaps(logits: torch.Tensor, sequence: torch.Tensor, valid: torch.Tensor
               ) -> torch.Tensor:
    """How far each token of ``sequence`` lies below the best logit that
    predicted it: logits [B, K, S, card] of the sequence's own forward ->
    gaps [B, n_valid] (>= 0) over the steps ``valid`` marks, steps >= 1; a
    token outside the vocabulary is infinitely far."""
    pred = logits[:, :, :-1]                                   # predicts steps 1 .. S - 1
    tokens = sequence[:, :, 1:].long()
    inside = (tokens >= 0) & (tokens < pred.shape[-1])
    best = pred.max(-1).values
    chosen = pred.gather(-1, tokens.clamp(0, pred.shape[-1] - 1)[..., None])[..., 0]
    gaps = torch.where(inside, best - chosen, torch.full_like(best, float('inf')))
    return gaps[:, valid[:, 1:]]


def argmax_gaps(logits: torch.Tensor, low: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The gaps, under ``logits``, of the tokens that ``low`` (the same
    forward in a lower precision) puts first at each step ``valid`` marks:
    [B, K, S, card] twice -> [B, n_valid]."""
    pred = logits[:, :, :-1]
    chosen = pred.gather(-1, low[:, :, :-1].argmax(-1, keepdim=True))[..., 0]
    return (pred.max(-1).values - chosen)[:, valid[:, 1:]]


def logit_errors(logits: torch.Tensor, drawn: torch.Tensor, valid: torch.Tensor
                 ) -> tp.Tuple[float, float]:
    """The squared L2 of ``drawn - logits`` and of ``logits``, each logit
    vector centred on its mean (softmax does not see a shift), over the
    steps ``valid`` marks, steps >= 1: logits [B, K, S, card] of the
    sequence's own forward (step s predicts step s + 1), ``drawn`` [B, K, S,
    card] the logits step s's token was taken from."""
    m = valid[:, 1:]
    want = logits[:, :, :-1][:, m]
    got = drawn[:, :, 1:][:, m].float()
    want = want - want.mean(-1, keepdim=True)
    got = got - got.mean(-1, keepdim=True)
    return float((got - want).square().sum()), float(want.square().sum())
