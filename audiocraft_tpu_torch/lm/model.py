"""Transformer LM over multiple codebook streams
(counterpart of ``audiocraft_tpu/lm/model.py:LMModel``).

Per-codebook embeddings ``emb.{k}`` are summed into the transformer input;
per-codebook heads ``linears.{k}`` give fp32 logits ``[B, K, S, card]``.
Parameter names are the reference audiocraft LM's, so ``state_dict()`` goes
through the JAX package's ``ckpt/torch_import.import_lm`` and a reference
state dict loads with ``strict=True``.

The heads, like the JAX package's ``preferred_element_type=float32``, give
fp32 results from bf16 weights: their operands are upcast, which is exact for
bf16 values.  Logits, CFG and sampling stay fp32.

``compute_predictions`` is the training forward: codes are laid out by the
codebook pattern, run through the model, and the logits reverted to the
codes' frames with NaN where a frame has no prediction.

Not ported yet: ``generate`` (MusicGen's delay-pattern decode) and its
KV-cache buckets, the quantized heads, RoPE positions, ``kv_repeat > 1``, the
'uniform' weight init and the depthwise init scaling.
"""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn.functional as F

from ..cond.fuser import ConditionFuser, ConditionType
from ..nn import init
from ..nn.transformer import CrossKV, LayerNorm, StreamingTransformer
from ..patterns import CodebooksPatternProvider


class LMOutput(tp.NamedTuple):
    logits: torch.Tensor  # [B, K, T, card] fp32, NaN where no prediction
    mask: torch.Tensor    # [B, K, T] bool


class LMModel(torch.nn.Module):

    def __init__(self, fuser: ConditionFuser, n_q: int = 8, card: int = 1024, dim: int = 128,
                 num_heads: int = 8, num_layers: int = 8, hidden_scale: int = 4,
                 norm_first: bool = False, bias_proj: bool = True,
                 cross_attention: bool = False, causal: bool = True,
                 past_context: tp.Optional[int] = None, layer_scale: tp.Optional[float] = None,
                 weight_init: tp.Optional[str] = None, bias_ff: bool = True,
                 bias_attn: bool = True, qk_layer_norm: bool = False,
                 qk_layer_norm_cross: bool = False, activation: str = 'gelu',
                 attn_kernel: tp.Union[bool, str] = False,
                 pattern_provider: tp.Optional[CodebooksPatternProvider] = None,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        if weight_init not in (None, 'gaussian'):
            raise ValueError(f"weight_init {weight_init!r}: None or 'gaussian'")
        self.fuser = fuser
        self.pattern_provider = pattern_provider
        self.n_q, self.card, self.dim = n_q, card, dim
        self.cross_attention = cross_attention
        std = 1.0 / math.sqrt(dim)
        emb = [init.normal((card + 1, dim), std, generator, truncate=3.0)
               if weight_init == 'gaussian' else init.normal((card + 1, dim), 1.0, generator)
               for _ in range(n_q)]
        self.emb = torch.nn.ModuleList(init.embedding(card + 1, dim, w) for w in emb)
        self.transformer = StreamingTransformer(
            d_model=dim, num_heads=num_heads, num_layers=num_layers,
            dim_feedforward=int(hidden_scale * dim), causal=causal, past_context=past_context,
            cross_attention=cross_attention, layer_scale=layer_scale, norm_first=norm_first,
            bias_ff=bias_ff, bias_attn=bias_attn, qk_layer_norm=qk_layer_norm,
            qk_layer_norm_cross=qk_layer_norm_cross, activation=activation,
            attn_kernel=attn_kernel, generator=generator)
        self.out_norm = LayerNorm(dim) if norm_first else None
        linears = []
        for _ in range(n_q):
            layer = torch.nn.Linear(dim, card, bias=bias_proj, device='meta')
            layer.weight = init.normal((card, dim), std, generator, truncate=3.0)
            if bias_proj:
                layer.bias = init.constant((card,), 0.0)
            linears.append(layer)
        self.linears = torch.nn.ModuleList(linears)

    @property
    def special_token_id(self) -> int:
        return self.card

    @property
    def num_codebooks(self) -> int:
        return self.n_q

    def embed_sequence(self, sequence: torch.Tensor) -> torch.Tensor:
        """sequence [B, K, S] int -> summed embeddings [B, S, dim]."""
        return torch.stack([emb(sequence[:, k].long()) for k, emb in enumerate(self.emb)],
                           dim=1).sum(1)

    def apply_heads(self, out: torch.Tensor) -> torch.Tensor:
        """out [B, S, dim] -> fp32 logits [B, K, S, card]."""
        out = out.float()
        logits = []
        for lin in self.linears:
            y = F.linear(out, lin.weight.float())
            logits.append(y if lin.bias is None else y + lin.bias.float())
        return torch.stack(logits, dim=1)

    def cross_source(self, condition_tensors: tp.Mapping[str, ConditionType],
                     batch: int) -> tp.Optional[torch.Tensor]:
        """The cross-attention source the fuser builds from the conditions."""
        if not (self.cross_attention and condition_tensors):
            return None
        dummy = self.emb[0].weight.new_zeros(batch, 1, self.dim)
        return self.fuser(dummy, condition_tensors, first_step=False)[1]

    def forward(self, sequence: torch.Tensor,
                condition_tensors: tp.Mapping[str, ConditionType],
                cross_kv: tp.Optional[tp.Sequence[CrossKV]] = None,
                attn_mask: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        """sequence [B, K, S] -> logits [B, K, S, card] (no cache)."""
        B, K, S = sequence.shape
        if K != self.n_q:
            raise ValueError(f"sequence has {K} codebooks, the model {self.n_q}")
        x, cross_src = self.fuser(self.embed_sequence(sequence), condition_tensors)
        if cross_kv is not None:
            cross_src = None
        out = self.transformer(x, cross_attention_src=cross_src, cross_kv=cross_kv,
                               attn_mask=attn_mask)
        if self.out_norm is not None:
            out = self.out_norm(out)
        logits = self.apply_heads(out)
        if self.fuser.has_prepend:
            logits = logits[:, :, -S:]
        return logits

    def compute_predictions(self, codes: torch.Tensor,
                            condition_tensors: tp.Mapping[str, ConditionType]) -> LMOutput:
        """Training forward through the codebook pattern (its valid steps
        only): codes [B, K, T] -> logits [B, K, T, card] and the mask of
        frames that have a prediction."""
        if self.pattern_provider is None:
            raise ValueError("compute_predictions needs a model built with a pattern_provider")
        B, K, T = codes.shape
        pattern = self.pattern_provider.get_pattern(T)
        sequence, _, _ = pattern.build_pattern_sequence(codes, self.special_token_id,
                                                        keep_only_valid_steps=True)
        logits = self(sequence, condition_tensors).permute(0, 3, 1, 2)  # [B, card, K, S]
        logits, _, mask = pattern.revert_pattern_logits(logits, float('nan'),
                                                        keep_only_valid_steps=True)
        mask = torch.as_tensor(mask, device=codes.device)[None].expand(B, K, T)
        return LMOutput(logits.permute(0, 2, 3, 1), mask)
