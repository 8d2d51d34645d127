"""Condition fuser: combine condition tensors into the LM input
(counterpart of ``audiocraft_tpu/cond/fuser.py``).

Conditions arrive as ``{name: (tensor [B, T, C], mask [B, T])}``; the fuser
sums, interpolates, prepends or routes each one to cross-attention by its
config.  It holds no parameters.  ``first_step`` is the streaming "prepend
only on the first step" switch.
"""

from __future__ import annotations

import typing as tp

import torch

from ..nn.transformer import create_sin_embedding

ConditionType = tp.Tuple[torch.Tensor, torch.Tensor]  # (tensor [B, T, C], mask [B, T])

FUSING_METHODS = ("sum", "prepend", "cross", "ignore", "input_interpolate")


class ConditionFuser:

    def __init__(self, fuse2cond: tp.Union[tp.Mapping[str, tp.Sequence[str]],
                                           tp.Sequence[tp.Tuple[str, tp.Sequence[str]]]],
                 cross_attention_pos_emb: bool = False,
                 cross_attention_pos_emb_scale: float = 1.0):
        """``fuse2cond``: {method: condition names}, or the JAX package's
        ((method, names), ...) pairs."""
        fuse2cond = dict(fuse2cond)
        unknown = set(fuse2cond) - set(FUSING_METHODS)
        if unknown:
            raise ValueError(f"unknown fusing methods {sorted(unknown)}")
        self.fuse2cond = {method: tuple(conds) for method, conds in fuse2cond.items()}
        self.cross_attention_pos_emb = cross_attention_pos_emb
        self.cross_attention_pos_emb_scale = cross_attention_pos_emb_scale

    @classmethod
    def from_dict(cls, fuse2cond: tp.Mapping[str, tp.Sequence[str]], **kw) -> "ConditionFuser":
        return cls(fuse2cond, **kw)

    @property
    def cond2fuse(self) -> tp.Dict[str, str]:
        return {c: method for method, conds in self.fuse2cond.items() for c in conds}

    def fuse_list(self, method: str) -> tp.Tuple[str, ...]:
        return self.fuse2cond.get(method, ())

    @property
    def has_prepend(self) -> bool:
        return len(self.fuse_list('prepend')) > 0

    def __call__(self, input: torch.Tensor, conditions: tp.Mapping[str, ConditionType],
                 first_step: bool = True) -> tp.Tuple[torch.Tensor, tp.Optional[torch.Tensor]]:
        """input [B, T, D] -> (fused input, cross-attention source or None)."""
        cond2fuse = self.cond2fuse
        unknown = set(conditions) - set(cond2fuse)
        if unknown:
            raise ValueError(f"unknown conditions for fuser: {sorted(unknown)}")
        cross = None
        for name, (cond, _mask) in conditions.items():
            op = cond2fuse[name]
            if op == 'sum':
                input = input + cond
            elif op == 'input_interpolate':
                # nearest resample of the condition over the input length
                T, src_t = input.shape[1], cond.shape[1]
                idx = (torch.arange(T, device=cond.device) * src_t) // T
                input = input + cond[:, idx]
            elif op == 'prepend':
                if first_step:
                    input = torch.cat([cond.to(input.dtype), input], dim=1)
            elif op == 'cross':
                cross = cond if cross is None else torch.cat([cross, cond], dim=1)
        if self.cross_attention_pos_emb and cross is not None:
            positions = torch.arange(cross.shape[1], device=cross.device).view(1, -1, 1)
            pos_emb = create_sin_embedding(positions, cross.shape[-1])
            cross = cross + self.cross_attention_pos_emb_scale * pos_emb.to(cross.dtype)
        return input, cross
