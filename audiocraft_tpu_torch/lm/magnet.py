"""MAGNeT: non-autoregressive masked parallel decoding over RVQ streams
(counterpart of ``audiocraft_tpu/lm/magnet.py``).

One stage per codebook, each an iterative mask-predict decode: a cosine
masking schedule, CFG with a coefficient annealed from ``max_cfg_coef`` to
``min_cfg_coef``, an annealed temperature, and re-masking of the least
probable spans ('nonoverlap': chunks of ``span_len``; 'stride1':
overlapping spans chosen by their cumulative coverage).  Stage 0 runs
whole-sequence non-causal forwards with no attention mask, which take the
flash kernel; stages 1.. use the banded ``restricted_context_attn_mask``
and stay on the plain masked path, as in the JAX package.

Ties in the re-masking order matter (many chunk scores are equal: the
unmasked chunks all carry ``DONT_REMASK_ME_SCORE``, and saturated
probabilities give equal scores): ``jax.lax.top_k`` returns the lower index
first among equal scores, and so does the stable descending sort used here.
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch

from ..cond.fuser import ConditionType
from ..ops.attention import additive_mask
from .model import LMModel
from .sampling import sample_token

DONT_REMASK_ME_SCORE = -1e4


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores on the last axis, lower index first
    among equal scores (the order of ``jax.lax.top_k``)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


class MagnetLMModel(LMModel):

    def __init__(self, *args, subcodes_context: int = 5, compression_model_framerate: int = 50,
                 segment_duration: int = 10, span_len: int = 3, **kwargs):
        super().__init__(*args, **kwargs)
        self.subcodes_context = subcodes_context
        self.compression_model_framerate = compression_model_framerate
        self.segment_duration = segment_duration
        self.span_len = span_len

    def restricted_context_attn_mask(self, seq_len: int,
                                     device: tp.Optional[torch.device] = None) -> torch.Tensor:
        """Additive [1, 1, T, T] bias: 0 where |query - key| <= subcodes_context."""
        pos = torch.arange(seq_len, device=device)
        return additive_mask((pos[:, None] - pos[None, :]).abs() <= self.subcodes_context)

    def stage_attn_mask(self, stage: int, seq_len: int,
                        device: tp.Optional[torch.device] = None) -> tp.Optional[torch.Tensor]:
        if stage > 0 and self.subcodes_context > -1:
            return self.restricted_context_attn_mask(seq_len, device)
        return None

    def _least_probable_span_masking(self, scores: torch.Tensor,
                                     num_masked_trg: int) -> torch.Tensor:
        """Overlapping span masking: cover the tokens of the u least probable
        spans, u chosen so the masked count is as close as possible to
        ``num_masked_trg`` from below.  scores [T] (higher = mask first) ->
        bool [T]."""
        L = self.span_len
        T = scores.shape[-1]
        num_masked_trg = max(num_masked_trg, L)
        M = T - L + 1
        csum = torch.cat([scores.new_zeros(1), torch.cumsum(scores, 0)])
        span_scores = csum[L:] - csum[:-L]
        order = torch.sort(-span_scores, stable=True).indices  # most maskable first
        ranks = torch.empty(M, dtype=torch.long, device=scores.device)
        ranks[order] = torch.arange(M, device=scores.device)
        # the rank at which each token is first covered, then the tokens
        # covered by the first u spans for every u
        starts = torch.arange(T, device=scores.device)[:, None] - torch.arange(L, device=scores.device)
        valid = (starts >= 0) & (starts < M)
        first = torch.where(valid, ranks[starts.clamp(0, M - 1)], M).min(1).values
        cum = (first[None, :] <= torch.arange(M, device=scores.device)[:, None]).sum(1)
        min_u = num_masked_trg // L
        max_u = max(num_masked_trg - L + 1, min_u)
        u_candidates = torch.arange(1, M + 1, device=scores.device)
        feasible = (cum <= num_masked_trg) & (u_candidates <= max_u)
        u = max(int(torch.where(feasible, u_candidates, 0).max()), min_u)
        return first < u

    @torch.no_grad()
    def generate_magnet(self, generator: torch.Generator,
                        prompt: tp.Optional[torch.Tensor] = None,
                        condition_tensors: tp.Optional[tp.Mapping[str, ConditionType]] = None,
                        num_samples: int = 1, max_gen_len: int = 256,
                        use_sampling: bool = True, temp: float = 3.0, top_k: int = 0,
                        top_p: float = 0.9, max_cfg_coef: float = 10.0,
                        min_cfg_coef: float = 1.0,
                        decoding_steps: tp.Sequence[int] = (20, 10, 10, 10),
                        anneal_temp: bool = True, span_scoring: str = 'max',
                        span_arrangement: str = 'nonoverlap') -> torch.Tensor:
        """Iterative mask-predict decode -> tokens [B, K, T_trim] int64.

        ``condition_tensors`` rows are the conditions then the null conditions
        (CFG doubles the batch, conditional rows first)."""
        if span_arrangement not in ('nonoverlap', 'stride1'):
            raise ValueError(f"span_arrangement {span_arrangement!r}")
        if len(decoding_steps) != self.n_q:
            raise ValueError(f"{len(decoding_steps)} decoding step counts for {self.n_q} "
                             "codebooks")
        device = self.emb[0].weight.device
        if prompt is None:
            prompt = torch.zeros(num_samples, self.n_q, 0, dtype=torch.long, device=device)
        prompt = prompt.to(device=device, dtype=torch.long)
        B, K, prompt_length = prompt.shape
        if prompt_length >= max_gen_len:
            raise ValueError(f"prompt of {prompt_length} frames leaves nothing to generate "
                             f"in {max_gen_len}")
        has_cfg = bool(condition_tensors)
        condition_tensors = condition_tensors or {}

        gen_sequence = torch.full((B, K, max_gen_len), self.special_token_id,
                                  dtype=torch.long, device=device)
        gen_sequence[..., :prompt_length] = prompt

        cross_kv = None
        cross_src = self.cross_source(condition_tensors, 2 * B if has_cfg else B)
        if cross_src is not None:
            cross_kv = self.transformer.precompute_cross_kv(cross_src)

        for stage, n_steps in enumerate(decoding_steps):
            gen_sequence = self._generate_stage(
                generator, gen_sequence, condition_tensors, has_cfg, stage=stage,
                prompt=prompt, temp=temp, max_cfg_coef=max_cfg_coef,
                min_cfg_coef=min_cfg_coef, top_k=top_k, top_p=top_p, timesteps=n_steps,
                anneal_temp=anneal_temp, span_scoring=span_scoring,
                use_sampling=use_sampling, cross_kv=cross_kv,
                span_arrangement=span_arrangement)
        return gen_sequence

    def _generate_stage(self, generator, gen_sequence, condition_tensors, has_cfg: bool,
                        stage: int, prompt, temp: float, max_cfg_coef: float,
                        min_cfg_coef: float, top_k: int, top_p: float, timesteps: int,
                        anneal_temp: bool, span_scoring: str, use_sampling: bool, cross_kv,
                        span_arrangement: str) -> torch.Tensor:
        """One codebook level of iterative decoding."""
        B, K, T = gen_sequence.shape
        device = gen_sequence.device
        prompt_length = prompt.shape[-1]
        mask_id = self.special_token_id
        lps_masking = span_arrangement == 'stride1' and self.span_len > 1
        chunk_masking = self.span_len > 1 and not lps_masking
        span_len = self.span_len if chunk_masking else 1

        n_chunks = T // span_len
        T = span_len * n_chunks
        gen_sequence = gen_sequence[..., :T].clone()

        stage_gen_seq = torch.full((B, 1, T), mask_id, dtype=torch.long, device=device)
        if lps_masking:
            ids = torch.arange(T, device=device)
            scores = torch.where(ids < prompt_length, DONT_REMASK_ME_SCORE, 0.0)
            scores = scores.expand(B, 1, T).clone()
            gen_T = T - prompt_length
        else:
            n_prompt_chunks = prompt_length // span_len
            ids = torch.arange(n_chunks, device=device)
            scores = torch.where(ids < n_prompt_chunks, DONT_REMASK_ME_SCORE, 0.0)
            scores = scores.expand(B, 1, n_chunks).clone()
            num_chunks_to_gen = n_chunks - n_prompt_chunks

        attn_mask = self.stage_attn_mask(stage, T, device)
        timestep_vals = np.linspace(0, 1, timesteps)
        for it, (timestep, steps_left) in enumerate(zip(timestep_vals,
                                                        reversed(range(timesteps)))):
            mask_p = float(np.cos(timestep * math.pi * 0.5))
            if lps_masking:
                num_masked = max(int(mask_p * gen_T), 1)
                mask = torch.stack([self._least_probable_span_masking(s, num_masked)
                                    for s in scores[:, 0]])[:, None]
                chunks_mask = mask
            else:
                num_masked = max(int(mask_p * num_chunks_to_gen), 1)
                chunks_mask = torch.zeros(B, 1, n_chunks, dtype=torch.bool, device=device)
                chunks_mask.scatter_(-1, top_k_indices(scores, num_masked), True)
                mask = chunks_mask.repeat_interleave(span_len, dim=-1)
            stage_gen_seq = torch.where(mask, mask_id, stage_gen_seq)
            if prompt_length:
                stage_gen_seq[..., :prompt_length] = prompt[:, stage:stage + 1]
            gen_sequence[:, stage:stage + 1] = stage_gen_seq

            seq = torch.cat([gen_sequence, gen_sequence]) if has_cfg else gen_sequence
            all_logits = self(seq, condition_tensors, cross_kv=cross_kv, attn_mask=attn_mask)
            if has_cfg:
                cond_logits, uncond_logits = all_logits[:B], all_logits[B:]
                cfg_coef = mask_p * max_cfg_coef + (1 - mask_p) * min_cfg_coef
                logits = uncond_logits + (cond_logits - uncond_logits) * cfg_coef
            else:
                logits = all_logits

            t = temp * (steps_left / timesteps) if anneal_temp else temp
            logits = logits[:, stage:stage + 1]                   # [B, 1, T, card]
            scaled = logits / max(t, 1e-2)
            probs = torch.softmax(scaled, dim=-1)
            if use_sampling:
                sampled = sample_token(scaled, True, 1.0, top_k, top_p, generator)
            else:
                sampled = torch.argmax(logits, dim=-1)

            stage_gen_seq = torch.where(stage_gen_seq == mask_id, sampled, stage_gen_seq)
            gen_sequence[:, stage:stage + 1] = stage_gen_seq

            sampled_probs = torch.gather(probs, -1, sampled[..., None])[..., 0]  # [B, 1, T]
            if lps_masking:
                scores = -torch.log(sampled_probs.clamp_min(1e-30))
                scores = torch.where(mask, scores, DONT_REMASK_ME_SCORE)
            elif span_scoring == 'max':
                scores = 1 - sampled_probs.reshape(B, 1, n_chunks, -1).max(-1).values
                scores = torch.where(chunks_mask, scores, DONT_REMASK_ME_SCORE)
            elif span_scoring == 'prod':
                scores = (-torch.log(sampled_probs.clamp_min(1e-30))
                          ).reshape(B, 1, n_chunks, -1).sum(-1)
                scores = torch.where(chunks_mask, scores, DONT_REMASK_ME_SCORE)
            else:
                raise NotImplementedError(span_scoring)
        return gen_sequence
