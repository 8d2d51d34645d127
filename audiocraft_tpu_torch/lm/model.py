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

``generate`` is MusicGen's autoregressive decode over the pattern sequence:
a prefill over the steps before the first to generate, then one step per
offset with KV caches (``nn/transformer.KVCache``), classifier-free
guidance by batch doubling (1-pass), tripling (double CFG) or two forwards
with two caches (two-step), and the pattern reverted at the end.  The steps
run on static buffers (``lm/decode.py``): on the card each capacity segment's
step is captured as a CUDA graph and replayed; on the CPU it runs eagerly.
``kv_buckets`` runs the steps in segments of growing cache capacity
(token-exact); ``kv_dtype='int8'`` stores the caches quantized; heads and
projections may hold the int8 or int4 weights of ``lm/quantize.py``.

``positional_embedding`` ('sin', 'rope', 'sin_rope') and ``kv_repeat`` go
to the transformer (``nn/transformer.py``); the caches then hold the kv
heads only.  :func:`dist.mesh.shard_lm` splits a model over a tensor-parallel
group.

The configuration is kept on the module under the JAX fields' names, for
``ckpt/io.py``.  ``depthwise_init`` and ``zero_bias_init`` (which JAX's
init reads nowhere), ``scan_layers`` (a JAX compile setting) and
``two_step_cfg`` (the facade's ``two_step_cfg`` picks the CFG form) are
kept for the config and change nothing here.
"""

from __future__ import annotations

import copy
import itertools
import math
import typing as tp

import torch
import torch.nn.functional as F

from ..cond.fuser import ConditionFuser, ConditionType
from ..nn import init
from ..nn.transformer import (CrossKV, KVCache, LayerNorm, QuantizedWeight,
                              StreamingTransformer)
from ..patterns import CodebooksPatternProvider
from .decode import UNKNOWN_TOKEN, DecodeCache, DecodeState
from .quantize import prepare_for_decode

Conditions = tp.Mapping[str, ConditionType]


def _weights_key(lm: torch.nn.Module) -> tp.Tuple[tp.Tuple[int, torch.dtype, torch.Size], ...]:
    """Where each of ``lm``'s tensors lives: a decode state's graphs read the
    weights at these addresses, so a state is reused only while they hold
    (values changed in place are read; tensors replaced are not)."""
    return tuple((t.data_ptr(), t.dtype, t.shape)
                 for t in itertools.chain(lm.parameters(), lm.buffers()))


def _plan_cache_segments(first: int, S: int, prepend_len: int,
                         capacities: tp.Sequence[int]) -> tp.List[tp.Tuple[int, int, int]]:
    """Split the decode offsets ``[first, S)`` into segments of growing KV
    capacity: ``[(start, end, capacity), ...]``.

    The step at offset ``o`` writes cache position ``prepend_len + o - 1``,
    so a segment under capacity ``c`` covers offsets ``o <= c - prepend_len``;
    the first must also hold the prefill (``prepend_len + first`` positions).
    Capacities are used in ascending order; the full capacity ``S +
    prepend_len`` is always the last."""
    full = S + prepend_len
    caps = sorted({int(c) for c in capacities if int(c) < full}) + [full]
    caps = [c for c in caps if c >= prepend_len + first] or [full]
    segs: tp.List[tp.Tuple[int, int, int]] = []
    start = first
    for c in caps:
        if start >= S:
            break
        end = S if c >= full else min(S, c - prepend_len + 1)
        if end > start:
            segs.append((start, end, c))
            start = end
    if not segs:                       # prompt == max_gen_len: prefill only
        segs = [(first, S, caps[0])]
    if segs[-1][1] < S:
        segs.append((segs[-1][1], S, full))
    return segs


def _auto_capacities(full: int, min_bucket: int = 256) -> tp.List[int]:
    """Doubling bucket ladder below ``full`` (256, 512, 1024, ...), from a
    full capacity of 1024 up, as in the JAX package (whose threshold is a TPU
    measurement; no card number moves it yet)."""
    if full < 1024:
        return []
    caps = []
    c = min_bucket
    while c < full:
        caps.append(c)
        c *= 2
    return caps


class LMOutput(tp.NamedTuple):
    logits: torch.Tensor  # [B, K, T, card] fp32, NaN where no prediction
    mask: torch.Tensor    # [B, K, T] bool


class LMModel(torch.nn.Module):

    def __init__(self, fuser: ConditionFuser, n_q: int = 8, card: int = 1024, dim: int = 128,
                 num_heads: int = 8, num_layers: int = 8, hidden_scale: int = 4,
                 norm_first: bool = False, bias_proj: bool = True,
                 cross_attention: bool = False, causal: bool = True,
                 past_context: tp.Optional[int] = None, positional_embedding: str = 'sin',
                 layer_scale: tp.Optional[float] = None,
                 weight_init: tp.Optional[str] = None, bias_ff: bool = True,
                 bias_attn: bool = True, qk_layer_norm: bool = False,
                 qk_layer_norm_cross: bool = False, kv_repeat: int = 1,
                 activation: str = 'gelu',
                 attn_kernel: tp.Union[bool, str] = False,
                 pattern_provider: tp.Optional[CodebooksPatternProvider] = None,
                 cfg_coef: float = 3.0, checkpointing: bool = False,
                 two_step_cfg: bool = False, depthwise_init: tp.Optional[str] = None,
                 zero_bias_init: bool = False, scan_layers: bool = False,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        if weight_init not in (None, 'gaussian', 'uniform'):
            raise ValueError(f"weight_init {weight_init!r}: None, 'gaussian' or 'uniform'")
        self.fuser = fuser
        self.pattern_provider = pattern_provider
        self.n_q, self.card, self.dim = n_q, card, dim
        self.num_heads, self.num_layers, self.hidden_scale = num_heads, num_layers, hidden_scale
        self.norm_first, self.bias_proj, self.bias_ff, self.bias_attn = (
            norm_first, bias_proj, bias_ff, bias_attn)
        self.cross_attention, self.causal, self.past_context = cross_attention, causal, past_context
        self.positional_embedding, self.layer_scale = positional_embedding, layer_scale
        self.qk_layer_norm, self.qk_layer_norm_cross = qk_layer_norm, qk_layer_norm_cross
        self.kv_repeat, self.activation, self.attn_kernel = kv_repeat, activation, attn_kernel
        self.cfg_coef, self.checkpointing, self.two_step_cfg = cfg_coef, checkpointing, two_step_cfg
        self.weight_init, self.depthwise_init = weight_init, depthwise_init
        self.zero_bias_init, self.scan_layers = zero_bias_init, scan_layers
        std = 1.0 / math.sqrt(dim)
        bound = math.sqrt(3.0) * std    # 'uniform': the std of the gaussian init

        def table(rows: int, gaussian: bool) -> torch.nn.Parameter:
            """[rows, dim]: uniform, truncated gaussian of ``std``, or N(0, 1)."""
            if weight_init == 'uniform':
                return init.uniform((rows, dim), bound, generator)
            if gaussian:
                return init.normal((rows, dim), std, generator, truncate=3.0)
            return init.normal((rows, dim), 1.0, generator)

        emb = [table(card + 1, weight_init == 'gaussian') for _ in range(n_q)]
        self.emb = torch.nn.ModuleList(init.embedding(card + 1, dim, w) for w in emb)
        self.transformer = StreamingTransformer(
            d_model=dim, num_heads=num_heads, num_layers=num_layers,
            dim_feedforward=int(hidden_scale * dim), causal=causal, past_context=past_context,
            cross_attention=cross_attention, layer_scale=layer_scale,
            positional_embedding=positional_embedding, norm_first=norm_first,
            bias_ff=bias_ff, bias_attn=bias_attn, qk_layer_norm=qk_layer_norm,
            qk_layer_norm_cross=qk_layer_norm_cross, kv_repeat=kv_repeat, activation=activation,
            attn_kernel=attn_kernel, checkpointing=checkpointing, generator=generator)
        self.out_norm = LayerNorm(dim) if norm_first else None
        linears = []
        for _ in range(n_q):
            layer = torch.nn.Linear(dim, card, bias=bias_proj, device='meta')
            layer.weight = table(card, True)
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

    @property
    def float_dtype(self) -> torch.dtype:
        """The dtype of the floating weights (the compute dtype)."""
        return self.emb[0].weight.dtype

    def apply_heads(self, out: torch.Tensor) -> torch.Tensor:
        """out [B, S, dim] -> fp32 logits [B, K, S, card]; quantized heads
        take the integer values in fp32 sums and scale by row (int8) or
        group (int4)."""
        logits = []
        for lin in self.linears:
            if isinstance(lin.weight, QuantizedWeight):
                y = lin.weight.matmul(out)
            else:
                y = F.linear(out.float(), lin.weight.float())
            logits.append(y if lin.bias is None else y + lin.bias.float())
        return torch.stack(logits, dim=1)

    def init_cache(self, batch: int, capacity: int, dtype: tp.Optional[torch.dtype] = None,
                   kv_dtype: tp.Optional[str] = None) -> tp.List[KVCache]:
        return self.transformer.init_cache(batch, capacity, dtype or self.float_dtype,
                                           kv_dtype, self.emb[0].weight.device)

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
                attn_mask: tp.Optional[torch.Tensor] = None,
                caches: tp.Optional[tp.Sequence[KVCache]] = None,
                first_step: bool = True) -> torch.Tensor:
        """sequence [B, K, S] -> logits [B, K, S, card].  With ``caches`` the
        steps continue at their index and are appended to them in place;
        ``first_step`` False skips the prepended conditions (streaming)."""
        B, K, S = sequence.shape
        if K != self.n_q:
            raise ValueError(f"sequence has {K} codebooks, the model {self.n_q}")
        x, cross_src = self.fuser(self.embed_sequence(sequence), condition_tensors,
                                  first_step=first_step)
        if cross_kv is not None:
            cross_src = None
        out = self.transformer(x, cross_attention_src=cross_src, cross_kv=cross_kv,
                               attn_mask=attn_mask, caches=caches)
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

    # -------------------------------------------------------------- generate
    def _combine_cfg(self, all_logits: torch.Tensor, B: int, has_cfg: bool, cfg_coef: float,
                     cfg_coef_beta: tp.Optional[float] = None) -> torch.Tensor:
        if not has_cfg:
            return all_logits
        if cfg_coef_beta is not None:
            # double CFG (MusicGen-Style): groups [text+style, style only, null]
            cond, wav, uncond = all_logits[:B], all_logits[B:2 * B], all_logits[2 * B:3 * B]
            return uncond + cfg_coef * (wav + cfg_coef_beta * (cond - wav) - uncond)
        cond, uncond = all_logits[:B], all_logits[B:2 * B]
        return uncond + (cond - uncond) * cfg_coef

    def _decode_plan(self, pattern, S: int, B: int, T: int, conditions, two_step: bool,
                     use_sampling: bool, temp: float, top_k: int, top_p: float,
                     cfg_coef: float, cfg_coef_beta: tp.Optional[float],
                     kv_dtype: tp.Optional[str],
                     kv_buckets: tp.Union[None, str, tp.Sequence[int]]) -> dict:
        """The shapes, segments and settings of one generate over a pattern
        sequence of S steps (host only)."""
        S0 = pattern.get_first_step_with_timesteps(T)
        if S0 is None or S0 < 1:
            raise ValueError(f"the pattern has no step to prefill before timestep {T}")
        main = conditions[0] if two_step else conditions
        has_cfg = len(main) > 0
        n_groups = 3 if cfg_coef_beta is not None else 2
        if not has_cfg or two_step:
            n_groups = 1
        prepend_len = 0
        if self.fuser.has_prepend and has_cfg:
            prepend_len = sum(main[name][0].shape[1] for name in self.fuser.fuse_list('prepend')
                              if name in main)
        capacity = S + prepend_len
        if kv_buckets is None:
            segments = [(S0 + 1, S, capacity)]
        else:
            caps = _auto_capacities(capacity) if kv_buckets == 'auto' else kv_buckets
            segments = _plan_cache_segments(S0 + 1, S, prepend_len, caps)
        return dict(S=S, S0=S0, batch=B, model_batch=n_groups * B, n_groups=n_groups,
                    has_cfg=has_cfg, two_step=two_step, segments=segments,
                    device=self.emb[0].weight.device, cache_dtype=self.float_dtype,
                    kv_dtype=kv_dtype,
                    use_sampling=use_sampling, temp=temp, top_k=top_k, top_p=top_p,
                    cfg_coef=cfg_coef, cfg_coef_beta=cfg_coef_beta)

    def _cast_for_decode(self, compute_dtype, graph_cache: tp.Optional[DecodeCache]
                         ) -> "LMModel":
        if compute_dtype is None:
            return self
        dtype = getattr(torch, compute_dtype) if isinstance(compute_dtype, str) else compute_dtype
        if dtype == self.float_dtype:
            return self
        if graph_cache is None:
            return copy.deepcopy(self).to(dtype)
        return graph_cache.cast(self, dtype)

    @torch.no_grad()
    def generate(self, generator: tp.Optional[torch.Generator] = None,
                 prompt: tp.Optional[torch.Tensor] = None,
                 condition_tensors: tp.Union[None, Conditions,
                                             tp.Tuple[Conditions, Conditions]] = None,
                 num_samples: int = 1, max_gen_len: int = 256, use_sampling: bool = True,
                 temp: float = 1.0, top_k: int = 250, top_p: float = 0.0,
                 cfg_coef: tp.Optional[float] = None,
                 cfg_coef_beta: tp.Optional[float] = None, remove_prompts: bool = False,
                 compute_dtype: tp.Union[None, str, torch.dtype] = None,
                 kv_dtype: tp.Optional[str] = None,
                 kv_buckets: tp.Union[None, str, tp.Sequence[int]] = None,
                 graph_cache: tp.Optional[DecodeCache] = None, *,
                 _eager: bool = False, _state_out: tp.Optional[list] = None) -> torch.Tensor:
        """Autoregressive generation over the pattern sequence -> codes
        [B, K, max_gen_len] int64 (the prompt included unless
        ``remove_prompts``).

        CFG forms: ``condition_tensors`` a dict whose rows are [conditions;
        null conditions] (1-pass, the model batch doubled), or with
        ``cfg_coef_beta`` [text+style; style only; null] (double CFG,
        tripled); a (conditions, null) tuple runs two-step CFG, two forwards a
        step with two caches.  ``compute_dtype`` runs a copy of the model in
        that dtype (logits, CFG and sampling stay fp32; with a
        ``graph_cache`` the copy is kept there and refreshed from this
        model's weights at each call); ``kv_dtype='int8'`` stores the caches
        quantized; ``kv_buckets`` ('auto', a list of capacities, or None)
        grows the caches in segments.  ``generator`` draws the sampling
        uniforms (up front; none when greedy).  ``graph_cache``: a
        :class:`DecodeCache` in which the decode states, with their CUDA
        graphs, are kept by signature and reused.  ``_eager`` runs every step
        eagerly on the card too (to hold the graphs against), and
        ``_state_out`` receives the decode state."""
        cfg_coef = self.cfg_coef if cfg_coef is None else cfg_coef
        lm = self._cast_for_decode(compute_dtype, graph_cache)
        prepare_for_decode(lm)
        device, dtype = lm.emb[0].weight.device, lm.float_dtype
        two_step = isinstance(condition_tensors, tuple)

        def cast(conds: tp.Optional[Conditions]) -> tp.Dict[str, ConditionType]:
            return {name: (t.to(device=device, dtype=dtype if t.is_floating_point() else t.dtype),
                           m.to(device)) for name, (t, m) in (conds or {}).items()}

        conditions = (tuple(cast(c) for c in condition_tensors) if two_step
                      else cast(condition_tensors))
        if prompt is None:
            prompt = torch.zeros(num_samples, self.n_q, 0, dtype=torch.long)
        prompt = prompt.to(device=device, dtype=torch.long)
        B, K, T = prompt.shape
        if self.pattern_provider is None:
            raise ValueError("generate needs a model built with a pattern_provider")
        if T > max_gen_len:
            raise ValueError(f"prompt of {T} frames is longer than max_gen_len {max_gen_len}")
        pattern = self.pattern_provider.get_pattern(max_gen_len)
        gen_codes = torch.full((B, K, max_gen_len), UNKNOWN_TOKEN, dtype=torch.long,
                               device=device)
        gen_codes[..., :T] = prompt
        gen_sequence, _, mask = pattern.build_pattern_sequence(gen_codes, self.special_token_id)
        plan = lm._decode_plan(pattern, gen_sequence.shape[-1], B, T, conditions, two_step,
                               use_sampling, temp, top_k, top_p, cfg_coef, cfg_coef_beta,
                               kv_dtype, tuple(kv_buckets) if isinstance(kv_buckets, list)
                               else kv_buckets)
        plan['mask'] = mask

        groups = conditions if two_step else (conditions,)
        key = (id(lm), _eager, _weights_key(lm),
               tuple(sorted((k, str(v)) for k, v in plan.items() if k != 'mask')),
               tuple((name, tuple(t.shape), tuple(m.shape)) for c in groups
                     for name, (t, m) in c.items()))
        make = lambda: DecodeState(lm, plan, conditions)  # noqa: E731
        state = make() if graph_cache is None else graph_cache.state(key, make)
        state.load(gen_sequence, conditions, generator)
        state.prefill()
        state.run(_eager)
        if _state_out is not None:
            _state_out.append(state)
        out_codes = pattern.revert_pattern_sequence(state.seq, special_token=UNKNOWN_TOKEN)[0]
        return out_codes[..., T if remove_prompts else 0:max_gen_len]
