"""The autoregressive decode loop of ``LMModel.generate``, on static buffers
(the counterpart of the JAX package's ``lax.scan`` over decode steps inside
one ``jax.jit``, ``audiocraft_tpu/lm/model.py:generate`` and
``gen/musicgen.py:_lm_generate``).

A :class:`DecodeState` holds everything a decode step reads or writes at
fixed addresses: the pattern sequence being filled, the step offset, the
pattern's validity mask, the uniforms drawn up front, the condition tensors
and their cross-attention keys and values, and the KV caches of each
capacity segment (their index a 0-d device tensor).  :meth:`DecodeState.step`
reads and writes only those tensors, in place, and reads nothing back to
the host.  So on the card each segment's step is captured once as a
``torch.cuda.CUDAGraph`` and replayed for every offset of the segment: one
launch a step for some 30 operations a layer that an eager step would
dispatch one by one.  A failed capture raises; nothing falls back to the
eager loop, which stays reachable on the card only through
``LMModel.generate(_eager=True)``, to hold the graph against it.  On the CPU
the same step runs eagerly.

A state serves one signature (batch, lengths, sampling and CFG settings,
dtypes, buckets, condition shapes, the addresses of the weights):
``LMModel.generate`` keeps states in the :class:`DecodeCache` its caller
passes (the facade keeps one, like the JAX facade's jit cache), reloads the
buffers in place for each call and replays the graphs captured by the first.
The cache holds at most ``DecodeCache.max_states`` (4) states, each with
caches at full capacity and a graph pool, and drops the least recently used.
"""

from __future__ import annotations

import copy
import time
import typing as tp

import torch

from ..nn.transformer import KVCache, grow_cache
from .sampling import draw_uniforms, sample_token, samples

UNKNOWN_TOKEN = -1
Caches = tp.Union[tp.List[KVCache], tp.Tuple[tp.List[KVCache], tp.List[KVCache]]]
Conditions = tp.Dict[str, tp.Tuple[torch.Tensor, torch.Tensor]]


def _copy_conditions(dst: Conditions, src: Conditions) -> None:
    for name, (t, m) in src.items():
        dst[name][0].copy_(t)
        dst[name][1].copy_(m)


class DecodeState:
    """Static buffers and graphs of one generate signature (see the module
    docstring).  ``plan`` is what ``LMModel._decode_plan`` computed."""

    def __init__(self, lm, plan: dict, conditions: tp.Union[Conditions, tp.Tuple[Conditions,
                                                                                 Conditions]]):
        self.lm, self.plan = lm, plan
        device = plan['device']
        B, K, S = plan['batch'], lm.n_q, plan['S']
        self.seq = torch.full((B, K, S), UNKNOWN_TOKEN, dtype=torch.long, device=device)
        self.offset = torch.zeros(1, dtype=torch.long, device=device)
        self.mask = torch.as_tensor(plan['mask'], device=device)          # [K, S] bool
        self.uniforms = (torch.zeros(S, B, K, 1, device=device)
                         if samples(plan['use_sampling'], plan['temp']) else None)
        groups = conditions if plan['two_step'] else (conditions,)
        self.conditions = tuple({name: (t.clone(), m.clone()) for name, (t, m) in c.items()}
                                for c in groups)
        self.cross_kv: tp.List[tp.Optional[list]] = [None] * len(groups)
        self.caches: tp.List[tp.Optional[Caches]] = [None] * len(plan['segments'])
        self.graphs: tp.Dict[int, torch.cuda.CUDAGraph] = {}
        self.capture_seconds: tp.List[float] = []   # host time of each capture
        self.pool = None
        self.segment = 0
        self.current: tp.Optional[Caches] = None   # the running segment's caches

    # ------------------------------------------------------------ buffers
    def _segment_caches(self, i: int) -> Caches:
        """Segment i's caches: allocated for segment 0, grown from segment
        i - 1's for the others (into the same tensors on a reused state)."""
        plan, lm = self.plan, self.lm
        capacity = plan['segments'][i][2]
        if i == 0:
            if self.caches[0] is None:
                make = lambda batch: lm.transformer.init_cache(  # noqa: E731
                    batch, capacity, plan['cache_dtype'], plan['kv_dtype'], plan['device'])
                self.caches[0] = ((make(plan['batch']), make(plan['batch']))
                                  if plan['two_step'] else make(plan['model_batch']))
            for cache_set in self._sets(self.caches[0]):
                cache_set[0].index.zero_()
                for cache in cache_set:
                    for t in cache.tensors():
                        t.zero_()
            return self.caches[0]
        prev = self._sets(self.caches[i - 1])
        out = None if self.caches[i] is None else self._sets(self.caches[i])
        grown = [grow_cache(p, capacity, None if out is None else out[j])
                 for j, p in enumerate(prev)]
        self.caches[i] = tuple(grown) if plan['two_step'] else grown[0]
        return self.caches[i]

    def _sets(self, caches: Caches) -> tp.List[tp.List[KVCache]]:
        return list(caches) if self.plan['two_step'] else [caches]

    def load(self, gen_sequence: torch.Tensor, conditions,
             generator: tp.Optional[torch.Generator]) -> None:
        """Reset the buffers for one call: the initial pattern sequence, the
        conditions, their cross K/V, the uniforms, segment 0's zeroed caches."""
        plan, lm = self.plan, self.lm
        self.seq.copy_(gen_sequence)
        groups = conditions if plan['two_step'] else (conditions,)
        batches = (plan['batch'],) * 2 if plan['two_step'] else (plan['model_batch'],)
        for i, (dst, src) in enumerate(zip(self.conditions, groups)):
            _copy_conditions(dst, src)
            src_cross = lm.cross_source(dst, batches[i])
            if src_cross is None:
                continue
            kv = lm.transformer.precompute_cross_kv(src_cross)
            if self.cross_kv[i] is None:
                self.cross_kv[i] = kv
            else:
                for (k_dst, v_dst), (k, v) in zip(self.cross_kv[i], kv):
                    k_dst.copy_(k)
                    v_dst.copy_(v)
        if self.uniforms is not None:
            S0 = plan['S0']
            self.uniforms[S0:].copy_(draw_uniforms(
                generator, plan['S'] - S0, (plan['batch'], lm.n_q), self.uniforms.device))
        self.segment = 0
        self.current = self._segment_caches(0)

    # --------------------------------------------------------------- step
    def model_step(self, seq_chunk: torch.Tensor, first_step: bool) -> torch.Tensor:
        """seq_chunk [B, K, s] -> logits [B, K, s, card] after CFG."""
        plan, lm = self.plan, self.lm
        if plan['two_step']:
            cond, null = (lm.forward(seq_chunk, c, cross_kv=kv, caches=caches,
                                     first_step=first_step)
                          for c, kv, caches in zip(self.conditions, self.cross_kv,
                                                   self.current))
            return null + (cond - null) * plan['cfg_coef']
        tiled = torch.cat([seq_chunk] * plan['n_groups']) if plan['has_cfg'] else seq_chunk
        logits = lm.forward(tiled, self.conditions[0], cross_kv=self.cross_kv[0],
                            caches=self.current, first_step=first_step)
        return lm._combine_cfg(logits, plan['batch'], plan['has_cfg'], plan['cfg_coef'],
                               plan['cfg_coef_beta'])

    def write_token(self, logits: torch.Tensor) -> None:
        """Sample the token at the current offset from logits [B, K, card]
        and write it where the pattern has no token yet (special where the
        pattern marks the step invalid for a codebook)."""
        plan = self.plan
        u = None if self.uniforms is None else self.uniforms.index_select(0, self.offset)[0]
        next_token = sample_token(logits, plan['use_sampling'], plan['temp'], plan['top_k'],
                                  plan['top_p'], u=u)
        valid = self.mask.index_select(1, self.offset)[:, 0]              # [K]
        next_token = torch.where(valid[None, :], next_token, self.lm.special_token_id)
        curr = self.seq.index_select(2, self.offset)[..., 0]              # [B, K]
        token = torch.where(curr == UNKNOWN_TOKEN, next_token, curr)
        self.seq.index_copy_(2, self.offset, token[..., None])

    def prefill(self) -> None:
        """The forward over the steps before the first one to generate, then
        that step's token."""
        S0 = self.plan['S0']
        logits = self.model_step(self.seq[..., :S0], first_step=True)
        self.offset.fill_(S0)
        self.write_token(logits[:, :, -1])
        self.offset.add_(1)

    def step(self) -> None:
        """One decode step at the offset, which it advances."""
        curr = self.seq.index_select(2, self.offset - 1)                  # [B, K, 1]
        logits = self.model_step(curr, first_step=False)
        self.write_token(logits[:, :, -1])
        self.offset.add_(1)

    # ---------------------------------------------------------- segments
    def run(self, eager: bool) -> None:
        """Every segment: grow the caches, then its steps (replays of its
        captured graph on the card unless ``eager``)."""
        for i, (start, end, _) in enumerate(self.plan['segments']):
            if i:
                self.current = self._segment_caches(i)
            self.segment = i
            self.offset.fill_(start)
            self.run_steps(end - start, eager)

    def run_steps(self, n: int, eager: bool) -> None:
        if eager or self.seq.device.type != 'cuda':
            for _ in range(n):
                self.step()
            return
        graph = self.graphs.get(self.segment)
        if graph is None and n:
            # one real step on a side stream first, as torch.cuda.graphs asks
            # (lazy initialisation of libraries and workspaces), then capture
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.step()
            torch.cuda.current_stream().wait_stream(side)
            n -= 1
            graph = self.capture()
        for _ in range(n):
            graph.replay()

    def capture(self) -> torch.cuda.CUDAGraph:
        """Capture the current segment's step (not run: a capture records)."""
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            self.step()
        self.capture_seconds.append(time.perf_counter() - t0)
        self.pool = graph.pool()
        self.graphs[self.segment] = graph
        return graph

    def kv_bytes(self) -> int:
        """Bytes of every cache the state holds (all segments)."""
        return sum(c.nbytes() for caches in self.caches if caches is not None
                   for cache_set in self._sets(caches) for c in cache_set)


class DecodeCache:
    """What ``LMModel.generate`` keeps across calls: decode states by
    signature, at most ``max_states`` of them (the least recently used is
    dropped with its caches and graphs), and one copy of the model cast to a
    ``compute_dtype``, whose tensors are refreshed in place from the model's
    at every call (so that the graphs captured over them stay valid and see
    new weights).  At MusicGen-small, 4 x 30 s with CFG, a state holds
    1.1-1.3 GiB of caches; four cover a stride extension (two signatures)
    beside two other requests."""

    max_states = 4

    def __init__(self):
        self.states: tp.Dict[tp.Hashable, DecodeState] = {}
        self._cast: tp.Optional[tuple] = None   # (source id, dtype, structure, copy)

    def __len__(self) -> int:
        return len(self.states)

    def clear(self) -> None:
        """Drop every state and the cast copy (their device memory with them)."""
        self.states.clear()
        self._cast = None

    def state(self, key: tp.Hashable, make: tp.Callable[[], DecodeState]) -> DecodeState:
        """The state of ``key``, made by ``make`` on a miss; least recently
        used first out."""
        state = self.states.pop(key, None)
        if state is None:
            while len(self.states) >= self.max_states:
                del self.states[next(iter(self.states))]
            state = make()
        self.states[key] = state
        return state

    def cast(self, lm: torch.nn.Module, dtype: torch.dtype) -> torch.nn.Module:
        """``lm`` in ``dtype``: the kept copy with ``lm``'s current values
        copied into it, or a new copy when ``lm``'s tensors changed in name,
        shape, dtype or device (quantized, say)."""
        source = lm.state_dict()
        structure = tuple((name, tuple(t.shape), t.dtype, t.device)
                          for name, t in source.items())
        if self._cast is not None and self._cast[:3] == (id(lm), dtype, structure):
            target = self._cast[3].state_dict()
            for name, t in source.items():
                target[name].copy_(t)
            return self._cast[3]
        self._cast = None   # the old copy goes before the new one is made
        self._cast = (id(lm), dtype, structure, copy.deepcopy(lm).to(dtype))
        return self._cast[3]
