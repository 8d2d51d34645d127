"""Codebook interleaving patterns: delay, parallel, unrolled, coarse-first
and MusicLM (counterpart of ``audiocraft_tpu/patterns/pattern.py``, which
imports JAX, so the port keeps its own copy).

A pattern is, for each sequence step, the list of (timestep, codebook)
coordinates emitted at that step; step 0 is empty so that generation can
start from a special token.  ``build_pattern_sequence`` maps codes
``[B, K, T] -> [B, K, S]`` and ``revert_pattern_sequence`` inverts it.  The
index and mask arrays are host numpy, cached per (T, flags); each build or
revert is one gather on the tensor's device.
"""

from __future__ import annotations

import dataclasses
import typing as tp
from abc import ABC, abstractmethod
from collections import namedtuple
from functools import lru_cache

import numpy as np
import torch

LayoutCoord = namedtuple("LayoutCoord", ["t", "q"])
PatternLayout = tp.List[tp.List[LayoutCoord]]


def _gather(x: torch.Tensor, indexes: np.ndarray, special: tp.Union[int, float]) -> torch.Tensor:
    """x [..., K, N] -> [..., K, M]: x flattened over (K, N) with ``special``
    appended as the last slot, taken at ``indexes`` [K, M]."""
    lead, (K, N) = x.shape[:-2], x.shape[-2:]
    flat = torch.cat([x.reshape(*lead, K * N), x.new_full((*lead, 1), special)], dim=-1)
    idx = torch.as_tensor(indexes.reshape(-1), device=x.device)
    return flat.index_select(-1, idx).reshape(*lead, *indexes.shape)


@dataclasses.dataclass
class Pattern:
    layout: PatternLayout
    timesteps: int
    n_q: int

    def __post_init__(self):
        if not self.layout:
            raise ValueError("a pattern needs at least one step")
        self._validate_layout()
        self._sequence_indexes = lru_cache(100)(self._sequence_indexes_impl)
        self._revert_indexes = lru_cache(100)(self._revert_indexes_impl)

    def _validate_layout(self):
        """No two coordinates of one codebook in a step; each codebook's
        timesteps never decrease along the sequence."""
        q_timesteps = {q: 0 for q in range(self.n_q)}
        for s, seq_coords in enumerate(self.layout):
            qs = set()
            for coord in seq_coords:
                qs.add(coord.q)
                if coord.t < q_timesteps[coord.q]:
                    raise ValueError(f"past timesteps found for codebook {coord.q} at step {s}")
                q_timesteps[coord.q] = coord.t
            if len(qs) != len(seq_coords):
                raise ValueError(f"multiple entries for one codebook at step {s}")

    @property
    def num_sequence_steps(self) -> int:
        return len(self.layout) - 1

    @property
    def max_delay(self) -> int:
        max_t = 0
        for seq_coords in self.layout[1:]:
            for coord in seq_coords:
                max_t = max(max_t, coord.t + 1)
        return max_t - self.timesteps

    @property
    def valid_layout(self) -> PatternLayout:
        return self.layout[:len(self.layout) - self.max_delay]

    def starts_with_special_token(self) -> bool:
        return self.layout[0] == []

    def get_sequence_coords_with_timestep(self, t: int, q: tp.Optional[int] = None):
        if t > self.timesteps:
            raise ValueError(f"timestep {t} is past the pattern's {self.timesteps}")
        return [(s, code) for s, seq_codes in enumerate(self.layout) for code in seq_codes
                if code.t == t and (q is None or code.q == q)]

    def get_steps_with_timestep(self, t: int, q: tp.Optional[int] = None) -> tp.List[int]:
        return [step for step, _ in self.get_sequence_coords_with_timestep(t, q)]

    def get_first_step_with_timesteps(self, t: int,
                                      q: tp.Optional[int] = None) -> tp.Optional[int]:
        steps = self.get_steps_with_timestep(t, q)
        return steps[0] if steps else None

    def _sequence_indexes_impl(self, timesteps: int, keep_only_valid_steps: bool
                               ) -> tp.Tuple[np.ndarray, np.ndarray]:
        """[K, S] indexes into the flattened [K * T + 1] codes (the last slot
        is the special token) and the mask of real codes."""
        if timesteps > self.timesteps:
            raise ValueError(f"{timesteps} timesteps exceed the pattern's {self.timesteps}")
        ref_layout = self.valid_layout if keep_only_valid_steps else self.layout
        indexes = np.full((self.n_q, len(ref_layout)), self.n_q * timesteps, dtype=np.int64)
        mask = np.zeros((self.n_q, len(ref_layout)), dtype=bool)
        for s, seq_coords in enumerate(ref_layout):
            for coord in seq_coords:
                if coord.t < timesteps:
                    indexes[coord.q, s] = coord.t + coord.q * timesteps
                    mask[coord.q, s] = True
        return indexes, mask

    def _revert_indexes_impl(self, sequence_steps: int, keep_only_valid_steps: bool,
                             is_model_output: bool) -> tp.Tuple[np.ndarray, np.ndarray]:
        """[K, T] indexes into the flattened [K * S + 1] sequence."""
        ref_layout = self.valid_layout if keep_only_valid_steps else self.layout
        if sequence_steps > len(ref_layout):
            raise ValueError(f"sequence to revert is longer than the defined pattern: "
                             f"{sequence_steps} > {len(ref_layout)}")
        if is_model_output and self.starts_with_special_token():
            ref_layout = ref_layout[1:]
        indexes = np.full((self.n_q, self.timesteps), self.n_q * sequence_steps, dtype=np.int64)
        mask = np.zeros((self.n_q, self.timesteps), dtype=bool)
        for s, seq_codes in enumerate(ref_layout[:sequence_steps]):
            for code in seq_codes:
                if code.t < self.timesteps:
                    indexes[code.q, code.t] = s + code.q * sequence_steps
                    mask[code.q, code.t] = True
        return indexes, mask

    def _check_codebooks(self, k: int) -> None:
        if k != self.n_q:
            raise ValueError(f"{k} codebooks given to a pattern of {self.n_q}")

    def build_pattern_sequence(self, z: torch.Tensor, special_token: int,
                               keep_only_valid_steps: bool = False):
        """z [B, K, T] -> (values [B, K, S], indexes [K, S], mask [K, S])."""
        self._check_codebooks(z.shape[1])
        indexes, mask = self._sequence_indexes(z.shape[2], keep_only_valid_steps)
        return _gather(z, indexes, special_token), indexes, mask

    def revert_pattern_sequence(self, s: torch.Tensor, special_token: int,
                                keep_only_valid_steps: bool = False):
        """s [B, K, S] -> (values [B, K, T], indexes [K, T], mask [K, T])."""
        self._check_codebooks(s.shape[1])
        indexes, mask = self._revert_indexes(s.shape[2], keep_only_valid_steps, False)
        return _gather(s, indexes, special_token), indexes, mask

    def revert_pattern_logits(self, logits: torch.Tensor, special_token: float,
                              keep_only_valid_steps: bool = False):
        """logits [B, card, K, S] -> [B, card, K, T]; the model's output is
        shifted by the initial special token, so its first step is dropped."""
        self._check_codebooks(logits.shape[2])
        indexes, mask = self._revert_indexes(logits.shape[3], keep_only_valid_steps, True)
        return _gather(logits, indexes, special_token), indexes, mask


class CodebooksPatternProvider(ABC):

    def __init__(self, n_q: int):
        if n_q <= 0:
            raise ValueError(f"n_q must be positive, not {n_q}")
        self.n_q = n_q
        self.get_pattern = lru_cache(100)(self.get_pattern)  # type: ignore

    @abstractmethod
    def get_pattern(self, timesteps: int) -> Pattern:
        ...


class DelayedPatternProvider(CodebooksPatternProvider):
    """The MusicGen default: codebook q delayed by ``delays[q]`` steps."""

    def __init__(self, n_q: int, delays: tp.Optional[tp.List[int]] = None,
                 flatten_first: int = 0, empty_initial: int = 0):
        super().__init__(n_q)
        self.delays = list(range(n_q)) if delays is None else delays
        self.flatten_first = flatten_first
        self.empty_initial = empty_initial
        if len(self.delays) != n_q or sorted(self.delays) != self.delays:
            raise ValueError(f"delays must be {n_q} non-decreasing steps, not {self.delays}")

    def get_pattern(self, timesteps: int) -> Pattern:
        """Step s carries, for every codebook q, the frame ``s - delays[q]``
        once that frame exists, after an optional flattened warm-up of
        ``flatten_first`` frames."""
        first = self.flatten_first
        steps: PatternLayout = []
        if self.empty_initial >= 0:
            steps.extend([] for _ in range(1 + self.empty_initial))
        steps.extend([LayoutCoord(t, q)] for t in range(min(timesteps, first))
                     for q in range(self.n_q))
        steps.extend([LayoutCoord(t - d, q) for q, d in enumerate(self.delays) if t - d >= first]
                     for t in range(first, timesteps + max(self.delays)))
        return Pattern(steps, n_q=self.n_q, timesteps=timesteps)


class ParallelPatternProvider(DelayedPatternProvider):

    def __init__(self, n_q: int, empty_initial: int = 0):
        super().__init__(n_q, [0] * n_q, empty_initial=empty_initial)


class UnrolledPatternProvider(CodebooksPatternProvider):
    """Codebooks flattened into inner steps, with per-group delays."""

    FlattenedCodebook = namedtuple("FlattenedCodebook", ["codebooks", "delay"])

    def __init__(self, n_q: int, flattening: tp.Optional[tp.List[int]] = None,
                 delays: tp.Optional[tp.List[int]] = None):
        super().__init__(n_q)
        flattening = list(range(n_q)) if flattening is None else flattening
        delays = [0] * n_q if delays is None else delays
        if len(flattening) != n_q or sorted(flattening) != flattening:
            raise ValueError(f"flattening must be {n_q} non-decreasing steps, not {flattening}")
        if len(delays) != n_q or sorted(delays) != delays:
            raise ValueError(f"delays must be {n_q} non-decreasing steps, not {delays}")
        self._flattened_codebooks: tp.Dict[int, UnrolledPatternProvider.FlattenedCodebook] = {}
        for q, (inner_step, delay) in enumerate(zip(flattening, delays)):
            group = self._flattened_codebooks.get(inner_step)
            if group is None:
                self._flattened_codebooks[inner_step] = self.FlattenedCodebook([q], delay)
            elif group.delay != delay:
                raise ValueError("codebooks flattened to one position must share a delay")
            else:
                group.codebooks.append(q)
        self.max_delay = max(delays)

    @property
    def _num_inner_steps(self) -> int:
        return max(self._flattened_codebooks.keys()) + 1

    def get_pattern(self, timesteps: int) -> Pattern:
        """Frame t expands into one slot per inner step; a slot is emitted
        ``delay`` frames after its frame, and slots are ordered by (emission
        time, contents)."""
        horizon = timesteps + self.max_delay
        slots: tp.List[tp.Tuple[int, list]] = [(-1, [])]
        for t in range(horizon):
            for k in range(self._num_inner_steps):
                group = self._flattened_codebooks.get(k)
                if group is None:
                    slots.append((t, []))
                elif t + group.delay < horizon:
                    slots.append((t + group.delay, [LayoutCoord(t, q) for q in group.codebooks]))
        return Pattern([coords for _, coords in sorted(slots)], n_q=self.n_q, timesteps=timesteps)


class CoarseFirstPattern(CodebooksPatternProvider):
    """All of codebook 0 first, then the rest with optional delays."""

    def __init__(self, n_q: int, delays: tp.Optional[tp.List[int]] = None):
        super().__init__(n_q)
        self.delays = [0] * (n_q - 1) if delays is None else delays
        if len(self.delays) != n_q - 1 or sorted(self.delays) != self.delays:
            raise ValueError(f"delays must be {n_q - 1} non-decreasing steps, not {self.delays}")

    def get_pattern(self, timesteps: int) -> Pattern:
        steps: PatternLayout = [[]]
        steps.extend([LayoutCoord(t, 0)] for t in range(timesteps))
        steps.extend([LayoutCoord(t - d, q + 1) for q, d in enumerate(self.delays) if t - d >= 0]
                     for t in range(timesteps + max(self.delays)))
        return Pattern(steps, n_q=self.n_q, timesteps=timesteps)


class MusicLMPattern(CodebooksPatternProvider):
    """Groups of ``group_by`` codebooks, each group fully flattened in turn."""

    def __init__(self, n_q: int, group_by: int = 2):
        super().__init__(n_q)
        self.group_by = group_by

    def get_pattern(self, timesteps: int) -> Pattern:
        steps: PatternLayout = [[]]
        steps.extend([LayoutCoord(t, q)]
                     for g0 in range(0, self.n_q, self.group_by)
                     for t in range(timesteps)
                     for q in range(g0, g0 + self.group_by))
        return Pattern(steps, n_q=self.n_q, timesteps=timesteps)


_PROVIDERS = {
    'parallel': ParallelPatternProvider,
    'delay': DelayedPatternProvider,
    'unroll': UnrolledPatternProvider,
    'coarse_first': CoarseFirstPattern,
    'musiclm': MusicLMPattern,
}


def get_pattern_provider(name: str, n_q: int, **kwargs) -> CodebooksPatternProvider:
    return _PROVIDERS[name](n_q, **kwargs)
