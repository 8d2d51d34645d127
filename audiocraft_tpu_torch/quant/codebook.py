"""Euclidean codebook: the nearest-code search, the lookup and the EMA
training (counterpart of ``audiocraft_tpu/quant/codebook.py``).

Distances keep the reference expression ``-(|x|^2 - 2 x.E^T + |E|^2)`` in
fp32, and the argmax takes the first index on ties, as ``torch.argmax`` and
``jnp.argmax`` both do.

A codebook's state is four buffers under the reference names (``embed``,
``cluster_size``, ``embed_avg``, ``inited``).  With ``kmeans_init`` (the
default, as in the JAX package) a fresh codebook is zeros with ``inited`` 0,
and the first training batch runs k-means on it; without, it starts from
the uniform init with ``inited`` 1.  The training functions are pure
(:class:`CodebookState` in, :class:`CodebookState` out):
:func:`kmeans` and :func:`ema_update` (with dead-code expiry
``'reference'``, ``'effective'`` or ``'none'``, as the JAX package defines
them); :meth:`EuclideanCodebook.state` and
:meth:`EuclideanCodebook.load_state_` move a state out of and into the
buffers.

Every random draw is apart from the arithmetic: :func:`draw_sample_indices`
draws row indices from a ``torch.Generator`` (on the host), and
:func:`sample_vectors`, :func:`kmeans` and :func:`ema_update` take the
indices.  The JAX package draws with
``jax.random.permutation`` / ``randint``, which no generator reproduces;
tests pass JAX's drawn indices into this arithmetic.

Under data parallelism (``group``, ``dist/mesh.py``) the one-hot counts and
embed sums are summed over the group before the EMA, and the rows that
k-means clusters and expiry samples are the whole group's, gathered in rank
order: the JAX package computes both over the global batch, and every rank
then holds the same codebook.
"""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn.functional as F

from ..dist.mesh import Group, all_sum, gather_rows
from ..nn.init import uniform

EXPIRY_MODES = ('reference', 'effective', 'none')


def compute_distances(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Negative squared distances: x [N, D], embed [K, D] -> [N, K] fp32."""
    x = x.float()
    embed_t = embed.float().t()
    return -(x.square().sum(1, keepdim=True) - 2 * (x @ embed_t)
             + embed_t.square().sum(0, keepdim=True))


def quantize(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Nearest code per row: x [..., D] -> [...] int32."""
    flat = x.reshape(-1, x.shape[-1])
    idx = compute_distances(flat, embed).argmax(-1).to(torch.int32)
    return idx.reshape(x.shape[:-1])


def dequantize(idx: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    return embed[idx.long()]


class CodebookState(tp.NamedTuple):
    embed: torch.Tensor         # [K, D] codebook vectors
    cluster_size: torch.Tensor  # [K] EMA usage counts
    embed_avg: torch.Tensor     # [K, D] EMA sums
    inited: torch.Tensor        # [1]: 1 once k-means ran (or with the uniform init)


def draw_sample_indices(generator: torch.Generator, n: int, num: int) -> torch.Tensor:
    """The rows :func:`sample_vectors` picks from ``n``: ``num`` without
    replacement when ``n >= num``, else with (reference core_vq.py:41-49),
    as int64 on the CPU."""
    if n >= num:
        return torch.randperm(n, generator=generator)[:num]
    return torch.randint(0, n, (num,), generator=generator)


def sample_vectors(samples: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The rows ``idx`` (from :func:`draw_sample_indices`) of ``samples`` [N, D]."""
    return samples[idx.to(samples.device)]


def _one_hot(idx: torch.Tensor, k: int) -> torch.Tensor:
    return F.one_hot(idx.long(), k).float()


def kmeans(samples: torch.Tensor, num_clusters: int, num_iters: int,
           init_idx: torch.Tensor) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """k-means on ``samples`` [N, D] from the rows ``init_idx``: (means [K, D],
    bins [K], the final assignment's counts).  An empty cluster keeps its
    mean (reference core_vq.py:52-75)."""
    samples = samples.float()
    means = sample_vectors(samples, init_idx)
    for _ in range(num_iters):
        one_hot = _one_hot(compute_distances(samples, means).argmax(-1), num_clusters)
        bins = one_hot.sum(0)
        new_means = one_hot.t() @ samples / torch.where(bins == 0, 1.0, bins)[:, None]
        means = torch.where((bins == 0)[:, None], means, new_means)
    bins = _one_hot(compute_distances(samples, means).argmax(-1), num_clusters).sum(0)
    return means, bins


def kmeans_state(samples: torch.Tensor, num_clusters: int, num_iters: int,
                 init_idx: torch.Tensor) -> CodebookState:
    """The state k-means leaves: its means as ``embed`` and ``embed_avg``,
    its counts as ``cluster_size``, ``inited`` 1."""
    means, bins = kmeans(samples, num_clusters, num_iters, init_idx)
    return CodebookState(means, bins, means, torch.ones(1, device=means.device))


def ema_update(state: CodebookState, x: torch.Tensor, embed_ind: torch.Tensor,
               decay: float, epsilon: float = 1e-5, threshold_ema_dead_code: float = 2.0,
               expiry: str = 'reference', expiry_idx: tp.Optional[torch.Tensor] = None,
               group: Group = None) -> CodebookState:
    """One EMA step from the rows ``x`` [N, D] and their codes (reference
    core_vq.py:195-217), counts and sums summed over ``group``.

    ``expiry`` as in the JAX package: ``'reference'`` replicates the
    reference, whose expiry within a step only replaces ``embed`` rows that
    the normalised copy then overwrites, so it changes nothing and is not
    run; ``'effective'`` replaces the rows of codes whose usage (before this
    step) is under the threshold by the rows ``expiry_idx`` of the group's
    ``x``, after the normalisation, with their EMA statistics reset to the
    replacement; ``'none'`` runs none."""
    if expiry not in EXPIRY_MODES:
        raise ValueError(f"expiry {expiry!r}: one of {EXPIRY_MODES}")
    flat = x.reshape(-1, x.shape[-1]).float()
    k = state.embed.shape[0]
    one_hot = _one_hot(embed_ind.reshape(-1), k)
    counts = all_sum(one_hot.sum(0), group)
    embed_sum = all_sum(one_hot.t() @ flat, group)
    cluster_size = state.cluster_size * decay + counts * (1 - decay)
    embed_avg = state.embed_avg * decay + embed_sum * (1 - decay)
    n = cluster_size.sum()
    smoothed = (cluster_size + epsilon) / (n + k * epsilon) * n
    new = CodebookState(embed_avg / smoothed[:, None], cluster_size, embed_avg, state.inited)
    if expiry == 'effective' and threshold_ema_dead_code > 0:
        if expiry_idx is None:
            raise ValueError("expiry='effective' needs the drawn rows (expiry_idx)")
        expired = state.cluster_size < threshold_ema_dead_code
        replacements = sample_vectors(gather_rows(flat, group), expiry_idx)
        mask = expired[:, None]
        new = CodebookState(
            torch.where(mask, replacements, new.embed),
            torch.where(expired, torch.full_like(cluster_size, threshold_ema_dead_code),
                        new.cluster_size),
            torch.where(mask, replacements * threshold_ema_dead_code, new.embed_avg),
            new.inited)
    return new


class EuclideanCodebook(torch.nn.Module):
    """A codebook's state under the reference buffer names: ``embed`` [K, D],
    ``cluster_size`` [K], ``embed_avg`` [K, D], ``inited`` [1], and its
    training configuration."""

    def __init__(self, dim: int, codebook_size: int,
                 generator: tp.Optional[torch.Generator] = None, kmeans_init: bool = True,
                 kmeans_iters: int = 10, decay: float = 0.8, epsilon: float = 1e-5,
                 threshold_ema_dead_code: float = 2.0):
        super().__init__()
        self.dim, self.codebook_size = dim, codebook_size
        self.kmeans_init, self.kmeans_iters = kmeans_init, kmeans_iters
        self.decay, self.epsilon = decay, epsilon
        self.threshold_ema_dead_code = threshold_ema_dead_code
        if kmeans_init:
            embed, inited = torch.zeros(codebook_size, dim), torch.zeros(1)
        else:
            # kaiming-uniform bound with gain sqrt(2), as the JAX uniform_init
            embed = uniform((codebook_size, dim), math.sqrt(2.0) * math.sqrt(3.0 / dim),
                            generator).data
            inited = torch.ones(1)
        self.register_buffer('embed', embed)
        self.register_buffer('cluster_size', torch.zeros(codebook_size))
        self.register_buffer('embed_avg', embed.clone())
        self.register_buffer('inited', inited)

    def state(self) -> CodebookState:
        return CodebookState(self.embed, self.cluster_size, self.embed_avg, self.inited)

    @torch.no_grad()
    def load_state_(self, state: CodebookState) -> None:
        """Copy ``state`` into the buffers, in place."""
        for buf, value in zip(self.state(), state):
            buf.copy_(value.reshape(buf.shape))

    def ema_update(self, state: CodebookState, x: torch.Tensor, embed_ind: torch.Tensor,
                   expiry: str = 'reference', expiry_idx: tp.Optional[torch.Tensor] = None,
                   group: Group = None) -> CodebookState:
        """:func:`ema_update` with this codebook's configuration."""
        return ema_update(state, x, embed_ind, self.decay, self.epsilon,
                          self.threshold_ema_dead_code, expiry, expiry_idx, group)

    def maybe_kmeans_init(self, state: CodebookState, x: torch.Tensor,
                          init_idx: tp.Optional[torch.Tensor], inited: bool,
                          group: Group = None) -> CodebookState:
        """k-means on the group's rows ``x`` when ``inited`` is False (the
        host's reading of ``state.inited``), else ``state``."""
        if inited:
            return state
        if init_idx is None:
            raise ValueError("k-means needs the drawn rows (init_idx)")
        rows = gather_rows(x.reshape(-1, x.shape[-1]).float(), group)
        return kmeans_state(rows, self.codebook_size, self.kmeans_iters, init_idx)
