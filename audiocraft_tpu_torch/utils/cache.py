"""Embedding and batch caches on disk (counterpart of
``audiocraft_tpu/utils/cache.py``; the reference's ``utils/cache.py``).

* :class:`EmbeddingCache` (reference :39-158): each file's whole embedding
  saved as ``<sha1 of the path>.npy``, loaded back in a thread pool into
  memory, and the part a batch needs extracted per item.
* :class:`CachedBatchWriter` / :class:`CachedBatchLoader` (reference
  :161-324): precomputed batches on disk, one zip of ``<i>.npy`` members a
  batch, ``<epoch>/<index>.<process>.zip``; each process writes and reads
  its own shard.

The files are the JAX package's byte for byte (``np.save`` into the same
names), so a cache that one package writes, the other reads.  Embeddings
that a compute function returns as tensors are saved from the host.
"""

from __future__ import annotations

import io
import logging
import typing as tp
import zipfile
from concurrent.futures import Future, ThreadPoolExecutor
from hashlib import sha1
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger(__name__)


def _to_numpy(x: tp.Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def get_full_embed(full_embed: np.ndarray, x: tp.Any, idx: int) -> np.ndarray:
    return full_embed


class EmbeddingCache:
    """``compute_embed_fn(path, x, idx)`` gives a file's whole embedding;
    ``extract_embed_fn(full_embed, x, idx)`` the part item ``idx`` of the
    batch ``x`` uses (default: all of it)."""

    def __init__(self, cache_path: tp.Union[str, Path],
                 compute_embed_fn: tp.Callable[[Path, tp.Any, int], tp.Any],
                 extract_embed_fn: tp.Optional[
                     tp.Callable[[np.ndarray, tp.Any, int], np.ndarray]] = None):
        self.cache_path = Path(cache_path)
        self._compute_embed_fn = compute_embed_fn
        self._extract_embed_fn = extract_embed_fn or get_full_embed
        self.cache_path.mkdir(exist_ok=True, parents=True)
        self.pool = ThreadPoolExecutor(8)
        self._current_batch_cache: dict = {}
        self._memory_cache: dict = {}

    def _get_cache_path(self, path: tp.Union[Path, str]) -> Path:
        sig = sha1(str(path).encode()).hexdigest()
        return self.cache_path / f"{sig}.npy"

    @staticmethod
    def _load(cache: Path) -> tp.Optional[np.ndarray]:
        try:
            return np.load(cache)
        except (OSError, ValueError) as exc:
            logger.error("Error loading %s: %r", cache, exc)
            return None

    def get_embed_from_cache(self, paths: tp.List[Path], x: tp.Any) -> np.ndarray:
        """The batch's embeddings [B, ...]: from what :meth:`populate_embed_cache`
        loaded, else computed now and saved."""
        embeds = []
        for idx, path in enumerate(paths):
            cache = self._get_cache_path(path)
            if cache in self._current_batch_cache:
                embed = self._current_batch_cache[cache]
            else:
                full_embed = _to_numpy(self._compute_embed_fn(path, x, idx))
                tmp = cache.with_suffix('.tmp.npy')
                try:
                    np.save(tmp, full_embed)
                    tmp.rename(cache)
                except OSError as exc:
                    logger.error('Error saving embed %s: %r', cache, exc)
                embed = self._extract_embed_fn(full_embed, x, idx)
            embeds.append(embed)
        return np.stack(embeds, axis=0)

    def populate_embed_cache(self, paths: tp.List[Path], x: tp.Any) -> None:
        """Load the batch's cached embeddings (in the pool, or from memory)."""
        self._current_batch_cache.clear()
        futures: tp.List[tp.Optional[Future]] = []
        for path in paths:
            if path is None:
                raise ValueError("Path is required for computation from cache")
            cache = self._get_cache_path(path)
            if cache in self._memory_cache or not cache.exists():
                futures.append(None)
            else:
                futures.append(self.pool.submit(EmbeddingCache._load, cache))
        for idx, (path, future) in enumerate(zip(paths, futures)):
            cache = self._get_cache_path(path)
            if future is None:
                full_embed = self._memory_cache.get(cache)
            else:
                full_embed = future.result()
                if full_embed is not None:
                    self._memory_cache[cache] = full_embed
            if full_embed is not None:
                self._current_batch_cache[cache] = self._extract_embed_fn(full_embed, x, idx)


class CachedBatchWriter:
    """Write each update's batch to one zip per (epoch, update) per process."""

    def __init__(self, cache_folder: tp.Union[str, Path], process_index: int = 0):
        self.cache_folder = Path(cache_folder)
        self.process_index = process_index
        self._current_epoch: tp.Optional[int] = None
        self._current_index = 0

    def start_epoch(self, epoch: int) -> None:
        self._current_epoch = epoch
        self._current_index = 0

    def _zip_path(self, epoch: int, index: int) -> Path:
        return self.cache_folder / f"{epoch:05d}" / f"{index:06d}.{self.process_index}.zip"

    def save(self, *content) -> None:
        """Save one batch: each argument (an array or tensor) as ``<i>.npy``."""
        if self._current_epoch is None:
            raise RuntimeError("call start_epoch first")
        zip_path = self._zip_path(self._current_epoch, self._current_index)
        zip_path.parent.mkdir(exist_ok=True, parents=True)
        tmp = zip_path.with_suffix('.tmp')
        with zipfile.ZipFile(tmp, 'w') as zf:
            for i, item in enumerate(content):
                buf = io.BytesIO()
                np.save(buf, _to_numpy(item))
                zf.writestr(f"{i}.npy", buf.getvalue())
        tmp.rename(zip_path)
        self._current_index += 1


class CachedBatchLoader:
    """Iterate the batches :class:`CachedBatchWriter` wrote for this
    process's shard, two reads ahead in a thread pool (reference
    cache.py:297-324)."""

    def __init__(self, cache_folder: tp.Union[str, Path], batch_size: int,
                 process_index: int = 0, num_workers: int = 4):
        self.cache_folder = Path(cache_folder)
        self.batch_size = batch_size
        self.process_index = process_index
        self.pool = ThreadPoolExecutor(num_workers)
        self._current_epoch: tp.Optional[int] = None

    def __len__(self) -> int:
        return len(list(self._epoch_folder().glob(f"*.{self.process_index}.zip")))

    def _epoch_folder(self) -> Path:
        if self._current_epoch is None:
            raise RuntimeError("call start_epoch first")
        return self.cache_folder / f"{self._current_epoch:05d}"

    def start_epoch(self, epoch: int) -> None:
        self._current_epoch = epoch

    @staticmethod
    def _read_zip(path: Path) -> tp.List[np.ndarray]:
        out = []
        with zipfile.ZipFile(path, 'r') as zf:
            for name in sorted(zf.namelist()):
                with zf.open(name) as f:
                    out.append(np.load(io.BytesIO(f.read())))
        return out

    def __iter__(self) -> tp.Iterator[tp.List[np.ndarray]]:
        paths = sorted(self._epoch_folder().glob(f"*.{self.process_index}.zip"))
        futures = [self.pool.submit(self._read_zip, p) for p in paths[:2]]
        for i in range(len(paths)):
            result = futures[i].result()
            if i + 2 < len(paths):
                futures.append(self.pool.submit(self._read_zip, paths[i + 2]))
            yield result
