"""Audio dataset: manifests, weighted segment sampling, collation, per-rank
shards (counterpart of ``audiocraft_tpu/data/audio_dataset.py``; the
reference's ``data/audio_dataset.py``).

* :class:`AudioMeta` / :class:`SegmentInfo` and jsonl(.gz) manifests
  (reference :61-241), which either package reads from the other.
* :func:`find_audio_files`: a threaded scan of a directory tree (:145-201).
* :class:`AudioDataset`: files sampled by weight and duration (:356-369)
  from a numpy ``RandomState`` seeded by the index and the epoch
  (:422-432), so that an index at an epoch gives the JAX package's file,
  seek time and samples; the file-permutation mode (:371-394); read retries
  (:434-454); padding and segment info; the duration filters (:502-521).
  Items and batches are numpy arrays on the host; the caller moves a batch
  to its device.  Resampling and channel conversion run through
  ``io/audio_utils.convert_audio`` on the CPU.
* :func:`collate` pads a batch to its longest item (:462-500).

Data parallelism: :meth:`AudioDataset.shard_indices` gives each rank a
contiguous stripe of every global batch, and :meth:`AudioDataset.iter_batches`
takes the rank and the count from ``torch.distributed`` when a process
group exists (the JAX package's ``jax.process_index()``).
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import logging
import random
import typing as tp
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..io.audio_utils import convert_audio
from ..io.wav import audio_info, audio_read
from .zip import PathInZip

logger = logging.getLogger(__name__)

DEFAULT_EXTS = ['.wav', '.mp3', '.flac', '.ogg', '.m4a']


@dataclasses.dataclass(order=True)
class AudioMeta:
    path: str
    duration: float
    sample_rate: int
    amplitude: tp.Optional[float] = None
    weight: tp.Optional[float] = None
    info_path: tp.Optional[PathInZip] = None

    @classmethod
    def from_dict(cls, d: dict) -> "AudioMeta":
        kw = {f.name: d[f.name] for f in dataclasses.fields(cls) if f.name in d}
        if kw.get('info_path') is not None:
            kw['info_path'] = PathInZip(kw['info_path'])
        return cls(**kw)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if d['info_path'] is not None:
            d['info_path'] = str(self.info_path)
        return d


@dataclasses.dataclass(order=True)
class SegmentInfo:
    meta: AudioMeta
    seek_time: float
    n_frames: int       # frames without padding
    total_frames: int   # frames with padding
    sample_rate: int
    channels: int

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d['meta'] = self.meta.to_dict()
        return d


def _get_audio_meta(file_path: str, minimal: bool = True) -> AudioMeta:
    sr, duration, _channels = audio_info(file_path)
    amplitude = None
    if not minimal:
        wav, _ = audio_read(file_path)
        amplitude = float(np.abs(wav).max())
    return AudioMeta(file_path, duration, sr, amplitude)


def find_audio_files(path: tp.Union[Path, str], exts: tp.Sequence[str] = tuple(DEFAULT_EXTS),
                     resolve: bool = True, minimal: bool = True, progress: bool = False,
                     workers: int = 0) -> tp.List[AudioMeta]:
    """The audio files under ``path`` (by suffix, sorted), as AudioMeta;
    unreadable files are logged and left out (reference :145-201)."""
    audio_files = [p for p in sorted(Path(path).rglob('*'))
                   if p.suffix.lower() in exts and p.is_file()]
    if resolve:
        audio_files = [p.resolve() for p in audio_files]

    def load(p):
        try:
            return _get_audio_meta(str(p), minimal)
        except Exception as exc:   # an unreadable file is left out, not fatal
            logger.warning("Error reading %s: %r", p, exc)
            return None

    if workers:
        with ThreadPoolExecutor(workers) as pool:
            metas = list(pool.map(load, audio_files))
    else:
        metas = [load(p) for p in audio_files]
    return [m for m in metas if m is not None]


def save_audio_meta(path: tp.Union[str, Path], meta: tp.List[AudioMeta]) -> None:
    path = Path(path)
    open_fn = gzip.open if path.suffix == '.gz' else open
    with open_fn(path, 'wt') as fp:  # type: ignore
        for m in meta:
            fp.write(json.dumps(m.to_dict()) + '\n')


def load_audio_meta(path: tp.Union[str, Path], fast: bool = True) -> tp.List[AudioMeta]:
    path = Path(path)
    open_fn = gzip.open if path.suffix == '.gz' else open
    with open_fn(path, 'rt') as fp:  # type: ignore
        return [AudioMeta.from_dict(json.loads(line)) for line in fp if line.strip()]


def collate(wavs: tp.List[np.ndarray], dim: int = 0) -> tp.Tuple[np.ndarray, np.ndarray]:
    """Pad-stack [C, T] arrays -> ([B, C, Tmax], lengths [B])."""
    lengths = np.asarray([w.shape[-1] for w in wavs])
    tmax = int(lengths.max())
    out = np.zeros((len(wavs), *wavs[0].shape[:-1], tmax), wavs[0].dtype)
    for i, w in enumerate(wavs):
        out[i, ..., :w.shape[-1]] = w
    return out, lengths


def _convert(wav: np.ndarray, from_rate: int, to_rate: int, channels: int) -> np.ndarray:
    """``convert_audio`` on the CPU, back to a numpy array of its own."""
    out = convert_audio(torch.from_numpy(np.ascontiguousarray(wav)), from_rate, to_rate, channels)
    return np.ascontiguousarray(out.numpy())


def _dist_shard() -> tp.Tuple[int, int]:
    """(rank, world size) of the default ``torch.distributed`` group, or
    (0, 1) without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class AudioDataset:
    """Segments of ``segment_duration`` s (or whole files when None) at
    ``sample_rate`` with ``channels``; see the module note."""

    def __init__(self, meta: tp.List[AudioMeta],
                 segment_duration: tp.Optional[float] = None,
                 shuffle: bool = True,
                 num_samples: int = 10_000,
                 sample_rate: int = 48_000,
                 channels: int = 2,
                 pad: bool = True,
                 sample_on_duration: bool = True,
                 sample_on_weight: bool = True,
                 min_segment_ratio: float = 0.5,
                 max_read_retry: int = 10,
                 return_info: bool = False,
                 min_audio_duration: tp.Optional[float] = None,
                 max_audio_duration: tp.Optional[float] = None,
                 shuffle_seed: int = 0,
                 load_wav: bool = True,
                 permutation_on_files: bool = False):
        if not meta:
            raise ValueError("No audio meta provided to AudioDataset.")
        if segment_duration is not None and segment_duration <= 0:
            raise ValueError(f"segment_duration {segment_duration} must be positive")
        if segment_duration is not None and min_segment_ratio < 0:
            raise ValueError(f"min_segment_ratio {min_segment_ratio} must be >= 0")
        if (min_audio_duration is not None and max_audio_duration is not None
                and min_audio_duration > max_audio_duration):
            raise ValueError("min_audio_duration is above max_audio_duration")
        self.segment_duration = segment_duration
        self.min_segment_ratio = min_segment_ratio
        self.min_audio_duration = min_audio_duration
        self.max_audio_duration = max_audio_duration
        self.meta = self._filter_duration(meta)
        if not self.meta:
            raise ValueError("the duration filters left no file")
        self.total_duration = sum(d.duration for d in self.meta)

        if segment_duration is None:
            num_samples = len(self.meta)
        self.num_samples = num_samples
        self.shuffle = shuffle
        self.sample_rate = sample_rate
        self.channels = channels
        self.pad = pad
        self.sample_on_weight = sample_on_weight
        self.sample_on_duration = sample_on_duration
        self.sampling_probabilities = self._get_sampling_probabilities()
        self.max_read_retry = max_read_retry
        self.return_info = return_info
        self.shuffle_seed = shuffle_seed
        self.current_epoch: tp.Optional[int] = None
        self.load_wav = load_wav
        if not load_wav and segment_duration is None:
            raise ValueError("load_wav=False needs a segment_duration")
        self.permutation_on_files = permutation_on_files
        if permutation_on_files and (sample_on_duration or sample_on_weight or not shuffle):
            raise ValueError("permutation_on_files needs shuffle and neither "
                             "sample_on_duration nor sample_on_weight")

    # ------------------------------------------------------------- sampling
    def start_epoch(self, epoch: int) -> None:
        self.current_epoch = epoch

    def __len__(self) -> int:
        return self.num_samples

    def _filter_duration(self, meta: tp.List[AudioMeta]) -> tp.List[AudioMeta]:
        orig_len = len(meta)
        if self.min_audio_duration is not None:
            meta = [m for m in meta if m.duration >= self.min_audio_duration]
        if self.max_audio_duration is not None:
            meta = [m for m in meta if m.duration <= self.max_audio_duration]
        removed = 100 * (1 - float(len(meta)) / max(orig_len, 1))
        if removed:
            logger.debug("Removed %.2f percent of the data because it was too short or too "
                         "long.", removed)
        return meta

    def _get_sampling_probabilities(self, normalized: bool = True) -> np.ndarray:
        scores = []
        for m in self.meta:
            score = 1.0
            if self.sample_on_weight and m.weight is not None:
                score *= m.weight
            if self.sample_on_duration:
                score *= m.duration
            scores.append(score)
        probs = np.asarray(scores, np.float64)
        if normalized:
            probs = probs / probs.sum()
        return probs

    def _file_permutation(self, permutation_index: int) -> np.ndarray:
        rng = np.random.RandomState(self.shuffle_seed + permutation_index)
        return rng.permutation(len(self.meta))

    def sample_file(self, index: int, rng: np.random.RandomState) -> AudioMeta:
        if self.permutation_on_files:
            if self.current_epoch is None:
                raise RuntimeError("permutation_on_files needs start_epoch first")
            total_index = self.current_epoch * len(self) + index
            permutation = self._file_permutation(total_index // len(self.meta))
            return self.meta[permutation[total_index % len(self.meta)]]
        if not self.sample_on_weight and not self.sample_on_duration:
            file_index = int(rng.randint(len(self.meta)))
        else:
            file_index = int(rng.choice(len(self.meta), p=self.sampling_probabilities))
        return self.meta[file_index]

    # -------------------------------------------------------------- loading
    def _audio_read(self, path: str, seek_time: float = 0, duration: float = -1):
        if self.load_wav:
            return audio_read(path, seek_time, duration, pad=False)
        n_frames = int(self.sample_rate * self.segment_duration)
        return np.zeros((self.channels, n_frames), np.float32), self.sample_rate

    def __getitem__(self, index: int):
        if self.segment_duration is None:
            file_meta = self.meta[index]
            out, sr = audio_read(file_meta.path)
            out = _convert(out, sr, self.sample_rate, self.channels)
            n_frames = out.shape[-1]
            segment_info = SegmentInfo(file_meta, 0.0, n_frames, n_frames, self.sample_rate,
                                       out.shape[0])
        else:
            if self.shuffle:
                if self.current_epoch is None:
                    seed = index + self.num_samples * random.randint(0, 2 ** 24)
                else:
                    seed = index + self.num_samples * (self.current_epoch + self.shuffle_seed)
            else:
                seed = index
            rng = np.random.RandomState(seed & 0x7fffffff)

            for retry in range(self.max_read_retry):
                file_meta = self.sample_file(index, rng)
                max_seek = max(0, file_meta.duration
                               - self.segment_duration * self.min_segment_ratio)
                seek_time = rng.rand() * max_seek
                try:
                    out, sr = self._audio_read(file_meta.path, seek_time, self.segment_duration)
                    out = _convert(out, sr, self.sample_rate, self.channels)
                    n_frames = out.shape[-1]
                    target_frames = int(self.segment_duration * self.sample_rate)
                    if self.pad:
                        out = np.pad(out, ((0, 0), (0, target_frames - n_frames)))
                    segment_info = SegmentInfo(file_meta, seek_time, n_frames, target_frames,
                                               self.sample_rate, out.shape[0])
                except Exception as exc:   # retried on another draw, raised at the last
                    logger.warning("Error opening file %s: %r", file_meta.path, exc)
                    if retry == self.max_read_retry - 1:
                        raise
                else:
                    break

        if self.return_info:
            return out, segment_info
        return out

    def collater(self, samples: tp.List):
        """A batch [B, C, T] of items (and their SegmentInfos with
        ``return_info``), whole files padded to the longest (reference
        :462-500)."""
        if self.segment_duration is None and len(samples) > 1 and not self.pad:
            raise ValueError("must allow padding when batching full-length audio")
        if self.return_info:
            wavs = [s[0] for s in samples]
            infos = [s[1] for s in samples]
            if self.segment_duration is None and len(samples) > 1:
                out, lengths = collate(wavs)
                for i, info in enumerate(infos):
                    info.total_frames = out.shape[-1]
                    info.n_frames = int(lengths[i])
                return out, infos
            return np.stack(wavs), infos
        wavs = list(samples)
        if self.segment_duration is None and len(samples) > 1:
            return collate(wavs)[0]
        return np.stack(wavs)

    # ------------------------------------------------------- data parallel
    def shard_indices(self, batch_size: int, process_index: int,
                      process_count: int) -> tp.Iterator[tp.List[int]]:
        """Rank ``process_index``'s contiguous stripe of every whole global
        batch of ``batch_size`` indices."""
        if batch_size % process_count:
            raise ValueError(f"batch {batch_size} does not divide over {process_count} ranks")
        local = batch_size // process_count
        for start in range(0, self.num_samples, batch_size):
            base = start + process_index * local
            if base + local <= self.num_samples:
                yield list(range(base, base + local))

    def iter_batches(self, batch_size: int, process_index: tp.Optional[int] = None,
                     process_count: tp.Optional[int] = None, epoch: tp.Optional[int] = None):
        """This rank's part of each global batch, collated; the rank and the
        count default to the ``torch.distributed`` group's, else (0, 1)."""
        if process_index is None or process_count is None:
            process_index, process_count = _dist_shard()
        if epoch is not None:
            self.start_epoch(epoch)
        for idx in self.shard_indices(batch_size, process_index, process_count):
            yield self.collater([self[i] for i in idx])

    @classmethod
    def from_meta(cls, root: tp.Union[str, Path], **kwargs) -> "AudioDataset":
        """From a manifest file, or a directory holding ``data.jsonl[.gz]``
        (reference :523-544)."""
        root = Path(root)
        if root.is_dir():
            if (root / 'data.jsonl').exists():
                root = root / 'data.jsonl'
            elif (root / 'data.jsonl.gz').exists():
                root = root / 'data.jsonl.gz'
            else:
                raise ValueError(f"Don't know where to read metadata from {root}")
        return cls(load_audio_meta(root), **kwargs)

    @classmethod
    def from_path(cls, root: tp.Union[str, Path], minimal_meta: bool = True,
                  exts: tp.Sequence[str] = tuple(DEFAULT_EXTS), **kwargs) -> "AudioDataset":
        """From a manifest file, or the audio files under a directory."""
        root = Path(root)
        if root.is_file():
            meta = load_audio_meta(root)
        else:
            meta = find_audio_files(root, exts, minimal=minimal_meta, resolve=True)
        return cls(meta, **kwargs)
