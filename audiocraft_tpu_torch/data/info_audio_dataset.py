"""An audio dataset whose items carry their metadata (counterpart of
``audiocraft_tpu/data/info_audio_dataset.py``; the reference's
``data/info_audio_dataset.py``): with ``return_info`` each item is (wav,
:class:`SegmentInfoWithAttributes`), whose info converts to
``ConditioningAttributes`` for the conditioning stack, and every manifest
path is mapped for the current cluster through ``AudioCraftEnvironment``."""

from __future__ import annotations

import dataclasses
import typing as tp

from ..cond.attributes import ConditioningAttributes
from ..utils.misc import AudioCraftEnvironment
from .audio_dataset import AudioDataset, AudioMeta, SegmentInfo


def _clusterify_meta(meta: AudioMeta) -> AudioMeta:
    """The cluster's dataset mappers, then the ``//reference`` placeholder
    (reference :25-38); in place."""
    meta.path = AudioCraftEnvironment.resolve_reference_path(
        AudioCraftEnvironment.apply_dataset_mappers(meta.path))
    if meta.info_path is not None:
        meta.info_path.zip_path = AudioCraftEnvironment.apply_dataset_mappers(
            meta.info_path.zip_path)
    return meta


def clusterify_all_meta(meta: tp.List[AudioMeta]) -> tp.List[AudioMeta]:
    return [_clusterify_meta(m) for m in meta]


@dataclasses.dataclass
class SegmentInfoWithAttributes(SegmentInfo):
    """A SegmentInfo that converts to ConditioningAttributes (the
    SegmentWithAttributes contract, reference ``conditioners.py``:129-136)."""

    def to_condition_attributes(self) -> ConditioningAttributes:
        return ConditioningAttributes()


class InfoAudioDataset(AudioDataset):
    """An AudioDataset over cluster-mapped paths whose items, with
    ``return_info``, carry a SegmentInfoWithAttributes (reference
    ``info_audio_dataset.py``:40-110)."""

    def __init__(self, meta: tp.List[AudioMeta], **kwargs):
        super().__init__(clusterify_all_meta(meta), **kwargs)

    def __getitem__(self, index: int):
        if not self.return_info:
            return super().__getitem__(index)
        wav, info = super().__getitem__(index)
        return wav, SegmentInfoWithAttributes(
            meta=info.meta, seek_time=info.seek_time, n_frames=info.n_frames,
            total_frames=info.total_frames, sample_rate=info.sample_rate,
            channels=info.channels)
