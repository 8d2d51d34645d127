"""Conditioning attribute containers and nullification (CFG null conditions)
(copied from ``audiocraft_tpu/cond/attributes.py``, which the port may not
import: the containers, ``dropout_condition``, the attribute and CFG
dropouts and ``drop_description_condition``).

Host-side metadata mirroring the reference audiocraft
``modules/conditioners.py:46-236``: a ``ConditioningAttributes`` carries
per-attribute text / wav / joint-embed / symbolic inputs; nullify functions
produce the null versions used by classifier-free guidance.  Arrays here are
numpy; tensors only appear after the conditioners embed them.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np


class WavCondition(tp.NamedTuple):
    wav: np.ndarray                      # [B, C, T]
    length: np.ndarray                   # [B]
    sample_rate: tp.List[int]
    path: tp.List[tp.Optional[str]] = []
    seek_time: tp.List[tp.Optional[float]] = []


class JointEmbedCondition(tp.NamedTuple):
    wav: np.ndarray
    text: tp.List[tp.Optional[str]]
    length: np.ndarray
    sample_rate: tp.List[int]
    path: tp.List[tp.Optional[str]] = []
    seek_time: tp.List[tp.Optional[float]] = []


class SymbolicCondition(tp.NamedTuple):
    frame_chords: tp.Optional[np.ndarray] = None
    melody: tp.Optional[np.ndarray] = None


@dataclasses.dataclass
class ConditioningAttributes:
    text: tp.Dict[str, tp.Optional[str]] = dataclasses.field(default_factory=dict)
    wav: tp.Dict[str, WavCondition] = dataclasses.field(default_factory=dict)
    joint_embed: tp.Dict[str, JointEmbedCondition] = dataclasses.field(default_factory=dict)
    symbolic: tp.Dict[str, SymbolicCondition] = dataclasses.field(default_factory=dict)

    def __getitem__(self, item):
        return getattr(self, item)

    @property
    def attributes(self) -> tp.Dict[str, tp.Iterable[str]]:
        return {"text": self.text.keys(), "wav": self.wav.keys(),
                "joint_embed": self.joint_embed.keys(),
                "symbolic": self.symbolic.keys()}

    def copy(self) -> "ConditioningAttributes":
        return ConditioningAttributes(
            text=dict(self.text), wav=dict(self.wav),
            joint_embed=dict(self.joint_embed), symbolic=dict(self.symbolic))

    def to_flat_dict(self):
        return {
            **{f"text.{k}": v for k, v in self.text.items()},
            **{f"wav.{k}": v for k, v in self.wav.items()},
            **{f"joint_embed.{k}": v for k, v in self.joint_embed.items()},
            **{f"symbolic.{k}": v for k, v in self.symbolic.items()},
        }

    @classmethod
    def from_flat_dict(cls, x):
        out = cls()
        for k, v in x.items():
            kind, att = k.split(".")
            out[kind][att] = v
        return out


def nullify_wav(cond: WavCondition) -> WavCondition:
    """Zero-length single-sample wav (reference ``conditioners.py``:165-181)."""
    B = cond.wav.shape[0]
    null_wav = np.zeros((*cond.wav.shape[:-1], 1), cond.wav.dtype)
    return WavCondition(
        wav=null_wav, length=np.zeros(B, np.int64),
        sample_rate=cond.sample_rate, path=[None] * B, seek_time=[None] * B)


def nullify_joint_embed(embed: JointEmbedCondition) -> JointEmbedCondition:
    B = embed.wav.shape[0]
    null_wav = np.zeros((*embed.wav.shape[:-1], 1), embed.wav.dtype)
    return JointEmbedCondition(
        wav=null_wav, text=[None] * len(embed.text),
        length=np.zeros(1, np.int64), sample_rate=embed.sample_rate,
        path=[None] * B, seek_time=[0] * B)


def nullify_chords(cond: SymbolicCondition, null_chord_idx: int = 194) -> SymbolicCondition:
    return SymbolicCondition(
        frame_chords=np.full_like(cond.frame_chords, null_chord_idx))


def nullify_melody(cond: SymbolicCondition) -> SymbolicCondition:
    return SymbolicCondition(melody=np.zeros_like(cond.melody))


def dropout_condition(sample: ConditioningAttributes, condition_type: str,
                      condition: str) -> ConditioningAttributes:
    """Nullify one attribute in place (reference ``conditioners.py``:1337-1369)."""
    assert condition_type in ('text', 'wav', 'joint_embed', 'symbolic')
    assert condition in getattr(sample, condition_type), \
        f"unexpected condition {condition!r} of type {condition_type!r}"
    if condition_type == 'wav':
        sample.wav[condition] = nullify_wav(sample.wav[condition])
    elif condition_type == 'joint_embed':
        sample.joint_embed[condition] = nullify_joint_embed(
            sample.joint_embed[condition])
    elif condition_type == 'symbolic':
        sym = sample.symbolic[condition]
        if sym.frame_chords is not None:
            sample.symbolic[condition] = nullify_chords(sym)
        elif sym.melody is not None:
            sample.symbolic[condition] = nullify_melody(sym)
    else:
        sample.text[condition] = None
    return sample


class AttributeDropout:
    """Independent per-attribute dropout (reference ``conditioners.py``:1380-1424)."""

    def __init__(self, p: tp.Dict[str, tp.Dict[str, float]],
                 active_on_eval: bool = False, seed: int = 1234):
        self.active_on_eval = active_on_eval
        self.p = p
        self.rng = np.random.RandomState(seed)

    def __call__(self, samples: tp.List[ConditioningAttributes],
                 training: bool = True) -> tp.List[ConditioningAttributes]:
        if not training and not self.active_on_eval:
            return samples
        samples = [s.copy() for s in samples]
        for condition_type, probs in self.p.items():
            for condition, p in probs.items():
                if self.rng.rand() < p:
                    for sample in samples:
                        dropout_condition(sample, condition_type, condition)
        return samples


class ClassifierFreeGuidanceDropout:
    """All-or-nothing condition dropout (reference ``conditioners.py``:1427-1466).

    Note the reference applies this whenever the module is in train mode; at
    generation time it is constructed fresh with p=1.0 (lm.py:500) so it always
    drops — `__call__` here defaults to that behavior.
    """

    def __init__(self, p: float, seed: int = 1234):
        self.p = p
        self.rng = np.random.RandomState(seed)

    def __call__(self, samples: tp.List[ConditioningAttributes],
                 cond_types: tp.Sequence[str] = ("wav", "text"),
                 training: bool = True) -> tp.List[ConditioningAttributes]:
        if not training:
            return samples
        if not (self.rng.rand() < self.p):
            return samples
        samples = [s.copy() for s in samples]
        for condition_type in cond_types:
            for sample in samples:
                for condition in list(sample.attributes[condition_type]):
                    dropout_condition(sample, condition_type, condition)
        return samples


def drop_description_condition(conditions: tp.List[ConditioningAttributes]
                               ) -> tp.List[ConditioningAttributes]:
    """Drop the text but keep the wav conditioning: the middle term of double
    CFG (reference ``conditioners.py``:223-236)."""
    for condition in conditions:
        if 'description' not in condition.text or 'self_wav' not in condition.wav:
            raise ValueError("double CFG needs a description and a self_wav condition")
    return AttributeDropout(p={'text': {'description': 1.0},
                               'wav': {'self_wav': 0.0}})(conditions)
