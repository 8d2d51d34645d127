"""Long-form generation by segments stitched with crossfades: the fork's
extend utility (counterpart of ``audiocraft_tpu/gen/extend.py``; the
reference ``utils/extend.py`` and the stitch in ``app.py``:425-453).

* :func:`separate_audio_segments`: a melody split into windows of
  ``segment_duration`` seconds sharing ``overlap`` seconds, at most 25.  As
  in the JAX package this is the splitter's intended behaviour: the
  reference's loop compares a segment count with a sample count and emits
  one segment almost always.
* :func:`plan_segments`: the segment count with the overlap's loss made
  up, durations capped at 720 s and overlaps at 15 s.
* :func:`generate_music_segments`: one prompt segment from the first (or
  ``prompt_index``-th) melody window, then per window a continuation
  conditioned on the text, that window's melody (optionally its harmonic
  part only, ``io/hpss.py``) and the prompt cropped to the overlap.  Each
  generate draws from its own ``torch.Generator``, seeded from ``seed`` and
  the segment's index, where JAX splits its key.
* :func:`stitch_segments`: a linear fade out of the last ``overlap``
  seconds against a fade in of the next segment's first, with the fork's
  half-overlap trim.
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch

from ..io.audio_utils import apply_tafade
from ..io.hpss import harmonic
from .musicgen import MusicGen

AudioTuple = tp.Tuple[int, np.ndarray]  # (sample_rate, samples [T] or [T, C])


def separate_audio_segments(audio: AudioTuple, segment_duration: int = 30,
                            overlap: int = 1) -> tp.List[AudioTuple]:
    """(sr, samples) -> up to 25 windows of ``segment_duration`` seconds,
    ``overlap`` seconds apart at their joins; audio no longer than one
    window is one segment, and a tail longer than the overlap gets a last
    window ending with the audio."""
    sr, audio_data = audio
    segment_samples, overlap_samples = sr * segment_duration, sr * overlap
    n = len(audio_data)
    if n <= segment_samples:
        return [(sr, audio_data)]
    segments: tp.List[AudioTuple] = []
    start, stride = 0, max(segment_samples - overlap_samples, 1)
    while start + segment_samples <= n and len(segments) < 25:
        segments.append((sr, audio_data[start:start + segment_samples]))
        start += stride
    if start < n and len(segments) < 25 and n - start > overlap_samples:
        segments.append((sr, audio_data[-segment_samples:]))
    return segments


def plan_segments(duration: int, segment_duration: int,
                  overlap: int) -> tp.Tuple[int, int, int]:
    """(total_segments, adjusted_duration, excess_duration): the count of
    segments with the overlap's loss made up (reference ``extend.py``:68-88)."""
    duration, overlap = min(duration, 720), min(overlap, 15)
    total_segments = max(math.ceil(duration / segment_duration), 1)
    duration_loss = max(total_segments - 1, 0) * math.ceil(overlap / 2)
    excess_duration = segment_duration - (total_segments * segment_duration - duration)
    duration += duration_loss
    while excess_duration + duration_loss > segment_duration:
        total_segments += 1
        duration_loss += math.ceil(overlap / 2)
        excess_duration = segment_duration - (total_segments * segment_duration - duration)
        if excess_duration + duration_loss > segment_duration:
            duration += duration_loss
            duration_loss = 0
    total_segments = min(total_segments,
                         720 // segment_duration if segment_duration <= 720 else 1)
    return max(total_segments, 1), duration, excess_duration


def _segment_generator(seed: int, index: int) -> torch.Generator:
    return torch.Generator().manual_seed(((seed & 0x7fffffff) << 8) + index)


def generate_music_segments(text: str, melody: AudioTuple, seed: int, model: MusicGen,
                            duration: int = 10, overlap: int = 1, segment_duration: int = 30,
                            prompt_index: int = 0, harmony_only: bool = False,
                            interrupt: tp.Optional[tp.Callable[[], bool]] = None
                            ) -> tp.Tuple[tp.List[torch.Tensor], int]:
    """A long piece as overlapping segments that follow ``melody`` ((sr,
    samples [T] or [T, C])).  Returns (the segments' audio [B, C, T] each,
    the excess duration).  ``prompt_index >= 0`` keeps one shared prompt
    segment; below 0 each segment's output prompts the next.  The model's
    duration is restored at the end."""
    melody_segments = separate_audio_segments(melody, segment_duration, 0)
    text = f"{text}, seed={seed}"
    total_segments, duration, excess_duration = plan_segments(duration, segment_duration,
                                                              overlap)
    while len(melody_segments) < total_segments:
        melody_segments.append(melody_segments[len(melody_segments) % len(melody_segments)])

    melodies = []
    for segment_idx in range(total_segments):
        if interrupt and interrupt():
            return [], duration
        sr, verse_data = melody_segments[segment_idx]
        verse = np.asarray(verse_data, np.float32)
        verse = verse[None] if verse.ndim == 1 else verse.T          # [C, T]
        verse = verse[..., :int(sr * model.max_duration)]
        melodies.append(harmonic(verse) if harmony_only else verse)

    prompt_verse = melodies[min(prompt_index, total_segments - 1)] if prompt_index > 0 \
        else melodies[0]

    def set_duration(seconds: float) -> None:
        model.set_generation_params(
            use_sampling=model.use_sampling, top_k=model.top_k, top_p=model.top_p,
            temperature=model.temperature, cfg_coef=model.cfg_coef, duration=seconds,
            extend_stride=model.extend_stride)

    saved_duration = model.duration
    set_duration(min(segment_duration, model.max_duration - 1e-9)
                 if segment_duration >= model.max_duration else segment_duration)
    prompt_segment = model.generate_with_chroma([text], [prompt_verse], sr,
                                                generator=_segment_generator(seed, 0))
    # the continuation prompt is the last overlap (at least 1 s) of the
    # prompt segment, so that each segment generates new music (JAX's note:
    # the reference's whole-segment prompt fills the window)
    prompt_samples = max(overlap, 1) * model.sample_rate

    output_segments: tp.List[torch.Tensor] = []
    remaining = duration
    for idx, verse in enumerate(melodies):
        if interrupt and interrupt():
            break
        if idx + 1 == len(melodies) or remaining < segment_duration:
            mod_duration = max(min(remaining, segment_duration), 1)
            set_duration(mod_duration)
            verse = verse[..., -mod_duration * model.sample_rate:]
        output = model.generate_continuation(
            prompt_segment[..., -prompt_samples:], model.sample_rate, descriptions=[text],
            melody_wavs=[verse], melody_sample_rate=sr,
            generator=_segment_generator(seed, idx + 1))
        if prompt_index < 0:
            prompt_segment = output
        output_segments.append(output)
        if remaining > segment_duration:
            remaining -= segment_duration
    model.duration = saved_duration
    return output_segments, excess_duration


def stitch_segments(segments: tp.Sequence[torch.Tensor], sample_rate: int,
                    overlap: int) -> torch.Tensor:
    """Segments [B, C, T_i] -> one [B, C, T]: each join keeps the first half
    of the earlier segment's faded-out overlap, then the later segment's
    faded-in overlap and its rest (the fork's ``app.py``:425-453)."""
    output = torch.as_tensor(segments[0])
    for seg in segments[1:]:
        seg = torch.as_tensor(seg).to(output.device)
        if overlap > 0:
            n = overlap * sample_rate
            fadeout = apply_tafade(output[:, :, -n:], sample_rate, duration=overlap, out=True,
                                   start=True, shape='linear')
            fadein = apply_tafade(seg[:, :, :n], sample_rate, duration=overlap, out=False,
                                  start=False, shape='linear')
            overlapping = torch.cat([fadeout[:, :, :-(n // 2)], fadein], dim=2)
            output = torch.cat([output[:, :, :-n], overlapping, seg[:, :, n:]], dim=2)
        else:
            output = torch.cat([output, seg], dim=2)
    return output
