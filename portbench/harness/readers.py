"""Arithmetic the per-layer readers share (``layer_metrics/<metric>.py``).

A reader takes the traced run's :class:`~portbench.harness.session.Record`
and returns a number, or None where it finds nothing to read: the harness
then leaves the metric out of the line.  A share of a roofline or a peak is
never made up as 0.
"""

from __future__ import annotations

import math
import re
import statistics
import typing as tp

from ..counts import PEAK_BF16
from ..counts import codec as codec_counts
from ..counts import lm as lm_counts
from . import models
from .text import text_ids


def kernels(rec, pattern: str) -> tp.List[float]:
    """Seconds of each traced kernel whose name matches ``pattern`` (re.search)."""
    if rec.trace is None:
        return []
    rx = re.compile(pattern)
    return rec.trace.kernel_times(lambda name: bool(rx.search(name)))


def roofline(rec, pattern: str, bound_s: float, per_unit: float = 1.0,
             units: tp.Optional[float] = None) -> tp.Optional[float]:
    """The least time over the time taken, in %: per launch (``units``
    None), or ``per_unit`` least seconds against the kernels' total over
    ``units`` units of work."""
    times = kernels(rec, pattern)
    if not times or sum(times) <= 0:
        return None
    if units is None:
        return 100.0 * bound_s / (sum(times) / len(times))
    return 100.0 * per_unit * units / sum(times)


def idle_share(rec) -> tp.Optional[float]:
    t = rec.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def span_ms(rec, name: str, per: float = 1.0) -> tp.Optional[float]:
    spans = rec.spans.get(name)
    if not spans:
        return None
    return 1e3 * statistics.fmean(spans) / per


def steps(rec) -> int:
    """Forward steps of one generate: the delay pattern's steps after the first."""
    return rec.counters['frames'] + rec.cfg['lm']['n_q'] - 1


def mfu(rec, flops: float) -> tp.Optional[float]:
    if not flops or not math.isfinite(rec.window_s) or rec.window_s <= 0:
        return None
    return 100.0 * flops / (rec.window_s * PEAK_BF16)


def tokenize_flops(rec) -> float:
    cfg, c = rec.cfg, rec.counters
    samples = int(c['clip_seconds'] * cfg['sample_rate'])
    return c['batches'] * c['batch'] * codec_counts.encode_flops(cfg, samples)


def generate_flops(rec, texts: tp.Iterable[str]) -> float:
    """Model FLOPs of generating one clip per text: its T5 conditioning and
    its null condition's, the decode of both model rows, the codec decode."""
    cfg = rec.cfg
    frames = rec.counters['frames']
    vocab = cfg['assumed']['t5_vocab']
    total = 0.0
    for text in texts:
        n = len(text_ids(text, vocab))
        total += (lm_counts.t5_flops(cfg['t5'], cfg['lm']['dim'], n)
                  + lm_counts.t5_flops(cfg['t5'], cfg['lm']['dim'], 1)
                  + lm_counts.decode_flops(cfg['lm'], frames, n)
                  + lm_counts.decode_flops(cfg['lm'], frames, 1)
                  + codec_counts.decode_flops(models.codec_cfg(cfg), frames))
    return total
