"""Waveform visualization (a copy of ``audiocraft_tpu/io/waveform.py``, numpy
and matplotlib only, which the port may not import): the rendering core of
the fork's ``modules/gradio.py:make_waveform`` reimplementation (:35-273),
minus the video mux, which ``io/video.py`` does; the bars image is the
per-frame content the video animates.
"""

from __future__ import annotations

import typing as tp
from pathlib import Path

import numpy as np


def waveform_bars(wav: np.ndarray, bars: int = 50) -> np.ndarray:
    """[T] or [C, T] -> per-bar normalized magnitudes [bars]."""
    wav = np.asarray(wav)
    if wav.ndim == 2:
        wav = wav.mean(0)
    chunks = np.array_split(np.abs(wav), bars)
    mags = np.asarray([c.max() if len(c) else 0.0 for c in chunks])
    peak = mags.max()
    return mags / peak if peak > 0 else mags


def make_waveform_image(path: tp.Union[str, Path], wav: np.ndarray,
                        bars: int = 50,
                        bar_color: str = "#2a6db0",
                        bg_color: str = "#0b0f19") -> Path:
    """Render the bar-style waveform image (the video's visual content)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    mags = waveform_bars(wav, bars)
    fig, ax = plt.subplots(figsize=(10, 2.5), facecolor=bg_color)
    ax.set_facecolor(bg_color)
    ax.bar(np.arange(bars), mags, width=0.8, color=bar_color)
    ax.bar(np.arange(bars), -mags, width=0.8, color=bar_color)
    ax.set_ylim(-1.1, 1.1)
    ax.axis("off")
    fig.tight_layout(pad=0.1)
    fig.savefig(path, dpi=100, facecolor=bg_color)
    plt.close(fig)
    return Path(path)
