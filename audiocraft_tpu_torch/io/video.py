"""Waveform-video rendering: animated MP4 with embedded metadata
(counterpart of ``audiocraft_tpu/io/video.py``).

Capability counterpart of the fork's ``make_waveform`` video pipeline (the
reference's ``modules/gradio.py``:35-273) and its MP4 metadata embedding
(``app.py``:469-538, mutagen).  The base frame (bars + optional title card)
renders with PIL on the host; the per-frame progress animation, MPEG-4/AAC
encode, MP4 mux, and metadata tags run in the native library
``native/libaudiocraft_video.so`` (built from ``native/video_mux.cc`` by
``native/build.sh``) over ffmpeg's shared libraries: no ffmpeg binary and
no mutagen required.  Everything here takes host arrays and runs on the
host.

The library is a file of the repository, not of either package.  As in
``io/native.py``, and unlike the JAX package, which checks only that the
file exists, :func:`available` and every entry point turn a failed load (a
missing ffmpeg library: an ``OSError`` from ``ctypes.CDLL``) into
:class:`~.native.NativeDecoderUnavailable` with the loader's message;
:func:`unavailable_reason` says why.
"""

from __future__ import annotations

import ctypes
import typing as tp
from pathlib import Path

import numpy as np

from .native import NativeDecoderUnavailable
from .waveform import waveform_bars

_LIB_PATH = Path(__file__).resolve().parent.parent.parent / "native" / \
    "libaudiocraft_video.so"

_lib: tp.Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists():
        raise NativeDecoderUnavailable(
            f"native video muxer not built — run {_LIB_PATH.parent}/build.sh")
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError as exc:
        raise NativeDecoderUnavailable(
            f"native video muxer {_LIB_PATH.name} does not load: {exc}") from exc
    lib.act_mux_waveform_video.restype = ctypes.c_int
    lib.act_mux_waveform_video.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.act_read_metadata.restype = ctypes.c_int
    lib.act_read_metadata.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the muxer loads (see :func:`unavailable_reason`)."""
    return unavailable_reason() is None


def unavailable_reason() -> tp.Optional[str]:
    """None when the muxer loads, else why it does not."""
    try:
        _load()
    except NativeDecoderUnavailable as exc:
        return str(exc)
    return None


def render_base_frame(wav: np.ndarray, width: int = 768, height: int = 512,
                      bars: int = 60,
                      bar_color=(42, 109, 176),
                      bg_color=(11, 15, 25),
                      title: str = "", settings: str = "",
                      background: tp.Optional[str] = None,
                      font: tp.Optional[str] = None,
                      font_color="#ffffff", font_size: int = 28
                      ) -> np.ndarray:
    """Compose the video's base frame: bars in the lower half, optional
    title card text above (PIL, RGB24 [H, W, 3])."""
    from PIL import Image, ImageDraw

    from .titlecard import render_title_card
    width, height = width - width % 2, height - height % 2
    if title or settings or background:
        base = render_title_card(title=title, description=settings,
                                 width=width, height=height,
                                 background=background, font=font,
                                 font_color=font_color, font_size=font_size)
        img = base.convert("RGB")
    else:
        img = Image.new("RGB", (width, height), bg_color)
    draw = ImageDraw.Draw(img)
    mags = waveform_bars(wav, bars)
    zone_top = height // 2
    zone_h = height - zone_top - 16
    mid = zone_top + zone_h // 2
    bar_w = width / bars
    for i, m in enumerate(mags):
        half = max(1, int(m * zone_h / 2))
        x0 = int(i * bar_w) + 1
        x1 = max(x0 + 1, int((i + 1) * bar_w) - 1)
        draw.rectangle([x0, mid - half, x1, mid + half], fill=bar_color)
    return np.asarray(img, dtype=np.uint8)


def mux_waveform_video(path: tp.Union[str, Path], wav: np.ndarray,
                       sample_rate: int, base_frame: np.ndarray,
                       fps: int = 20,
                       metadata: tp.Optional[tp.Mapping[str, tp.Any]] = None
                       ) -> Path:
    """Encode `wav` ([C, T] or [T] float) + animated `base_frame` into an
    MP4 at `path`, embedding `metadata` as container tags."""
    lib = _load()
    wav = np.asarray(wav, np.float32)
    if wav.ndim == 1:
        wav = wav[None]
    channels, n = wav.shape
    interleaved = np.ascontiguousarray(wav.T.reshape(-1))
    frame = np.ascontiguousarray(base_frame, np.uint8)
    h, w, _ = frame.shape
    meta = {str(k): str(v) for k, v in (metadata or {}).items()}
    keys = (ctypes.c_char_p * len(meta))(*[k.encode() for k in meta])
    vals = (ctypes.c_char_p * len(meta))(*[v.encode() for v in meta.values()])
    err = ctypes.create_string_buffer(512)
    ret = lib.act_mux_waveform_video(
        str(path).encode(), frame.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        w, h, fps, interleaved.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, sample_rate, channels, keys, vals, len(meta), err, len(err))
    if ret != 0:
        raise RuntimeError(f"video mux failed ({ret}): {err.value.decode()}")
    return Path(path)


def read_metadata(path: tp.Union[str, Path]) -> tp.Dict[str, str]:
    """Container tags of a media file as a dict."""
    lib = _load()
    out = ctypes.create_string_buffer(65536)
    err = ctypes.create_string_buffer(512)
    n = lib.act_read_metadata(str(path).encode(), out, len(out), err, len(err))
    if n < 0:
        raise RuntimeError(f"read metadata failed: {err.value.decode()}")
    tags = {}
    for line in out.value.decode(errors="replace").splitlines():
        if "=" in line:
            k, v = line.split("=", 1)
            tags[k] = v
    return tags


def make_waveform_video(path: tp.Union[str, Path], wav: np.ndarray,
                        sample_rate: int,
                        metadata: tp.Optional[tp.Mapping[str, tp.Any]] = None,
                        title: str = "", settings: str = "",
                        background: tp.Optional[str] = None,
                        width: int = 768, height: int = 512, fps: int = 20,
                        font: tp.Optional[str] = None,
                        font_color="#ffffff", font_size: int = 28) -> Path:
    """One-call pipeline: base frame (bars + title card) -> animated MP4 with
    metadata (the reference's make_waveform + mutagen tagging in one step)."""
    base = render_base_frame(np.asarray(wav), width=width, height=height,
                             title=title, settings=settings,
                             background=background, font=font,
                             font_color=font_color, font_size=font_size)
    return mux_waveform_video(path, wav, sample_rate, base, fps=fps,
                              metadata=metadata)
