"""ctypes bindings to the native audio codec library
``native/libaudiocraft_audio.so`` (built from ``native/audio_decode.cc`` by
``native/build.sh`` against ffmpeg's libavformat, libavcodec, libavutil and
libswresample); counterpart of ``audiocraft_tpu/io/native.py``.

It covers the compressed-format half of the reference's ``audio_read`` and
``audio_write`` (``audio.py``:117-228): mp3, ogg, flac, m4a and opus decoded
with the reference's 0.1 s seek pre-roll, a GIL-free batch decode on a C++
thread pool, and encoding through libavcodec.

The library is a file of the repository, not of either package.  It needs
ffmpeg's shared libraries at load time.  Unlike the JAX package, which
checks only that the file exists, :func:`available` and every entry point
turn a failed load (a missing ffmpeg library: an ``OSError`` from
``ctypes.CDLL``) into :class:`NativeDecoderUnavailable`, with the loader's
message, so a host without ffmpeg reads that it lacks it.
"""

from __future__ import annotations

import ctypes
import typing as tp
from pathlib import Path

import numpy as np

_LIB_PATH = Path(__file__).resolve().parent.parent.parent / "native" / "libaudiocraft_audio.so"

_lib: tp.Optional[ctypes.CDLL] = None

_F = ctypes.POINTER(ctypes.c_float)


class NativeDecoderUnavailable(RuntimeError):
    pass


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists():
        raise NativeDecoderUnavailable(
            f"native audio library not built: run {_LIB_PATH.parent}/build.sh")
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError as exc:
        raise NativeDecoderUnavailable(
            f"native audio library {_LIB_PATH.name} does not load: {exc}") from exc
    lib.act_decode_audio.restype = ctypes.c_int
    lib.act_decode_audio.argtypes = [
        ctypes.c_char_p, ctypes.c_double, ctypes.c_double, ctypes.POINTER(_F),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
    lib.act_audio_info.restype = ctypes.c_int
    lib.act_audio_info.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
    lib.act_free_buffer.restype = None
    lib.act_free_buffer.argtypes = [_F]
    lib.act_encode_audio.restype = ctypes.c_int
    lib.act_encode_audio.argtypes = [
        ctypes.c_char_p, _F, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.act_decode_batch.restype = None
    lib.act_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(_F), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library loads on this host (see :func:`unavailable_reason`)."""
    return unavailable_reason() is None


def unavailable_reason() -> tp.Optional[str]:
    """None when the library loads, else why it does not."""
    try:
        _load()
    except NativeDecoderUnavailable as exc:
        return str(exc)
    return None


def _take(lib: ctypes.CDLL, data: tp.Any, frames: int, channels: int) -> np.ndarray:
    """The library's interleaved buffer as [C, T] float32, then freed."""
    try:
        arr = np.ctypeslib.as_array(data, shape=(frames * channels,)).copy()
    finally:
        lib.act_free_buffer(data)
    return arr.reshape(frames, channels).T.copy()


def decode_audio(path: tp.Union[str, Path], seek_time: float = 0.0,
                 duration: float = -1.0) -> tp.Tuple[np.ndarray, int]:
    """Decode a file ffmpeg reads -> ([C, T] float32, sample_rate)."""
    lib = _load()
    data = _F()
    frames, channels, sr = ctypes.c_int64(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    ret = lib.act_decode_audio(str(path).encode(), float(seek_time), float(duration),
                               ctypes.byref(data), ctypes.byref(frames),
                               ctypes.byref(channels), ctypes.byref(sr), err, len(err))
    if ret != 0:
        raise RuntimeError(f"native decode failed ({ret}) for {path}: "
                           f"{err.value.decode(errors='replace')}")
    return _take(lib, data, frames.value, channels.value), sr.value


#: format -> (encoder name, default bitrate kbps; <= 0: the encoder's default).
#: mp3's default is the reference audio_write's mp3_rate=320 (audio.py:167);
#: ogg leaves it to ffmpeg, as audio_write2 does.  opus needs 48 kHz input and
#: round-trips with a head offset of about 200 samples (its pre-skip);
#: mp3, ogg, flac and m4a are sample-aligned.
ENCODERS = {
    'mp3': ('libmp3lame', 320),
    'ogg': ('libvorbis', 0),
    'flac': ('flac', 0),
    'm4a': ('aac', 0),
    'opus': ('libopus', 0),
}

#: format -> MIME type, kept beside ENCODERS so that the two stay in step.
MIME_TYPES = {
    'wav': 'audio/wav',
    'mp3': 'audio/mpeg',
    'ogg': 'audio/ogg',
    'flac': 'audio/flac',
    'm4a': 'audio/mp4',
    'opus': 'audio/opus',
}


def encode_audio(path: tp.Union[str, Path], wav: np.ndarray, sample_rate: int,
                 format: tp.Optional[str] = None, bitrate_kbps: tp.Optional[int] = None) -> None:
    """Encode [C, T] float audio into a compressed file (mp3, ogg, flac, m4a,
    opus; ``format`` defaults to the suffix) through libavcodec, the write
    half of the reference's ``audio_write`` (``audio.py``:164-228).  An
    unknown format or a sample rate the encoder refuses raises
    ``ValueError``."""
    if wav.ndim != 2:
        raise ValueError("expected [C, T]")
    fmt = format or Path(path).suffix.lstrip('.').lower()
    if fmt not in ENCODERS:
        raise ValueError(f"unsupported encode format {fmt!r} (have {sorted(ENCODERS)})")
    lib = _load()
    codec_name, default_rate = ENCODERS[fmt]
    rate = default_rate if bitrate_kbps is None else bitrate_kbps
    interleaved = np.ascontiguousarray(wav.T, dtype=np.float32)
    err = ctypes.create_string_buffer(256)
    ret = lib.act_encode_audio(str(path).encode(), interleaved.ctypes.data_as(_F),
                               wav.shape[1], wav.shape[0], int(sample_rate),
                               codec_name.encode(), int(rate), err, len(err))
    if ret == -3:
        # the encoder refused the sample rate (opus wants 48 kHz): the
        # caller's input, so the same type as an unknown format
        raise ValueError(f"{fmt!r} cannot encode sample_rate={sample_rate}: "
                         f"{err.value.decode(errors='replace')}")
    if ret != 0:
        raise RuntimeError(f"native encode failed ({ret}) for {path}: "
                           f"{err.value.decode(errors='replace')}")


def probe_audio(path: tp.Union[str, Path]) -> tp.Tuple[int, float, int]:
    """(sample_rate, duration in seconds, channels) without decoding."""
    lib = _load()
    dur, channels, sr = ctypes.c_double(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    ret = lib.act_audio_info(str(path).encode(), ctypes.byref(dur), ctypes.byref(channels),
                             ctypes.byref(sr), err, len(err))
    if ret != 0:
        raise RuntimeError(f"native probe failed ({ret}) for {path}: "
                           f"{err.value.decode(errors='replace')}")
    return sr.value, dur.value, channels.value


def decode_audio_batch(paths: tp.Sequence[tp.Union[str, Path]],
                       seek_times: tp.Optional[tp.Sequence[float]] = None,
                       durations: tp.Optional[tp.Sequence[float]] = None,
                       num_threads: int = 8) -> tp.List[tp.Tuple[np.ndarray, int]]:
    """Decode files in parallel on the library's C++ thread pool, without
    the GIL: a list of ([C, T] float32, sample_rate); a failed item raises
    after every buffer is freed."""
    lib = _load()
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    c_seeks = (ctypes.c_double * n)(*(seek_times or [0.0] * n))
    c_durs = (ctypes.c_double * n)(*(durations or [-1.0] * n))
    datas = (_F * n)()
    frames = (ctypes.c_int64 * n)()
    channels = (ctypes.c_int * n)()
    srs = (ctypes.c_int * n)()
    status = (ctypes.c_int * n)()
    lib.act_decode_batch(c_paths, n, c_seeks, c_durs, datas, frames, channels, srs, status,
                         num_threads)
    out, error = [], None
    for i in range(n):
        if status[i] != 0:
            error = error or RuntimeError(
                f"native batch decode failed ({status[i]}) for {paths[i]}")
            continue
        out.append((_take(lib, datas[i], frames[i], channels[i]), srs[i]))
    if error is not None:
        raise error
    return out
