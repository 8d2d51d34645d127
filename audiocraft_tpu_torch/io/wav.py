"""Audio file read and write (counterpart of ``audiocraft_tpu/io/wav.py``,
which the port may not import).

``audio_read`` and ``audio_write`` take the roles of the reference's
``data/audio.py``:117-228.  WAV is read and written in numpy: PCM 16, 24 and
32 bit and float32, with ``seek_time`` and ``duration`` as the reference
reads them.  Every other suffix and format goes to the native codec library
(``io/native.py``: mp3, ogg, flac, m4a, opus), as in the JAX package; where
that library does not load, they raise ``NativeDecoderUnavailable`` saying
why.
"""

from __future__ import annotations

import struct
import typing as tp
from pathlib import Path

import numpy as np
import torch

from .audio_utils import f32_pcm, i16_pcm, normalize_audio

PathLike = tp.Union[str, Path]


def _parse_wav_header(data: bytes) -> tp.Tuple[dict, int, int]:
    """(format fields, offset of the samples, their byte count)."""
    if data[:4] != b'RIFF' or data[8:12] != b'WAVE':
        raise ValueError("not a RIFF/WAVE file")
    pos, fmt = 12, None
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        size = struct.unpack('<I', data[pos + 4:pos + 8])[0]
        body = pos + 8
        if chunk_id == b'fmt ':
            audio_format, channels, sample_rate, _, block_align, bits = struct.unpack(
                '<HHIIHH', data[body:body + 16])
            fmt = dict(format=audio_format, channels=channels, sample_rate=sample_rate,
                       block_align=block_align, bits=bits)
        elif chunk_id == b'data':
            if fmt is None:
                raise ValueError("data chunk before fmt chunk")
            return fmt, body, size
        pos = body + size + (size & 1)
    raise ValueError("no data chunk found")


def wav_read(filepath: PathLike, seek_time: float = 0.0,
             duration: float = -1.0) -> tp.Tuple[np.ndarray, int]:
    """A wav file -> (wav [C, T] float32 in [-1, 1], sample_rate)."""
    data = Path(filepath).read_bytes()
    fmt, body, size = _parse_wav_header(data)
    sr, ch, bits, frame_bytes = (fmt['sample_rate'], fmt['channels'], fmt['bits'],
                                 fmt['block_align'])
    n_frames = size // frame_bytes
    start = min(int(seek_time * sr) if seek_time else 0, n_frames)
    count = n_frames - start
    if duration > 0:
        count = min(count, int(duration * sr))
    raw = data[body + start * frame_bytes: body + (start + count) * frame_bytes]
    if fmt['format'] == 3:  # IEEE float
        arr = np.frombuffer(raw, dtype='<f4').astype(np.float32)
    elif bits == 16:
        arr = f32_pcm(np.frombuffer(raw, dtype='<i2'))
    elif bits == 32:
        arr = f32_pcm(np.frombuffer(raw, dtype='<i4'))
    elif bits == 24:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        i32 = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
               | (b[:, 2].astype(np.int32) << 16))
        i32 = np.where(i32 >= 1 << 23, i32 - (1 << 24), i32)
        arr = i32.astype(np.float32) / (1 << 23)
    else:
        raise ValueError(f"unsupported wav: format={fmt['format']} bits={bits}")
    return arr.reshape(-1, ch).T.copy(), sr


def wav_write(wav: np.ndarray, filepath: PathLike, sample_rate: int,
              dtype: str = 'int16') -> None:
    """Write [C, T] float audio as 16-bit PCM or float32, through a temporary
    file renamed into place (no half-written file is left on an error)."""
    if wav.ndim != 2:
        raise ValueError("expected [C, T]")
    C = wav.shape[0]
    if dtype == 'int16':
        byte_data = i16_pcm(np.asarray(wav)).T.reshape(-1).astype('<i2').tobytes()
        bits, fmt_code = 16, 1
    elif dtype == 'float32':
        byte_data = np.asarray(wav, np.float32).T.reshape(-1).astype('<f4').tobytes()
        bits, fmt_code = 32, 3
    else:
        raise ValueError(f"dtype {dtype!r}: 'int16' or 'float32'")
    block_align = C * bits // 8
    header = b'RIFF' + struct.pack('<I', 36 + len(byte_data)) + b'WAVE'
    header += b'fmt ' + struct.pack('<IHHIIHH', 16, fmt_code, C, sample_rate,
                                    sample_rate * block_align, block_align, bits)
    header += b'data' + struct.pack('<I', len(byte_data))
    path = Path(filepath)
    tmp = path.with_suffix(path.suffix + '.tmp')
    try:
        tmp.write_bytes(header + byte_data)
        tmp.rename(path)
    except Exception:
        if tmp.exists():
            tmp.unlink()
        raise


def audio_info(filepath: PathLike) -> tp.Tuple[int, float, int]:
    """(sample_rate, duration in seconds, channels) of an audio file, without
    decoding its samples."""
    path = Path(filepath)
    if path.suffix.lower() != '.wav':
        from .native import probe_audio
        return probe_audio(path)
    fmt, _, size = _parse_wav_header(path.read_bytes())
    return fmt['sample_rate'], size // fmt['block_align'] / fmt['sample_rate'], fmt['channels']


def audio_read(filepath: PathLike, seek_time: float = 0.0, duration: float = -1.0,
               pad: bool = False) -> tp.Tuple[np.ndarray, int]:
    """(wav [C, T] float32, sample_rate) of an audio file (reference
    ``audio.py``:117-151): WAV in numpy, other containers through the native
    library; ``pad`` zero-pads to ``duration``."""
    path = Path(filepath)
    if path.suffix.lower() == '.wav':
        wav, sr = wav_read(path, seek_time, duration)
    else:
        from .native import decode_audio
        wav, sr = decode_audio(path, seek_time, duration)
    if pad and duration > 0:
        expected = int(duration * sr)
        if wav.shape[-1] < expected:
            wav = np.pad(wav, ((0, 0), (0, expected - wav.shape[-1])))
    return wav, sr


def audio_write(stem_name: PathLike, wav: tp.Union[np.ndarray, torch.Tensor], sample_rate: int,
                format: str = 'wav', mp3_rate: int = 320, ogg_rate: tp.Optional[int] = None,
                normalize: bool = True, strategy: str = 'peak',
                peak_clip_headroom_db: float = 1.0, rms_headroom_db: float = 18.0,
                loudness_headroom_db: float = 14.0, loudness_compressor: bool = False,
                make_parent_dir: bool = True, add_suffix: bool = True) -> Path:
    """Normalize by ``strategy`` and write (reference ``audio.py``:164-228,
    ``audio_write2``): ``wav`` [C, T] or [T], float, numpy or a tensor on any
    device.  ``format`` 'wav' writes 16-bit PCM in numpy; 'mp3', 'ogg',
    'flac', 'm4a' and 'opus' go through the native library, ``mp3_rate`` and
    ``ogg_rate`` in kbps (``ogg_rate`` None: the encoder's default); a failed
    encode leaves no file.  Returns the path written."""
    wav = torch.as_tensor(wav).detach().cpu()
    if not wav.is_floating_point():
        raise ValueError("wav is not a floating point array")
    if wav.dim() not in (1, 2):
        raise ValueError("wav should be [C, T] or [T]")
    if wav.dim() == 1:
        wav = wav[None]
    wav = normalize_audio(wav.float(), normalize=normalize, strategy=strategy,
                          peak_clip_headroom_db=peak_clip_headroom_db,
                          rms_headroom_db=rms_headroom_db,
                          loudness_headroom_db=loudness_headroom_db,
                          loudness_compressor=loudness_compressor, sample_rate=sample_rate)
    path = Path(str(stem_name) + (f'.{format}' if add_suffix else ''))
    if make_parent_dir:
        path.parent.mkdir(exist_ok=True, parents=True)
    if format == 'wav':
        wav_write(wav.numpy(), path, sample_rate)
        return path
    from .native import encode_audio
    try:
        encode_audio(path, wav.numpy(), sample_rate, format=format,
                     bitrate_kbps={'mp3': mp3_rate, 'ogg': ogg_rate}.get(format))
    except Exception:
        # no half-written file (reference audio.py:221-227)
        if path.exists():
            path.unlink()
        raise
    return path
