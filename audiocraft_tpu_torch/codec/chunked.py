"""Chunked EnCodec encode and decode for long audio
(counterpart of ``audiocraft_tpu/codec/chunked.py``).

A long decode (minutes of audio) as one call holds every layer's activations
over the whole signal at once.  These helpers run the time-local part of
the codec in sequential windows instead, so the activations stay about one
window's size, while every kept output sample still reads exactly the
whole-signal inputs: each window carries a halo of true neighbouring data
at least the slice's corruption radius wide (``nn/seanet.corruption_radius``).

Window layout, in frames, the same for both directions: a window of ``W``
frames emits ``F_out = W - 2 * halo``; window ``i`` writes output offset
``g_i = i * F_out`` (the last snaps to ``T - F_out``, so its right edge is
the true edge) and starts at ``s_i = clamp(g_i - halo, 0, T - W)``, so an
edge window has the true boundary and its layers' pads are the
whole-signal pads.

* :func:`chunked_decode` runs the head (the input conv and the LSTM, so K2's
  two launches) once on the whole frame sequence and the upsampling tail per
  window; it equals ``model.decode`` up to float rounding (the convs sum in
  other blocks at other lengths).  A stereo wrapper
  (``codec/stereo.py``) de-interleaves its codes and decodes both channels
  as one doubled batch of the mono codec, as its own ``decode`` does.
* :func:`chunked_encode` runs the conv front per window and the tail (the
  LSTM, the last conv, the RVQ: K2 and K1) once on the frame features; it is
  token-exact with ``model.encode`` when the length is a multiple of the
  hop (otherwise it pads to one).
"""

from __future__ import annotations

import typing as tp

import torch

from .encodec import EncodecModel
from .stereo import InterleaveStereoCompressionModel


def _window_plan(T: int, W: int, halo: int) -> tp.Tuple[tp.List[int], tp.List[int], int]:
    """Window starts ``s_i`` and output offsets ``g_i`` covering ``[0, T)``
    with ``F_out = W - 2 * halo`` output frames a window."""
    F_out = W - 2 * halo
    if F_out <= 0:
        raise ValueError(f"a window of {W} frames is too small for a halo of {halo}")
    gs, ss = [], []
    for i in range(-(-T // F_out)):
        g = min(i * F_out, T - F_out)
        gs.append(g)
        ss.append(min(max(g - halo, 0), T - W))
    return ss, gs, F_out


def _stitch(pieces: tp.List[torch.Tensor], body_len: int) -> torch.Tensor:
    """Windows are contiguous but for the last (snapped to the end): the
    first ``body_len`` of the others, then the last whole."""
    body = torch.cat(pieces[:-1], dim=2)[:, :, :body_len]
    return torch.cat([body, pieces[-1]], dim=2)


@torch.no_grad()
def chunked_decode(model: tp.Union[EncodecModel, InterleaveStereoCompressionModel],
                   codes: torch.Tensor, scale: tp.Optional[torch.Tensor] = None,
                   chunk_frames: int = 1500) -> torch.Tensor:
    """``model.decode`` of ``codes [B, K, T_f]`` in windows of
    ``chunk_frames``; a sequence of at most one window (or a window under
    four halos) decodes in one call."""
    if isinstance(model, InterleaveStereoCompressionModel):
        both, scales = model.both_channels(codes, scale)
        return model.stereo_audio(chunked_decode(model.model, both, scales, chunk_frames))
    dec = model.decoder
    hop, split = dec.hop_length, dec.split_index
    c_l, c_r = dec.tail_corruption_radius()                  # output samples
    halo = -(-max(c_l, c_r, 1) // hop) + 1                   # frames, one of margin
    T_f = codes.shape[-1]
    W = min(chunk_frames, T_f)
    if T_f <= W or W < 4 * halo:
        return model.decode(codes, scale)
    h = dec(model._cast(model.decode_latent(codes)), stop_layer=split)
    ss, gs, F_out = _window_plan(T_f, W, halo)
    pieces = [dec(h[..., s:s + W], start_layer=split)[..., (g - s) * hop:(g - s + F_out) * hop]
              .float() for s, g in zip(ss, gs)]
    return model.postprocess(_stitch(pieces, (T_f - F_out) * hop), scale)


@torch.no_grad()
def chunked_encode(model: EncodecModel, x: torch.Tensor, chunk_frames: int = 1500
                   ) -> tp.Tuple[torch.Tensor, tp.Optional[torch.Tensor]]:
    """``model.encode`` of ``x [B, C, T]`` in windows of ``chunk_frames``
    (the 32 kHz family: ``renormalize`` off)."""
    if model.renormalize:
        raise ValueError("chunked_encode supports models without renormalize")
    enc = model.encoder
    hop, split = enc.hop_length, enc.split_index
    halo = max(enc.front_corruption_radius()) + 1           # frames
    T = x.shape[-1]
    T_pad = -(-T // hop) * hop
    T_f = T_pad // hop
    W = min(chunk_frames, T_f)
    if T_f <= W or W < 4 * halo:
        return model.encode(x)
    x = model._cast(torch.nn.functional.pad(x, (0, T_pad - T)))
    ss, gs, F_out = _window_plan(T_f, W, halo)
    pieces = [enc(x[..., s * hop:(s + W) * hop], stop_layer=split)[..., g - s:g - s + F_out]
              for s, g in zip(ss, gs)]
    feat = _stitch(pieces, T_f - F_out)
    emb = enc(feat, start_layer=split).float()
    return model.quantizer.encode(emb), None
