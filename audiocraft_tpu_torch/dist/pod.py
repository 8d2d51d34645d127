"""Time-parallel (pod) EnCodec tokenization and synthesis of ONE long
waveform over a ``torch.distributed`` group (counterpart of
``audiocraft_tpu/dist/pod.py``, whose shards are the devices of a mesh axis).

Every rank holds the whole signal (or code sequence) and runs its own time
shard; ``group=None`` is one process, one shard.

* :func:`pod_encode`: each rank runs the encoder's time-local conv front
  (the layers before ``split_index``, on the module stack: the pod front
  never takes the fused K4/K5 route) on its chunk extended by halos of its
  neighbours' samples.  The halos wrap around, as the pair of ``ppermute``
  calls of the JAX package does (rank 0's left halo is rank S-1's end), and are swapped
  by one ``all_gather`` of each rank's two edge slices.  The two global
  edges, which the wrapped halos corrupt, are re-run on a short segment with
  the true edge padding (the uniform edge correction).  The front's frames
  are gathered in rank order along time and every rank runs the
  sequence-global tail: the LSTM (K2 on the card, a launch a layer), the
  final conv, fp32, the RVQ encode (K1).  The codes equal
  ``model.encode`` of the signal zero-padded to a multiple of ``hop * S``,
  on the module-stack route (at near-ties on the card, where cuDNN may pick
  another algorithm at the halo-extended length).
* :func:`pod_decode`: every rank runs the sequence-global head (the input
  conv and the LSTM: K2) on the whole frame embedding, then the upsampling
  tail on its window of frames: its own chunk and a halo of true
  neighbouring frames on each side, the two edge windows slid inward so that
  every window has one length.  The ranks' samples are gathered in rank
  order: every rank returns the whole waveform, the value of the JAX
  package's time-sharded array, equal to ``model.decode`` of the codes
  zero-padded to a multiple of S frames up to float rounding.

JAX's refusals are kept as ``ValueError``: a renormalizing codec, a
``time_group_norm`` conv in the front (its statistics are sequence-global),
and too few frames a shard.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F

from ..nn.conv import StreamableConv1d
from ..nn.seanet import SEANetResnetBlock
from .mesh import Group, gather_parts, rank, world_size


def _check_pod_compatible(model) -> None:
    if model.renormalize:
        raise ValueError("pod_encode supports renormalize=False models (the 32 kHz family)")
    enc = model.encoder
    for layer in enc.model[:enc.split_index]:
        convs = [layer] if isinstance(layer, StreamableConv1d) else (
            [m for m in [*layer.block, layer.shortcut] if isinstance(m, StreamableConv1d)]
            if isinstance(layer, SEANetResnetBlock) else [])
        if any(conv.norm == 'time_group_norm' for conv in convs):
            raise ValueError("time_group_norm has sequence-global statistics; the conv front "
                             "cannot be time-sharded exactly")


@torch.no_grad()
def pod_encode(model, x: torch.Tensor, group: Group = None,
               compute_dtype: tp.Union[str, torch.dtype, None] = None) -> torch.Tensor:
    """Encode ``x`` [B, C, T] with time sharded over ``group``: codes
    [B, K, T' / hop] on every rank, T' being T zero-padded to a multiple of
    ``hop * S``.  ``compute_dtype`` as in ``EncodecModel.encode`` (None:
    the model's)."""
    _check_pod_compatible(model)
    enc = model.encoder
    S, r = world_size(group), rank(group)
    hop, split = enc.hop_length, enc.split_index
    c_l, c_r = enc.front_corruption_radius()
    halo_f = max(c_l, c_r) + 1        # +1 frame of margin
    seg_f = c_l + c_r + 2             # edge-correction segment length

    B, C, T = x.shape
    T_pad = -(-T // (hop * S)) * (hop * S)
    x = F.pad(x, (0, T_pad - T))
    n_frames = T_pad // (hop * S)     # frames a shard
    if n_frames < max(halo_f, seg_f):
        raise ValueError(f"pod_encode needs >= {max(halo_f, seg_f)} frames a shard, got "
                         f"{n_frames}; use fewer shards or longer audio")
    x = model._cast(x, compute_dtype)
    halo_s, seg_s, chunk = halo_f * hop, seg_f * hop, n_frames * hop

    x_l = x[..., r * chunk:(r + 1) * chunk]
    # the halo exchange: each rank's (head, tail) edges, the neighbours' picked
    edges = gather_parts(torch.stack([x_l[..., :halo_s], x_l[..., -halo_s:]]), group)
    from_left, from_right = edges[(r - 1) % S][1], edges[(r + 1) % S][0]
    ext = torch.cat([from_left, x_l, from_right], dim=-1)
    y = enc(ext, stop_layer=split)[..., halo_f:halo_f + n_frames]
    # the uniform edge correction: the wrapped halos made the global edges'
    # frames garbage; a segment with true edge padding replaces them
    if c_l > 0 and r == 0:
        y[..., :c_l] = enc(x_l[..., :seg_s], stop_layer=split)[..., :c_l]
    if c_r > 0 and r == S - 1:
        y[..., -c_r:] = enc(x_l[..., -seg_s:], stop_layer=split)[..., -c_r:]
    feat = torch.cat(gather_parts(y, group), dim=-1)

    # the replicated sequence-global tail: LSTM -> final act and conv -> RVQ
    emb = enc(feat, start_layer=split).float()
    return model.quantizer.encode(emb)


@torch.no_grad()
def pod_decode(model, codes: torch.Tensor, group: Group = None,
               compute_dtype: tp.Union[str, torch.dtype, None] = None) -> torch.Tensor:
    """Decode ``codes`` [B, K, T_f] with time sharded over ``group``: the
    whole waveform [B, C, T_f' * hop] fp32 on every rank, T_f' being T_f
    zero-code-padded to a multiple of S."""
    if model.renormalize:
        raise ValueError("pod_decode supports renormalize=False models")
    dec = model.decoder
    S, r = world_size(group), rank(group)
    hop, split = dec.hop_length, dec.split_index
    c_l, c_r = dec.tail_corruption_radius()   # output samples
    halo_f = -(-max(c_l, c_r, 1) // hop) + 1  # frames (+1 margin)

    B, K, T_f = codes.shape
    Tf_pad = -(-T_f // S) * S
    codes = F.pad(codes, (0, Tf_pad - T_f))
    n_frames = Tf_pad // S
    # n_frames >= 2 halo keeps the inward slide to the two edge windows and
    # fits a window inside the signal for any S >= 2
    if S > 1 and n_frames < 2 * halo_f:
        raise ValueError(f"pod_decode needs >= {2 * halo_f} frames a shard, got {n_frames}; "
                         f"use fewer shards or more frames")

    emb = model._cast(model.decode_latent(codes), compute_dtype)
    h = dec(emb, stop_layer=split)                    # replicated [B, C, Tf']
    W = min(n_frames + 2 * halo_f, Tf_pad)            # window frames
    # rank r's window: frames [r F - halo, r F + F + halo), slid inward at the
    # global edges so that every window is true signal of one length
    start = min(max(r * n_frames - halo_f, 0), Tf_pad - W)
    y = dec(h[..., start:start + W], start_layer=split)
    # rank r's F hop samples start at (r F - start) hop, at least c_l from a
    # padded window edge (and 0 at a true edge)
    y = y[..., (r * n_frames - start) * hop:][..., :n_frames * hop]
    wav = torch.cat(gather_parts(y, group), dim=-1)
    return model.postprocess(wav.float(), None)
