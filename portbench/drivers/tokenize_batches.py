"""Batches back to back through ``EncodecModel.encode``: a closed loop of
one caller that keeps the card's queue full, the codes left on the device.

Traffic (the cell's ``params``): ``batch`` clips of ``clip_seconds`` of
music-like audio (``harness/audio.py``: ``notes``, ``harmonics``, ``bursts``,
``midi_range``, ``level_dbfs``), ``distinct_batches`` of them made from the
seed and cycled.  The window runs batches until ``--seconds`` have passed,
then waits for the device; the rate is the audio seconds of every batch
dispatched over that whole time.  The traced run profiles the whole window.

Check: for two batches of the window (one drawn from the seed among the
first ``check_pick_below``, and the last) the encoder's latent as the
quantizer received it against the plain float32 encoder
(``latent_rel_err``: relative L2), and the codes against the plain
quantizer run on that same latent (``codes_off_share``: the share of codes
whose squared distance exceeds the nearest code's by more than a rounding
tie, ``tie_rel`` of the two vectors' squared norms).  The control is the
plain encoder in float8 and the plain quantizer with TF32 products, put in
the program's place.
"""

from __future__ import annotations

import time
import typing as tp

import numpy as np
import torch

from ..harness import models
from ..harness.audio import music_batch
from ..reference import codec as ref
from ..reference.precision import Precision


def _program(ctx, cfg):
    model = ctx.reuse.get('codec')
    if model is None:
        model = ctx.reuse['codec'] = models.build_codec(cfg, ctx.device.torch)
    return model


def setup(ctx) -> dict:
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    model = _program(ctx, cfg)
    shapes = models.state_shapes(model)
    state = models.make_state(shapes, cfg, ctx.seed, dev.torch)
    models.load(model, state)
    codebooks = models.codebooks_of(state)
    samples = int(tr['clip_seconds'] * cfg['sample_rate'])
    gen = dev.generator(ctx.seed + 11)
    inputs = [music_batch(gen, tr['batch'], samples, cfg['sample_rate'], tr['audio'])
              for _ in range(tr['distinct_batches'])]
    kept: tp.Dict[str, tp.Any] = {}
    encode = model.encode
    if ctx.control:
        state32 = state
        embeds = ref.codebooks(state32, cfg['quantizer']['n_q'])

        def encode(x):                                  # noqa: F811
            latent = ref.encode_latent(state32, cfg, x, Precision('fp8'))
            kept['latent'] = latent
            return ref.rvq_encode(latent, embeds, Precision('tf32')), None
    else:
        del state
        quantizer_encode = type(model.quantizer).encode.__get__(model.quantizer)

        def capture(latent):
            kept['latent'] = latent
            return quantizer_encode(latent)

        model.quantizer.encode = capture
    dev.reset_peak()
    for x in inputs[:2 if ctx.warm else 0]:
        encode(x)
    dev.sync()
    rng = np.random.default_rng(ctx.seed)
    return dict(model=model, encode=encode, inputs=inputs, kept=kept, shapes=shapes,
                codebooks=codebooks, pick=int(rng.integers(0, tr['check_pick_below'])))


def window(ctx, st: dict) -> dict:
    tr, dev = ctx.traffic, ctx.device
    inputs, kept, encode = st['inputs'], st['kept'], st['encode']
    checked: tp.Dict[int, tuple] = {}
    dev.sync()
    ctx.tracer.start()
    t0 = time.perf_counter()
    n = 0
    while True:
        x = inputs[n % len(inputs)]
        codes = encode(x)[0]
        checked[n] = (n % len(inputs), kept['latent'], codes)
        if n - 1 in checked and n - 1 != st['pick']:
            del checked[n - 1]                        # keep the pick and the latest
        n += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    dev.sync()
    wall = time.perf_counter() - t0
    ctx.tracer.stop()
    st['checked'] = checked
    audio_s = n * tr['batch'] * tr['clip_seconds']
    return dict(e2e={'codec_audio_s_per_s': (audio_s / wall, 'audio-s/s')},
                attempted=n, failed=0, window_s=wall,
                counters={'batches': n, 'traced_batches': n if ctx.trace else 0,
                          'batch': tr['batch'], 'clip_seconds': tr['clip_seconds']})


def release(st: dict) -> None:
    st.pop('model', None)
    st.pop('encode', None)


def codes_off(latent: torch.Tensor, codes: torch.Tensor, embeds: torch.Tensor,
              tie_rel: float) -> torch.Tensor:
    """Per code: whether its squared distance to the residual the codes
    before it leave exceeds the nearest code's by more than ``tie_rel`` of
    the residual's and the nearest vector's squared norms.  latent
    [B, D, T], codes [B, K, T] -> [B, K, T] bool."""
    B, D, T = latent.shape
    residual = latent.transpose(1, 2).reshape(B * T, D).float()
    flat_codes = codes.transpose(1, 2).reshape(B * T, -1).long()
    off = []
    for q, embed in enumerate(embeds):
        dist = (residual.square().sum(1, keepdim=True) - 2 * residual @ embed.t()
                + embed.square().sum(1)[None])
        best, arg = dist.min(1)
        chosen = dist.gather(1, flat_codes[:, q:q + 1])[:, 0]
        scale = residual.square().sum(1) + embed[arg].square().sum(1)
        off.append(chosen - best > tie_rel * scale)
        residual = residual - embed[flat_codes[:, q]]
    return torch.stack(off, 1).view(B, T, -1).transpose(1, 2)


def check(ctx, st: dict) -> None:
    cfg, tr = ctx.cfg, ctx.traffic
    state = models.make_state(st['shapes'], cfg, ctx.seed, ctx.device.torch, st['codebooks'])
    embeds = ref.codebooks(state, cfg['quantizer']['n_q'])
    with Precision('fp32').context():
        for _, (which, latent, codes) in sorted(st.pop('checked').items()):
            want = ref.encode_latent(state, cfg, st['inputs'][which])
            err = (latent.float() - want).norm() / want.norm()
            ctx.checks.compare('latent_rel_err', float(err))
            off = codes_off(latent, codes, embeds, tr['tie_rel'])
            ctx.checks.compare('codes_off_share', float(off.float().mean()))
