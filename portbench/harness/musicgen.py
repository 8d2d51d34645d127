"""What the MusicGen cells share: the facade with its seeded weights and T5
ids, the recording of what its timed path produced, the controls, and the
comparison of one generate call with the plain references.

The comparison of a call (:func:`check_call`), for the greedy rows it names:

* ``t5_rel_err``: the conditioning the program computed (the provider's
  output, conditions and null conditions) against the plain T5 and
  projection, relative L2;
* ``lm_gap_max`` and ``lm_gap_mean``: the plain LM's full forward pass
  over each served token sequence, with classifier-free guidance over the
  plain conditioning; per token, how far the logit of the token served lies
  below the best logit at its step (0 where the program picked the
  reference's argmax), the widest and the mean over the tokens compared;
* ``lm_logit_err``: the guided logits the program's decode sampled each
  token from (copied at every step of a greedy call, inside its CUDA
  graphs, by :func:`record_logits`) against that same full forward's, at
  every step and codebook the pattern fills, each centred on its mean: the
  L2 of the difference over the L2 of the reference's, pooled over the run.
  A change of the decode's precision moves every logit, where the tokens
  move only at near ties;
* ``lm_kv_err``: the keys and values the decode cached in the first layer
  (read back, dequantized where the cache is int8, by :func:`take_kv`
  once a greedy call has returned) against the plain LM's first-layer
  projections of the same tokens, relative L2 over every filled position,
  pooled over the run.  They depend on the tokens alone, so the bf16
  rounding of the residual stream, which sets the logits' error floor,
  has not built up there: int8 weights or an int8 cache show above it;
* ``audio_err``: the audio served against the plain decoder's audio of the
  served tokens: the error's L2 over the L2 of the magnitudes of the terms
  the decoder's last convolution sums (``|w| * |x| + |b|``), pooled over
  the rows of the run, over the samples the reference keeps inside
  (-0.99, 0.99).  With random weights
  that last convolution (64 channels to 1) cancels by a factor that differs
  from seed to seed, up to five times, and the error relative to its output
  swings with it; relative to the magnitudes summed it is steady.

``ctx.control`` picks the control:

* ``'reference'``: the plain T5 with TF32 products (the step below its
  float32) and the plain codec decoder in float8 (below its bfloat16) in
  the program's place; for the LM, at each step of the served prompts and
  tokens, the plain LM in float8: the gap of the token it puts first, read
  under the float32 LM, its logits and its first layer's keys and values
  (a served model's control need not decode);
* ``'program_int8'``: the program's own lower-precision decode
  (``MusicGen.optimize_for_serving``: int8 weights and int8 KV caches), with
  nothing else changed; its tokens, logits and cached keys and values are
  compared as the program's are.
"""

from __future__ import annotations

import typing as tp
import weakref

import numpy as np
import torch

from ..reference import codec as ref_codec
from ..reference import lm as ref_lm
from ..reference import t5 as ref_t5
from ..reference.precision import Precision
from . import models
from .text import WordHashT5, description

T5_PREFIX = 'provider.conditioners.description.'


def prepare(ctx) -> dict:
    """The facade with the run's seeded weights, the T5 ids handed to its
    conditioner, and the provider's output recorded."""
    cfg, dev = ctx.cfg, ctx.device
    mg = ctx.reuse.get('musicgen')
    if mg is None:
        mg = ctx.reuse['musicgen'] = models.build_musicgen(cfg, dev.torch)
    shapes = models.state_shapes(mg)
    state = models.make_state(shapes, cfg, ctx.seed, dev.torch)
    models.load(mg, state)
    tokenizer = WordHashT5(cfg['assumed']['t5_vocab'])
    mg.condition_provider.conditioners['description'].load_tokenizer = lambda: tokenizer
    rec: tp.Dict[str, tp.Any] = {}
    provider = mg.condition_provider
    forward = type(provider).forward.__get__(provider)
    if ctx.control == 'reference':
        forward = _control_conditioning(state, cfg, dev.torch)
        _control_decode(mg, state, cfg)
    elif ctx.control == 'program_int8':
        mg.optimize_for_serving()
        ctx.reuse.pop('musicgen')            # the int8 weights are one-way
    record_logits(mg, rec)

    def recorded(tokenized):
        out = forward(tokenized)
        rec['cond'] = out['description'][0]
        return out

    provider.forward = recorded
    ctx.tracer.wrap(provider, 'forward', 'conditioning')
    ctx.tracer.wrap(mg.lm, 'generate', 'decode_loop')
    ctx.tracer.wrap(mg.compression_model, 'decode', 'codec_decode')
    return dict(mg=mg, shapes=shapes, codebooks=models.codebooks_of(state), rec=rec,
                tokenizer=tokenizer)


_LOGITS: 'weakref.WeakKeyDictionary' = weakref.WeakKeyDictionary()   # state -> its buffer


def record_logits(mg, rec: dict) -> None:
    """Make every greedy decode state of the facade's decode cache copy the
    logits it takes each token from ([B, K, card], after guidance) into a
    buffer [S, B, K, card] at the step's offset, as one more operation of
    its step, so inside the CUDA graphs too; ``rec['logits']`` is the buffer
    of the state the last call used and ``rec['state']`` that state (both
    None for a sampling call).  The states are wrapped as the cache makes
    them, before any capture, and keep their buffer while the cache keeps
    them."""
    cache = mg._decode_cache
    make_state = type(cache).state.__get__(cache)

    def state(key, make):
        def made():
            s = make()
            if s.uniforms is None:                  # greedy: nothing to draw
                B, K, S = s.seq.shape
                buf = torch.zeros(S, B, K, s.lm.card, dtype=torch.float32,
                                  device=s.seq.device)
                write = s.write_token

                def write_token(logits):
                    buf.index_copy_(0, s.offset, logits[None].float())
                    write(logits)

                s.write_token = write_token
                _LOGITS[s] = buf
            return s

        out = make_state(key, made)
        rec['logits'] = _LOGITS.get(out)
        rec['state'] = out if rec['logits'] is not None else None
        return out

    cache.state = state


def take_kv(rec: dict) -> tp.Optional[torch.Tensor]:
    """A float32 copy of the first layer's self-attention keys and values
    that the last greedy call's decode state cached, [2, rows, n, dim] over
    the n positions it filled (int8 caches times their scales), or None
    after a sampling call; the reference to the state is dropped."""
    s = rec.pop('state', None)
    if s is None:
        return None
    cache = s._sets(s.current)[0][0]              # the first group's first layer
    n = int(cache.index)
    kv = []
    for t, scale in ((cache.k, cache.k_scale), (cache.v, cache.v_scale)):
        t = t[:, :n].float()
        if scale is not None:
            t = t * scale[:, :n, :, None]
        kv.append(t.flatten(2))
    return torch.stack(kv)


def _control_conditioning(state, cfg, device):
    t5_state = models.component(state, T5_PREFIX)

    def forward(tokenized):
        ids, mask = (t.to(device) for t in tokenized['description'])
        return {'description': (ref_t5.condition(t5_state, cfg['t5'], ids, mask,
                                                 Precision('tf32')), mask)}

    return forward


def _control_decode(mg, state, cfg) -> None:
    codec_state = models.component(state, 'codec.')
    c = models.codec_cfg(cfg)
    embeds = ref_codec.codebooks(codec_state, c['quantizer']['n_q'])

    def decode(codes, scale=None, compute_dtype=None, lstm_kernel=None):
        return ref_codec.decode_latent(codec_state, c, ref_codec.rvq_decode(codes, embeds),
                                       Precision('fp8'))

    mg.compression_model.decode = decode


def release(st: dict) -> None:
    st.pop('mg', None)


def frames(ctx) -> int:
    """Codec frames of one generated clip."""
    return int(round(ctx.traffic['duration'] * models.codec_cfg(ctx.cfg)['frame_rate']))


def reference_state(ctx, st: dict) -> dict:
    return models.make_state(st['shapes'], ctx.cfg, ctx.seed, ctx.device.torch, st['codebooks'])


def check_call(ctx, state: dict, texts: tp.Sequence[str], rows: tp.Sequence[int],
               tokens: torch.Tensor, cond: tp.Optional[torch.Tensor],
               logits: tp.Optional[torch.Tensor], kv: tp.Optional[torch.Tensor],
               audio: tp.Sequence[torch.Tensor], tokenizer: WordHashT5) -> tp.Dict[str, tp.Any]:
    """Compare the greedy ``rows`` of one generate call over ``texts`` (every
    row of the call, padding rows included): ``tokens`` [B, K, T] as served,
    ``cond`` the conditioning the program computed ([2B, L, dim]: conditions,
    then null conditions), ``logits`` the decode's [S, B, K, card] (see
    :func:`record_logits`), ``kv`` the decode's cached first-layer keys and
    values ([2, rows, n, dim], :func:`take_kv`), ``audio`` the served audio
    of each row in ``rows`` ([C, samples]).  Returns the rows' logit gaps
    and the squared errors and scales of the logits, the keys and values
    and the audio, for :func:`compare_run` to pool over the run."""
    cfg, dev, checks = ctx.cfg, ctx.device.torch, ctx.checks
    c = models.codec_cfg(cfg)
    B = len(texts)
    enc = tokenizer(list(texts) + [''] * B)
    ids = torch.as_tensor(enc['input_ids'], device=dev)
    mask = torch.as_tensor(enc['attention_mask'], device=dev)
    mask[B:] = 0                                     # null conditions: empty texts
    with Precision('fp32').context():
        want = ref_t5.condition(models.component(state, T5_PREFIX), cfg['t5'], ids, mask)
        if cond is not None:
            got = cond.float()[:B]
            checks.compare('t5_rel_err', float((got - want[:B]).norm() / want[:B].norm()))
        rows_t = torch.as_tensor(list(rows), device=dev)
        codes = tokens.to(dev)[rows_t]
        seq, valid = ref_lm.delay_sequence(codes, cfg['lm']['card'])
        lm_state = models.component(state, 'lm.')
        gaps = []
        logit_err2 = logit_scale2 = 0.0
        if ctx.control != 'reference':
            if logits is None:
                checks.fail('the greedy call recorded no logits')
            if kv is None:
                checks.fail('the greedy call recorded no keys and values')
        kv_err2 = kv_scale2 = 0.0
        coef = float(ctx.traffic['cfg_coef'])
        for i in range(len(rows)):
            args = (lm_state, cfg['lm'], seq[i:i + 1], want[:B][rows_t[i:i + 1]],
                    want[B:][rows_t[i:i + 1]], coef)
            ref = ref_lm.cfg_logits(*args)
            if ctx.control == 'reference':
                got = ref_lm.cfg_logits(*args, Precision('fp8'))
                gaps.append(ref_lm.argmax_gaps(ref, got, valid).flatten())
            else:
                gaps.append(ref_lm.logit_gaps(ref, seq[i:i + 1], valid).flatten())
                got = None if logits is None else logits[:, rows[i]].to(dev).transpose(0, 1)[None]
            if got is not None:
                e2, s2 = ref_lm.logit_errors(ref, got, valid)
                logit_err2 += e2
                logit_scale2 += s2
            del ref, got
            want_kv = ref_lm.first_layer_kv(lm_state, cfg['lm'], seq[i:i + 1])
            if ctx.control == 'reference':
                got = ref_lm.first_layer_kv(lm_state, cfg['lm'], seq[i:i + 1], Precision('fp8'))
            else:
                got = None if kv is None else kv[:, rows[i]:rows[i] + 1].to(dev)
            if got is not None:
                n = got.shape[2]
                if not 0 < n <= want_kv.shape[2]:
                    checks.fail(f'{n} cached positions for a sequence of {want_kv.shape[2]}')
                else:
                    kv_err2 += float((got - want_kv[:, :, :n]).square().sum())
                    kv_scale2 += float(want_kv[:, :, :n].square().sum())
            del want_kv, got
        codec_state = models.component(state, 'codec.')
        embeds = ref_codec.codebooks(codec_state, c['quantizer']['n_q'])
        err2 = scale2 = 0.0
        for i in range(len(rows)):
            both = ref_codec.decode_latent(codec_state, c,
                                           ref_codec.rvq_decode(codes[i:i + 1], embeds),
                                           magnitude=True)[0]
            wav, scale = both[:1], both[1:]
            got = audio[i].to(dev).float()
            if got.shape != wav.shape:
                checks.fail(f'served audio {tuple(got.shape)} for {tuple(wav.shape)}')
                continue
            keep = wav.abs() < 0.99
            err2 += float((got - wav)[keep].square().sum())
            scale2 += float(scale[keep].square().sum())
    return dict(gaps=torch.cat(gaps), logit_err2=logit_err2, logit_scale2=logit_scale2,
                kv_err2=kv_err2, kv_scale2=kv_scale2, audio_err2=err2, audio_scale2=scale2)


def _pooled(parts: tp.Sequence[dict], name: str) -> float:
    err2 = sum(p[f'{name}_err2'] for p in parts)
    scale2 = sum(p[f'{name}_scale2'] for p in parts)
    return (err2 / scale2) ** 0.5 if scale2 > 0 else float('inf')


def compare_run(ctx, parts: tp.Sequence[dict]) -> None:
    """Over every row compared in the run: the widest and the mean logit gap,
    the logits' error, the first layer's keys' and values' error and the
    audio's error over the scale of its last sum."""
    if not parts:
        ctx.checks.fail('no greedy tokens were served to compare')
        return
    pooled = torch.cat([p['gaps'] for p in parts])
    ctx.checks.compare('lm_gap_max', float(pooled.max()))
    ctx.checks.compare('lm_gap_mean', float(pooled.mean()))
    ctx.checks.compare('lm_logit_err', _pooled(parts, 'logit'))
    ctx.checks.compare('lm_kv_err', _pooled(parts, 'kv'))
    ctx.checks.compare('audio_err', _pooled(parts, 'audio'))


def draw_texts(rng: np.random.Generator, counts: tp.Sequence[int],
               vocabulary: tp.Sequence[str]) -> tp.List[str]:
    return [description(rng, n, vocabulary) for n in counts]
