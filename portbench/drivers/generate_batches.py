"""Whole ``MusicGen.generate`` calls back to back: one caller, as the
``batch_generate`` CLI runs a list of prompts.

Traffic (the cell's ``params``): each call takes ``descriptions`` texts of
``words`` word counts (the same counts every call, spread evenly over the
range, in an order drawn from the seed; the words drawn from the seed), for
``duration`` seconds with ``top_k``, ``temperature`` and ``cfg_coef``.
Every ``greedy_every``-th call, from the first, decodes greedily: those are
the calls the check compares.  Set-up warms one sampling call: each call
draws new texts, so a new padded description length, and captures its own
decode graphs in the window as ``batch_generate`` does over a list of
prompts; the warm call loads what every call shares.  A call
starts only while the last call's duration still fits before ``--seconds``,
so the window holds whole calls (at least one); the rate is the audio
seconds of the calls over the time from the window's start to the end of
the last.  The traced run profiles one call (the second, where the window
holds two).

Check: ``harness/musicgen.check_call`` on every greedy call's rows.
"""

from __future__ import annotations

import time
import typing as tp

import numpy as np
import torch

from ..harness import musicgen
from ..harness.text import word_counts, words


def _settings(mg, tr: dict, greedy: bool) -> None:
    mg.set_generation_params(use_sampling=not greedy, top_k=tr['top_k'],
                             temperature=tr['temperature'], duration=tr['duration'],
                             cfg_coef=tr['cfg_coef'])


def _call(mg, rng: np.random.Generator, tr: dict, vocab: tp.Sequence[str], greedy: bool,
          device) -> dict:
    texts = musicgen.draw_texts(rng, word_counts(tr['descriptions'], *tr['words'], rng), vocab)
    _settings(mg, tr, greedy)
    gen = torch.Generator().manual_seed(int(rng.integers(0, 2 ** 31 - 1)))
    audio, tokens = mg.generate(texts, generator=gen, return_tokens=True)
    device.sync()
    return dict(texts=texts, audio=audio, tokens=tokens, greedy=greedy)


def setup(ctx) -> dict:
    st = musicgen.prepare(ctx)
    st['vocab'] = words()
    st['rng'] = np.random.default_rng(ctx.seed)
    warm_rng = np.random.default_rng([ctx.seed, 1])
    ctx.device.reset_peak()
    t0 = time.perf_counter()
    if ctx.warm:
        _call(st['mg'], warm_rng, ctx.traffic, st['vocab'], False, ctx.device)
    st['warm_s'] = time.perf_counter() - t0
    return st


def window(ctx, st: dict) -> dict:
    tr, mg, dev = ctx.traffic, st['mg'], ctx.device
    traced = 1 if ctx.seconds >= 2 * st['warm_s'] else 0
    calls: tp.List[dict] = []
    t0 = time.perf_counter()
    last = st['warm_s']
    while True:
        g = len(calls)
        if g == traced:
            ctx.tracer.start()
        t_call = time.perf_counter()
        call = _call(mg, st['rng'], tr, st['vocab'], g % tr['greedy_every'] == 0, dev)
        last = time.perf_counter() - t_call
        if g == traced:
            t_stop = time.perf_counter()
            ctx.tracer.stop()
            t0 += time.perf_counter() - t_stop        # closing the profiler is not the window's
        if call['greedy']:
            call['cond'] = st['rec'].get('cond')
            logits = st['rec'].get('logits')
            call['logits'] = None if logits is None else logits.clone()
            call['kv'] = musicgen.take_kv(st['rec'])
        else:
            call.pop('audio')
        calls.append(call)
        if time.perf_counter() - t0 + last > ctx.seconds:
            break
    wall = time.perf_counter() - t0
    st['calls'] = calls
    audio_s = len(calls) * tr['descriptions'] * tr['duration']
    rows = 2 * tr['descriptions']
    return dict(e2e={'gen_audio_s_per_s': (audio_s / wall, 'audio-s/s')},
                attempted=len(calls), failed=0, window_s=wall,
                counters={'calls': len(calls), 'model_rows': rows,
                          'frames': musicgen.frames(ctx),
                          'audio_s': audio_s},
                extra={'texts': [c['texts'] for c in calls]})


def release(st: dict) -> None:
    musicgen.release(st)


def check(ctx, st: dict) -> None:
    state = musicgen.reference_state(ctx, st)
    parts = []
    for call in st.pop('calls'):
        if not call['greedy']:
            continue
        rows = list(range(len(call['texts'])))
        parts.append(musicgen.check_call(ctx, state, call['texts'], rows, call['tokens'],
                                        call['cond'], call['logits'], call['kv'],
                                        list(call['audio']), st['tokenizer']))
    musicgen.compare_run(ctx, parts)
