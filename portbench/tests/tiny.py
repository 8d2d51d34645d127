"""Configurations and cells at debug sizes for the CPU tests: the published
files with their widths cut, so that the harness, the drivers, the checks
and the references run end to end on the CPU in seconds."""

from __future__ import annotations

import copy
import typing as tp

from portbench.harness import spec
from portbench.harness.device import Device
from portbench.harness.session import Context

TOKENIZE = 'encodec_32khz.tokenize_b128x10s'
BATCH = 'musicgen_small.batch_b4x30s'


def codec_cfg() -> dict:
    cfg = copy.deepcopy(spec.config('encodec_32khz'))
    # fp32: the CPU's bf16 strided convolution is off at some of these shapes
    cfg['compute_dtype'] = None
    cfg['seanet'].update(n_filters=2, dimension=16)
    cfg['quantizer'].update(dimension=16, bins=32)
    cfg['assumed'].update(codebook_clips=4, codebook_clip_seconds=1.0)
    return cfg


def musicgen_cfg() -> dict:
    cfg = copy.deepcopy(spec.config('musicgen_small'))
    cfg['codec'] = codec_cfg()
    cfg['lm'].update(dim=32, num_heads=4, num_layers=2, card=32)
    cfg['t5'].update(vocab_size=512, d_model=16, d_kv=4, d_ff=32, num_layers=2, num_heads=4)
    cfg['assumed']['t5_vocab'] = 500
    return cfg


def cell(name: str, **params: tp.Any) -> dict:
    out = copy.deepcopy(spec.workload(name))
    small = {TOKENIZE: dict(batch=2, clip_seconds=0.25, distinct_batches=2),
             BATCH: dict(duration=0.2, descriptions=2, words=[2, 6], greedy_every=2)}[name]
    out['params'].update(small, **params)
    if name == BATCH:
        # the facade decodes in bfloat16 on the card only: on the CPU its
        # logits and caches are float32's, and so are their limits (the
        # program reads about 1e-6 here, its int8 path about 1e-2)
        out['check']['limits'].update(lm_logit_err=1e-4, lm_kv_err=1e-4)
    return out


def context(name: str, seed: int = 3, seconds: float = 0.5, **kw: tp.Any) -> Context:
    cfg = codec_cfg() if name == TOKENIZE else musicgen_cfg()
    return Context(cell=cell(name), cfg=cfg, seed=seed, seconds=seconds, device=Device('cpu'),
                   **kw)
