#!/usr/bin/env python3
"""Drive the PyTorch port (``audiocraft_tpu_torch``) on one CUDA card.

Run from the repository root, with no arguments:  python3 chip_smoke.py

1. Card and build: prints the card's name and power limit, builds the CUDA
   kernels from ``audiocraft_tpu_torch/csrc`` and prints the build time.
2. Kernels against their plain PyTorch versions, on the card, at the main
   paths' shapes: RVQ encode (codes equal, near-ties excluded and counted),
   one LSTM layer (fp32 and bf16) and flash attention (fp32 and bf16,
   causal and not, at MAGNeT-small's [8, 1500, 16, 64] and off the tiles),
   each timed beside its bound, its plain version and, where one exists, one
   PyTorch call computing the same thing.
3. The codec path: ``get_encodec_32khz()`` (bf16, random weights from a
   seed) tokenizes and reconstructs 128 clips of 10 s; both codec kernels'
   launch counts must rise during that run.
4. fp32 codec parity: the same weights with ``compute_dtype=None`` on the
   card and on the CPU (plain versions), TF32 off.
5. The MAGNeT path: ``get_magnet_lm('small', segment_duration=30)`` with its
   T5-base conditioning (bf16, random weights from a seed) generates 30 s for
   4 seeded descriptions with CFG, and the 32 kHz codec decodes them; every
   stage-0 self-attention must go through the attention kernel and the
   decode through the LSTM kernel.  Then the debug MAGNeT facade generates
   from a text prompt on the card.
6. MAGNeT parity: the same LM in fp32 (TF32 off), one stage-0 forward
   through the attention kernel against the plain path, and the greedy
   token match of a generate on each route.
7. The training path: ``get_musicgen_lm('small')`` (published widths, 24
   layers, random weights from a seed) trains with AdamW in bf16 compute on
   fp32 masters, each step encoding 4 clips of 30 s with
   ``get_encodec_32khz()``; every self-attention must run the flash forward
   and both backward kernels, the loss must fall, and every parameter must
   get a finite, non-zero gradient.  Then the training CLI takes two debug
   steps on the card.
8. Training parity in fp32 (TF32 off): loss and every gradient of the
   kernel route against the plain route, then three AdamW steps on each.
Then one JSON line on the kernels and, last, one JSON line with the result.
Any failed check ends the run with a non-zero exit and no result line, as
does a host without a CUDA card.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time
import typing as tp
import warnings

import torch

from audiocraft_tpu_torch.apps import train_lm
from audiocraft_tpu_torch.builders import get_encodec_32khz, get_magnet_lm, get_musicgen_lm
from audiocraft_tpu_torch.cond.attributes import (ClassifierFreeGuidanceDropout,
                                                  ConditioningAttributes)
from audiocraft_tpu_torch.dist.train import lm_loss, lm_loss_and_grads, make_lm_train_step
from audiocraft_tpu_torch.gen.magnet import get_debug_magnet
from audiocraft_tpu_torch.ops import _build
from audiocraft_tpu_torch.ops.attention import (
    attention_bwd_dkv, attention_bwd_dkv_reference, attention_bwd_dq, attention_bwd_dq_reference,
    attention_di, attention_lse_reference, fused_attention, fused_attention_backward,
    fused_attention_backward_reference, fused_attention_reference, fused_attention_with_lse)
from audiocraft_tpu_torch.ops.lstm import lstm_layer, lstm_layer_reference
from audiocraft_tpu_torch.ops.rvq import rvq_encode, rvq_encode_reference
from audiocraft_tpu_torch.optim import make_optimizer
from audiocraft_tpu_torch.quant.codebook import compute_distances, quantize

# Published H100 SXM peaks (dense): fp32 outside the tensor cores, bf16
# tensor cores, and HBM bandwidth.
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

BATCH, SECONDS, SAMPLE_RATE = 128, 10, 32000       # main path: b128 x 10 s clips
RVQ_SHAPE = dict(n=BATCH * SECONDS * 50, d=128, k=2048, n_q=4)
LSTM_SHAPE = dict(t=SECONDS * 50, b=BATCH, h=1024)
# MAGNeT-small-30s: 4 prompts x 2 (CFG), 30 s at 50 Hz, 16 heads of 64
PROMPTS, MAGNET_SECONDS, DESC_LEN = 4, 30, 12
ATTN_SHAPE = dict(b=2 * PROMPTS, t=MAGNET_SECONDS * 50, h=16, d=64)
# MusicGen-small training: 4 clips x 30 s, T = 1500 codes, S = 1501 steps
TRAIN_BATCH, TRAIN_SECONDS, TRAIN_STEPS, TRAIN_LR = 4, 30, 5, 1e-4
TRAIN_ATTN_SHAPE = (TRAIN_BATCH, TRAIN_SECONDS * 50 + 1, 16, 64)


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def card() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(ops: float, peak_ops: float, nbytes: float) -> tuple:
    """The least time for the work, and whether operations or bytes set it."""
    t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def phase_build() -> None:
    print('== phase 1: card and build', flush=True)
    print('card:', card())
    print('torch', torch.__version__, 'cuda', torch.version.cuda,
          'device', torch.cuda.get_device_name(0))
    result = _build.build()
    _build.library()
    print(f'build: {result.seconds:.1f} s -> {result.path.name}')
    for line in result.log.splitlines():
        if 'registers' in line or 'spill' in line or 'error' in line:
            print('  ptxas:', line.strip())


def _rvq_inputs(device, n, d, k, n_q, seed=1):
    """Random rows and codebooks with planted ties: codes 7, 16, 25, ... copy
    code 3 in every codebook, and every 97th row equals code 3 of the first."""
    gen = torch.Generator().manual_seed(seed)
    embeds = torch.randn(n_q, k, d, generator=gen)
    x = torch.randn(n, d, generator=gen)
    embeds[:, 7::9] = embeds[:, 3:4]
    x[::97] = embeds[0, 3]
    return x.to(device), embeds.to(device)


def _near_ties(x, embeds, codes, rel=1e-6):
    """Rows whose top-2 plain distances lie within ``rel`` of each other at
    some codebook of the chain that ``codes`` takes."""
    residual, near = x.clone(), torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for q, embed in enumerate(embeds):
        top2 = compute_distances(residual, embed).topk(2, dim=1).values
        near |= (top2[:, 0] - top2[:, 1]).abs() <= rel * top2[:, 0].abs()
        residual = residual - embed[codes[q].long()]
    return near


def check_rvq(x, embeds) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel codes against the plain codes on ``_rvq_inputs``: equal on every
    row but the near-ties, and every planted tie goes to the first equal
    code.  Returns (kernel codes, plain codes, near-tie mask)."""
    codes = rvq_encode(x, embeds)
    plain = rvq_encode_reference(x, embeds)
    torch.cuda.synchronize()
    what = f'rvq {tuple(x.shape)} x {tuple(embeds.shape)}'
    check(bool((codes[0, ::97] == 3).all() and (plain[0, ::97] == 3).all()),
          f'{what}: planted ties do not go to the first equal code')
    copies = torch.arange(7, embeds.shape[1], 9, device=x.device)
    check(not bool(torch.isin(codes, copies).any()),
          f'{what}: a copy of code 3 won over code 3')
    near = _near_ties(x, embeds, plain)
    diff = (codes != plain)[:, ~near]
    check(not bool(diff.any()), f'{what}: {int(diff.any(0).sum())} rows differ from the plain codes')
    return codes, plain, near


def check_off_tile_shapes(device) -> None:
    """Shapes off the kernels' tiles, masked inside the kernels: RVQ at the
    debug codec's D = 32 and K = 400 with N not a multiple of 64; LSTM with
    B and H not multiples of 32; and a row wider than the RVQ kernel's
    maximum, which must raise."""
    x, embeds = _rvq_inputs(device, n=517, d=32, k=400, n_q=4, seed=8)
    _, _, near = check_rvq(x, embeds)
    gen = torch.Generator().manual_seed(9)
    T, B, C, H = 7, 3, 48, 40
    args = [torch.randn(shape, generator=gen) * 0.5
            for shape in ((T, B, C), (4 * H, C), (4 * H, H), (4 * H,), (4 * H,))]
    errs = []
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 5e-2)):
        a = [t.to(device, dtype) for t in args]
        errs.append(float((lstm_layer(*a).float() - lstm_layer_reference(*a).float())
                          .abs().max()))
        check(errs[-1] <= tol, f'lstm T={T} B={B} H={H} {dtype}: max-abs {errs[-1]:.3g} > {tol}')
    try:
        rvq_encode(torch.zeros(8, 256, device=device), torch.zeros(1, 16, 256, device=device))
    except ValueError:
        pass
    else:
        raise CheckFailed('rvq: D = 256 did not raise')
    print(f'off-tile shapes: rvq N=517 D=32 K=400 codes equal ({int(near.sum())} near-tie '
          f'rows excluded); lstm T={T} B={B} C={C} H={H} max-abs fp32 {errs[0]:.3g} (<= 1e-5), '
          f'bf16 {errs[1]:.3g} (<= 5e-2); D=256 refused', flush=True)


def phase_kernels(device) -> dict:
    print('== phase 2: kernels against their plain versions', flush=True)
    results = {}
    check_off_tile_shapes(device)

    s = RVQ_SHAPE
    x, embeds = _rvq_inputs(device, **s)
    codes, plain, near = check_rvq(x, embeds)
    checked = ~near
    ops = 2.0 * s['n'] * s['d'] * s['k'] * s['n_q']
    nbytes = 4.0 * (s['n'] * s['d'] + s['n_q'] * s['k'] * s['d'] + s['n_q'] * s['n'])
    b_ms, b_by = bound_ms(ops, PEAK_FP32, nbytes)
    rvq = dict(name='rvq_encode', route='cuda', source='audiocraft_tpu_torch/csrc/rvq.cu',
               replaces='audiocraft_tpu/ops/rvq_pallas.py:46',
               max_abs_err=float((codes - plain)[:, checked].abs().max()),
               ms=time_ms(lambda: rvq_encode(x, embeds), 5),
               plain_ms=time_ms(lambda: rvq_encode_reference(x, embeds), 5),
               bound_ms=b_ms, bound_by=b_by, library_ms=None)
    print(f"rvq N={s['n']} D={s['d']} K={s['k']} n_q={s['n_q']}: codes equal on "
          f"{int(checked.sum())} rows, {int(near.sum())} near-tie rows excluded; "
          f"kernel {rvq['ms']:.3f} ms, plain {rvq['plain_ms']:.3f} ms, "
          f"bound {b_ms:.3f} ms ({b_by})", flush=True)
    results['rvq_encode'] = rvq
    del x, embeds, codes, plain

    s = LSTM_SHAPE
    T, B, H = s['t'], s['b'], s['h']
    gen = torch.Generator().manual_seed(2)
    bound = 1.0 / math.sqrt(H)
    weights = [(torch.rand(shape, generator=gen) * 2 - 1) * bound
               for shape in ((4 * H, H), (4 * H, H), (4 * H,), (4 * H,))]
    x = torch.randn(T, B, H, generator=gen) * 0.5
    errs = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
        args = [a.to(device, dtype) for a in (x, *weights)]
        out = lstm_layer(*args)
        ref = lstm_layer_reference(*args)
        errs[dtype] = float((out.float() - ref.float()).abs().max())
        check(bool(torch.isfinite(out).all()), f'lstm {dtype}: non-finite output')
        check(errs[dtype] <= tol, f'lstm {dtype}: max-abs {errs[dtype]:.3g} > {tol}')
    # timed in bf16, the main path's dtype
    args = [a.to(device, torch.bfloat16) for a in (x, *weights)]
    cudnn = torch.nn.LSTM(H, H, num_layers=1).to(device, torch.bfloat16)
    with torch.no_grad(), warnings.catch_warnings():
        for p, w in zip((cudnn.weight_ih_l0, cudnn.weight_hh_l0, cudnn.bias_ih_l0,
                         cudnn.bias_hh_l0), args[1:]):
            p.copy_(w)
        # nn.LSTM cannot flatten bf16 weights into one buffer, so cuDNN packs
        # them on every call (an 8 MB copy, timed with it) and warns each time
        warnings.filterwarnings('ignore', message='RNN module weights are not part')
        library = time_ms(lambda: cudnn(args[0]), 3)
    ops = 2.0 * T * B * 4 * H * (H + H)          # input projection + recurrence
    nbytes = 2.0 * (2 * T * B * H + 8 * H * H + 8 * H)
    b_ms, b_by = bound_ms(ops, PEAK_BF16, nbytes)
    lstm = dict(name='lstm_step', route='cuda', source='audiocraft_tpu_torch/csrc/lstm.cu',
                replaces='audiocraft_tpu/ops/lstm_pallas.py:44',
                max_abs_err=errs[torch.bfloat16],
                ms=time_ms(lambda: lstm_layer(*args), 3),
                plain_ms=time_ms(lambda: lstm_layer_reference(*args), 3),
                bound_ms=b_ms, bound_by=b_by, library_ms=library)
    print(f'lstm T={T} B={B} H={H}: max-abs fp32 {errs[torch.float32]:.3g} (<= 1e-4), '
          f'bf16 {errs[torch.bfloat16]:.3g} (<= 5e-2); one layer in bf16: kernel '
          f"{lstm['ms']:.3f} ms, plain {lstm['plain_ms']:.3f} ms, cuDNN nn.LSTM "
          f'{library:.3f} ms, bound {b_ms:.3f} ms ({b_by})', flush=True)
    results['lstm_step'] = lstm
    results['flash_attention'] = check_attention(device)
    dkv, dq = check_attention_backward(device)
    results[dkv['name']], results[dq['name']] = dkv, dq
    return results


def _attn_err(q, k, v, causal: bool) -> float:
    out = fused_attention(q, k, v, causal=causal)
    ref = fused_attention_reference(q, k, v, causal=causal)
    check(bool(torch.isfinite(out).all()), f'attention {tuple(q.shape)}: non-finite output')
    return float((out.float() - ref.float()).abs().max())


def check_attention(device) -> dict:
    """K3 against its plain version (the plain one computed from the same
    inputs in the same dtype), fp32 at 1e-5 (TF32 off; only the order of the
    fp32 sums differs) and bf16 at 2e-2 (the online rescaling, P carried as
    two bf16 parts into the tensor-core product and the bf16 rounding of the
    output), causal and not, at the main path's shape and off the 64-row
    tiles; D = 256 must raise.  Then times at S = 1500 and 500 in bf16."""
    gen = torch.Generator().manual_seed(10)
    errs = {}
    shapes = {'main': tuple(ATTN_SHAPE.values()), 'off-tile': (1, 130, 3, 32)}
    for name, shape in shapes.items():
        qkv = [torch.randn(shape, generator=gen).to(device) for _ in range(3)]
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            for causal in (False, True):
                err = _attn_err(*(x.to(dtype) for x in qkv), causal)
                errs[(name, dtype, causal)] = err
                check(err <= tol, f'attention {shape} {dtype} causal={causal}: max-abs '
                                  f'{err:.3g} > {tol}')
        print(f'attention {name} {shape}: max-abs fp32 {errs[(name, torch.float32, False)]:.3g}'
              f' / causal {errs[(name, torch.float32, True)]:.3g} (<= 1e-5), bf16 '
              f'{errs[(name, torch.bfloat16, False)]:.3g} / causal '
              f'{errs[(name, torch.bfloat16, True)]:.3g} (<= 2e-2)', flush=True)
        del qkv
    try:
        x = torch.zeros(1, 8, 1, 256, device=device)
        fused_attention(x, x, x, causal=False)
    except ValueError:
        pass
    else:
        raise CheckFailed('attention: D = 256 did not raise')

    times = {}
    B, H, D = ATTN_SHAPE['b'], ATTN_SHAPE['h'], ATTN_SHAPE['d']
    for T in (ATTN_SHAPE['t'], 500):   # bf16, non-causal: MAGNeT stage 0 at 30 s and 10 s
        q, k, v = (torch.randn(B, T, H, D, generator=gen).to(device, torch.bfloat16)
                   for _ in range(3))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        b_ms, b_by = bound_ms(4.0 * B * H * T * T * D, PEAK_BF16, 2.0 * 4 * B * T * H * D)
        times[T] = dict(ms=time_ms(lambda: fused_attention(q, k, v, causal=False), 10),
                        plain_ms=time_ms(lambda: fused_attention_reference(q, k, v,
                                                                           causal=False), 5),
                        library_ms=time_ms(sdpa, 10), bound_ms=b_ms, bound_by=b_by)
        t = times[T]
        print(f'attention bf16 B={B} T={T} H={H} D={D}: kernel {t["ms"]:.3f} ms, plain '
              f'{t["plain_ms"]:.3f} ms, SDPA {t["library_ms"]:.3f} ms, bound {b_ms:.4f} ms '
              f'({b_by})', flush=True)
        del q, k, v
    return dict(name='flash_attention', route='cuda',
                source='audiocraft_tpu_torch/csrc/attention.cu',
                replaces='audiocraft_tpu/ops/attention_pallas.py:117',
                max_abs_err=errs[('main', torch.bfloat16, False)], **times[ATTN_SHAPE['t']])


def _attn_bwd_errs(q, k, v, do, causal: bool) -> tp.Tuple[float, float, float]:
    """K3f's lse and K3b's gradients against their plain versions on the
    same inputs: (lse max-abs, worst gradient max-abs / max-abs of the plain
    gradient, worst gradient max-abs)."""
    o, lse = fused_attention_with_lse(q, k, v, causal=causal)
    lse_err = float((lse - attention_lse_reference(q, k, v, causal=causal)).abs().max())
    grads = fused_attention_backward(q, k, v, o, lse, do, causal=causal)
    refs = fused_attention_backward_reference(q, k, v, o, lse, do, causal=causal)
    rel = err = 0.0
    for g, r in zip(grads, refs):
        check(bool(torch.isfinite(g).all()), f'attention backward {tuple(q.shape)}: non-finite')
        diff = float((g.float() - r.float()).abs().max())
        check(math.isfinite(diff), f'attention backward {tuple(q.shape)}: error {diff}')
        err, rel = max(err, diff), max(rel, diff / float(r.float().abs().max()))
    return lse_err, rel, err


def check_attention_backward(device) -> tp.Tuple[dict, dict]:
    """K3b (and K3f's lse) against the plain versions: fp32 (TF32 off; only
    the order of fp32 sums differs) within 1e-4 of each gradient's max-abs,
    bf16 within 2e-2 (the gradients are rounded to bf16; P and dS stay fp32
    on both sides), lse within 1e-5; at the training shape (causal),
    MAGNeT's (not causal) and off the tiles (both).  Then each kernel timed
    at the training shape in bf16."""
    gen = torch.Generator().manual_seed(11)
    cases = [(TRAIN_ATTN_SHAPE, (True,)), (tuple(ATTN_SHAPE.values()), (False,)),
             ((1, 130, 3, 32), (True, False))]
    worst = {}
    for shape, masks in cases:
        q, k, v, do = (torch.randn(shape, generator=gen).to(device) for _ in range(4))
        for causal in masks:
            for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
                lse_err, rel, err = _attn_bwd_errs(*(x.to(dtype) for x in (q, k, v, do)),
                                                   causal)
                worst[(shape, causal, dtype)] = err
                print(f'attention backward {shape} causal={causal} {dtype}: lse max-abs '
                      f'{lse_err:.3g} (<= 1e-5), gradients max-abs / max {rel:.3g} '
                      f'(<= {tol})', flush=True)
                check(lse_err <= 1e-5, f'lse {shape} {dtype}: max-abs {lse_err:.3g} > 1e-5')
                check(rel <= tol, f'attention backward {shape} causal={causal} {dtype}: '
                                  f'{rel:.3g} > {tol}')
        del q, k, v, do

    B, T, H, D = TRAIN_ATTN_SHAPE
    q, k, v, do = (torch.randn(TRAIN_ATTN_SHAPE, generator=gen).to(device, torch.bfloat16)
                   for _ in range(4))
    o, lse = fused_attention_with_lse(q, k, v, causal=True)
    di = attention_di(o, do)
    args = (q, k, v, do, lse, di)
    leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(*leaves, is_causal=True)
    sdpa_bwd = lambda: torch.autograd.grad(out, leaves, do.transpose(1, 2), retain_graph=True)
    library = time_ms(sdpa_bwd, 10)
    pairs = T * (T + 1) / 2            # (query, key) pairs a causal row set needs
    product = 2.0 * B * H * pairs * D  # one [T, T] x D product over those pairs
    elems, stats = B * T * H * D, B * H * T
    entries = []
    for name, fn, ref, n_products, n_out in (
            ('flash_attention_bwd_dkv', attention_bwd_dkv, attention_bwd_dkv_reference, 4, 2),
            ('flash_attention_bwd_dq', attention_bwd_dq, attention_bwd_dq_reference, 3, 1)):
        b_ms, b_by = bound_ms(n_products * product, PEAK_BF16,
                              2.0 * (4 + n_out) * elems + 4.0 * 2 * stats)
        entry = dict(name=name, route='cuda', source='audiocraft_tpu_torch/csrc/attention_bwd.cu',
                     replaces='audiocraft_tpu/ops/attention_pallas.py:167 (bundled '
                              f'flash_attention.py:{941 if n_out == 2 else 1287} '
                              f'_flash_attention_bwd_{name.rsplit("_", 1)[1]})',
                     max_abs_err=worst[(TRAIN_ATTN_SHAPE, True, torch.bfloat16)],
                     ms=time_ms(lambda: fn(*args, causal=True), 10),
                     plain_ms=time_ms(lambda: ref(*args, causal=True), 3),
                     bound_ms=b_ms, bound_by=b_by, library_ms=library)
        entries.append(entry)
        print(f'{name} bf16 {TRAIN_ATTN_SHAPE} causal: kernel {entry["ms"]:.3f} ms, plain '
              f'{entry["plain_ms"]:.3f} ms, bound {b_ms:.4f} ms ({b_by}; {n_products} products)',
              flush=True)
    whole = bound_ms(5 * product, PEAK_BF16, 2.0 * 7 * elems + 8.0 * stats)[0]
    print(f'attention backward bf16 {TRAIN_ATTN_SHAPE} causal: both kernels '
          f'{entries[0]["ms"] + entries[1]["ms"]:.3f} ms, SDPA backward (dq, dk, dv in one '
          f'call) {library:.3f} ms, bound of the whole backward {whole:.4f} ms '
          f'(5 products, {5 * product / 1e9:.1f} GFLOP)', flush=True)
    return entries[0], entries[1]


def _clips(batch: int, samples: int, device, seed: int) -> torch.Tensor:
    """Seeded test audio: a few random tones plus noise, [batch, 1, samples]."""
    gen = torch.Generator().manual_seed(seed)
    t = torch.arange(samples) / SAMPLE_RATE
    freqs = 50 + 2000 * torch.rand(batch, 4, 1, generator=gen)
    tones = torch.sin(2 * math.pi * freqs * t).sum(1, keepdim=True) * 0.1
    noise = 0.02 * torch.randn(batch, 1, samples, generator=gen)
    return (tones + noise).to(device)


def seed_codebooks(model, wav: torch.Tensor, seed: int = 3) -> None:
    """Codebook q takes random residual frames left after q codebooks, as a
    k-means init would start, so that codes spread over the codebook."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        x = model.encoder(model._cast(wav)).float()
        residual = x.transpose(1, 2).reshape(-1, x.shape[1])
        for layer in model.quantizer.vq.layers:
            cb = layer._codebook
            pick = torch.randperm(residual.shape[0], generator=gen)[:cb.embed.shape[0]]
            cb.embed.copy_(residual[pick.to(residual.device)])
            cb.embed_avg.copy_(cb.embed)
            residual = residual - cb.embed[quantize(residual, cb.embed).long()]


def layer_ms(stack, x: torch.Tensor) -> tp.Tuple[torch.Tensor, tp.List[tp.Tuple[str, float]]]:
    """Run a SEANet stack layer by layer, with CUDA events around each layer."""
    marks = []
    with torch.no_grad():
        for layer in stack.model:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            x = layer(x)
            end.record()
            marks.append((type(layer).__name__, start, end))
    torch.cuda.synchronize()
    return x, [(name, start.elapsed_time(end)) for name, start, end in marks]


def print_breakdown(model, wav: torch.Tensor) -> None:
    """Where one encode and one decode spend device time, by layer kind."""
    emb, enc = layer_ms(model.encoder, model._cast(wav))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    codes = model.quantizer.encode(emb.float())
    latent = model.decode_latent(codes)
    end.record()
    _, dec = layer_ms(model.decoder, model._cast(latent))
    for stack, times in (('encoder', enc), ('decoder', dec)):
        kinds: tp.Dict[str, float] = {}
        for name, ms in times:
            kinds[name] = kinds.get(name, 0.0) + ms
        print(f'{stack} layers (ms): ' + ', '.join(f'{i}:{n} {ms:.2f}' for i, (n, ms)
                                                   in enumerate(times)))
        print(f'{stack} by kind (ms): ' + ', '.join(f'{n} {ms:.2f}' for n, ms in kinds.items())
              + f', total {sum(kinds.values()):.2f}')
    print(f'rvq encode + latent lookup: {start.elapsed_time(end):.2f} ms', flush=True)


def phase_main_path(device) -> dict:
    print('== phase 3: main path, get_encodec_32khz() encode + decode', flush=True)
    model = get_encodec_32khz()
    check(model.compute_dtype == 'bfloat16', 'the 32 kHz default is not bf16')
    seed_codebooks(model, _clips(16, SECONDS * SAMPLE_RATE, device, seed=4))
    wav = _clips(BATCH, SECONDS * SAMPLE_RATE, device, seed=5)
    model.decode(model.encode(wav)[0])   # warm-up, not counted
    torch.cuda.synchronize()

    rvq_encode.launches = lstm_layer.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    codes, scale = model.encode(wav)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = model.decode(codes)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {'rvq_encode': rvq_encode.launches, 'lstm_step': lstm_layer.launches}
    peak = torch.cuda.max_memory_allocated()

    frames = SECONDS * 50
    check(tuple(codes.shape) == (BATCH, 4, frames) and codes.dtype == torch.int32,
          f'codes {tuple(codes.shape)} {codes.dtype}')
    check(bool(((codes >= 0) & (codes < 2048)).all()), 'codes out of range')
    check(tuple(out.shape) == (BATCH, 1, SECONDS * SAMPLE_RATE), f'wav {tuple(out.shape)}')
    check(bool(torch.isfinite(out).all()), 'non-finite waveform')
    check(launches['rvq_encode'] == 1, f"rvq launches {launches['rvq_encode']} != 1")
    check(launches['lstm_step'] == 2 * 2 * frames,
          f"lstm launches {launches['lstm_step']} != {2 * 2 * frames}")
    audio = BATCH * SECONDS
    name = card()
    print(f'codes {tuple(codes.shape)}, {int(codes.unique().numel())} distinct; wav '
          f'{tuple(out.shape)}; launches {launches}')
    print(f'encode {t1 - t0:.4f} s = {audio / (t1 - t0):.1f} audio-s tokenized/s; decode '
          f'{t2 - t1:.4f} s = {audio / (t2 - t1):.1f} audio-s decoded/s; peak memory '
          f'{peak / 2**30:.2f} GiB; card {name}', flush=True)
    print_breakdown(model, wav)
    return launches


def phase_parity(device) -> None:
    print('== phase 4: fp32 parity, card vs CPU (TF32 off)', flush=True)
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          'TF32 is on')
    gpu = get_encodec_32khz(compute_dtype=None)
    cpu = get_encodec_32khz(compute_dtype=None, device='cpu')
    seed_codebooks(gpu, _clips(8, SECONDS * SAMPLE_RATE, device, seed=6))
    wav = _clips(8, 2 * SAMPLE_RATE, device, seed=7)
    cpu.quantizer.load_state_dict(gpu.quantizer.state_dict())
    with torch.no_grad():
        lat_gpu = gpu.encoder(wav).float()
        lat_cpu = cpu.encoder(wav.cpu()).float()
        rel = float((lat_gpu.cpu() - lat_cpu).abs().max() / lat_cpu.abs().max())
        share = float((gpu.quantizer.encode(lat_gpu).cpu()
                       == cpu.quantizer.encode(lat_cpu)).float().mean())
    print(f'encoder latent [8, 128, 100]: max-abs / max {rel:.3g} (<= 1e-4); '
          f'code match share {share:.6f} (>= 0.995)', flush=True)
    check(rel <= 1e-4, f'latent rel {rel:.3g} > 1e-4')
    check(share >= 0.995, f'code match share {share:.6f} < 0.995')


def set_attn_kernel(lm, flag) -> None:
    """Route every self-attention of ``lm`` by ``flag`` (see ops.attention.kernel_route)."""
    for layer in lm.transformer.layers:
        layer.self_attn.attn_kernel = flag


def _descriptions(n: int, device, seed: int) -> dict:
    """n seeded T5 id rows of DESC_LEN, then n null rows (mask 0): what the
    CFG dropout of the facade yields for n descriptions."""
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(1, 32100, (n, DESC_LEN), generator=gen)
    ids = torch.cat([ids, torch.zeros_like(ids)])
    mask = torch.cat([torch.ones(n, DESC_LEN, dtype=torch.long),
                      torch.zeros(n, DESC_LEN, dtype=torch.long)])
    return {'description': (ids.to(device), mask.to(device))}


def _stage_sequence(lm, batch: int, device, seed: int) -> torch.Tensor:
    """A stage-0 input: all mask ids but a seeded quarter of the positions."""
    gen = torch.Generator().manual_seed(seed)
    T = MAGNET_SECONDS * 50
    seq = torch.full((batch, lm.n_q, T), lm.special_token_id, dtype=torch.long)
    keep = torch.rand(batch, lm.n_q, T, generator=gen) < 0.25
    seq[keep] = torch.randint(0, lm.card, (int(keep.sum()),), generator=gen)
    return seq.to(device)


def phase_magnet(device, lm32, provider32, codec) -> dict:
    print('== phase 5: MAGNeT path, get_magnet_lm(small, 30 s) generate + codec decode',
          flush=True)
    lm = copy.deepcopy(lm32).to(torch.bfloat16)
    provider = copy.deepcopy(provider32).to(torch.bfloat16)
    tokenized = _descriptions(PROMPTS, device, seed=20)
    with torch.no_grad():   # warm-up: one stage-0 forward, not counted
        cond = provider(tokenized)
        lm(_stage_sequence(lm, 2 * PROMPTS, device, seed=21), cond)
    torch.cuda.synchronize()

    gen = torch.Generator().manual_seed(22)
    rvq_encode.launches = lstm_layer.launches = fused_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        cond = provider(tokenized)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tokens = lm.generate_magnet(gen, condition_tensors=cond, num_samples=PROMPTS,
                                max_gen_len=MAGNET_SECONDS * 50)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    attn_launches = fused_attention.launches
    audio = codec.decode(tokens)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = {'flash_attention': attn_launches, 'lstm_step': lstm_layer.launches,
                'rvq_encode': rvq_encode.launches}
    peak = torch.cuda.max_memory_allocated()

    frames = MAGNET_SECONDS * 50
    n_layers = len(lm.transformer.layers)
    check(tuple(tokens.shape) == (PROMPTS, 4, frames), f'tokens {tuple(tokens.shape)}')
    check(bool(((tokens >= 0) & (tokens < lm.card)).all()), 'tokens out of range or masked')
    check(tuple(audio.shape) == (PROMPTS, 1, frames * 640), f'audio {tuple(audio.shape)}')
    check(bool(torch.isfinite(audio).all()), 'non-finite audio')
    check(attn_launches == 20 * n_layers,
          f'attention launches {attn_launches} != 20 stage-0 forwards x {n_layers} layers')
    check(launches['lstm_step'] == 2 * frames, f"lstm launches {launches['lstm_step']}")
    audio_s = PROMPTS * MAGNET_SECONDS
    print(f'tokens {tuple(tokens.shape)}, {int(tokens.unique().numel())} distinct; audio '
          f'{tuple(audio.shape)}; launches {launches}')
    print(f'conditions {t1 - t0:.4f} s, generate {t2 - t1:.4f} s, decode {t3 - t2:.4f} s: '
          f'{audio_s / (t3 - t0):.2f} audio-s generated/s end to end '
          f'({audio_s / (t2 - t1):.2f} for the generate alone); peak memory '
          f'{peak / 2**30:.2f} GiB; card {card()}', flush=True)

    with torch.no_grad():
        seq = torch.cat([tokens, tokens])
        cross_kv = lm.transformer.precompute_cross_kv(lm.cross_source(cond, 2 * PROMPTS))
        band = lm.restricted_context_attn_mask(frames, device)
        stage0 = time_ms(lambda: lm(seq, cond, cross_kv=cross_kv), 3)
        banded = time_ms(lambda: lm(seq, cond, cross_kv=cross_kv, attn_mask=band), 3)
        t5 = time_ms(lambda: provider(tokenized), 5)
    print(f'one forward at B={2 * PROMPTS} T={frames}: stage 0 (attention kernel) '
          f'{stage0:.2f} ms, stages 1-3 (plain banded attention) {banded:.2f} ms; '
          f'T5-base encoder + projection at B={2 * PROMPTS} L={DESC_LEN}: {t5:.3f} ms',
          flush=True)
    del lm, provider, cond, cross_kv

    facade = get_debug_magnet()
    audio, tokens = facade.generate(['a short jingle'], generator=torch.Generator().manual_seed(23),
                                    return_tokens=True)
    torch.cuda.synchronize()
    check(tokens.shape[:2] == (1, 4) and bool(((tokens >= 0) & (tokens < 400)).all()),
          f'debug facade tokens {tuple(tokens.shape)}')
    check(bool(torch.isfinite(audio).all()), 'debug facade: non-finite audio')
    print(f'debug facade on {audio.device}: tokens {tuple(tokens.shape)}, audio '
          f'{tuple(audio.shape)}', flush=True)
    return launches


def phase_magnet_parity(device, lm, provider) -> None:
    print('== phase 6: MAGNeT parity in fp32 (TF32 off), attention kernel vs plain path',
          flush=True)
    check(not torch.backends.cuda.matmul.allow_tf32, 'TF32 is on')
    n = 2
    with torch.no_grad():
        cond = provider(_descriptions(n, device, seed=30))
        seq = _stage_sequence(lm, 2 * n, device, seed=31)
        set_attn_kernel(lm, 'auto')
        before = fused_attention.launches
        fast = lm(seq, cond)
        check(fused_attention.launches - before == len(lm.transformer.layers),
              'the stage-0 forward did not take the attention kernel')
        set_attn_kernel(lm, False)
        plain = lm(seq, cond)
    rel = float((fast - plain).abs().max() / plain.abs().max())
    share = float((fast.argmax(-1) == plain.argmax(-1)).float().mean())
    print(f'stage-0 logits [{2 * n}, 4, {seq.shape[-1]}, {lm.card}]: max-abs / max {rel:.3g} '
          f'(<= 1e-4), argmax share {share:.6f} (>= 0.999)', flush=True)
    check(rel <= 1e-4, f'stage-0 logits rel {rel:.3g} > 1e-4')
    check(share >= 0.999, f'stage-0 argmax share {share:.6f} < 0.999')
    tokens = {}
    for flag in ('auto', False):
        set_attn_kernel(lm, flag)
        tokens[flag] = lm.generate_magnet(torch.Generator().manual_seed(32),
                                          condition_tensors=cond, num_samples=n,
                                          max_gen_len=MAGNET_SECONDS * 50, use_sampling=False)
    set_attn_kernel(lm, 'auto')
    match = float((tokens['auto'] == tokens[False]).float().mean())
    print(f'greedy generate, kernel route vs plain route: token match share {match:.6f} '
          f'(information; re-masking feeds back its own choices)', flush=True)


def _train_conditions(provider, n: int, device, seed: int,
                      cfg_drop: tp.Optional[ClassifierFreeGuidanceDropout] = None) -> dict:
    """Condition tensors of n seeded T5 id rows of DESC_LEN, computed under
    no_grad.  With ``cfg_drop`` the training app's CFG dropout nullifies the
    descriptions (all or none, as the reference does), and a nullified row
    gets mask 0, as the T5 conditioner gives an empty text."""
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(1, 32100, (n, DESC_LEN), generator=gen)
    mask = torch.ones(n, DESC_LEN, dtype=torch.long)
    if cfg_drop is not None:
        attrs = cfg_drop([ConditioningAttributes(text={'description': f'row {i}'})
                          for i in range(n)])
        for i, attr in enumerate(attrs):
            if attr.text['description'] is None:
                mask[i] = 0
    with torch.no_grad():
        return provider({'description': (ids.to(device), mask.to(device))})


def _launch_counts() -> tp.Dict[str, int]:
    return {'flash_attention': fused_attention.launches,
            'flash_attention_bwd_dkv': attention_bwd_dkv.launches,
            'flash_attention_bwd_dq': attention_bwd_dq.launches,
            'rvq_encode': rvq_encode.launches, 'lstm_step': lstm_layer.launches}


def _reset_launch_counts() -> None:
    fused_attention.launches = attention_bwd_dkv.launches = attention_bwd_dq.launches = 0
    rvq_encode.launches = lstm_layer.launches = 0


def print_train_breakdown(lm, optimizer, state, codec, wav, codes, cond) -> None:
    """Where one training step spends device time: codec encode, forward
    (to the loss), backward, optimizer update, with CUDA events."""
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    params = list(lm.parameters())
    marks[0].record()
    codec.encode(wav)
    marks[1].record()
    loss = lm_loss(lm, codes, cond, compute_dtype='bfloat16')
    marks[2].record()
    grads = torch.autograd.grad(loss, params)
    marks[3].record()
    optimizer.update(grads, state, params)
    marks[4].record()
    torch.cuda.synchronize()
    parts = [marks[i].elapsed_time(marks[i + 1]) for i in range(4)]
    print('training step split (ms): ' + ', '.join(
        f'{name} {ms:.2f}' for name, ms in zip(('codec encode', 'forward', 'backward',
                                                 'optimizer'), parts))
          + f', total {sum(parts):.2f}', flush=True)


def print_train_profile(step, state, codes, cond) -> None:
    """torch.profiler over one LM step: device busy time against the step's
    wall time (both under the profiler), and the kernels that take most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, codes, cond)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        print('profiler: no device time seen', flush=True)
        return
    print(f'profiled LM step: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms wall, idle share '
          f'{1 - busy_ms / wall_ms:.3f} (under the profiler); top kernels (ms, calls): ' + '; '.join(
              f'{e.key[:70]} {e.self_device_time_total / 1e3:.2f} {e.count}' for e in kernels[:8]),
          flush=True)


def phase_train(device, lm, provider) -> tp.Dict[str, int]:
    print("== phase 7: training path, get_musicgen_lm('small') + get_encodec_32khz() encode, "
          'AdamW in bf16 compute on fp32 masters', flush=True)
    codec = get_encodec_32khz()
    samples = TRAIN_SECONDS * SAMPLE_RATE
    seed_codebooks(codec, _clips(8, SECONDS * SAMPLE_RATE, device, seed=40))
    wav = _clips(TRAIN_BATCH, samples, device, seed=41)   # the fixed batch
    optimizer = make_optimizer('adamw', TRAIN_LR, betas=(0.9, 0.95), weight_decay=0.1)
    step = make_lm_train_step(lm, optimizer, compute_dtype='bfloat16')
    state = optimizer.init(list(lm.parameters()))
    cfg_drop = ClassifierFreeGuidanceDropout(p=0.1, seed=42)
    n_layers = len(lm.transformer.layers)

    def one_step():
        cond = _train_conditions(provider, TRAIN_BATCH, device, seed=43, cfg_drop=cfg_drop)
        t0 = time.perf_counter()
        codes = codec.encode(wav)[0]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss = float(step(state, codes, cond)['loss'])   # synchronises
        return codes, cond, loss, t1 - t0, time.perf_counter() - t1

    one_step()   # warm-up, not counted
    _reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, encode_s, step_s, per_step = [], [], [], []
    for i in range(TRAIN_STEPS):
        before = _launch_counts()
        codes, cond, loss, t_enc, t_step = one_step()
        after = _launch_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        losses.append(loss)
        encode_s.append(t_enc)
        step_s.append(t_step)
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()

    B, K, T = codes.shape
    check((B, K, T) == (TRAIN_BATCH, 4, TRAIN_SECONDS * 50), f'codes {tuple(codes.shape)}')
    expect = {'flash_attention': n_layers, 'flash_attention_bwd_dkv': n_layers,
              'flash_attention_bwd_dq': n_layers, 'rvq_encode': 1, 'lstm_step': 2 * T}
    for i, counts in enumerate(per_step):
        check(counts == expect, f'step {i} launches {counts} != {expect}')
    check(all(math.isfinite(x) for x in losses), f'non-finite loss {losses}')
    check(losses[-1] < losses[0], f'the loss did not fall: {losses}')
    check(all(p.dtype == torch.float32 for p in lm.parameters()), 'master parameters not fp32')

    mean_enc, mean_step = sum(encode_s) / TRAIN_STEPS, sum(step_s) / TRAIN_STEPS
    audio = TRAIN_BATCH * TRAIN_SECONDS
    print(f'losses {[round(x, 5) for x in losses]}; launches over {TRAIN_STEPS} steps '
          f'{launches}')
    print(f'step (mean of {TRAIN_STEPS}): codec encode {mean_enc * 1e3:.1f} ms, LM step '
          f'{mean_step * 1e3:.1f} ms; {B * K * T / mean_step:.0f} codes trained/s by the LM '
          f'step, {B * K * T / (mean_enc + mean_step):.0f} with the encode; '
          f'{audio / (mean_enc + mean_step):.2f} audio-s trained/s; peak memory '
          f'{peak / 2**30:.2f} GiB; card {card()}', flush=True)
    print(f'step times (s): encode {[round(x, 4) for x in encode_s]}, LM '
          f'{[round(x, 4) for x in step_s]}', flush=True)
    print_train_breakdown(lm, optimizer, state, codec, wav, codes, cond)
    print_train_profile(step, state, codes, cond)

    # the gradient of every parameter, the self-attention projections included
    _, grads = lm_loss_and_grads(lm, codes, cond, compute_dtype='bfloat16')
    names = [name for name, _ in lm.named_parameters()]
    for name, g in zip(names, grads):
        check(bool(torch.isfinite(g).all()), f'{name}: non-finite gradient')
        parts = g.chunk(3) if name.endswith('self_attn.in_proj_weight') else (g,)
        check(all(float(part.abs().max()) > 0 for part in parts), f'{name}: zero gradient')
    in_proj = sum(name.endswith('self_attn.in_proj_weight') for name in names)
    check(in_proj == n_layers, f'{in_proj} self-attention projections')
    print(f'gradients: {len(names)} parameters finite and non-zero, the q, k and v rows of '
          f'{in_proj} self_attn.in_proj_weight included', flush=True)
    del grads, state

    train_lm.main(['--debug', '--synthetic', '--steps', '2', '--log-every', '1'])
    torch.cuda.synchronize()
    print('training CLI: --debug --synthetic --steps 2 on the card', flush=True)
    return launches


def phase_train_parity(device, lm, provider) -> None:
    print('== phase 8: training parity in fp32 (TF32 off), kernel route vs plain route',
          flush=True)
    check(not torch.backends.cuda.matmul.allow_tf32, 'TF32 is on')
    codec = get_encodec_32khz()
    seed_codebooks(codec, _clips(8, SECONDS * SAMPLE_RATE, device, seed=50))
    codes = codec.encode(_clips(2, SECONDS * SAMPLE_RATE, device, seed=51))[0]
    cond = _train_conditions(provider, 2, device, seed=52)
    n_layers = len(lm.transformer.layers)
    start = {k: v.clone() for k, v in lm.state_dict().items()}
    results = {}
    for flag in ('auto', False):
        set_attn_kernel(lm, flag)
        before = _launch_counts()
        loss, grads = lm_loss_and_grads(lm, codes, cond)
        after = _launch_counts()
        if flag:
            for name in ('flash_attention', 'flash_attention_bwd_dkv', 'flash_attention_bwd_dq'):
                check(after[name] - before[name] == n_layers,
                      f'kernel route: {name} launched {after[name] - before[name]} times')
        results[flag] = (float(loss), grads)
    (loss_k, grads_k), (loss_p, grads_p) = results['auto'], results[False]
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    worst, worst_name = 0.0, ''
    for (name, _), gk, gp in zip(lm.named_parameters(), grads_k, grads_p):
        top = float(gp.abs().max())
        err = float((gk - gp).abs().max()) / top if top > 0 else float(gk.abs().max())
        if err > worst:
            worst, worst_name = err, name
    diff = torch.sqrt(sum((gk - gp).double().square().sum() for gk, gp in zip(grads_k, grads_p)))
    norm = torch.sqrt(sum(gp.double().square().sum() for gp in grads_p))
    rel_l2 = float(diff / norm)
    print(f'B=2 T={codes.shape[-1]} fp32: loss {loss_k:.6f} vs {loss_p:.6f}, relative '
          f'{rel_loss:.3g} (<= 1e-5); worst parameter gradient max-abs / max {worst:.3g} '
          f'({worst_name}, <= 1e-3); whole gradient relative L2 {rel_l2:.3g} (<= 1e-4)',
          flush=True)
    check(rel_loss <= 1e-5, f'fp32 loss relative {rel_loss:.3g} > 1e-5')
    check(worst <= 1e-3, f'{worst_name}: gradient max-abs / max {worst:.3g} > 1e-3')
    check(rel_l2 <= 1e-4, f'gradient relative L2 {rel_l2:.3g} > 1e-4')
    del results, grads_k, grads_p

    trajectories, finals = {}, {}
    for flag in ('auto', False):
        set_attn_kernel(lm, flag)
        lm.load_state_dict(start)
        optimizer = make_optimizer('adamw', TRAIN_LR, betas=(0.9, 0.95), weight_decay=0.1)
        step = make_lm_train_step(lm, optimizer)
        state = optimizer.init(list(lm.parameters()))
        trajectories[flag] = [float(step(state, codes, cond)['loss']) for _ in range(3)]
        finals[flag] = [p.detach().clone() for p in lm.parameters()]
    set_attn_kernel(lm, 'auto')
    rels = [abs(a - b) / abs(b) for a, b in zip(trajectories['auto'], trajectories[False])]
    moved = max(float((a - b).abs().max()) for a, b in zip(finals['auto'], finals[False]))
    print(f'3 AdamW steps (lr {TRAIN_LR}): losses kernel {trajectories["auto"]}, plain '
          f'{trajectories[False]}; relative {[f"{r:.3g}" for r in rels]} (step 1 <= 1e-5, '
          f'later <= 1e-4: Adam turns rounding of near-zero gradients into whole lr steps); '
          f'parameters max-abs apart {moved:.3g} (information)', flush=True)
    check(rels[0] <= 1e-5 and max(rels[1:]) <= 1e-4, f'AdamW losses apart: {rels}')


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print('TF32 off for fp32 matmuls and convolutions')
    device = torch.device('cuda')
    phase_build()
    kernels = phase_kernels(device)
    launches = phase_main_path(device)
    phase_parity(device)
    lm, provider = get_magnet_lm('small', segment_duration=MAGNET_SECONDS)
    magnet_launches = phase_magnet(device, lm, provider, get_encodec_32khz())
    phase_magnet_parity(device, lm, provider)
    del lm, provider
    lm, provider = get_musicgen_lm('small', seed=1)
    train_launches = phase_train(device, lm, provider)
    phase_train_parity(device, lm, provider)
    launches['flash_attention'] = magnet_launches['flash_attention']
    for name in ('flash_attention_bwd_dkv', 'flash_attention_bwd_dq'):
        launches[name] = train_launches[name]
    for name, n in launches.items():
        kernels[name]['launches'] = n
    keys = ('name', 'route', 'source', 'replaces', 'launches', 'max_abs_err', 'ms',
            'plain_ms', 'bound_ms', 'bound_by', 'library_ms')
    print(card())
    print(json.dumps({'kernels': [{k: kern[k] for k in keys} for kern in kernels.values()]}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
