#!/usr/bin/env python3
"""Drive the PyTorch port (``audiocraft_tpu_torch``) on one CUDA card.

Run from the repository root, with no arguments:  python3 chip_smoke.py

1. Card and build: prints the card's name and power limit, builds the CUDA
   kernels from ``audiocraft_tpu_torch/csrc`` and prints the build time;
   the attention route's widest head must equal the kernels'.
2. Kernels against their plain PyTorch versions, on the card, at the main
   paths' shapes: RVQ encode (codes equal, near-ties excluded and counted,
   D from 32 to 1024), one LSTM layer (fp32 and bf16; one cooperative
   launch a layer, timed at B = 128 and B = 4 beside cuDNN) and flash
   attention (fp32 and bf16, causal and not, at MAGNeT-small's
   [8, 1500, 16, 64] and off the tiles; heads of 256 take the plain path),
   each timed beside its bound, its plain version and, where one exists, one
   PyTorch call computing the same thing.
3. The codec path: ``get_encodec_32khz()`` (bf16, random weights from a
   seed) tokenizes and reconstructs 128 clips of 10 s; both codec kernels'
   launch counts must rise during that run.
4. fp32 codec parity: the same weights with ``compute_dtype=None`` on the
   card and on the CPU (plain versions), with torch's default TF32 flags:
   the codec turns cuDNN's TF32 off itself.
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
   kernel route against the plain route, then three AdamW steps on each;
   and the bf16-compute gradients of both routes on the same batch.
9. The fused encode path: ``get_encodec_32khz()`` encodes 128 clips of 10 s
   three times on each route, the default, ``fused=True`` (the input conv
   and two stages through K4) and ``conv0_kernel=True`` (K5); K4 must launch
   twice per fused encode, K5 once per ``conv0_kernel`` encode, K1 once and
   K2 twice per encode on every route; each route's bf16 latent is held
   against the default route's, and the fp32 latent of the fused and K5
   routes against the plain route on the CPU.
10. The data-movement probe (P1): ``apps/probe_ops`` runs its seven bf16
   operations on the card, each of which must equal torch's result.
Phase 2 also holds K3b (the attention backward, both dtypes, at the model
shapes and the tiles' edges), K4
(both 32 kHz stage shapes), K5 and K6 against their plain versions.  Then
one JSON line on the kernels and, last, one JSON line with the result.
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

from audiocraft_tpu_torch.apps import probe_ops, train_lm
from audiocraft_tpu_torch.builders import get_encodec_32khz, get_magnet_lm, get_musicgen_lm
from audiocraft_tpu_torch.cond.attributes import (ClassifierFreeGuidanceDropout,
                                                  ConditioningAttributes)
from audiocraft_tpu_torch.dist.train import lm_loss, lm_loss_and_grads, make_lm_train_step
from audiocraft_tpu_torch.gen.magnet import get_debug_magnet
from audiocraft_tpu_torch.nn.transformer import StreamingMultiheadAttention
from audiocraft_tpu_torch.ops import _build, attention
from audiocraft_tpu_torch.ops import lstm as lstm_ops
from audiocraft_tpu_torch.ops.attention import (
    attention_bwd_dkv, attention_bwd_dkv_reference, attention_bwd_dq, attention_bwd_dq_reference,
    attention_di, attention_lse_reference, fused_attention, fused_attention_backward,
    fused_attention_backward_reference, fused_attention_reference, fused_attention_with_lse)
from audiocraft_tpu_torch.ops.lstm import lstm_kernel_info, lstm_layer, lstm_layer_reference
from audiocraft_tpu_torch.ops.probe import gather, split_contract, split_contract_reference
from audiocraft_tpu_torch.ops.rvq import rvq_encode, rvq_encode_reference
from audiocraft_tpu_torch.ops.seanet import (
    StageSpec, banded_mono_conv, banded_mono_conv_reference, fused_encoder_apply, fused_stage,
    fused_stage_reference, mono_input_conv, mono_input_conv_reference)
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
# the two stages that encode(fused=True) runs through K4 at 32 kHz, b128 x 10 s
STAGES = ((StageSpec(c_in=64, c_out=128, stride=4), SECONDS * SAMPLE_RATE),
          (StageSpec(c_in=128, c_out=256, stride=4), SECONDS * SAMPLE_RATE // 4))
CONV0_CHANNELS, CONV0_TAPS = 64, 7
ENCODES = 3   # timed encodes per route in phase 9


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
    lib = _build.library()
    print(f'build: {result.seconds:.1f} s -> {result.path.name}')
    for line in result.log.splitlines():
        if 'registers' in line or 'spill' in line or 'error' in line:
            print('  ptxas:', line.strip())
    check(attention.MAX_HEAD_DIM == lib.acx_attention_max_dim(),
          f'ops/attention.py MAX_HEAD_DIM {attention.MAX_HEAD_DIM} != the kernels\' '
          f'{lib.acx_attention_max_dim()}')
    print(f'attention route: heads up to {attention.MAX_HEAD_DIM} wide take the kernels '
          f'(the library says {lib.acx_attention_max_dim()}); RVQ kernel rows up to '
          f'D = {lib.acx_rvq_max_dim()}', flush=True)


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
    debug codec's D = 32 and K = 400 with N not a multiple of 64, and at the
    style conditioner's widths D = 256, 512 and 1024 (64 residual rows a
    block up to D = 832, 32 above); LSTM with B and H not multiples of 8 or
    of the units a block owns; and a row wider than the RVQ kernel's maximum
    (1024), which must raise.  Then the RVQ kernel timed at D = 1024 beside
    D = 128 on the style conditioner's codebooks (K = 1024, n_q = 6)."""
    nears = []
    for n, d, k in ((517, 32, 400), (301, 256, 400), (301, 512, 1024), (517, 1024, 1024)):
        x, embeds = _rvq_inputs(device, n=n, d=d, k=k, n_q=4, seed=8 + d)
        nears.append(f'D={d}: {int(check_rvq(x, embeds)[2].sum())}')
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
        rvq_encode(torch.zeros(8, 1032, device=device), torch.zeros(1, 16, 1032, device=device))
    except ValueError:
        pass
    else:
        raise CheckFailed('rvq: D = 1032 did not raise')
    print(f'off-tile shapes: rvq N=517 D=32 K=400, N=301 D=256 K=400, N=301 D=512 K=1024, '
          f'N=517 D=1024 K=1024 codes equal (near-tie rows excluded: {", ".join(nears)}); '
          f'lstm T={T} B={B} C={C} H={H} max-abs fp32 {errs[0]:.3g} (<= 1e-5), '
          f'bf16 {errs[1]:.3g} (<= 5e-2); D=1032 refused', flush=True)
    times = {}
    for d in (128, 1024):
        x, embeds = _rvq_inputs(device, n=8192, d=d, k=1024, n_q=6, seed=12)
        times[d] = time_ms(lambda: rvq_encode(x, embeds), 5)
        del x, embeds
    print(f'rvq N=8192 K=1024 n_q=6: kernel D=128 {times[128]:.3f} ms, D=1024 '
          f'{times[1024]:.3f} ms ({times[1024] / times[128]:.2f}x for 8x the width)', flush=True)


def _lstm_args(T: int, B: int, H: int, seed: int) -> tp.List[torch.Tensor]:
    """Seeded x [T, B, H] and weights uniform in +-1/sqrt(H), as the codec's init."""
    gen = torch.Generator().manual_seed(seed)
    bound = 1.0 / math.sqrt(H)
    weights = [(torch.rand(shape, generator=gen) * 2 - 1) * bound
               for shape in ((4 * H, H), (4 * H, H), (4 * H,), (4 * H,))]
    return [torch.randn(T, B, H, generator=gen) * 0.5, *weights]


def plan_text(plan) -> str:
    return f'{plan.grid} blocks of {plan.units} units x {plan.batch_rows} batch rows'


def _cudnn_lstm(args: tp.List[torch.Tensor]) -> tp.Tuple[torch.nn.LSTM, bool]:
    """cuDNN's nn.LSTM with the layer's weights, packed once into cuDNN's
    flat buffer.  nn.LSTM packs only fp16 and fp32 weights itself; unpacked
    bf16 weights are copied into a fresh buffer (8 MB at H = 1024) on every
    call, which would be timed with it.  Returns the module and whether a
    call ran on the packed buffer (cuDNN warns when it has to repack)."""
    H = args[0].shape[-1]
    cudnn = torch.nn.LSTM(H, H, num_layers=1).to(args[0].device, args[0].dtype)
    with torch.no_grad(), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        for p, w in zip((cudnn.weight_ih_l0, cudnn.weight_hh_l0, cudnn.bias_ih_l0,
                         cudnn.bias_hh_l0), args[1:]):
            p.copy_(w)
        try:
            torch._cudnn_rnn_flatten_weight(
                cudnn._flat_weights, 4, H, torch.backends.cudnn.rnn.get_cudnn_mode('LSTM'),
                H, 0, 1, False, False)
        except (RuntimeError, AttributeError) as exc:   # timed repacking, and said so
            print(f'cuDNN did not pack the {args[0].dtype} LSTM weights: {exc}', flush=True)
        cudnn(args[0])
        torch.cuda.synchronize()
    packed = not any('not part of single contiguous' in str(w.message) for w in caught)
    return cudnn, packed


def time_lstm(args: tp.List[torch.Tensor], reps: int) -> dict:
    """One bf16 layer on the card: the kernel held against its plain version
    on the same inputs (max-abs <= 5e-2, as at the codec's shape), both timed
    beside cuDNN's nn.LSTM with its weights packed once, the bound, and the
    kernel's plan and resources."""
    T, B, H = args[0].shape
    out = lstm_layer(*args)
    ref = lstm_layer_reference(*args)
    err = float((out.float() - ref.float()).abs().max())
    check(bool(torch.isfinite(out).all()), f'lstm bf16 T={T} B={B}: non-finite output')
    check(err <= 5e-2, f'lstm bf16 T={T} B={B} H={H}: max-abs {err:.3g} > 5e-2')
    cudnn, packed = _cudnn_lstm(args)
    with torch.no_grad(), warnings.catch_warnings():
        warnings.filterwarnings('ignore', message='RNN module weights are not part')
        cudnn_err = float((cudnn(args[0])[0].float() - ref.float()).abs().max())
        library = time_ms(lambda: cudnn(args[0]), reps)
    del out, ref, cudnn
    ops = 2.0 * T * B * 4 * H * (H + H)          # input projection + recurrence
    nbytes = 2.0 * (2 * T * B * H + 8 * H * H + 8 * H)
    b_ms, b_by = bound_ms(ops, PEAK_BF16, nbytes)
    plan = lstm_ops.device_plan(H, B, torch.bfloat16, args[0].device)
    info = lstm_kernel_info(torch.bfloat16, plan)
    entry = dict(ms=time_ms(lambda: lstm_layer(*args), reps),
                 plain_ms=time_ms(lambda: lstm_layer_reference(*args), 1),
                 bound_ms=b_ms, bound_by=b_by, library_ms=library)
    print(f"lstm one bf16 layer T={T} B={B} H={H}: max-abs against plain {err:.3g} (<= 5e-2); "
          f"kernel {entry['ms']:.3f} ms ({entry['ms'] * 1e3 / T:.2f} us per step), plain "
          f"{entry['plain_ms']:.3f} ms, cuDNN nn.LSTM {library:.3f} ms "
          f"({library * 1e3 / T:.2f} us per step; weights "
          f"{'packed once' if packed else 'repacked on every call'}; max-abs against plain "
          f"{cudnn_err:.3g}, information), bound {b_ms:.3f} ms ({b_by}); plan: "
          f"{plan_text(plan)}, batch tile {plan.batch_tile}, K chunk "
          f"{plan.k_chunk} in a ring of {plan.stages}, weight slice {plan.weight_bytes} B "
          f"{'resident' if plan.resident else 'streamed'}, {plan.smem_bytes} B dynamic shared "
          f"memory a block; {info['registers']} registers x {info['threads']} threads, "
          f"{info['static_shared_bytes']} B static shared, {info['spill_bytes']} B spilled",
          flush=True)
    return entry


def check_lstm(device) -> dict:
    """K2 against its plain version at the codec's shape, T = 500, B = 128,
    H = 1024: fp32 within 1e-4 (TF32 plays no part; only the order of the
    fp32 sums differs, over 500 steps), bf16 within 5e-2 (bf16 products are
    exact in fp32; the sums' order moves a bf16-stored h by a step, which the
    recurrence carries).  Then one bf16 layer checked (5e-2) and timed at the
    training encode's and MAGNeT decode's shape, T = 1500, B = 4, at B = 4
    to 128 for T = 500, and at the codec's shape."""
    T, B, H = LSTM_SHAPE['t'], LSTM_SHAPE['b'], LSTM_SHAPE['h']
    x, *weights = _lstm_args(T, B, H, seed=2)
    errs = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
        args = [a.to(device, dtype) for a in (x, *weights)]
        out = lstm_layer(*args)
        ref = lstm_layer_reference(*args)
        errs[dtype] = float((out.float() - ref.float()).abs().max())
        check(bool(torch.isfinite(out).all()), f'lstm {dtype}: non-finite output')
        check(errs[dtype] <= tol, f'lstm {dtype}: max-abs {errs[dtype]:.3g} > {tol}')
    print(f'lstm T={T} B={B} H={H}: max-abs fp32 {errs[torch.float32]:.3g} (<= 1e-4), '
          f'bf16 {errs[torch.bfloat16]:.3g} (<= 5e-2)', flush=True)
    del out, ref, args
    small = [a.to(device, torch.bfloat16) for a in _lstm_args(1500, 4, H, seed=3)]
    time_lstm(small, 10)
    del small
    sweep, sweep_err = {}, {}
    for b in (4, 8, 16, 32, 64, 128):   # how a step grows with the bytes of h
        a = [t.to(device, torch.bfloat16) for t in _lstm_args(T, b, H, seed=4)]
        sweep_err[b] = float((lstm_layer(*a).float() - lstm_layer_reference(*a).float())
                             .abs().max())
        check(sweep_err[b] <= 5e-2, f'lstm bf16 T={T} B={b}: max-abs {sweep_err[b]:.3g} > 5e-2')
        sweep[b] = time_ms(lambda: lstm_layer(*a), 3) * 1e3 / T
    print(f'lstm one bf16 layer T={T} H={H}, us per step by batch: '
          + ', '.join(f'B={b} {us:.2f}' for b, us in sweep.items())
          + f'; max-abs against plain <= {max(sweep_err.values()):.3g} (<= 5e-2)', flush=True)
    # timed in bf16, the main path's dtype
    args = [a.to(device, torch.bfloat16) for a in (x, *weights)]
    entry = time_lstm(args, 10)
    # the same layer with the plan held to one batch group (128 blocks of 8
    # units over all 128 rows), timed in this call beside the plan's split
    whole = lstm_ops.fit_plan(H, B, torch.bfloat16, 8, 1, True,
                              lstm_ops.device_limits(device.index or 0)[1])
    chosen = lstm_ops.device_plan
    lstm_ops.device_plan = lambda *_: whole
    try:
        check(float((lstm_layer(*args).float() - lstm_layer_reference(*args).float())
                    .abs().max()) <= 5e-2, 'lstm bf16, one batch group: max-abs > 5e-2')
        one_group = time_ms(lambda: lstm_layer(*args), 3)
    finally:
        lstm_ops.device_plan = chosen
    print(f'lstm one bf16 layer T={T} B={B} H={H} held to one batch group ({whole.grid} blocks '
          f'of {whole.units} units x {whole.batch_rows} rows, information): {one_group:.3f} ms '
          f'({one_group * 1e3 / T:.2f} us per step), against {entry["ms"]:.3f} ms for the '
          f'plan\'s {plan_text(lstm_ops.device_plan(H, B, torch.bfloat16, device))}', flush=True)
    return dict(name='lstm_step', route='cuda', source='audiocraft_tpu_torch/csrc/lstm.cu',
                replaces='audiocraft_tpu/ops/lstm_pallas.py:44',
                max_abs_err=errs[torch.bfloat16], **entry)


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

    results['lstm_step'] = check_lstm(device)
    results['flash_attention'] = check_attention(device)
    dkv, dq = check_attention_backward(device)
    results[dkv['name']], results[dq['name']] = dkv, dq
    results['fused_stage'] = check_fused_stage(device)
    results.update(check_mono_conv(device))
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
    tiles; D = 256 must raise when the kernel is called, and a transformer
    layer with heads of 256 and attn_kernel='auto' must take the plain path
    by shape, launch nothing and equal the plain route (fp32, 1e-5).  Then
    times at S = 1500 and 500 in bf16."""
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
    wide = []
    for causal in (False, True):
        layer = StreamingMultiheadAttention(512, 2, causal=causal, attn_kernel='auto',
                                            generator=gen).to(device)
        x = torch.randn(2, 300, 512, generator=gen).to(device)
        before = fused_attention.launches
        with torch.no_grad():
            out = layer(x)
            layer.attn_kernel = False
            plain = layer(x)
        check(fused_attention.launches == before, 'a head of 256 launched the attention kernel')
        wide.append(float((out - plain).abs().max()))
        check(wide[-1] <= 1e-5, f'attention layer D=256 causal={causal}: {wide[-1]:.3g} > 1e-5')
    print(f"attention layer E=512, 2 heads of 256, attn_kernel='auto', T=300: plain path by "
          f'shape, no launch; max-abs against attn_kernel=False {wide[0]:.3g} / causal '
          f'{wide[1]:.3g} (<= 1e-5)', flush=True)

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
    gradient, worst gradient max-abs).  A gradient that is zero in exact
    arithmetic is rounding noise on both sides (dq and dk at T = 1, where
    P = 1 and dS = dP - di = 0), so each gradient's max-abs is floored at
    1e-2 of the largest of the three."""
    o, lse = fused_attention_with_lse(q, k, v, causal=causal)
    lse_err = float((lse - attention_lse_reference(q, k, v, causal=causal)).abs().max())
    refs = fused_attention_backward_reference(q, k, v, o, lse, do, causal=causal)
    tops = [float(r.float().abs().max()) for r in refs]
    floor = 1e-2 * max(tops)
    rel = err = 0.0
    grads = fused_attention_backward(q, k, v, o, lse, do, causal=causal)
    for g, r, top in zip(grads, refs, tops):
        what = f'attention backward {tuple(q.shape)}'
        check(g.shape == r.shape and g.dtype == r.dtype,
              f'{what}: gradient {tuple(g.shape)} {g.dtype}')
        check(bool(torch.isfinite(g).all()), f'{what}: non-finite')
        diff = float((g.float() - r.float()).abs().max())
        check(math.isfinite(diff), f'{what}: error {diff}')
        err, rel = max(err, diff), max(rel, diff / max(top, floor))
    return lse_err, rel, err


def _attn_inputs(shape, fused: bool, gen, device) -> tp.Callable[[torch.dtype], tuple]:
    """Seeded q, k, v, dO [B, T, H, D] in a given dtype.  With ``fused``, q,
    k and v are what the transformer passes: strided slices of one
    [B, T, 3 H D] projection (nn/transformer.py), cast before the split."""
    B, T, H, D = shape
    if not fused:
        inputs = [torch.randn(shape, generator=gen).to(device) for _ in range(4)]
        return lambda dtype: tuple(x.to(dtype) for x in inputs)
    qkv = torch.randn(B, T, 3 * H * D, generator=gen).to(device)
    do = torch.randn(shape, generator=gen).to(device)
    return lambda dtype: (*(x.unflatten(-1, (H, D)) for x in qkv.to(dtype).split(H * D, -1)),
                          do.to(dtype))


def print_attention_bwd_resources() -> None:
    """Registers per thread, shared memory per block and blocks per SM of the
    K3b kernels (cudaFuncGetAttributes and the occupancy API)."""
    for dtype, dims in ((torch.bfloat16, (32, 64, 128)), (torch.float32, (64,))):
        for dim in dims:
            info = attention.attention_bwd_kernel_info(dim, dtype)
            print(f'attention backward kernels {dtype} D={dim}: ' + '; '.join(
                f"{name} {i['registers']} registers x {i['threads']} threads, "
                f"{i['shared_bytes']} B shared, {i['blocks_per_sm']} blocks/SM, "
                f"{i['spill_bytes']} B spilled" for name, i in info.items()), flush=True)


def check_attention_backward(device) -> tp.Tuple[dict, dict]:
    """K3b (and K3f's lse) against the plain versions: fp32 (TF32 off; only
    the order of fp32 sums differs) within 1e-4 of each gradient's max-abs,
    bf16 within 2e-2 (the gradients are rounded to bf16; P and dS are
    rounded once to bf16 on both sides, at the same points), lse within
    1e-5.  Shapes: the training shape (causal), MAGNeT's (not causal), the
    tiles' edges at D = 64 (T = 1, 63, 65, 129), D = 32 and 128 at T = 130,
    q, k, v as strided slices of one fused projection, and D = 36 (padded to
    40 by the wrapper for the bf16 kernels' 16-byte copies); both masks except
    at the two model shapes.  Then each kernel timed at the training shape in
    bf16 beside SDPA's backward and the bound."""
    print_attention_bwd_resources()
    gen = torch.Generator().manual_seed(11)
    both = (True, False)
    cases = [(TRAIN_ATTN_SHAPE, (True,), False), (tuple(ATTN_SHAPE.values()), (False,), False),
             *(((2, t, 3, 64), both, False) for t in (1, 63, 65, 129)),
             ((1, 130, 3, 32), both, False), ((1, 130, 3, 128), both, False),
             ((2, 257, 4, 64), both, True), ((1, 70, 2, 36), both, False)]
    worst = {}
    for shape, masks, fused in cases:
        inputs = _attn_inputs(shape, fused, gen, device)
        layout = ' fused qkv' if fused else ''
        for causal in masks:
            for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
                lse_err, rel, err = _attn_bwd_errs(*inputs(dtype), causal)
                worst[(shape, causal, dtype)] = err
                print(f'attention backward {shape}{layout} causal={causal} {dtype}: lse '
                      f'max-abs {lse_err:.3g} (<= 1e-5), gradients max-abs / max {rel:.3g} '
                      f'(<= {tol})', flush=True)
                check(lse_err <= 1e-5, f'lse {shape} {dtype}: max-abs {lse_err:.3g} > 1e-5')
                check(rel <= tol, f'attention backward {shape}{layout} causal={causal} '
                                  f'{dtype}: {rel:.3g} > {tol}')
        del inputs

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
                     ms=time_ms(lambda: fn(*args, causal=True), 20),
                     plain_ms=time_ms(lambda: ref(*args, causal=True), 3),
                     bound_ms=b_ms, bound_by=b_by, library_ms=library)
        entries.append(entry)
        print(f'{name} bf16 {TRAIN_ATTN_SHAPE} causal: kernel {entry["ms"]:.4f} ms, plain '
              f'{entry["plain_ms"]:.3f} ms, bound {b_ms:.4f} ms ({b_by}; {n_products} products)',
              flush=True)
    whole = bound_ms(5 * product, PEAK_BF16, 2.0 * 7 * elems + 8.0 * stats)[0]
    print(f'attention backward bf16 {TRAIN_ATTN_SHAPE} causal: both kernels '
          f'{entries[0]["ms"] + entries[1]["ms"]:.4f} ms, SDPA backward (dq, dk, dv in one '
          f'call) {library:.4f} ms, bound of the whole backward {whole:.4f} ms '
          f'(5 products, {5 * product / 1e9:.1f} GFLOP)', flush=True)
    del q, k, v, out, leaves
    fq, fk, fv, fdo = _attn_inputs(TRAIN_ATTN_SHAPE, True, gen, device)(torch.bfloat16)
    check(fq.stride(1) == 3 * H * D, 'the fused layout is not strided')
    fused = (fq, fk, fv, fdo, lse, attention_di(o, fdo))
    fused_ms = [time_ms(lambda: fn(*fused, causal=True), 20)
                for fn in (attention_bwd_dkv, attention_bwd_dq)]
    print(f'the same on strided q, k, v slices of one fused projection (the model\'s layout): '
          f'dK/dV {fused_ms[0]:.4f} ms, dQ {fused_ms[1]:.4f} ms (information)', flush=True)
    return entries[0], entries[1]


def _stage_params(spec: StageSpec, device, dtype, seed: int) -> tp.Dict[str, torch.Tensor]:
    """Random stage weights in the kernel's layout (ops/seanet.stage_params),
    uniform in +-1/sqrt(fan_in) as the encoder's init draws them."""
    gen = torch.Generator().manual_seed(seed)
    C, H, s, C_out = spec.c_in, spec.res_hidden, spec.stride, spec.c_out
    shapes = dict(w1=((3 * C, H), 3 * C), b1=((H,), 3 * C), w2=((H, C), H), b2=((C,), H),
                  wd=((2 * s * C, C_out), 2 * s * C), bd=((C_out,), 2 * s * C))
    return {name: ((torch.rand(shape, generator=gen) * 2 - 1) / math.sqrt(fan_in))
            .to(device, dtype) for name, (shape, fan_in) in shapes.items()}


def _stage_errs(x, params, spec, chunk: int) -> tp.Tuple[tp.Tuple[float, ...], float]:
    """K4 against its plain version, the plain one run on ``chunk`` batch rows
    at a time (its fp32 temporaries at b128 would not fit): max-abs / max-abs
    of the plain output over all frames, the first 4 and the last 4; and the
    max-abs over all frames."""
    out = fused_stage(x, params, spec)
    check(bool(torch.isfinite(out).all()), f'fused_stage {spec} {tuple(x.shape)}: non-finite')
    worst = [0.0, 0.0, 0.0]
    top = [0.0, 0.0, 0.0]
    for i in range(0, x.shape[0], chunk):
        ref = fused_stage_reference(x[i:i + chunk], params, spec).float()
        got = out[i:i + chunk].float()
        for j, sl in enumerate((slice(None), slice(0, 4), slice(-4, None))):
            worst[j] = max(worst[j], float((got[..., sl] - ref[..., sl]).abs().max()))
            top[j] = max(top[j], float(ref[..., sl].abs().max()))
        del ref, got
    return tuple(w / max(t, 1e-30) for w, t in zip(worst, top)), worst[0]


def check_fused_stage(device) -> dict:
    """K4 against its plain version on the same inputs: fp32 (TF32 off; only
    the order of fp32 sums differs) within 1e-5 of the max at B = 16, bf16
    within 1e-2 (the same rounding points; a sum in another order can move a
    bf16-stored z or ELU(r) by one step) at b128, the first and last 4 frames
    checked on their own, at both stage shapes of the fused encode; then
    shapes off the tiles: B = 1, a length whose frames fill no whole tile,
    the shortest length the route takes (one frame), and the debug codec's
    widths (C = 4, s = 16, the fp32-FMA variant in bf16).  Then each stage
    timed in bf16 at b128 beside its bound, its plain version and the
    module stack it replaces (resnet block, ELU, downsample conv: cuDNN)."""
    gen = torch.Generator(device=device).manual_seed(60)   # b128 inputs are drawn on the card
    lines = []
    bf16_abs = 0.0
    for si, (spec, L) in enumerate(STAGES):
        for dtype, batch, tol in ((torch.float32, 16, 1e-5), (torch.bfloat16, BATCH, 1e-2)):
            params = _stage_params(spec, device, dtype, seed=61 + si)
            x = (torch.randn(batch, spec.c_in, L, generator=gen, device=device) * 0.5).to(dtype)
            errs, abs_err = _stage_errs(x, params, spec, chunk=16)
            del x
            if dtype == torch.bfloat16:
                bf16_abs = max(bf16_abs, abs_err)
            lines.append(f'stage {si} {dtype} B={batch}: max-abs / max {errs[0]:.3g}, first 4 '
                         f'frames {errs[1]:.3g}, last 4 {errs[2]:.3g} (<= {tol})')
            check(max(errs) <= tol, f'fused_stage {si} {dtype}: {errs} > {tol}')
    debug = StageSpec(c_in=4, c_out=8, stride=16)
    for spec, L in ((STAGES[0][0], 4 * 67), (STAGES[1][0], 4 * 97), (STAGES[0][0], 4),
                    (STAGES[1][0], 4), (debug, 16 * 37)):
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            params = _stage_params(spec, device, dtype, seed=65)
            x = (torch.randn(1, spec.c_in, L, generator=gen, device=device) * 0.5).to(dtype)
            errs, _ = _stage_errs(x, params, spec, chunk=1)
            check(max(errs) <= tol, f'fused_stage {spec} L={L} {dtype}: {errs} > {tol}')
    lines.append('off the tiles (B = 1; frames 67, 97, 1; C = 4, s = 16): fp32 <= 1e-5, '
                 'bf16 <= 1e-2, edges included')
    try:
        x = torch.zeros(1, 64, 6, device=device)
        fused_stage(x, _stage_params(STAGES[0][0], device, torch.float32, seed=66), STAGES[0][0])
    except ValueError:
        lines.append('a length not a multiple of the stride refused')
    else:
        raise CheckFailed('fused_stage: L = 6 at stride 4 did not raise')
    for line in lines:
        print(line, flush=True)

    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    bound_by = {}   # each stage's limit, weighted by its bound
    encoder = get_encodec_32khz().encoder
    for si, (spec, L) in enumerate(STAGES):
        C, H, s, C_out = spec.c_in, spec.res_hidden, spec.stride, spec.c_out
        params = _stage_params(spec, device, torch.bfloat16, seed=61 + si)
        x = (torch.randn(BATCH, C, L, generator=gen, device=device) * 0.5).to(torch.bfloat16)
        stack = torch.nn.Sequential(*encoder.model[1 + 3 * si:4 + 3 * si])
        ms = time_ms(lambda: fused_stage(x, params, spec), 5)
        plain = time_ms(lambda: [fused_stage_reference(x[i:i + 16], params, spec)
                                 for i in range(0, BATCH, 16)], 1)
        with torch.no_grad():
            unfused = time_ms(lambda: stack(x), 3)
        U = L // s
        ops = 2.0 * BATCH * L * (3 * C * H + H * C) + 2.0 * BATCH * U * (2 * s * C * C_out)
        nbytes = 2.0 * (BATCH * C * L + BATCH * C_out * U + 3 * C * H + H * C
                        + 2 * s * C * C_out + H + C + C_out)
        b_ms, b_by = bound_ms(ops, PEAK_BF16, nbytes)
        print(f'fused_stage {si} bf16 [{BATCH}, {C}, {L}] -> [{BATCH}, {C_out}, {U}]: kernel '
              f'{ms:.3f} ms, plain {plain:.3f} ms (8 chunks of 16), module stack it replaces '
              f'(cuDNN, information) {unfused:.3f} ms, bound {b_ms:.3f} ms ({b_by}; '
              f'{ops / 1e12:.3f} TFLOP, {nbytes / 1e9:.3f} GB)', flush=True)
        total['ms'] += ms
        total['plain_ms'] += plain
        total['bound_ms'] += b_ms
        bound_by[b_by] = bound_by.get(b_by, 0.0) + b_ms
        del x
    # the two launches are bounded one by one; the larger share names the limit
    return dict(name='fused_stage', route='cuda', source='audiocraft_tpu_torch/csrc/seanet.cu',
                replaces='audiocraft_tpu/ops/seanet_pallas.py:157',
                max_abs_err=bf16_abs, ms=total['ms'], plain_ms=total['plain_ms'],
                bound_ms=total['bound_ms'], bound_by=max(bound_by, key=bound_by.get),
                library_ms=None)


def _mono_errs(fn, ref, x, w, b) -> tp.Tuple[float, float]:
    out = fn(x, w, b)
    check(bool(torch.isfinite(out).all()), f'{fn.__name__} {tuple(x.shape)}: non-finite')
    plain = ref(x, w, b)
    check(out.shape == plain.shape, f'{fn.__name__}: {tuple(out.shape)} != {tuple(plain.shape)}')
    diff = (out.float() - plain.float()).abs()
    scale = plain.float().abs()
    if x.dtype == torch.bfloat16:   # one bf16 step of each output
        check(bool((diff <= 2 ** -7 * scale + 1e-6 * float(scale.max())).all()),
              f'{fn.__name__} {tuple(x.shape)} bf16: more than one bf16 step apart')
    return float(diff.max() / scale.max()), float(diff.max())


def check_mono_conv(device) -> tp.Dict[str, dict]:
    """K5 and K6 against their plain versions: fp32 within 1e-6 of the max
    (TF32 off; seven fp32 products summed in another order), bf16 within one
    bf16 step of each output; at b128 x 10 s, at B = 1 off the 1024-sample
    tiles, and at the shortest lengths (K5: one output; K6: T = 4, one more
    than its pad).  Then both timed in bf16 at b128 beside the bound, the
    plain version and one cuDNN F.conv1d on the padded signal."""
    gen = torch.Generator().manual_seed(70)
    k, h = CONV0_TAPS, (CONV0_TAPS - 1) // 2
    T = SECONDS * SAMPLE_RATE
    w32 = (torch.rand(CONV0_CHANNELS, 1, k, generator=gen) * 2 - 1) / math.sqrt(k)
    b32 = (torch.rand(CONV0_CHANNELS, generator=gen) * 2 - 1) / math.sqrt(k)
    cases = {'banded_mono_conv': (banded_mono_conv, banded_mono_conv_reference, k - 1),
             'mono_input_conv': (mono_input_conv, mono_input_conv_reference, 0)}
    errs: tp.Dict[tuple, float] = {}
    abs_errs: tp.Dict[str, float] = {}
    for name, (fn, ref, extra) in cases.items():
        for batch, length in ((BATCH, T), (1, 1000 + 3), (1, 1 if extra else h + 1)):
            x = torch.randn(batch, 1, length + extra, generator=gen) * 0.4
            for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, None)):
                xd, wd, bd = (t.to(device, dtype) for t in (x, w32, b32))
                err, abs_err = _mono_errs(fn, ref, xd, wd, bd)
                errs[(name, batch, length, dtype)] = err
                if (batch, dtype) == (BATCH, torch.bfloat16):
                    abs_errs[name] = abs_err
                if tol is not None:
                    check(err <= tol, f'{name} B={batch} T={length} {dtype}: {err:.3g} > {tol}')
            del x
        print(f'{name}: max-abs / max fp32 {errs[(name, BATCH, T, torch.float32)]:.3g} at '
              f'[{BATCH}, 1, {T}] (<= 1e-6), bf16 {errs[(name, BATCH, T, torch.bfloat16)]:.3g} '
              f'(one bf16 step of each output); B = 1 at T = 1003 and at the shortest length '
              f'held to the same', flush=True)

    results = {}
    x = (torch.randn(BATCH, 1, T + k - 1, generator=gen) * 0.4).to(device, torch.bfloat16)
    w, b = w32.to(device, torch.bfloat16), b32.to(device, torch.bfloat16)
    library = time_ms(lambda: torch.nn.functional.conv1d(x, w, b), 5)
    ops = 2.0 * BATCH * T * CONV0_CHANNELS * k
    nbytes = 2.0 * (BATCH * (T + k - 1) + BATCH * CONV0_CHANNELS * T + CONV0_CHANNELS * (k + 1))
    b_ms, b_by = bound_ms(ops, PEAK_BF16, nbytes)
    for name, (fn, ref, extra) in cases.items():
        xin = x if extra else x[..., h:h + T].contiguous()
        entry = dict(name=name, route='cuda', source='audiocraft_tpu_torch/csrc/seanet.cu',
                     replaces=('audiocraft_tpu/ops/seanet_pallas.py:407' if extra else
                               'audiocraft_tpu/ops/seanet_pallas.py:515'),
                     max_abs_err=abs_errs[name],
                     ms=time_ms(lambda: fn(xin, w, b), 10),
                     plain_ms=time_ms(lambda: ref(xin, w, b), 3),
                     bound_ms=b_ms, bound_by=b_by, library_ms=library)
        results[name] = entry
        print(f'{name} bf16 [{BATCH}, 1, {T}] -> [{BATCH}, {CONV0_CHANNELS}, {T}]: kernel '
              f'{entry["ms"]:.3f} ms, plain {entry["plain_ms"]:.3f} ms, cuDNN F.conv1d on the '
              f'padded signal {library:.3f} ms, bound {b_ms:.3f} ms ({b_by})', flush=True)
    return results


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
    check(launches['lstm_step'] == 2 * 2,
          f"lstm launches {launches['lstm_step']} != 4 (2 layers, encode and decode)")
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
    print("== phase 4: fp32 parity, card vs CPU (TF32 flags at torch's defaults)", flush=True)
    check(not torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32,
          "TF32 flags not at torch's defaults: this phase shows the codec turns cuDNN's off")
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
    check(torch.backends.cudnn.allow_tf32, "the codec did not restore cuDNN's TF32 flag")


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
    check(launches['lstm_step'] == 2, f"lstm launches {launches['lstm_step']} != 2 layers")
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
              'flash_attention_bwd_dq': n_layers, 'rvq_encode': 1, 'lstm_step': 2}
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


# bf16 model gradients, kernel route against plain route (phase 8): the whole
# gradient's relative L2 and the worst parameter's max-abs / max, bounded at
# twice what the fp32-FMA K3b kernels gave on the same batch in the same
# state, after phase 7 (2.96e-3 and 8.58e-3 on an NVIDIA H100 80GB HBM3 at
# 700 W).  This bounds the model-level bf16 gap only: the tensor-core kernels
# read the same (2.95e-3 and 8.55e-3), so the gap comes from bf16 rounding
# elsewhere in the model, and this check cannot tell a small fault in K3b from
# none.  Phase 2, which holds each K3b kernel against its plain twin at 2e-2
# of each gradient's max-abs, is the check of K3b's numerics.
BF16_GRAD_L2, BF16_GRAD_WORST = 5.9e-3, 1.72e-2


def _route_gradients(lm, codes, cond, compute_dtype) -> tp.Tuple[float, float, float, str, float]:
    """Loss and gradients of the kernel route and of the plain route on one
    batch: (kernel loss, plain loss, worst parameter gradient max-abs / max,
    its name, whole gradient relative L2).  The kernel route must launch
    K3f and both K3b kernels once per layer."""
    n_layers = len(lm.transformer.layers)
    results = {}
    for flag in ('auto', False):
        set_attn_kernel(lm, flag)
        before = _launch_counts()
        loss, grads = lm_loss_and_grads(lm, codes, cond, compute_dtype=compute_dtype)
        after = _launch_counts()
        if flag:
            for name in ('flash_attention', 'flash_attention_bwd_dkv', 'flash_attention_bwd_dq'):
                check(after[name] - before[name] == n_layers,
                      f'kernel route: {name} launched {after[name] - before[name]} times')
        results[flag] = (float(loss), grads)
    set_attn_kernel(lm, 'auto')
    (loss_k, grads_k), (loss_p, grads_p) = results['auto'], results[False]
    worst, worst_name = 0.0, ''
    for (name, _), gk, gp in zip(lm.named_parameters(), grads_k, grads_p):
        check(bool(torch.isfinite(gk).all()), f'{name}: non-finite gradient ({compute_dtype})')
        top = float(gp.abs().max())
        err = float((gk - gp).abs().max()) / top if top > 0 else float(gk.abs().max())
        if err > worst:
            worst, worst_name = err, name
    diff = torch.sqrt(sum((gk - gp).double().square().sum() for gk, gp in zip(grads_k, grads_p)))
    norm = torch.sqrt(sum(gp.double().square().sum() for gp in grads_p))
    return loss_k, loss_p, worst, worst_name, float(diff / norm)


def phase_train_parity(device, lm, provider) -> None:
    """fp32 (TF32 off): loss within 1e-5 relative, every parameter's gradient
    within 1e-3 of its max-abs and the whole within 1e-4 relative L2 of the
    plain route, then three AdamW steps on each route.  bf16 compute on the
    same batch: both routes round at other points (K3f's output and K3b's
    gradients in bf16, P and dS rounded once to bf16 in K3b, against fp32
    softmax and autograd on the plain route), so the gap is that of bf16
    rounding across the model, bounded by BF16_GRAD_L2 and BF16_GRAD_WORST
    (see there; phase 2, not this, checks K3b's own numerics)."""
    print('== phase 8: training parity in fp32 (TF32 off) and bf16, kernel route vs plain route',
          flush=True)
    check(not torch.backends.cuda.matmul.allow_tf32, 'TF32 is on')
    codec = get_encodec_32khz()
    seed_codebooks(codec, _clips(8, SECONDS * SAMPLE_RATE, device, seed=50))
    codes = codec.encode(_clips(2, SECONDS * SAMPLE_RATE, device, seed=51))[0]
    cond = _train_conditions(provider, 2, device, seed=52)
    start = {k: v.clone() for k, v in lm.state_dict().items()}
    loss_k, loss_p, worst, worst_name, rel_l2 = _route_gradients(lm, codes, cond, None)
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    print(f'B=2 T={codes.shape[-1]} fp32: loss {loss_k:.6f} vs {loss_p:.6f}, relative '
          f'{rel_loss:.3g} (<= 1e-5); worst parameter gradient max-abs / max {worst:.3g} '
          f'({worst_name}, <= 1e-3); whole gradient relative L2 {rel_l2:.3g} (<= 1e-4)',
          flush=True)
    check(rel_loss <= 1e-5, f'fp32 loss relative {rel_loss:.3g} > 1e-5')
    check(worst <= 1e-3, f'{worst_name}: gradient max-abs / max {worst:.3g} > 1e-3')
    check(rel_l2 <= 1e-4, f'gradient relative L2 {rel_l2:.3g} > 1e-4')

    loss_k, loss_p, worst, worst_name, rel_l2 = _route_gradients(lm, codes, cond, 'bfloat16')
    print(f'B=2 T={codes.shape[-1]} bf16 compute: loss {loss_k:.6f} vs {loss_p:.6f}; worst '
          f'parameter gradient max-abs / max {worst:.3g} ({worst_name}, <= {BF16_GRAD_WORST}); '
          f'whole gradient relative L2 {rel_l2:.3g} (<= {BF16_GRAD_L2})', flush=True)
    check(worst <= BF16_GRAD_WORST,
          f'bf16 {worst_name}: gradient max-abs / max {worst:.3g} > {BF16_GRAD_WORST}')
    check(rel_l2 <= BF16_GRAD_L2, f'bf16 gradient relative L2 {rel_l2:.3g} > {BF16_GRAD_L2}')

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


def _event() -> torch.cuda.Event:
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def print_fused_breakdown(model, wav: torch.Tensor) -> None:
    """Where one fused encode spends device time, CUDA events around the
    route's own calls: ``fused_encoder_apply`` (the input conv timed by hooks
    on layer 0, the rest of the call being its K4 stages), each remaining
    layer by kind, the RVQ."""
    enc = model.encoder
    conv0: tp.List[torch.cuda.Event] = []
    hooks = (enc.model[0].register_forward_pre_hook(lambda *_: conv0.append(_event())),
             enc.model[0].register_forward_hook(lambda *_: conv0.append(_event())))
    with torch.no_grad():
        start = _event()
        x, next_layer = fused_encoder_apply(enc, model._cast(wav), 2)
        end = _event()
        for hook in hooks:
            hook.remove()
        check(len(conv0) == 2 and next_layer == 7, f'fused route: next layer {next_layer}')
        marks = [('conv0 (cuDNN)', start, conv0[1]), ('K4 stages 0-1', conv0[1], end)]
        for layer in enc.model[next_layer:]:
            begin = _event()
            x = layer(x)
            marks.append((type(layer).__name__, begin, _event()))
        begin = _event()
        model.quantizer.encode(x.float())
        marks.append(('rvq encode', begin, _event()))
    torch.cuda.synchronize()
    times = [(name, start.elapsed_time(end)) for name, start, end in marks]
    kinds: tp.Dict[str, float] = {}
    for name, ms in times:
        kinds[name] = kinds.get(name, 0.0) + ms
    print('fused encode by kind (ms): ' + ', '.join(f'{n} {ms:.2f}' for n, ms in kinds.items())
          + f', total {sum(kinds.values()):.2f}', flush=True)


def _seanet_launches() -> tp.Dict[str, int]:
    return {'fused_stage': fused_stage.launches, 'banded_mono_conv': banded_mono_conv.launches,
            'rvq_encode': rvq_encode.launches, 'lstm_step': lstm_layer.launches}


def phase_fused_encode(device) -> tp.Dict[str, int]:
    print('== phase 9: fused encode path, get_encodec_32khz() encode(fused=True) and '
          'encode(conv0_kernel=True)', flush=True)
    model = get_encodec_32khz()
    seed_codebooks(model, _clips(16, SECONDS * SAMPLE_RATE, device, seed=4))
    wav = _clips(BATCH, SECONDS * SAMPLE_RATE, device, seed=5)
    routes = {'default': {}, 'fused': dict(fused=True), 'conv0_kernel': dict(conv0_kernel=True)}
    frames = SECONDS * 50
    per_encode = {'default': dict(fused_stage=0, banded_mono_conv=0),
                  'fused': dict(fused_stage=2, banded_mono_conv=0),
                  'conv0_kernel': dict(fused_stage=0, banded_mono_conv=1)}
    path_launches: tp.Dict[str, int] = {}
    codes, latents = {}, {}
    name = card()
    for route, kw in routes.items():
        model.encode(wav, **kw)   # warm-up, not counted
        torch.cuda.synchronize()
        fused_stage.launches = banded_mono_conv.launches = 0
        rvq_encode.launches = lstm_layer.launches = 0
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(ENCODES):
            t0 = time.perf_counter()
            codes[route] = model.encode(wav, **kw)[0]
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = _seanet_launches()
        peak = torch.cuda.max_memory_allocated()
        expect = {k: ENCODES * v for k, v in per_encode[route].items()}
        expect.update(rvq_encode=ENCODES, lstm_step=ENCODES * 2)
        check(launches == expect, f'{route}: launches {launches} != {expect}')
        for kernel in ('fused_stage', 'banded_mono_conv'):
            if expect[kernel]:
                path_launches[kernel] = launches[kernel]
        c = codes[route]
        check(tuple(c.shape) == (BATCH, 4, frames) and bool(((c >= 0) & (c < 2048)).all()),
              f'{route}: codes {tuple(c.shape)}')
        audio = BATCH * SECONDS
        print(f'{route}: encode {", ".join(f"{t:.4f}" for t in times)} s = '
              f'{", ".join(f"{audio / t:.1f}" for t in times)} audio-s tokenized/s; peak memory '
              f'{peak / 2**30:.2f} GiB; launches over {ENCODES} encodes {launches}; card {name}',
              flush=True)
        with torch.no_grad():
            latents[route] = model.encoder(model._cast(wav),
                                           fused_stages=2 if kw.get('fused') else 0,
                                           conv0_kernel=bool(kw.get('conv0_kernel'))).float()
        check(bool(torch.isfinite(latents[route]).all()), f'{route}: non-finite latent')
    ref = latents['default']
    for route in ('fused', 'conv0_kernel'):
        rel = float((latents[route] - ref).abs().max() / ref.abs().max())
        share = float((codes[route] == codes['default']).float().mean())
        print(f'{route} vs default, bf16 latent [{BATCH}, 128, {frames}]: max-abs / max '
              f'{rel:.3g} (<= 3e-2); code match share {share:.6f} (information: other bf16 '
              f'rounding points move near-tie codes)', flush=True)
        check(rel <= 3e-2, f'{route}: bf16 latent rel {rel:.3g} > 3e-2')
    print_fused_breakdown(model, wav)
    del latents, codes, model, wav

    check(torch.backends.cudnn.allow_tf32, "cuDNN's TF32 flag is not at torch's default")
    gpu = get_encodec_32khz(compute_dtype=None)
    cpu = get_encodec_32khz(compute_dtype=None, device='cpu')
    seed_codebooks(gpu, _clips(8, SECONDS * SAMPLE_RATE, device, seed=6))
    cpu.quantizer.load_state_dict(gpu.quantizer.state_dict())
    wav = _clips(8, 2 * SAMPLE_RATE, device, seed=7)
    with torch.no_grad():
        lat_cpu = cpu.encoder(wav.cpu()).float()
        codes_cpu = cpu.quantizer.encode(lat_cpu)
        for route, kw in (('fused', dict(fused_stages=2)), ('conv0_kernel',
                                                             dict(conv0_kernel=True))):
            before = fused_stage.launches + banded_mono_conv.launches
            lat = gpu.encoder(wav, **kw).float()
            ran = fused_stage.launches + banded_mono_conv.launches - before
            check(ran == (2 if route == 'fused' else 1), f'{route} fp32: {ran} kernel launches')
            rel = float((lat.cpu() - lat_cpu).abs().max() / lat_cpu.abs().max())
            share = float((gpu.quantizer.encode(lat).cpu() == codes_cpu).float().mean())
            print(f'{route} fp32 on the card vs the plain unfused route on the CPU, latent '
                  f'[8, 128, 100]: max-abs / max {rel:.3g} (<= 1e-4); code match share '
                  f'{share:.6f} (>= 0.995)', flush=True)
            check(rel <= 1e-4, f'{route} fp32: latent rel {rel:.3g} > 1e-4')
            check(share >= 0.995, f'{route} fp32: code match share {share:.6f} < 0.995')
    return path_launches


def phase_probe(device) -> tp.Tuple[tp.Dict[str, int], tp.Dict[str, dict]]:
    print('== phase 10: data-movement probe (P1), apps/probe_ops on the card', flush=True)
    gather.launches = split_contract.launches = 0
    results = probe_ops.run(device)
    launches = {'probe_gather': gather.launches, 'probe_contract': split_contract.launches}
    for name, ok, shape, err in results:
        print(f'{name}: {"OK" if ok else "FAIL"} {shape} (max-abs from torch {err:.3g})',
              flush=True)
    check(all(ok for _, ok, _, _ in results), 'a probe operation failed')
    check(launches == {'probe_gather': 6, 'probe_contract': 1}, f'probe launches {launches}')

    ops = probe_ops.probes(device)
    gathers = [(kernel, plain) for name, kernel, plain in ops if 'dot_general' not in name]
    contract = next((kernel, plain) for name, kernel, plain in ops if 'dot_general' in name)
    moved = sum(2.0 * 2 * plain().numel() for _, plain in gathers)  # each element read + written
    g_bound = bound_ms(0.0, PEAK_BF16, moved)
    # a view is no copy: the plain version, and the one torch call doing each
    # gather, is the plain result cloned
    copy_ms = sum(time_ms(lambda: plain().clone(), 20) for _, plain in gathers)
    entries = {'probe_gather': dict(
        name='probe_gather', route='cuda', source='audiocraft_tpu_torch/csrc/probe.cu',
        replaces='scripts/probe_mosaic_ops.py:13',
        max_abs_err=max(err for name, _, _, err in results if 'dot_general' not in name),
        ms=sum(time_ms(kernel, 20) for kernel, _ in gathers),
        plain_ms=copy_ms, bound_ms=g_bound[0], bound_by=g_bound[1], library_ms=copy_ms)}
    x, taps = torch.randn(512, 64, device=device).bfloat16(), torch.randn(4, 64, 32,
                                                                          device=device).bfloat16()
    c_bound = bound_ms(2.0 * 128 * 256 * 32, PEAK_BF16, 2.0 * (512 * 64 + 4 * 64 * 32 + 128 * 32))
    entries['probe_contract'] = dict(
        name='probe_contract', route='cuda', source='audiocraft_tpu_torch/csrc/probe.cu',
        replaces='scripts/probe_mosaic_ops.py:46',
        max_abs_err=next(err for name, _, _, err in results if 'dot_general' in name),
        ms=time_ms(contract[0], 20),
        plain_ms=time_ms(lambda: split_contract_reference(x, taps), 20),
        bound_ms=c_bound[0], bound_by=c_bound[1],
        library_ms=time_ms(lambda: x.reshape(128, 256) @ taps.reshape(256, 32), 20))
    library = {'probe_gather': 'torch clone, one per gather; the six together',
               'probe_contract': 'torch matmul'}
    for name, entry in entries.items():
        print(f'{name}: kernel {entry["ms"]:.4f} ms, plain {entry["plain_ms"]:.4f} ms, '
              f'bound {entry["bound_ms"]:.6f} ms ({entry["bound_by"]}), {library[name]} '
              f'{entry["library_ms"]:.4f} ms', flush=True)
    return launches, entries


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    # the global flags stay at torch's defaults: fp32 matmuls without TF32,
    # cuDNN convolutions with it, which the fp32 codec turns off itself
    print(f'TF32 flags left at torch\'s defaults: matmul allow_tf32 '
          f'{torch.backends.cuda.matmul.allow_tf32}, cudnn allow_tf32 '
          f'{torch.backends.cudnn.allow_tf32} (the fp32 conv stacks turn it off themselves)')
    device = torch.device('cuda')
    start = time.perf_counter()
    mark = lambda: print(f'-- {time.perf_counter() - start:.1f} s since the start', flush=True)
    phase_build()
    mono_input_conv.launches = 0
    kernels = phase_kernels(device)
    kernel_checks_k6 = mono_input_conv.launches
    mark()
    launches = phase_main_path(device)
    phase_parity(device)
    mark()
    lm, provider = get_magnet_lm('small', segment_duration=MAGNET_SECONDS)
    magnet_launches = phase_magnet(device, lm, provider, get_encodec_32khz())
    phase_magnet_parity(device, lm, provider)
    del lm, provider
    mark()
    lm, provider = get_musicgen_lm('small', seed=1)
    train_launches = phase_train(device, lm, provider)
    phase_train_parity(device, lm, provider)
    del lm, provider
    mark()
    launches.update(phase_fused_encode(device))
    mark()
    probe_launches, probe_kernels = phase_probe(device)
    launches.update(probe_launches)
    kernels.update(probe_kernels)
    # K6 is on no model path (the JAX package calls it from tests only): its
    # launches are phase 2's, its checks and timing
    launches['mono_input_conv'] = kernel_checks_k6
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
