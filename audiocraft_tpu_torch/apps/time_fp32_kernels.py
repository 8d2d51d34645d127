"""Time the fp32 parity path's kernels on the card: K4's fp32 stage kernel
and K3f's fp32 flash-attention forward, and K3b's fp32 backward kernels.

    python -m audiocraft_tpu_torch.apps.time_fp32_kernels

Each kernel runs on seeded inputs at the shapes the fp32 paths give it and
is held against its plain version, then timed by CUDA events beside that
plain version, one PyTorch call computing the same function (the cuDNN
module stack of the stage in fp32 with TF32 off; scaled_dot_product_attention
in fp32 and its backward) and the bound (the larger of the operations over
the fp32 rate and the bytes over the memory rate of an H100 SXM).  K4 also
prints its per-phase cycle split (``fused_stage_clocks``) and its resources.
The stage shapes: both fused 32 kHz stages at B = 16 x 10 s and at the
style conditioner's excerpt (6 x 3 s); the attention shapes: JASCO's
U-net [6, 500, 8, 64] and [8, 1500, 16, 64], not causal; the backward at
the training shape [4, 1501, 16, 64], causal.  Every line names the card
and its power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys
import typing as tp

import torch

from ..builders import get_encodec_32khz
from ..nn.conv import fp32_convs
from ..obs import PEAK_BYTES, PEAK_FP32
from ..ops.attention import (attention_bwd_dkv, attention_bwd_dkv_reference, attention_bwd_dq,
                             attention_bwd_dq_reference, attention_di, attention_fwd_kernel_info,
                             fused_attention, fused_attention_reference, fused_attention_with_lse)
from ..ops.seanet import (StageSpec, fused_stage, fused_stage_clocks, fused_stage_reference,
                          stage_kernel_info)

STAGE0 = StageSpec(c_in=64, c_out=128, stride=4)
STAGE1 = StageSpec(c_in=128, c_out=256, stride=4)
# (name, batch, samples at the stage's input) for both fused 32 kHz stages
STAGE_SHAPES = (('B=16 x 10 s', 16, 320000), ('style excerpt 6 x 3 s', 6, 96000))
ATTN_SHAPES = ((6, 500, 8, 64), (8, 1500, 16, 64))
BWD_SHAPE = (4, 1501, 16, 64)


def card() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
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


def bound_ms(ops: float, nbytes: float) -> tp.Tuple[float, str]:
    """The least time for the work in fp32, and whether operations or bytes set it."""
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def stage_inputs(spec: StageSpec, batch: int, length: int, device, seed: int
                 ) -> tp.Tuple[torch.Tensor, tp.Dict[str, torch.Tensor]]:
    """Seeded fp32 stage input [batch, C, length] and weights in the kernel's
    layout (``ops/seanet.stage_params``), uniform in +-1/sqrt(fan_in)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    C, H, s, CO = spec.c_in, spec.res_hidden, spec.stride, spec.c_out
    shapes = dict(w1=((3 * C, H), 3 * C), b1=((H,), 3 * C), w2=((H, C), H), b2=((C,), H),
                  wd=((2 * s * C, CO), 2 * s * C), bd=((CO,), 2 * s * C))
    params = {k: (torch.rand(shape, generator=gen, device=device) * 2 - 1) / math.sqrt(fan)
              for k, (shape, fan) in shapes.items()}
    x = torch.randn(batch, C, length, generator=gen, device=device) * 0.5
    return x, params


def stage_ops_bytes(spec: StageSpec, batch: int, length: int) -> tp.Tuple[float, float]:
    """Operations and fp32 bytes of one stage: each input read once, each output written once."""
    C, H, s, CO = spec.c_in, spec.res_hidden, spec.stride, spec.c_out
    U = length // s
    ops = 2.0 * batch * length * (3 * C * H + H * C) + 2.0 * batch * U * (2 * s * C * CO)
    nbytes = 4.0 * (batch * C * length + batch * CO * U + 3 * C * H + H * C + 2 * s * C * CO
                    + H + C + CO)
    return ops, nbytes


def time_stage(spec: StageSpec, x: torch.Tensor, params: tp.Dict[str, torch.Tensor],
               stack: torch.nn.Module, reps: int = 3) -> tp.Dict[str, tp.Any]:
    """K4 in fp32 against its plain version (max-abs / max of the plain
    output), then its time, the plain version's, the module stack's (cuDNN in
    fp32, TF32 off; ``stack`` the encoder's layers of this stage), the bound,
    the counter's per-phase shares and the kernel's resources."""
    B, C, L = x.shape
    out, ref = fused_stage(x, params, spec), fused_stage_reference(x, params, spec)
    rel = float((out - ref).abs().max() / ref.abs().max())
    del out, ref
    ops, nbytes = stage_ops_bytes(spec, B, L)
    b_ms, b_by = bound_ms(ops, nbytes)
    row = dict(shape=[B, C, L], max_rel=rel, ms=time_ms(lambda: fused_stage(x, params, spec), reps),
               plain_ms=time_ms(lambda: fused_stage_reference(x, params, spec), reps),
               bound_ms=b_ms, bound_by=b_by)
    with torch.no_grad(), fp32_convs(torch.float32):
        row['library_ms'] = time_ms(lambda: stack(x), reps)
    _, clocks, work = fused_stage_clocks(x, params, spec)
    total = max(sum(clocks.values()), 1)
    row['split'] = {k: round(v / total, 4) for k, v in clocks.items()}
    row['resources'] = stage_kernel_info(spec, B, L, x.dtype)
    row['tflops'] = ops / row['ms'] / 1e9
    return row


def print_stage(si: int, what: str, spec: StageSpec, row: tp.Dict[str, tp.Any], name: str) -> None:
    B, C, L = row['shape']
    r = row['resources']
    print(f"K4 fp32 stage {si} ({what}) [{B}, {C}, {L}] -> [{B}, {spec.c_out}, {L // spec.stride}]: "
          f"max-abs / max against plain {row['max_rel']:.3g} (<= 1e-5); kernel {row['ms']:.3f} ms "
          f"({row['tflops']:.1f} TFLOP/s), plain {row['plain_ms']:.3f} ms, module stack (cuDNN fp32, "
          f"TF32 off) {row['library_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}); split "
          + ', '.join(f'{k} {v:.3f}' for k, v in row['split'].items())
          + f"; {r['registers']} registers x {r['threads']} threads, {r['shared_bytes']} B shared, "
          f"{r['blocks_per_sm']} blocks/SM, {r['spill_bytes']} B spilled, {r['tile']} frames a "
          f"tile, {r['blocks']} blocks; card {name}", flush=True)


def time_attention(shape: tp.Sequence[int], device, seed: int, causal: bool = False,
                   reps: int = 100) -> tp.Dict[str, tp.Any]:
    """K3f in fp32 against its plain version (max-abs), its time beside the
    plain version's, SDPA's in fp32 and the bound.  ``reps`` launches a
    timing: 100 at JASCO's shape span 10 ms, where a 2 ms window of 20 has
    read 0.149 ms against 0.103 for the same kernel later in the same
    process (an NVIDIA H100 80GB HBM3 at 700 W)."""
    B, T, H, D = shape
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(tuple(shape), generator=gen).to(device) for _ in range(3))
    err = float((fused_attention(q, k, v, causal=causal)
                 - fused_attention_reference(q, k, v, causal=causal)).abs().max())
    pairs = T * (T + 1) / 2 if causal else T * T
    ops = 4.0 * B * H * pairs * D
    b_ms, b_by = bound_ms(ops, 4.0 * 4 * B * T * H * D)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=causal)
    row = dict(shape=list(shape), causal=causal, max_abs_err=err,
               ms=time_ms(lambda: fused_attention(q, k, v, causal=causal), reps),
               plain_ms=time_ms(lambda: fused_attention_reference(q, k, v, causal=causal), 10),
               library_ms=time_ms(sdpa, reps), bound_ms=b_ms, bound_by=b_by)
    row['tflops'] = ops / row['ms'] / 1e9
    return row


def print_attention(row: tp.Dict[str, tp.Any], name: str) -> None:
    print(f"K3f fp32 {tuple(row['shape'])} causal={row['causal']}: max-abs against plain "
          f"{row['max_abs_err']:.3g} (<= 1e-5); kernel {row['ms']:.4f} ms ({row['tflops']:.1f} "
          f"TFLOP/s), plain {row['plain_ms']:.4f} ms, SDPA fp32 {row['library_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}); kernel / SDPA "
          f"{row['ms'] / row['library_ms']:.2f}; card {name}", flush=True)


def time_attention_backward(shape: tp.Sequence[int], device, seed: int,
                            reps: int = 10) -> tp.Dict[str, tp.Dict[str, tp.Any]]:
    """K3b's fp32 kernels (causal) against their plain versions (max-abs /
    max of each gradient), each timed beside its plain version, the backward
    of one fp32 SDPA call (dq, dk and dv together) and its bound."""
    B, T, H, D = shape
    gen = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(tuple(shape), generator=gen).to(device) for _ in range(4))
    o, lse = fused_attention_with_lse(q, k, v, causal=True)
    args = (q, k, v, do, lse, attention_di(o, do))
    leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(*leaves, is_causal=True)
    library = time_ms(lambda: torch.autograd.grad(out, leaves, do.transpose(1, 2),
                                                  retain_graph=True), reps)
    product = 2.0 * B * H * T * (T + 1) / 2 * D
    elems, stats = B * T * H * D, B * H * T
    rows = {}
    for name, fn, ref, n_products, n_out in (
            ('dkv', attention_bwd_dkv, attention_bwd_dkv_reference, 4, 2),
            ('dq', attention_bwd_dq, attention_bwd_dq_reference, 3, 1)):
        got, want = fn(*args, causal=True), ref(*args, causal=True)
        pairs = list(zip(got, want)) if n_out == 2 else [(got, want)]
        err = max(float((g - w).abs().max()) for g, w in pairs)
        rel = max(float((g - w).abs().max() / w.abs().max()) for g, w in pairs)
        b_ms, b_by = bound_ms(n_products * product, 4.0 * (4 + n_out) * elems + 4.0 * 2 * stats)
        rows[name] = dict(shape=list(shape), max_rel=rel, max_abs_err=err,
                          ms=time_ms(lambda: fn(*args, causal=True), reps),
                          plain_ms=time_ms(lambda: ref(*args, causal=True), 2),
                          library_ms=library, bound_ms=b_ms, bound_by=b_by)
    return rows


def print_attention_backward(kname: str, row: tp.Dict[str, tp.Any], name: str) -> None:
    print(f"K3b fp32 {kname} {tuple(row['shape'])} causal: max-abs / max against plain "
          f"{row['max_rel']:.3g} (<= 1e-4; max-abs {row['max_abs_err']:.3g}); kernel "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, SDPA fp32 backward (dq, dk, dv) "
          f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}); card "
          f"{name}", flush=True)


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> int:
    argparse.ArgumentParser(description=__doc__.split('\n\n')[0]).parse_args(argv)
    if not torch.cuda.is_available():
        print('time_fp32_kernels: needs a CUDA card', file=sys.stderr)
        return 1
    device = torch.device('cuda')
    name = card()
    encoder = get_encodec_32khz(compute_dtype=None).encoder
    for what, batch, samples in STAGE_SHAPES:
        length = samples
        for si, spec in enumerate((STAGE0, STAGE1)):
            x, params = stage_inputs(spec, batch, length, device, seed=61 + si)
            stack = torch.nn.Sequential(*encoder.model[1 + 3 * si:4 + 3 * si])
            print_stage(si, what, spec, time_stage(spec, x, params, stack), name)
            del x, params
            length //= spec.stride
    print('K3f fp32 forward resources D=64: ' + ', '.join(
        f'{k} {v}' for k, v in attention_fwd_kernel_info(64, torch.float32).items()), flush=True)
    for shape in ATTN_SHAPES:
        print_attention(time_attention(shape, device, seed=162), name)
    for kname, row in time_attention_backward(BWD_SHAPE, device, seed=11).items():
        print_attention_backward(kname, row, name)
    return 0


if __name__ == '__main__':
    sys.exit(main())
