"""Work of the EnCodec kernels and of a whole encode or decode, from shapes.

Kernel counts (the port's ``csrc`` kernels by their launch shapes):

* K1 ``rvq_encode_kernel``: ``n`` frames of width ``d`` against ``n_q``
  codebooks of ``k`` vectors: the distance products ``2 n d k n_q`` in
  float32; bytes: the frames, the codebooks and the codes, 4 bytes each.
* K2 ``lstm_layer_kernel``: the recurrence of one layer over ``t`` steps of
  ``b`` rows, hidden ``h``, bf16: ``2 t b 4h h``; bytes: the hoisted input
  gates read, the outputs written, ``w_hh`` read once.  The input
  projection runs before it as a cuBLAS product, so it is not the kernel's;
  ``input_projection=True`` adds it, on the basis of the kernel table in
  PERF.md (the whole layer call).
* K4 ``stage_mma_kernel``: one fused encoder stage, bf16: the residual
  block's k3 and k1 convolutions at the input length and the strided
  down-sampling convolution at the output length; bytes: the input and
  output activations and the weights.
* K5 ``mono_conv_kernel``: the mono input convolution, bf16: ``2 b t c k``;
  bytes: the padded input, the output and the weights.

A whole encode or decode counts every convolution, the LSTM and (encode) the
quantizer's distances as multiply-adds of two operations.
"""

from __future__ import annotations

import typing as tp

from . import PEAK_BF16, PEAK_FP32, Work


def k1(n: int, d: int, k: int, n_q: int) -> Work:
    return Work(2.0 * n * d * k * n_q, 4.0 * (n * d + n_q * k * d + n_q * n), PEAK_FP32)


def k2(t: int, b: int, h: int, input_projection: bool = False) -> Work:
    if input_projection:
        return Work(2.0 * t * b * 4 * h * (h + h), 2.0 * (2 * t * b * h + 8 * h * h + 8 * h),
                    PEAK_BF16)
    return Work(2.0 * t * b * 4 * h * h, 2.0 * (t * b * 4 * h + t * b * h + 4 * h * h),
                PEAK_BF16)


def k4_stage(b: int, c_in: int, c_out: int, stride: int, length: int, hidden: int) -> Work:
    u = length // stride
    ops = 2.0 * b * length * (3 * c_in * hidden + hidden * c_in) \
        + 2.0 * b * u * (2 * stride * c_in * c_out)
    nbytes = 2.0 * (b * c_in * length + b * c_out * u + 3 * c_in * hidden + hidden * c_in
                    + 2 * stride * c_in * c_out + hidden + c_in + c_out)
    return Work(ops, nbytes, PEAK_BF16)


def k5(b: int, t: int, c: int, k: int) -> Work:
    return Work(2.0 * b * t * c * k, 2.0 * (b * (t + k - 1) + b * c * t + c * (k + 1)),
                PEAK_BF16)


def fused_stages(cfg: dict, samples: int, count: int = 2) -> tp.List[dict]:
    """The shapes of the first ``count`` encoder stages (the fused ones)."""
    s = cfg['seanet']
    c, length, out = s['n_filters'], samples, []
    for ratio in list(reversed(s['ratios']))[:count]:
        out.append(dict(c_in=c, c_out=2 * c, stride=ratio, length=length,
                        hidden=c // s['compress']))
        c, length = 2 * c, length // ratio
    return out


def k4(cfg: dict, batch: int, samples: int) -> float:
    """K4's least time (s) for one encode: each launch bounded on its own."""
    return sum(k4_stage(batch, **st).bound_s() for st in fused_stages(cfg, samples))


def _conv(c_in: int, c_out: int, k: int, length_out: int) -> float:
    return 2.0 * c_in * c_out * k * length_out


def _lstm(h: int, t: int, layers: int) -> float:
    return layers * 2.0 * t * 4 * h * (h + h)


def encode_flops(cfg: dict, samples: int) -> float:
    """Model FLOPs of encoding one clip of ``samples`` to codes."""
    s, q = cfg['seanet'], cfg['quantizer']
    c, length = s['n_filters'], samples
    flops = _conv(1, c, s['kernel_size'], length)
    for ratio in reversed(s['ratios']):
        hidden = c // s['compress']
        flops += s['n_residual_layers'] * (_conv(c, hidden, s['residual_kernel_size'], length)
                                           + _conv(hidden, c, 1, length))
        length //= ratio
        flops += _conv(c, 2 * c, 2 * ratio, length)
        c *= 2
    flops += _lstm(c, length, s['lstm'])
    flops += _conv(c, s['dimension'], s['last_kernel_size'], length)
    return flops + 2.0 * length * q['dimension'] * q['bins'] * q['n_q']


def decode_flops(cfg: dict, frames: int) -> float:
    """Model FLOPs of decoding one clip of ``frames`` codes to audio."""
    s = cfg['seanet']
    c = s['n_filters'] * 2 ** len(s['ratios'])
    length = frames
    flops = _conv(s['dimension'], c, s['kernel_size'], length) + _lstm(c, length, s['lstm'])
    for ratio in s['ratios']:
        flops += 2.0 * c * (c // 2) * 2 * ratio * length
        length *= ratio
        c //= 2
        hidden = c // s['compress']
        flops += s['n_residual_layers'] * (_conv(c, hidden, s['residual_kernel_size'], length)
                                           + _conv(hidden, c, 1, length))
    return flops + _conv(c, 1, s['last_kernel_size'], length)
