"""Streamable 1d convolutions with the exact Audiocraft padding
(counterpart of ``audiocraft_tpu/nn/conv.py``).

* ``get_extra_padding_for_conv1d``: pad so that the last conv window is full.
* ``pad1d``: reflect padding that also works on inputs shorter than the pad.
* ``StreamableConv1d``: causal puts all padding on the left; non-causal splits
  it with the larger half on the left.
* ``StreamableConvTranspose1d``: trims ``kernel - stride`` samples, split by
  ``trim_right_ratio`` (causal) or with the larger half on the left.

Weight norm is folded into the stored weight, as the JAX package stores it, so
the parameters sit at the reference names ``conv.conv.weight`` and
``convtr.convtr.weight``.  ``norm='time_group_norm'`` puts GroupNorm(1, C_out)
after a ``StreamableConv1d`` (one mean and variance over channels and time per
batch row, eps 1e-5), its scale and bias at the reference names
``conv.norm.weight`` and ``conv.norm.bias``; a transposed conv takes none, as
in the JAX package.  The stored weights stay fp32; a call casts them to
the input's dtype, so a bf16 input runs the conv in bf16.  ``fp32_convs``
turns cuDNN's TF32 off around an fp32 conv stack.
"""

from __future__ import annotations

import contextlib
import math
import typing as tp

import torch
import torch.nn.functional as F

from .init import uniform


@contextlib.contextmanager
def fp32_convs(dtype: torch.dtype) -> tp.Iterator[None]:
    """Run the fp32 convolutions inside in full fp32 on the card.

    torch sends fp32 convolutions through cuDNN in TF32 by default
    (``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
    decimal digits and changes codes against the reference.  For an fp32
    ``dtype`` the flag is False inside and the caller's value is restored on
    exit (it is process-global, as torch's own ``cudnn.flags`` is); any other
    dtype leaves it alone."""
    if dtype != torch.float32:
        yield
        return
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def get_extra_padding_for_conv1d(length: int, kernel_size: int, stride: int,
                                 padding_total: int = 0) -> int:
    """Extra right padding so that the last conv window is full."""
    n_frames = (length - kernel_size + padding_total) / stride + 1
    ideal_length = (math.ceil(n_frames) - 1) * stride + (kernel_size - padding_total)
    return ideal_length - length


def pad1d(x: torch.Tensor, paddings: tp.Tuple[int, int], mode: str = 'constant',
          value: float = 0.) -> torch.Tensor:
    """Pad the last axis; reflect padding on a signal shorter than the pad
    appends zeros first and strips them afterwards."""
    length = x.shape[-1]
    padding_left, padding_right = paddings
    if padding_left < 0 or padding_right < 0:
        raise ValueError(f"negative padding {paddings}")
    if mode == 'reflect':
        max_pad = max(padding_left, padding_right)
        extra_pad = 0
        if length <= max_pad:
            extra_pad = max_pad - length + 1
            x = F.pad(x, (0, extra_pad))
        # built from slices rather than F.pad(mode='reflect'), whose CUDA
        # kernel refuses tensors past 32-bit indexing (the b128 x 10 s input)
        n = x.shape[-1]
        padded = torch.cat([x[..., 1:padding_left + 1].flip(-1), x,
                            x[..., n - 1 - padding_right:n - 1].flip(-1)], dim=-1)
        return padded[..., :padded.shape[-1] - extra_pad]
    return F.pad(x, (padding_left, padding_right), mode=mode, value=value)


def unpad1d(x: torch.Tensor, paddings: tp.Tuple[int, int]) -> torch.Tensor:
    padding_left, padding_right = paddings
    if padding_left < 0 or padding_right < 0 or padding_left + padding_right > x.shape[-1]:
        raise ValueError(f"cannot unpad {paddings} from length {x.shape[-1]}")
    return x[..., padding_left:x.shape[-1] - padding_right]


def _conv_params(weight_shape: tp.Tuple[int, int, int], in_channels: int,
                 out_channels: int, bias: bool,
                 generator: tp.Optional[torch.Generator]) -> torch.nn.ParameterDict:
    """One conv's ``weight`` and ``bias``, uniform in +-1/sqrt(fan_in) as the
    JAX package initialises them (fan_in = in_channels * kernel_size)."""
    bound = 1.0 / math.sqrt(in_channels * weight_shape[2])
    params = {'weight': uniform(weight_shape, bound, generator)}
    if bias:
        params['bias'] = uniform((out_channels,), bound, generator)
    return torch.nn.ParameterDict(params)


def _check_norm(norm: str) -> None:
    if norm not in ('none', 'weight_norm', 'time_group_norm'):
        raise NotImplementedError(f"norm={norm!r} is not ported; 'none', 'weight_norm' "
                                  "(folded into the weight) and 'time_group_norm' are")


class StreamableConv1d(torch.nn.Module):
    """Conv1d with built-in causal or asymmetric padding."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, bias: bool = True,
                 causal: bool = False, norm: str = 'none', pad_mode: str = 'reflect',
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        _check_norm(norm)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.stride, self.dilation = kernel_size, stride, dilation
        self.causal, self.norm, self.pad_mode = causal, norm, pad_mode
        shape = (out_channels, in_channels, kernel_size)
        self.conv = torch.nn.ModuleDict({'conv': _conv_params(
            shape, in_channels, out_channels, bias, generator)})
        if norm == 'time_group_norm':
            self.conv['norm'] = torch.nn.ParameterDict({
                'weight': torch.nn.Parameter(torch.ones(out_channels)),
                'bias': torch.nn.Parameter(torch.zeros(out_channels))})

    @property
    def effective_kernel_size(self) -> int:
        return (self.kernel_size - 1) * self.dilation + 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ks = self.effective_kernel_size
        padding_total = ks - self.stride
        extra = get_extra_padding_for_conv1d(x.shape[-1], ks, self.stride, padding_total)
        if self.causal:
            pads = (padding_total, extra)
        else:
            padding_right = padding_total // 2
            pads = (padding_total - padding_right, padding_right + extra)
        x = pad1d(x, pads, mode=self.pad_mode)
        p = self.conv['conv']
        bias = p['bias'].to(x.dtype) if 'bias' in p else None
        y = F.conv1d(x, p['weight'].to(x.dtype), bias, stride=self.stride,
                     dilation=self.dilation)
        if self.norm == 'time_group_norm':
            gn = self.conv['norm']
            y = F.group_norm(y, 1, gn['weight'].to(y.dtype), gn['bias'].to(y.dtype), eps=1e-5)
        return y


class StreamableConvTranspose1d(torch.nn.Module):
    """ConvTranspose1d that trims its ``kernel - stride`` overlap."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, causal: bool = False, norm: str = 'none',
                 trim_right_ratio: float = 1., bias: bool = True,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        _check_norm(norm)
        if not (causal or trim_right_ratio == 1.):
            raise ValueError("`trim_right_ratio` != 1.0 only makes sense for causal convolutions")
        if not 0. <= trim_right_ratio <= 1.:
            raise ValueError(f"trim_right_ratio={trim_right_ratio} is outside [0, 1]")
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.stride = kernel_size, stride
        self.causal, self.norm, self.trim_right_ratio = causal, norm, trim_right_ratio
        shape = (in_channels, out_channels, kernel_size)   # torch ConvTranspose1d layout
        self.convtr = torch.nn.ModuleDict({'convtr': _conv_params(
            shape, in_channels, out_channels, bias, generator)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.convtr['convtr']
        bias = p['bias'].to(x.dtype) if 'bias' in p else None
        y = F.conv_transpose1d(x, p['weight'].to(x.dtype), bias, stride=self.stride)
        padding_total = self.kernel_size - self.stride
        if self.causal:
            padding_right = math.ceil(padding_total * self.trim_right_ratio)
        else:
            padding_right = padding_total // 2
        return unpad1d(y, (padding_total - padding_right, padding_right))
