"""SEANet encoder kernels and the fused-encode route (K4, K5, K6)
(counterpart of ``audiocraft_tpu/ops/seanet_pallas.py``).

* :func:`fused_stage` (K4, ``csrc/seanet.cu``) runs one encoder stage in one
  pass: ``r = a + conv1(ELU(conv3(ELU(a))))``, then ELU, then the strided
  downsample conv (kernel 2s, stride s), with the reflect pads of both convs
  rebuilt in the kernel.  The full-rate activations stay in shared memory.
* :func:`banded_mono_conv` (K5) is the encoder's first conv (C_in = 1,
  stride 1) on a signal padded by ``pad1d``; :func:`mono_input_conv` (K6) is
  the same conv with the reflect pad built in.
* :func:`encoder_stage_plan` and :func:`fused_encoder_apply` decide which
  leading stages of a ``SEANetEncoder`` fuse, as the JAX package decides it
  (the topology checks, ``L % s == 0`` and the plan's channel rule); the
  TPU tiling rules (the 128-lane channel padding, ``_choose_tile`` and
  ``T % 128``) do not carry over: the kernels take every length.

Layouts are PyTorch's ``[B, C, T]``; no channel is padded.  On a CPU tensor
each wrapper runs its plain version (``*_reference``), which rounds where the
TPU kernel rounds; on a CUDA tensor it launches its kernel, or raises.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch
import torch.nn.functional as F

from ..nn.conv import pad1d
from . import _build

_DTYPES = (torch.float32, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One encoder stage: res(k3, k1) -> ELU -> down(k = 2s, stride s)."""
    c_in: int            # stage channel count (the resnet block's width)
    c_out: int           # after the downsample (2 * c_in in SEANet)
    stride: int
    hidden: int = 0      # resnet bottleneck; default c_in // 2
    input_padded: bool = False  # the JAX route feeds this stage lane-padded

    @property
    def res_hidden(self) -> int:
        return self.hidden or self.c_in // 2

    @property
    def right_pad(self) -> int:
        # reference conv.py: padding_right = total // 2, the left gets the rest
        return self.stride // 2

    @property
    def left_pad(self) -> int:
        return self.stride - self.right_pad

    @property
    def c_pad(self) -> int:
        """The JAX route's lane-padded width; kept only for the plan's rule."""
        return max(128, ((self.c_in + 127) // 128) * 128)


def encoder_stage_plan(enc) -> tp.List[tp.Tuple[StageSpec, tp.List[int]]]:
    """Leading fusible stages of a SEANetEncoder config: [(spec, [res, down])]
    (layer 0, the input conv, runs before them); empty when the topology is
    not the kernel's.  Plans the same stages as the JAX package."""
    if (enc.n_residual_layers != 1 or not enc.true_skip or enc.causal
            or enc.activation.lower() != 'elu' or enc.activation_alpha != 1.0
            or enc.pad_mode != 'reflect' or enc.residual_kernel_size != 3
            or enc.compress != 2 or enc.dilation_base < 1
            or enc.norm not in ('none', 'weight_norm')
            or enc.channels != 1 or enc.kernel_size % 2 != 1):
        return []
    plan: tp.List[tp.Tuple[StageSpec, tp.List[int]]] = []
    mult = 1
    for si, ratio in enumerate(enc.enc_ratios):
        c = mult * enc.n_filters
        base = 1 + 3 * si  # layers: [conv0, (res, act, down) * n_ratios, ...]
        spec = StageSpec(c_in=c, c_out=2 * c, stride=ratio, input_padded=(si == 0))
        if spec.c_in != spec.c_pad and not spec.input_padded:
            break
        plan.append((spec, [base, base + 2]))
        mult *= 2
    return plan


def stage_params(enc, spec: StageSpec, layer_ids: tp.Sequence[int],
                 dtype: torch.dtype) -> tp.Dict[str, torch.Tensor]:
    """One stage's weights from the encoder's modules, cast to ``dtype``, as
    K-major matrices: ``w1`` [3C, H] (row d*C + c holds tap d of input
    channel c), ``w2`` [H, C], ``wd`` [2sC, C_out] (row k*C + c); biases
    ``b1`` [H], ``b2`` [C], ``bd`` [C_out]."""
    C, H, s, C_out = spec.c_in, spec.res_hidden, spec.stride, spec.c_out
    res, down = enc.model[layer_ids[0]], enc.model[layer_ids[1]]
    conv3, conv1 = res.block[1].conv['conv'], res.block[3].conv['conv']
    convd = down.conv['conv']
    shapes = ((conv3['weight'], (H, C, 3)), (conv1['weight'], (C, H, 1)),
              (convd['weight'], (C_out, C, 2 * s)))
    for w, shape in shapes:
        if tuple(w.shape) != shape:
            raise ValueError(f"stage weight {tuple(w.shape)} is not {shape} for {spec}")
    cast = lambda t: t.detach().to(dtype).contiguous()
    return dict(
        w1=cast(conv3['weight'].permute(2, 1, 0).reshape(3 * C, H)), b1=cast(conv3['bias']),
        w2=cast(conv1['weight'][:, :, 0].t()), b2=cast(conv1['bias']),
        wd=cast(convd['weight'].permute(2, 1, 0).reshape(2 * s * C, C_out)),
        bd=cast(convd['bias']))


def _elu(x: torch.Tensor) -> torch.Tensor:
    """ELU(alpha = 1) as the TPU kernel writes it, exp(min(x, 0)) - 1."""
    return torch.where(x > 0, x, torch.exp(torch.clamp(x, max=0.0)) - 1.0)


def fused_stage_reference(x: torch.Tensor, params: tp.Dict[str, torch.Tensor],
                          spec: StageSpec) -> torch.Tensor:
    """Plain PyTorch version of K4: [B, C, L] -> [B, C_out, L / s] in
    ``x.dtype``.  Products and sums are fp32 (on values already rounded to the
    input dtype), and the rounding points are the TPU kernel's: ELU(a), z
    and ELU(r) are stored in the input dtype, r and the outputs are summed in
    fp32 with the biases as rounded to the input dtype."""
    C, H, s, C_out = spec.c_in, spec.res_hidden, spec.stride, spec.c_out
    dt = x.dtype
    w1 = params['w1'].float().reshape(3, C, H).permute(2, 1, 0)         # [H, C, 3]
    w2 = params['w2'].float().t()[:, :, None]                           # [C, H, 1]
    wd = params['wd'].float().reshape(2 * s, C, C_out).permute(2, 1, 0)  # [C_out, C, 2s]
    a = x.float()
    z = F.conv1d(pad1d(_elu(a).to(dt).float(), (1, 1), 'reflect'), w1)
    z = _elu(z + params['b1'].float()[:, None]).to(dt).float()
    r = a + F.conv1d(z, w2) + params['b2'].float()[:, None]
    del a, z
    e = pad1d(_elu(r).to(dt).float(), (spec.left_pad, spec.right_pad), 'reflect')
    del r
    return (F.conv1d(e, wd, stride=s) + params['bd'].float()[:, None]).to(dt)


def _on_cpu(x: torch.Tensor, what: str) -> bool:
    """True for a CPU tensor (run the plain version); raise unless CUDA."""
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f"{what} runs on CUDA or CPU tensors, not {x.device}")
    return x.device.type == 'cpu'


def pack_mma_fragments(w: torch.Tensor) -> torch.Tensor:
    """A bf16 [K, N] matrix (K % 16 == 0, N % 8 == 0) in the order the
    m16n8k16 B fragments are read: for k-chunk kc, n-tile nt and lane l
    (g = l // 4, t = l % 4), four values B[16 kc + 2t + {0, 1, 8, 9}, 8 nt + g],
    so one warp reads a fragment as 256 contiguous bytes."""
    K, N = w.shape
    if K % 16 or N % 8:
        raise ValueError(f"[{K}, {N}] is not a whole number of 16 x 8 fragments")
    # k = 16 kc + 8 h + 2 t + p, n = 8 nt + g  ->  [kc, nt, g, t, h, p]
    return w.reshape(K // 16, 2, 4, 2, N // 8, 8).permute(0, 4, 5, 2, 1, 3).contiguous()


def _mma_widths(spec: StageSpec) -> bool:
    """Whether the tensor-core variant takes these widths: each product's
    depth a whole number of 16-wide chunks within one tap, and its width of
    8-wide tiles."""
    return spec.c_in % 16 == 0 and spec.res_hidden % 16 == 0 and spec.c_out % 8 == 0


def fused_stage(x: torch.Tensor, params: tp.Dict[str, torch.Tensor],
                spec: StageSpec) -> torch.Tensor:
    """One fused encoder stage (K4): x [B, C, L] (fp32 or bf16, L % s == 0)
    and :func:`stage_params` weights in x's dtype -> [B, C_out, L / s].

    bf16 at widths of whole mma tiles runs the tensor-core variant; any other
    width, and fp32, the fp32-FMA variant of the same kernel."""
    cpu = _on_cpu(x, 'fused_stage')
    C, H, s, C_out = spec.c_in, spec.res_hidden, spec.stride, spec.c_out
    if x.dim() != 3 or x.shape[1] != C:
        raise ValueError(f"fused_stage takes [B, {C}, L], not {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused_stage takes fp32 or bf16, not {x.dtype}")
    B, _, L = x.shape
    if L % s or L < 2:
        raise ValueError(f"length {L} is not a positive multiple of the stride {s}")
    shapes = dict(w1=(3 * C, H), b1=(H,), w2=(H, C), b2=(C,), wd=(2 * s * C, C_out),
                  bd=(C_out,))
    for name, shape in shapes.items():
        p = params[name]
        if tuple(p.shape) != shape or p.dtype != x.dtype or p.device != x.device:
            raise ValueError(f"{name} must be {shape} in {x.dtype} on {x.device}")
    if cpu:
        return fused_stage_reference(x, params, spec)
    if not (x.is_contiguous() and all(p.is_contiguous() for p in params.values())):
        raise ValueError("fused_stage takes contiguous inputs and weights")
    lib = _build.library()
    is_bf16 = x.dtype == torch.bfloat16
    use_mma = is_bf16 and _mma_widths(spec)
    if B > 65535:
        raise ValueError(f"batch {B} is larger than the kernel's grid")
    y = torch.empty(B, C_out, L // s, dtype=x.dtype, device=x.device)
    if B == 0:
        return y
    w1, w2, wd = params['w1'], params['w2'], params['wd']
    if use_mma:
        w1, w2, wd = (pack_mma_fragments(w) for w in (w1, w2, wd))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.acx_seanet_stage(x.data_ptr(), w1.data_ptr(), params['b1'].data_ptr(),
                                   w2.data_ptr(), params['b2'].data_ptr(), wd.data_ptr(),
                                   params['bd'].data_ptr(), y.data_ptr(), B, C, H, C_out, L,
                                   s, int(is_bf16), int(use_mma), stream)
    _build.check(err, 'acx_seanet_stage')
    fused_stage.launches += 1
    return y


fused_stage.launches = 0  # kernel launches since the last reset


def fused_encoder_apply(enc, x: torch.Tensor, n_stages: int
                        ) -> tp.Optional[tp.Tuple[torch.Tensor, int]]:
    """Run the input conv (the module's own) and the first ``n_stages``
    planned stages through K4.  x: [B, 1, T].  Returns (y, next_layer), or
    None when no stage fuses (the caller runs the module stack)."""
    plan = encoder_stage_plan(enc)[:n_stages]
    if not plan or x.shape[-1] % plan[0][0].stride or x.shape[-1] < 2:
        return None
    y = enc.model[0](x)
    next_layer = 0
    for spec, ids in plan:
        if y.shape[-1] % spec.stride:
            break
        y = fused_stage(y, stage_params(enc, spec, ids, y.dtype), spec)
        next_layer = ids[-1] + 1
    return y, next_layer


# ------------------------------------------------------ mono input conv (K5, K6)

_MAX_TAPS = 15  # the kernel keeps a thread's window of taps in registers


def _mono_conv_ref(xp: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    return (F.conv1d(xp.float(), weight.to(dtype).float()) + bias.float()[:, None]).to(dtype)


def banded_mono_conv_reference(x: torch.Tensor, weight: torch.Tensor,
                               bias: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: x [B, 1, T + k - 1] (padded), weight [C_out, 1, k]
    (cast to x's dtype), bias added in fp32 as given -> [B, C_out, T]."""
    return _mono_conv_ref(x, weight, bias.float(), x.dtype)


def mono_input_conv_reference(x: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor) -> torch.Tensor:
    """Plain version of K6: x [B, 1, T], reflect pad (k - 1) / 2 on each side,
    weight and bias rounded to x's dtype, sums in fp32 -> [B, C_out, T]."""
    h = (weight.shape[-1] - 1) // 2
    return _mono_conv_ref(pad1d(x, (h, h), 'reflect'), weight, bias.to(x.dtype), x.dtype)


def _mono_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, t_out: int,
               half: int, what: str) -> torch.Tensor:
    B, _, t_in = x.shape
    c_out, _, k = weight.shape
    w = weight[:, 0, :].to(x.dtype).contiguous()
    y = torch.empty(B, c_out, t_out, dtype=x.dtype, device=x.device)
    if B == 0 or t_out == 0:
        return y
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.acx_mono_conv(x.data_ptr(), w.data_ptr(), bias.contiguous().data_ptr(),
                                y.data_ptr(), B, t_in, t_out, c_out, k, half,
                                int(x.dtype == torch.bfloat16), stream)
    _build.check(err, what)
    return y


def _check_mono(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                what: str) -> bool:
    """Check the shapes; True for a CPU tensor (run the plain version), and
    on a CUDA tensor raise on what the kernel cannot take."""
    cpu = _on_cpu(x, what)
    if x.dim() != 3 or x.shape[1] != 1:
        raise ValueError(f"{what} takes a mono [B, 1, T] signal, not {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{what} takes fp32 or bf16, not {x.dtype}")
    if weight.dim() != 3 or weight.shape[1] != 1 or tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"{what}: weight {tuple(weight.shape)} and bias "
                         f"{tuple(bias.shape)} are not [C_out, 1, k] and [C_out]")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError(f"{what}: the weights must be on {x.device}")
    if cpu:
        return True
    if not 1 <= weight.shape[-1] <= _MAX_TAPS:
        raise ValueError(f"{what} takes 1 to {_MAX_TAPS} taps, not {weight.shape[-1]}")
    if weight.shape[0] * (weight.shape[-1] + 1) > 8192:
        raise ValueError(f"{what}: {weight.shape[0]} output channels do not fit the "
                         "kernel's shared memory")
    if not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous input")
    if x.shape[0] > 65535:
        raise ValueError(f"batch {x.shape[0]} is larger than the kernel's grid")
    return False


def banded_mono_conv(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """K5, the encoder's first conv on a padded mono signal: x [B, 1, T + k - 1],
    weight [C_out, 1, k], bias [C_out] (added in fp32) -> [B, C_out, T]."""
    cpu = _check_mono(x, weight, bias, 'banded_mono_conv')
    t_out = x.shape[-1] - weight.shape[-1] + 1
    if t_out < 1:
        raise ValueError(f"a padded signal of {x.shape[-1]} is shorter than the kernel")
    if cpu:
        return banded_mono_conv_reference(x, weight, bias)
    y = _mono_conv(x, weight, bias.float(), t_out, -1, 'acx_mono_conv (K5)')
    banded_mono_conv.launches += 1
    return y


banded_mono_conv.launches = 0  # kernel launches since the last reset


def mono_input_conv(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """K6, the same conv with the reflect pad built in: x [B, 1, T], odd k,
    T > (k - 1) / 2 -> [B, C_out, T]; the bias is rounded to x's dtype."""
    cpu = _check_mono(x, weight, bias, 'mono_input_conv')
    k, T = weight.shape[-1], x.shape[-1]
    h = (k - 1) // 2
    if k % 2 == 0 or T <= h:
        raise ValueError(f"mono_input_conv takes an odd kernel and a signal longer than "
                         f"its pad, not k={k} and T={T}")
    if cpu:
        return mono_input_conv_reference(x, weight, bias)
    y = _mono_conv(x, weight, bias.to(x.dtype).float(), T, h, 'acx_mono_conv (K6)')
    mono_input_conv.launches += 1
    return y


mono_input_conv.launches = 0  # kernel launches since the last reset
