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
TPU kernel rounds and runs its fp32 convs without TF32 on the card; on a CUDA
tensor it launches its kernel, or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import typing as tp

import torch
import torch.nn.functional as F

from ..nn.conv import fp32_convs, pad1d
from . import _build
from ._grad import refuse_grad

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


def fused_length_ok(enc, length: int, n_stages: int = 2) -> bool:
    """Whether :func:`fused_encoder_apply` takes a signal of ``length``
    samples: the config has a stage plan and the length is a multiple of the
    first stage's stride."""
    plan = encoder_stage_plan(enc)[:n_stages]
    return bool(plan) and length % plan[0][0].stride == 0 and length >= 2


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


def _stage_sources(enc, layer_ids: tp.Sequence[int]) -> tp.List[torch.Tensor]:
    res, down = enc.model[layer_ids[0]], enc.model[layer_ids[1]]
    return [conv[k] for conv in (res.block[1].conv['conv'], res.block[3].conv['conv'],
                                 down.conv['conv']) for k in ('weight', 'bias')]


def encoder_stage_weights(enc, spec: StageSpec, layer_ids: tp.Sequence[int],
                          dtype: torch.dtype) -> tp.Dict[str, torch.Tensor]:
    """:func:`stage_params`, with ``w1_mma``, ``w2_mma`` and ``wd_mma`` in
    :func:`pack_b_tiles` order where the tensor-core variant runs the
    stage, made once per encoder, stage and dtype and kept on the encoder.
    The cache holds the source parameters and their version counters, so an
    in-place update (an optimizer step, ``load_state_dict``) or a parameter
    put in another's place packs anew."""
    sources = _stage_sources(enc, layer_ids)
    versions = [t._version for t in sources]
    key = (tuple(layer_ids), dtype)
    cache = enc.__dict__.setdefault('_stage_weight_cache', {})
    hit = cache.get(key)
    if (hit is not None and all(a is b for a, b in zip(hit[0], sources))
            and hit[1] == versions):
        return hit[2]
    params = stage_params(enc, spec, layer_ids, dtype)
    params.update(packed_stage_weights(params, spec))
    cache[key] = (sources, versions, params)
    return params


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
    with fp32_convs(torch.float32):
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


def pack_b_tiles(w: torch.Tensor) -> torch.Tensor:
    """A bf16 [K, N] matrix (K % 16 == 0, N % 8 == 0) in the shared-memory
    layout the tensor-core K4 gives wgmma as its B operand: no swizzle,
    K-major core matrices of 8 columns x 8 depths (16 bytes a column), for
    each 16-deep chunk kc the 8-column groups ng one after another (256
    bytes each), the chunk's two 8-deep halves in each (128 bytes apart):
    element (k, n) at [kc, ng, k // 8 % 2, n % 8, k % 8]."""
    K, N = w.shape
    if K % 16 or N % 8:
        raise ValueError(f"[{K}, {N}] is not a whole number of 16 x 8 tiles")
    # k = 16 kc + 8 h + i, n = 8 ng + j  ->  [kc, ng, h, j, i]
    return w.reshape(K // 16, 2, 8, N // 8, 8).permute(0, 3, 1, 4, 2).contiguous()


# The stages the tensor-core K4 is built for, (C, H, C_out, stride): the
# fused stages of the 32 kHz and 24 kHz codecs (csrc/seanet.cu:run_stage
# instantiates the same); other stages, and fp32, run an FMA variant
# (:func:`stage_route`).
_MMA_STAGES = ((32, 16, 64, 2), (64, 32, 128, 4), (128, 64, 256, 4))
SMEM_LIMIT = 232448   # shared bytes an H100 block may take (csrc/seanet.cu:kSmemLimit)
RING = 8              # k-chunks of wd in a warpgroup's streaming ring (csrc/seanet.cu:kRing)


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """How the tensor-core K4 lays one stage over the card: frames per item
    (``tile``, with s * (tile + 1) r rows, a whole number of 16-row m-tiles),
    input tiles in shared memory (2: the next item's copy starts as this one
    starts; 1: once conv1 has read it), and wd either resident (``ring`` 0)
    or streamed through each warpgroup's ring of ``ring`` k-chunks.
    ``smem_bytes`` the kernel recomputes and must find equal."""
    tile: int
    in_bufs: int
    ring: int
    smem_bytes: int

    def args(self) -> ctypes.Array:
        return (ctypes.c_int * 4)(self.tile, self.in_bufs, self.ring, self.smem_bytes)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _mma_smem_bytes(spec: StageSpec, in_bufs: int, ring: int) -> int:
    """The tensor-core K4's shared bytes (csrc/seanet.cu:Geometry and
    mma_geometry): w1, w2, wd or the warpgroups' rings, the input tiles
    [C][raw_rs], ELU(a) rows or ELU(r) by phase, z or the output tile, the
    fp32 biases, the mbarriers (one an input tile, one a ring slot of each
    of the 4 warpgroups)."""
    C, H, s, CO = spec.c_in, spec.res_hidden, spec.stride, spec.c_out
    tile = 128 // s - 1
    frames, rows = tile + 1, 128
    na = rows + 2
    raw_rs = 8 * (((na + 14) // 8) | 1)   # an odd number of 16-byte units a row
    phase_bytes = frames // 8 * C * 16 + 128 // s
    elu = max((na + 1) * (C + 8) * 2, s * phase_bytes)   # ELU(a) has a spare row
    z = 2 * max(rows * (H + 8), CO * (frames + 8))
    wd = ring * 16 * CO * 2 if ring else 2 * 2 * s * C * CO
    return (2 * (3 * C * H + H * C) + wd + in_bufs * C * raw_rs * 2 + elu + z
            + _round_up(4 * (H + C + CO), 16) + 8 * (2 + 4 * ring))


def stage_plan(spec: StageSpec, dtype: torch.dtype) -> tp.Optional[StagePlan]:
    """The tensor-core K4's plan for this stage, or None where an FMA
    variant runs it (fp32, or a stage it is not built for).

    The tile is fixed by the stride: s * (tile + 1) = 128 r rows, two m64
    blocks of the products.  Everything resident with two input tiles where
    that fits shared memory, else wd streamed through the warpgroups' rings
    with one input tile."""
    key = (spec.c_in, spec.res_hidden, spec.c_out, spec.stride)
    if dtype != torch.bfloat16 or key not in _MMA_STAGES:
        return None
    for in_bufs, ring in ((2, 0), (1, RING)):
        smem = _mma_smem_bytes(spec, in_bufs, ring)
        if smem <= SMEM_LIMIT:
            return StagePlan(128 // spec.stride - 1, in_bufs, ring, smem)
    return None


# The stages the register-tiled fp32-FMA K4 is built for, (C, H, C_out,
# stride): the tensor-core stages and the debug codecs' at 32 and 16 kHz
# (csrc/seanet.cu:run_stage instantiates the same); any other stage runs
# the first FMA kernel, stage_kernel.
_TILED_STAGES = _MMA_STAGES + ((4, 2, 8, 16), (4, 2, 8, 8))
FMA_WORKERS = 256   # computing threads (csrc/seanet.cu:kFmaWorkers), and a weight warp
FMA_STAGES = 3      # weight chunks in the ring (kFmaStages)
FMA_SLOT = 4096     # floats a ring slot holds at most (kFmaSlot)


@dataclasses.dataclass(frozen=True)
class TiledPlan:
    """How the register-tiled fp32-FMA K4 lays one stage over the card: a
    persistent block an SM (8 computing warps, one weight warp) walks over
    items of ``tile`` output frames (``rows`` = stride * (tile + 1) r rows,
    256 where shared memory allows, else 128); w1, w2 and wd stream through
    a ring of ``stages`` slots of ``slot`` floats, in chunks of ``chunks`` =
    (conv3 channels, three taps each; conv1 rows; downsample channels of one
    phase, two taps each).  The C entry recomputes every field and must find
    it equal."""
    tile: int
    rows: int
    stages: int
    slot: int
    chunks: tp.Tuple[int, int, int]
    smem_bytes: int

    def args(self) -> ctypes.Array:
        return (ctypes.c_int * 8)(self.tile, self.rows, self.stages, self.slot, *self.chunks,
                                  self.smem_bytes)


def _chunk_rows(n: int, per: int, width: int) -> int:
    """The largest power of two dividing n whose chunk (d rows of ``per``
    weight rows of ``width`` floats) fits a slot (csrc/seanet.cu:chunk_rows)."""
    d = n & -n
    while d > 1 and d * per * width > FMA_SLOT:
        d //= 2
    return d


def _tiled_chunks(spec: StageSpec) -> tp.Tuple[tp.Tuple[int, int, int], int]:
    """The chunk rows of conv3, conv1 and the downsample, and the floats of
    the slot that holds the largest chunk."""
    C, H, CO = spec.c_in, spec.res_hidden, spec.c_out
    c3, c1, cd = _chunk_rows(C, 3, H), _chunk_rows(H, 1, C), _chunk_rows(C, 2, CO)
    return (c3, c1, cd), max(3 * c3 * H, c1 * C, 2 * cd * CO)


def _tiled_floats(spec: StageSpec, rows: int) -> int:
    """Shared floats of an item of ``rows`` r rows (csrc/seanet.cu:
    tiled_floats): the input tile and ELU(a) [C][rows + 8] (ELU(r) by phase
    [s][C][rows / s + 4] over ELU(a)), z [H][rows] (the output tile
    [C_out][rows / s + 4] over it), the ring, the biases, the ring's full and
    empty mbarriers (8 bytes each)."""
    C, H, s, CO = spec.c_in, spec.res_hidden, spec.stride, spec.c_out
    rs, es = rows + 8, rows // s + 4
    slot = _tiled_chunks(spec)[1]
    return (C * rs + max(C * rs, s * C * es) + max(H * rows, CO * es) + FMA_STAGES * slot
            + _round_up(H + C + CO, 4) + 4 * FMA_STAGES)


def tiled_plan(spec: StageSpec) -> tp.Optional[TiledPlan]:
    """The register-tiled fp32-FMA K4's plan for this stage (fp32, and bf16
    where the tensor-core variant is not built), or None for a stage it is
    not built for, which runs ``stage_kernel`` (the first FMA kernel)."""
    key = (spec.c_in, spec.res_hidden, spec.c_out, spec.stride)
    if key not in _TILED_STAGES:
        return None
    rows = 256 if 4 * _tiled_floats(spec, 256) <= SMEM_LIMIT else 128
    chunks, slot = _tiled_chunks(spec)
    return TiledPlan(rows // spec.stride - 1, rows, FMA_STAGES, slot, chunks,
                     4 * _tiled_floats(spec, rows))


# The kernel variants of K4 (csrc/seanet.cu:Variant)
SIMT, TILED, TENSOR_CORES = 0, 1, 2


def stage_route(spec: StageSpec, dtype: torch.dtype
                ) -> tp.Tuple[int, tp.Union[StagePlan, TiledPlan, None]]:
    """Which K4 variant runs this stage in ``dtype``, and its plan: the
    tensor cores (bf16 at the widths they are built for), else the
    register-tiled FMA kernel where it is built, else ``stage_kernel``."""
    plan = stage_plan(spec, dtype)
    if plan is not None:
        return TENSOR_CORES, plan
    tiled = tiled_plan(spec)
    return (TILED, tiled) if tiled is not None else (SIMT, None)


def stage_weight_l2_bytes(spec: StageSpec, plan: StagePlan, batch: int, length: int,
                          blocks: int) -> int:
    """Weight bytes the tensor-core K4 reads from L2 in one launch of
    ``blocks`` persistent blocks: w1 and w2 once a block, wd once a block
    where resident, else once an item (each warpgroup copies its columns)."""
    C, H, s, CO = spec.c_in, spec.res_hidden, spec.stride, spec.c_out
    items = batch * -(-(length // s) // plan.tile)
    wd = 2 * 2 * s * C * CO
    if plan.ring:
        return blocks * 2 * (3 * C * H + H * C) + items * wd
    return blocks * (2 * (3 * C * H + H * C) + wd)


def _check_stage(x: torch.Tensor, params: tp.Dict[str, torch.Tensor], spec: StageSpec,
                 what: str) -> bool:
    """Check a stage's input and weights; True for a CPU tensor (run the
    plain version), and on a CUDA tensor raise on what the kernel cannot
    take."""
    cpu = _on_cpu(x, what)
    C, H, s, C_out = spec.c_in, spec.res_hidden, spec.stride, spec.c_out
    if x.dim() != 3 or x.shape[1] != C:
        raise ValueError(f"{what} takes [B, {C}, L], not {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{what} takes fp32 or bf16, not {x.dtype}")
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
        return True
    if not (x.is_contiguous() and all(p.is_contiguous() for p in params.values())):
        raise ValueError(f"{what} takes contiguous inputs and weights")
    if B > 65535:
        raise ValueError(f"batch {B} is larger than the kernel's grid")
    return False


def packed_stage_weights(params: tp.Dict[str, torch.Tensor], spec: StageSpec
                         ) -> tp.Dict[str, torch.Tensor]:
    """``w1_mma``, ``w2_mma``, ``wd_mma``: the stage's K-major weights in the
    layouts the tensor-core K4 reads (:func:`stage_plan` for their dtype);
    empty where an FMA variant runs the stage."""
    if stage_plan(spec, params['w1'].dtype) is None:
        return {}
    return {f'{k}_mma': pack_b_tiles(params[k]) for k in ('w1', 'w2', 'wd')}


def _launch_stage(x: torch.Tensor, params: tp.Dict[str, torch.Tensor], spec: StageSpec,
                  clocks: tp.Optional[torch.Tensor] = None, max_blocks: int = 0) -> torch.Tensor:
    """Launch K4 (the counter's instance with ``clocks``, its grid capped at
    ``max_blocks`` where that is positive)."""
    C, H, s, C_out = spec.c_in, spec.res_hidden, spec.stride, spec.c_out
    B, _, L = x.shape
    lib = _build.library()
    variant, plan = stage_route(spec, x.dtype)
    y = torch.empty(B, C_out, L // s, dtype=x.dtype, device=x.device)
    if B == 0:
        return y
    w = {k: params[k] for k in ('w1', 'b1', 'w2', 'b2', 'wd', 'bd')}
    if variant == TENSOR_CORES:
        w.update({k: params[f'{k}_mma'] if f'{k}_mma' in params else pack_b_tiles(w[k])
                  for k in ('w1', 'w2', 'wd')})
    elif variant == TILED:   # fp32 weights (exact for bf16 ones)
        w = {k: v.float() for k, v in w.items()}
    args = (x.data_ptr(), w['w1'].data_ptr(), w['b1'].data_ptr(), w['w2'].data_ptr(),
            w['b2'].data_ptr(), w['wd'].data_ptr(), w['bd'].data_ptr(), y.data_ptr(), B, C,
            H, C_out, L, s, int(x.dtype == torch.bfloat16), variant,
            plan.args() if plan else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if clocks is None:
            _build.check(lib.acx_seanet_stage(*args, stream), 'acx_seanet_stage')
        else:
            _build.check(lib.acx_seanet_stage_clocks(*args, clocks.data_ptr(), max_blocks,
                                                     stream), 'acx_seanet_stage_clocks')
    return y


def fused_stage(x: torch.Tensor, params: tp.Dict[str, torch.Tensor],
                spec: StageSpec) -> torch.Tensor:
    """One fused encoder stage (K4): x [B, C, L] (fp32 or bf16, L % s == 0)
    and :func:`stage_params` weights in x's dtype -> [B, C_out, L / s].

    The variant is :func:`stage_route`'s: bf16 at the widths the
    tensor-core variant is built for runs it; fp32 (and bf16 at the debug
    codecs' widths) the register-tiled FMA variant; any other width the
    first FMA kernel.  ``params`` may also hold ``w1_mma``, ``w2_mma`` and
    ``wd_mma``, the weights already in :func:`pack_b_tiles` layout
    (:func:`encoder_stage_weights` packs them once); else they are packed
    here.  Forward only (``ops/_grad.py``)."""
    refuse_grad('fused_stage (K4)', (x, *params.values()), 'fused_stages=0')
    if _check_stage(x, params, spec, 'fused_stage'):
        return fused_stage_reference(x, params, spec)
    y = _launch_stage(x, params, spec)
    fused_stage.launches += 1
    if x.dtype == torch.float32:
        fused_stage.fp32_launches += 1
    return y


fused_stage.launches = 0       # kernel launches since the last reset, every variant
fused_stage.fp32_launches = 0  # of which fp32 (the parity path: an FMA kernel)

FMA_PHASES = ('input', 'conv3', 'conv1', 'reflect', 'downsample', 'output')
MMA_PHASES = ('input wait', 'ELU(a)', 'conv3', 'conv1', 'reflect', 'downsample', 'output')
# the register-tiled FMA variant (csrc/seanet.cu:TiledPhase): 'input' issues
# the next item's copy (or gathers an edge tile), 'chunk wait' sums the
# computing warps' waits for weight chunks and, at each item's start, for
# its input
TILED_PHASES = ('input', 'ELU(a)', 'conv3', 'conv1', 'reflect', 'downsample', 'output',
                'chunk wait')
_CLOCK_PHASES = 8   # csrc/seanet.cu:kPhases


def fused_stage_clocks(x: torch.Tensor, params: tp.Dict[str, torch.Tensor], spec: StageSpec,
                       max_blocks: int = 0
                       ) -> tp.Tuple[torch.Tensor, tp.Dict[str, int], tp.Dict[str, int]]:
    """A measurement, not a route: one K4 launch built with its per-phase
    cycle counter, on a CUDA tensor.  Returns the output and, for each phase
    of the variant that ran (:data:`MMA_PHASES`, :data:`TILED_PHASES` or
    :data:`FMA_PHASES`), the
    %clock64 cycles thread 0 of every block spent in it, barrier included,
    summed over the blocks; and (tensor-core variant) the cycles each warp
    spent on the phase's own work before the barrier, summed over the warps
    of every block.  ``max_blocks`` > 0 caps a persistent grid.  Not counted
    in the launches."""
    if _check_stage(x, params, spec, 'fused_stage_clocks'):
        raise ValueError("fused_stage_clocks measures the kernel: it takes a CUDA tensor")
    clocks = torch.zeros(2 * _CLOCK_PHASES, dtype=torch.int64, device=x.device)
    y = _launch_stage(x, params, spec, clocks, max_blocks)
    phases = (FMA_PHASES, TILED_PHASES, MMA_PHASES)[stage_route(spec, x.dtype)[0]]
    counts = clocks.tolist()
    return (y, dict(zip(phases, counts)),
            dict(zip(phases, counts[_CLOCK_PHASES:])) if phases is MMA_PHASES else {})


def stage_kernel_info(spec: StageSpec, batch: int, length: int,
                      dtype: torch.dtype) -> tp.Dict[str, int]:
    """Registers, shared bytes, blocks per SM, threads, spilled bytes, frames
    per tile and blocks launched of the K4 instance that
    :func:`fused_stage` launches for this input on the current card."""
    out = (ctypes.c_int * 7)()
    variant, plan = stage_route(spec, dtype)
    _build.check(_build.library().acx_seanet_stage_info(
        batch, spec.c_in, spec.res_hidden, spec.c_out, length, spec.stride,
        int(dtype == torch.bfloat16), variant, plan.args() if plan else None, out),
        'acx_seanet_stage_info')
    return dict(zip(('registers', 'shared_bytes', 'blocks_per_sm', 'threads', 'spill_bytes',
                     'tile', 'blocks'), out))


def fused_encoder_apply(enc, x: torch.Tensor, n_stages: int,
                        conv0: tp.Optional[tp.Callable[[torch.Tensor],
                                                       tp.Optional[torch.Tensor]]] = None
                        ) -> tp.Optional[tp.Tuple[torch.Tensor, int]]:
    """Run the input conv and the first ``n_stages`` planned stages through
    K4.  x: [B, 1, T].  The input conv is ``conv0(x)`` when given and not
    None (``SEANetEncoder._conv0_kernel``: K5), else the module's own; the
    function is the same either way.  Returns (y, next_layer), or None when
    no stage fuses (the caller runs the module stack)."""
    plan = encoder_stage_plan(enc)[:n_stages]
    if not fused_length_ok(enc, x.shape[-1], n_stages):
        return None
    y = conv0(x) if conv0 is not None else None
    if y is None:
        y = enc.model[0](x)
    next_layer = 0
    for spec, ids in plan:
        if y.shape[-1] % spec.stride:
            break
        y = fused_stage(y, encoder_stage_weights(enc, spec, ids, y.dtype), spec)
        next_layer = ids[-1] + 1
    return y, next_layer


# ------------------------------------------------------ mono input conv (K5, K6)

_MAX_TAPS = 15     # taps of the kernel's generic instance (csrc/seanet.cu:kMaxTaps)
CONV_OUTS = 8      # consecutive outputs a thread stores as 16 bytes (csrc/seanet.cu:kConvOuts)
CONV_TILE = 1024   # outputs of one item along T (csrc/seanet.cu:kConvTile)


@dataclasses.dataclass(frozen=True)
class MonoPlan:
    """How K5 / K6 lay the conv over the card: the instance's taps (7, the
    codec's, or the generic 15 that takes any fewer), the channels a thread
    keeps in registers, the outputs a thread stores as one 16-byte vector
    (two for fp32), the outputs of one item, and the shared bytes of the two
    input buffers, which the C entry recomputes and must find equal."""
    taps: int
    channels: int
    outputs: int
    tile: int
    smem_bytes: int

    def args(self) -> ctypes.Array:
        return (ctypes.c_int * 5)(self.taps, self.channels, self.outputs, self.tile,
                                  self.smem_bytes)


def mono_conv_plan(taps: int, dtype: torch.dtype) -> MonoPlan:
    """The plan for a mono conv of ``taps`` taps in ``dtype``: the codec's
    7 taps take the instance with 8 channels a thread, every other width the
    generic one with 4; each input buffer holds a tile, its halo and one
    element of shift, in 16-byte units."""
    inst, channels = (7, 8) if taps == 7 else (_MAX_TAPS, 4)
    size = torch.finfo(dtype).bits // 8
    buffer = _round_up((CONV_TILE + inst + 1) * size, 16)
    return MonoPlan(inst, channels, CONV_OUTS, CONV_TILE, 2 * buffer)


def _mono_conv_ref(xp: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    with fp32_convs(torch.float32):
        y = F.conv1d(xp.float(), weight.to(dtype).float())
    return (y + bias.float()[:, None]).to(dtype)


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
                                int(x.dtype == torch.bfloat16),
                                mono_conv_plan(k, x.dtype).args(), stream)
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
    if not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous input")
    return False


def banded_mono_conv(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """K5, the encoder's first conv on a padded mono signal: x [B, 1, T + k - 1],
    weight [C_out, 1, k], bias [C_out] (added in fp32) -> [B, C_out, T].
    Forward only (``ops/_grad.py``)."""
    refuse_grad('banded_mono_conv (K5)', (x, weight, bias), 'conv0_kernel=False')
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
    T > (k - 1) / 2 -> [B, C_out, T]; the bias is rounded to x's dtype.
    Forward only (``ops/_grad.py``)."""
    refuse_grad('mono_input_conv (K6)', (x, weight, bias), 'the module stack')
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
