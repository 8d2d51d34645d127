"""The launch plan of the tensor-core SEANet stage kernel (K4), on the CPU.

``ops/seanet.py:stage_plan`` decides how one encoder stage is laid over the
card: frames per item, input tiles in shared memory, wd resident or
streamed through each warp's ring, and the shared bytes, which
``csrc/seanet.cu:mma_geometry`` computes again and must find equal (only
the card can show that; change both copies together).  Here the plan is
held to the shapes the repository runs, and the weights' packing and its
once-per-encoder cache to what the kernel reads.
"""

import math

import pytest
import torch

from audiocraft_tpu_torch import builders
from audiocraft_tpu_torch.ops import seanet as tsp
from audiocraft_tpu_torch.ops.seanet import StagePlan, StageSpec, stage_plan

STAGE0 = StageSpec(c_in=64, c_out=128, stride=4)     # 32 kHz, encode(fused=True) stage 0
STAGE1 = StageSpec(c_in=128, c_out=256, stride=4)    # and stage 1
STAGE24 = StageSpec(c_in=32, c_out=64, stride=2)     # 24 kHz, stage 0


def test_stage0_keeps_every_weight_resident_with_two_input_tiles():
    """144 KiB of weights beside two input tiles of 31 frames (128 r rows)."""
    assert stage_plan(STAGE0, torch.bfloat16) == StagePlan(31, 2, 0, 216384)


def test_stage1_streams_wd_through_the_warpgroups_rings():
    """wd is 512 KiB: each of 4 warpgroups streams its 64 rows of wd^T, 2 KiB
    a k-chunk, through a ring of 8 chunks (64 KiB in all)."""
    assert stage_plan(STAGE1, torch.bfloat16) == StagePlan(31, 1, 8, 228160)
    # the rings and their 8 x 4 mbarriers in place of the resident wd
    assert tsp._mma_smem_bytes(STAGE1, 1, 8) - tsp._mma_smem_bytes(STAGE1, 1, 0) \
        == 8 * 16 * 256 * 2 + 8 * 4 * 8 - 2 * 8 * 128 * 256


def test_24khz_stage0_takes_63_frames_at_stride_2():
    plan = stage_plan(STAGE24, torch.bfloat16)
    assert (plan.tile, plan.in_bufs, plan.ring) == (63, 2, 0)


@pytest.mark.parametrize("spec,dtype", [
    (STAGE0, torch.float32), (STAGE1, torch.float32),          # fp32: the parity path
    (StageSpec(c_in=4, c_out=8, stride=16), torch.bfloat16),   # the debug codec's widths
    (StageSpec(c_in=48, c_out=96, stride=4), torch.bfloat16),  # widths not built
    (StageSpec(c_in=64, c_out=128, stride=8), torch.bfloat16),     # a stride not built
    (StageSpec(c_in=128, c_out=256, stride=5), torch.bfloat16),
])
def test_fp32_and_stages_off_the_instantiations_take_the_fma_variant(spec, dtype):
    assert stage_plan(spec, dtype) is None


@pytest.mark.parametrize("spec", [STAGE0, STAGE1, STAGE24])
def test_every_plan_fills_two_m64_blocks_within_shared_memory(spec):
    plan = stage_plan(spec, torch.bfloat16)
    assert spec.stride * (plan.tile + 1) == 128 and (plan.tile + 1) % 8 == 0
    assert plan.tile + 1 in (32, 64)   # the downsample's N: a wgmma width it is built for
    assert plan.smem_bytes == tsp._mma_smem_bytes(spec, plan.in_bufs, plan.ring)
    assert plan.smem_bytes <= tsp.SMEM_LIMIT
    assert plan.ring in (0, tsp.RING) and (plan.ring == 0 or spec.c_out == 256)


def test_stage0_shared_bytes_by_part():
    """The parts csrc/seanet.cu:mma_geometry lays out, one by one."""
    C, H, CO, s = 64, 32, 128, 4
    weights = 2 * (3 * C * H + H * C + 2 * s * C * CO)
    raw = 2 * C * 152 * 2               # two input tiles, 19 16-byte units a row
    elu = max(131 * (C + 8) * 2,        # ELU(a): 130 rows and a spare one
              s * (32 // 8 * C * 16 + 32))   # ELU(r): 4 phases of 4 core-matrix rows, padded
    z = 2 * max(128 * (H + 8), CO * 40)
    bias = 4 * (H + C + CO)
    barriers = 2 * 8                    # one mbarrier an input tile
    assert weights == 147456 and elu == 18864
    assert tsp._mma_smem_bytes(STAGE0, 2, 0) == weights + raw + elu + z + bias + barriers \
        == 216384


def _elu_r_byte(q: int, c: int, C: int, s: int) -> int:
    """csrc/seanet.cu:stage_mma_kernel e_at: ELU(r) row q = s j + p, channel
    c, in phase p's 8 x 8 core matrices (16-byte rows)."""
    phase_bytes = (128 // s) // 8 * C * 16 + 128 // s
    j = q // s
    return (q % s) * phase_bytes + (j // 8) * C * 16 + (c // 8) * 128 + (j % 8) * 16 + (c % 8) * 2


@pytest.mark.parametrize("C,s", [(32, 2), (64, 4), (128, 4)])
def test_elu_r_stores_of_one_row_group_fall_on_distinct_banks(C, s):
    """conv1's epilogue stores 8 consecutive r rows x 4 words at once; the
    padding of each phase makes them 32 distinct banks."""
    for q0 in range(0, 128, 8):
        for c0 in range(0, C, 8):
            banks = {_elu_r_byte(q, c0 + 2 * t, C, s) // 4 % 32
                     for q in range(q0, q0 + 8) for t in range(4)}
            assert len(banks) == 32


@pytest.mark.parametrize("C,s", [(32, 2), (64, 4), (128, 4)])
def test_elu_r_layout_is_the_descriptors_canonical_layout(C, s):
    """The downsample's B operand of phase p and channels 16 cc .. is read
    through a descriptor: 16-byte rows of 8 frames x 8 channels, the two
    channel halves 128 bytes apart (LBO), 8-frame groups C * 16 apart (SBO);
    every row the products read lies inside the buffer."""
    frames = 128 // s
    base = lambda p, cc: _elu_r_byte(p, 16 * cc, C, s)
    for p in range(s):
        for cc in range(C // 16):
            for j in range(frames):
                for ci in range(16):
                    want = base(p, cc) + (ci // 8) * 128 + (j // 8) * C * 16 + (j % 8) * 16 \
                        + (ci % 8) * 2
                    assert _elu_r_byte(s * j + p, 16 * cc + ci, C, s) == want
    top = max(_elu_r_byte(q, c, C, s) for q in range(128) for c in range(C))
    spec = StageSpec(c_in=C, c_out=2 * C, stride=s)
    assert top + 2 <= s * ((128 // s) // 8 * C * 16 + 128 // s)
    assert tsp._mma_smem_bytes(spec, 1, 0) > 0


def test_weight_bytes_from_l2():
    """Stage 1 at b128 x 10 s: wd once an item (each warpgroup its columns),
    w1 and w2 once a block; stage 0: everything once a block."""
    plan = stage_plan(STAGE1, torch.bfloat16)
    items = 128 * math.ceil(20000 / 31)
    wd, w12 = 2 * 1024 * 256, 2 * (384 * 64 + 64 * 128)
    assert tsp.stage_weight_l2_bytes(STAGE1, plan, 128, 80000, 132) == 132 * w12 + items * wd
    resident = stage_plan(STAGE0, torch.bfloat16)
    assert tsp.stage_weight_l2_bytes(STAGE0, resident, 128, 320000, 132) == 132 * 147456


def test_encoder_stage_weights_pack_once_and_again_after_a_change():
    model = builders.get_encodec_32khz(device='cpu')
    enc = model.encoder
    (spec, ids), _ = tsp.encoder_stage_plan(enc)[:2]
    first = tsp.encoder_stage_weights(enc, spec, ids, torch.bfloat16)
    assert tsp.encoder_stage_weights(enc, spec, ids, torch.bfloat16) is first
    plain = tsp.stage_params(enc, spec, ids, torch.bfloat16)
    for k in plain:
        assert torch.equal(first[k], plain[k])
    for k in ('w1', 'w2', 'wd'):   # stage 0 keeps w1 resident
        assert torch.equal(first[f'{k}_mma'], tsp.pack_b_tiles(plain[k]))
    # an in-place update (as an optimizer step or load_state_dict makes)
    with torch.no_grad():
        enc.model[ids[1]].conv['conv']['weight'].mul_(2.0)
    second = tsp.encoder_stage_weights(enc, spec, ids, torch.bfloat16)
    assert second is not first
    assert torch.equal(second['wd_mma'], tsp.pack_b_tiles(2 * first['wd']))
    # a parameter put in another's place
    conv = enc.model[ids[0]].block[1].conv['conv']
    conv['bias'] = torch.nn.Parameter(conv['bias'].detach() + 1.0)
    third = tsp.encoder_stage_weights(enc, spec, ids, torch.bfloat16)
    assert third is not second and torch.equal(third['b1'], (second['b1'].float() + 1).bfloat16())
    # fp32 runs the FMA variant: no packed copies
    assert 'wd_mma' not in tsp.encoder_stage_weights(enc, spec, ids, torch.float32)


def test_counter_and_info_take_the_card_only():
    x = torch.zeros(1, 64, 8)
    params = {k: torch.zeros(shape) for k, shape in dict(
        w1=(192, 32), b1=(32,), w2=(32, 64), b2=(64,), wd=(512, 128), bd=(128,)).items()}
    with pytest.raises(ValueError, match="CUDA"):
        tsp.fused_stage_clocks(x, params, STAGE0)
    assert len(tsp.MMA_PHASES) == 7 and len(tsp.FMA_PHASES) == 6
    assert tsp._CLOCK_PHASES >= len(tsp.MMA_PHASES)


# ------------------------------------------------ the mono input conv (K5, K6)

def test_codec_mono_conv_takes_the_7_tap_instance_8_channels_a_thread():
    """64 channels x 7 taps: each warp keeps one group of 8 channels' 56
    weights in registers; an item is 1024 outputs, a thread stores 8 at a
    time; two input buffers of a tile, its 6-sample halo and one element of
    shift, in 16-byte units."""
    assert tsp.mono_conv_plan(7, torch.bfloat16) == tsp.MonoPlan(7, 8, 8, 1024, 2 * 2064)
    assert tsp.mono_conv_plan(7, torch.float32) == tsp.MonoPlan(7, 8, 8, 1024, 2 * 4128)


@pytest.mark.parametrize("taps", [1, 3, 5, 9, 15])
def test_other_widths_take_the_generic_instance(taps):
    plan = tsp.mono_conv_plan(taps, torch.bfloat16)
    assert (plan.taps, plan.channels) == (tsp._MAX_TAPS, 4) and taps <= plan.taps


@pytest.mark.parametrize("taps", [7, 15])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_an_input_buffer_holds_the_furthest_window_a_lane_reads(taps, dtype):
    """The last lane of the last segment reads elements shift + 1016 ..
    shift + 1016 + 8 + taps - 2 of its buffer; the interior copy moves whole
    4-byte words from one element of shift on."""
    plan = tsp.mono_conv_plan(taps, dtype)
    size = torch.finfo(dtype).bits // 8
    buffer = plan.smem_bytes // 2
    assert buffer % 16 == 0 and plan.tile % (32 * plan.outputs) == 0
    furthest = 1 + (plan.tile - plan.outputs) + plan.outputs + plan.taps - 2
    assert (furthest + 1) * size <= buffer
    words = -(-((plan.tile + taps - 1 + 1) * size) // 4)
    assert 4 * words <= buffer


def test_mono_plan_args_are_the_five_ints_the_entry_compares():
    plan = tsp.mono_conv_plan(7, torch.bfloat16)
    assert list(plan.args()) == [7, 8, 8, 1024, 4128]
