"""The launch plan of the LSTM kernel (K2), on the CPU.

``ops/lstm.py:lstm_plan`` decides how one layer's recurrence is laid over
the card: hidden units and batch rows per block, grid, batch tile, K chunk,
ring depth, and whether a block's slice of W_hh stays resident in shared
memory or streams through the ring.  The kernel recomputes the shared-memory bytes from the same
numbers and refuses a plan that disagrees, which only the card can show;
here the plan's choices are held to the shapes the repository runs.
"""

import pytest
import torch

from audiocraft_tpu_torch.ops.lstm import fit_plan, lstm_plan

SMS, SMEM = 132, 232448   # an H100 SXM: SMs and opt-in shared bytes per block


@pytest.mark.parametrize("batch", [4, 8, 16])
def test_small_batch_bf16_layer_is_resident_on_128_blocks_of_8_units(batch):
    """The training encode and MAGNeT decode (B = 4): 64 KB of W_hh a block."""
    plan = lstm_plan(1024, batch, torch.bfloat16, SMS, SMEM)
    assert (plan.units, plan.grid, plan.batch_groups) == (8, 128, 1)
    assert plan.resident and plan.weight_bytes == 64 * 1024
    assert plan.weight_bytes < plan.smem_bytes <= SMEM
    assert plan.masked == (batch % 8 != 0)


def test_codec_layer_in_bf16_splits_the_batch_over_16_unit_blocks():
    """B = 128: doubling the units frees half the SMs for a second batch
    group, so a block reads 64 rows of h a step instead of 128."""
    plan = lstm_plan(1024, 128, torch.bfloat16, SMS, SMEM)
    assert (plan.units, plan.batch_groups, plan.batch_rows, plan.grid) == (16, 2, 64, 128)
    assert plan.resident and plan.weight_bytes == 128 * 1024 and plan.smem_bytes <= SMEM
    assert plan.batch_tile == 64 and not plan.masked


def test_codec_layer_in_fp32_keeps_128_kb_resident():
    plan = lstm_plan(1024, 128, torch.float32, SMS, SMEM)
    assert (plan.units, plan.grid, plan.batch_groups) == (8, 128, 1)
    assert plan.resident and plan.weight_bytes == 128 * 1024
    assert plan.smem_bytes <= SMEM


@pytest.mark.parametrize("batch,groups,rows", [(16, 1, 16), (31, 1, 31), (32, 2, 16),
                                               (100, 2, 50), (128, 2, 64), (300, 2, 150)])
def test_batch_groups_hold_at_least_16_rows(batch, groups, rows):
    plan = lstm_plan(1024, batch, torch.bfloat16, SMS, SMEM)
    assert (plan.batch_groups, plan.batch_rows) == (groups, rows)
    assert plan.grid == plan.batch_groups * (1024 // plan.units) <= SMS


@pytest.mark.parametrize("batch,tile", [(4, 8), (8, 8), (3, 8), (20, 32), (31, 32),
                                        (128, 64), (300, 64)])
def test_batch_tile_is_a_power_of_two_times_8_up_to_128(batch, tile):
    """At most 128, and at most 4 tiles a warp: 64 rows at 16 units."""
    plan = lstm_plan(1024, batch, torch.bfloat16, SMS, SMEM)
    assert plan.batch_tile == tile
    assert plan.masked == (plan.batch_rows % tile != 0
                           or plan.batch_rows * plan.batch_groups != batch)


def test_ragged_units_and_batch_are_masked():
    plan = lstm_plan(40, 3, torch.float32, SMS, SMEM)
    assert (plan.units, plan.grid) == (4, 10) and plan.masked and plan.resident
    ragged = lstm_plan(1030, 8, torch.bfloat16, SMS, SMEM)
    assert ragged.grid * ragged.units > 1030 and ragged.grid <= SMS and ragged.masked


@pytest.mark.parametrize("hidden,units", [(512, 4), (1024, 8), (1030, 8), (2048, 16),
                                          (40, 4)])
def test_units_cover_hidden_with_at_most_one_block_per_sm(hidden, units):
    plan = lstm_plan(hidden, 16, torch.bfloat16, SMS, SMEM)
    assert plan.units == units and plan.grid <= SMS and plan.batch_groups == 1
    assert (plan.grid - 1) * plan.units < hidden <= plan.grid * plan.units


def test_a_slice_too_large_to_hold_is_streamed():
    plan = lstm_plan(2048, 128, torch.float32, SMS, SMEM)
    assert not plan.resident and plan.weight_bytes > SMEM
    assert plan.smem_bytes <= SMEM and plan.batch_groups == 1
    assert lstm_plan(2048, 128, torch.bfloat16, SMS, SMEM).resident is False
    assert not lstm_plan(4096, 4, torch.float32, SMS, SMEM).resident


def test_fewer_sms_take_more_units():
    plan = lstm_plan(1024, 4, torch.bfloat16, 60, SMEM)
    assert (plan.units, plan.grid) == (32, 32)


@pytest.mark.parametrize("hidden,batch,dtype", [(1024, 100000, torch.float32),
                                                (20000, 2, torch.float32),
                                                (64, 2, torch.float16)])
def test_a_shape_nothing_holds_raises(hidden, batch, dtype):
    with pytest.raises(ValueError):
        lstm_plan(hidden, batch, dtype, SMS, SMEM)


@pytest.mark.parametrize("hidden,batch,dtype,smem", [
    (1024, 4, torch.bfloat16, 90112), (1024, 32, torch.bfloat16, 180480),
    (1024, 64, torch.bfloat16, 212992), (1024, 128, torch.bfloat16, 211968),
    (1024, 128, torch.float32, 221696), (40, 3, torch.float32, 8960),
    (40, 3, torch.bfloat16, 6528)])
def test_shared_memory_bytes_are_pinned(hidden, batch, dtype, smem):
    """The shared-memory layout is written twice, in ``ops/lstm.py:_smem_bytes``
    and ``csrc/lstm.cu:make_plan``, and the kernel refuses a plan whose bytes
    differ from its own.  These are plans that chip_smoke.py launches, with the
    bytes both copies give; a change to either copy must keep them or change
    them here with it."""
    assert lstm_plan(hidden, batch, dtype, SMS, SMEM).smem_bytes == smem


def test_one_batch_group_plan_bytes_are_pinned():
    """The codec layer held to one batch group, as chip_smoke.py times it."""
    plan = fit_plan(1024, 128, torch.bfloat16, 8, 1, True, SMEM)
    assert (plan.grid, plan.batch_tile, plan.k_chunk, plan.stages) == (128, 128, 128, 4)
    assert plan.smem_bytes == 217600
