"""The launch plan and codebook packing of the RVQ kernel (K1), on the CPU.

``ops/rvq.py:rvq_plan`` decides how a block lays the chain over the card:
rows of residual kept in shared memory, codes a tile, the ring of codebook
chunks and the shared bytes, which ``csrc/rvq.cu:make_plan`` computes again
and must find equal (only the card can show that; change both copies
together).  ``pack_codebooks`` lays the codebooks out as the kernel streams
them.  Here the plan is held to the widths the repository quantizes, and the
packing to what the kernel's threads read, by following the kernel's
indexing in numpy.
"""

import numpy as np
import pytest
import torch

from audiocraft_tpu_torch.ops import rvq
from audiocraft_tpu_torch.ops.rvq import RvqPlan, pack_codebooks, rvq_plan


def test_codec_width_keeps_128_rows_two_blocks_an_sm():
    """D = 128 (every codec): 128 rows, 128 codes a tile, a ring of 3 chunks
    of 16 features, 93,184 shared bytes: two blocks fit an SM's 228 KiB."""
    plan = rvq_plan(128)
    assert plan == RvqPlan(128, 128, 16, 3, 93184)
    assert 2 * (plan.smem_bytes + 1024) <= 233472


def test_codec_shared_bytes_by_part():
    residual = 128 * 128 * 4          # D x rows fp32
    ring = 3 * 16 * 128 * 4           # stages x features x codes
    norms = 256 * 4 + 128 * 4         # |r|^2 partials of 256 threads, |r|^2 per row
    bests = 2 * 1 * 128 * 4           # (value, index) of one warp a row
    chosen = 128 * 4
    assert rvq_plan(128).smem_bytes == residual + ring + norms + bests + chosen


@pytest.mark.parametrize("d,rows", [(32, 128), (128, 128), (256, 128), (400, 128),
                                    (401, 64), (512, 64), (800, 32), (1024, 32)])
def test_rows_a_block_fall_as_the_residual_grows(d, rows):
    """The most rows (128, 64, 32) whose residual fits beside the ring; the
    256 threads' 8 x 8 register tiles always cover rows x codes."""
    plan = rvq_plan(d)
    assert plan.rows == rows
    assert plan.rows * plan.codes == 256 * 8 * 8
    assert plan.smem_bytes <= rvq.SMEM_LIMIT
    if rows < 128:   # twice the rows would not fit
        assert rvq._smem_bytes(2 * rows, d) > rvq.SMEM_LIMIT


def test_widest_row_takes_two_warps_a_row_of_partial_bests():
    """At D = 1024 a tile is 512 codes: the 64 threads of a row span two
    warps, whose partial bests meet in shared memory."""
    plan = rvq_plan(1024)
    assert plan == RvqPlan(32, 512, 16, 3, 231168)
    assert plan.smem_bytes == 4 * (1024 * 32 + 3 * 16 * 512 + 256 + 32 + 2 * 2 * 32 + 32)


def test_a_row_wider_than_shared_memory_holds_raises():
    with pytest.raises(ValueError, match="shared memory"):
        rvq_plan(1025)


@pytest.mark.parametrize("n_q,k,d", [(4, 2048, 128), (4, 400, 32), (2, 1000, 1024), (3, 7, 5)])
def test_packing_puts_each_element_where_the_kernel_reads_it(n_q, k, d):
    """E^T [n_q, Dp, Kp]: feature f of code c of codebook q at [q, f, c],
    zeros past D and K; |E|^2 [n_q, Kp] summed per code."""
    plan = rvq_plan(d)
    embeds = torch.from_numpy(np.random.RandomState(k + d).randn(n_q, k, d).astype(np.float32))
    et, esq = pack_codebooks(embeds, plan)
    dp, kp = -(-d // plan.chunk) * plan.chunk, -(-k // plan.codes) * plan.codes
    assert et.shape == (n_q, dp, kp) and esq.shape == (n_q, kp) and et.is_contiguous()
    assert torch.equal(et[:, :d, :k], embeds.transpose(1, 2))
    assert not et[:, d:].any() and not et[:, :, k:].any() and not esq[:, k:].any()
    assert torch.equal(esq[:, :k], embeds.square().sum(-1))


def test_threads_tiles_and_chunks_cover_every_product_once():
    """Follow the kernel's reads: chunk (q, t, dc) of the ring holds
    et[q, 16 dc + f, codes t + c]; thread (rg, cg) multiplies rows 4 rg + i
    and rows / 2 + 4 rg + i by codes 4 cg + j and codes / 2 + 4 cg + j.  The
    sums over the chunks are x . E^T, every (row, code) summed by one thread."""
    n, d, k = 128, 40, 300
    plan = rvq_plan(d)
    rng = np.random.RandomState(0)
    x = rng.randn(n, d).astype(np.float32)
    embeds = rng.randn(1, k, d).astype(np.float32)
    et = pack_codebooks(torch.from_numpy(embeds), plan)[0].numpy()
    res = np.zeros((et.shape[1], plan.rows), np.float32)     # feature-major residual
    res[:d, :n] = x.T
    ct = plan.codes // 8
    dots = np.zeros((n, et.shape[2]), np.float64)
    seen = np.zeros(dots.shape, np.int64)
    for t in range(et.shape[2] // plan.codes):
        for tid in range(256):
            cg, rg = tid % ct, tid // ct
            rows = [4 * rg + i for i in range(4)] + [plan.rows // 2 + 4 * rg + i for i in range(4)]
            cols = [4 * cg + j for j in range(4)] + [plan.codes // 2 + 4 * cg + j for j in range(4)]
            acc = np.zeros((8, 8), np.float64)
            for dc in range(et.shape[1] // plan.chunk):
                slot = et[0, dc * plan.chunk:(dc + 1) * plan.chunk, t * plan.codes:(t + 1) * plan.codes]
                a = res[dc * plan.chunk:(dc + 1) * plan.chunk][:, rows]
                acc += a.T.astype(np.float64) @ slot[:, cols].astype(np.float64)
            dots[np.ix_(rows, [t * plan.codes + c for c in cols])] += acc
            seen[np.ix_(rows, [t * plan.codes + c for c in cols])] += 1
    assert (seen == 1).all()
    np.testing.assert_allclose(dots[:, :k], x.astype(np.float64) @ embeds[0].T.astype(np.float64),
                               rtol=1e-6, atol=1e-6)
    # each thread's codes come in increasing order: j < 4, then the second half
    cols = [4 * 3 + j for j in range(4)] + [plan.codes // 2 + 4 * 3 + j for j in range(4)]
    assert cols == sorted(cols)


def test_packing_follows_a_changed_codebook():
    """The packing is built on every call: a changed codebook packs anew."""
    plan = rvq_plan(128)
    embeds = torch.randn(2, 64, 128)
    first = pack_codebooks(embeds, plan)
    embeds[1, 5] += 1.0
    second = pack_codebooks(embeds, plan)
    assert not torch.equal(first[0], second[0]) and not torch.equal(first[1], second[1])
    assert torch.equal(second[0][1, :, 5], embeds[1, 5])


def test_counter_takes_the_card_only():
    with pytest.raises(ValueError, match="CUDA"):
        rvq.rvq_encode_clocks(torch.zeros(4, 128), torch.zeros(1, 16, 128))
    assert len(rvq.PHASES) == 7 and rvq._CLOCK_PHASES >= len(rvq.PHASES)


def test_plan_args_are_the_five_ints_the_entry_compares():
    plan = rvq_plan(256)
    assert list(plan.args()) == [plan.rows, plan.codes, plan.chunk, plan.stages, plan.smem_bytes]
