"""The operation and byte counts against the kernel table of PERF.md
(section 6, "Bound ms"), at the table's shapes: K1 at N = 64000, K2 at
T = 500, B = 128, K4 and K5 at b128 x 10 s.  K2's table entry counts the
whole layer call (the input projection, which cuBLAS runs before the
kernel, and the recurrence); the roofline of the kernel by its name counts
the recurrence alone."""

from __future__ import annotations

import pytest

from portbench.counts import PEAK_BF16, Work
from portbench.counts import codec, lm
from portbench.harness import spec

CFG = spec.config('encodec_32khz')


def ms(work: Work) -> float:
    return work.bound_s() * 1e3


def test_k1_at_the_main_shape():
    work = codec.k1(64000, 128, 2048, 4)
    assert ms(work) == pytest.approx(2.003, abs=5e-4)
    assert work.bound_by() == 'operations'


def test_k2_whole_layer_is_the_table_and_the_kernel_half_of_it():
    assert ms(codec.k2(500, 128, 1024, input_projection=True)) == pytest.approx(1.086, abs=5e-4)
    assert ms(codec.k2(500, 128, 1024)) == pytest.approx(1.086 / 2, abs=5e-4)


def test_k4_both_stages():
    stages = codec.fused_stages(CFG, 320000)
    assert [(s['c_in'], s['c_out'], s['stride'], s['length']) for s in stages] == \
        [(64, 128, 4, 320000), (128, 256, 4, 80000)]
    works = [codec.k4_stage(128, **s) for s in stages]
    assert ms(works[0]) == pytest.approx(2.348, abs=5e-4) and works[0].bound_by() == 'bytes'
    assert ms(works[1]) == pytest.approx(2.036, abs=5e-4)
    assert works[1].bound_by() == 'operations'
    assert codec.k4(CFG, 128, 320000) * 1e3 == pytest.approx(4.383, abs=5e-4)


def test_k5_at_the_main_shape():
    work = codec.k5(128, 320000, 64, 7)
    assert ms(work) == pytest.approx(1.589, abs=5e-4) and work.bound_by() == 'bytes'


def test_encode_and_decode_flops_count_every_layer():
    """A hand count of the 32 kHz codec on one 10 s clip."""
    T0 = 320000
    conv = lambda ci, co, k, n: 2.0 * ci * co * k * n  # noqa: E731
    want, c, n = conv(1, 64, 7, T0), 64, T0
    for r in (4, 4, 5, 8):
        want += conv(c, c // 2, 3, n) + conv(c // 2, c, 1, n)
        n //= r
        want += conv(c, 2 * c, 2 * r, n)
        c *= 2
    want += 2 * 2.0 * n * 4 * 1024 * 2048 + conv(1024, 128, 7, n) + 2.0 * n * 128 * 2048 * 4
    assert codec.encode_flops(CFG, T0) == pytest.approx(want)
    assert 70e9 < codec.decode_flops(CFG, 500) < 90e9


def test_musicgen_step_flops():
    m = spec.config('musicgen_small')
    per_row = lm.decode_flops(m['lm'], 1500, 0) / 1503
    # 24 layers x 14 d^2 and 4 heads of 1024 x 2048, two operations a weight
    weights = 2.0 * (24 * 14 * 1024 ** 2 + 4 * 1024 * 2048)
    assert weights < per_row < weights * 1.2
    assert PEAK_BF16 == 989e12
