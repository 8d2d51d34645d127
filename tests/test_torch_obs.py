"""The port's observability module (``obs``) against the JAX package's, on
the CPU: the meter, the token match and the roofline give JAX's numbers;
the chained timer's rate is its units over its seconds; the trace and the
bandwidth probe run on the CPU.  Times here are the host's, never a
device's."""

import json
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiocraft_tpu import obs as jax_obs
from audiocraft_tpu_torch import obs


def _fill(meter):
    meter.add(audio_seconds=10.0, tokens=2000, bytes_in=1_000_000)
    meter.add(audio_seconds=5.0, tokens=1000, bytes_in=500_000, items=2)
    return meter


def test_meter_matches_jax(monkeypatch):
    ours, theirs = _fill(obs.Meter(started=100.0)), _fill(jax_obs.Meter(started=100.0))
    monkeypatch.setattr(time, 'perf_counter', lambda: 112.5)
    assert (ours.items, ours.audio_seconds, ours.tokens, ours.bytes_in) == (3, 15.0, 3000,
                                                                             1_500_000)
    assert ours.rates() == theirs.rates()
    assert ours.rates()['audio_sec_per_s'] == 15.0 / 12.5
    assert ours.report() == theirs.report()
    assert ours.report().startswith('3 items | 15.0 audio-sec (1.2/s)')


def test_token_match_matches_jax():
    a = np.random.RandomState(0).randint(0, 2048, (2, 4, 50))
    b = a.copy()
    b[0, 1, 7] = (b[0, 1, 7] + 1) % 2048
    b[1, 3, 0] = (b[1, 3, 0] + 1) % 2048
    for x, y in ((a, a.copy()), (a, b), (a, a[:1])):
        want = jax_obs.token_match(jnp.asarray(x), jnp.asarray(y))
        assert obs.token_match(x, y) == want
        assert obs.token_match(torch.from_numpy(x), torch.from_numpy(y)) == want
    assert obs.token_match(a, b) == 1 - 2 / a.size
    assert obs.token_match(a, a[:1]) == 0.0


def test_roofline_matches_jax_at_explicit_peaks():
    for kw in (dict(flops=3e12, bytes_moved=2e11), dict(flops=5e12), dict(bytes_moved=7e10),
               dict()):
        peaks = dict(peak_tflops=123.0, peak_gbs=456.0)
        assert obs.roofline(0.25, **kw, **peaks) == jax_obs.roofline(0.25, **kw, **peaks)
    # the defaults are the H100's bf16 tensor-core and HBM3 peaks
    r = obs.roofline(1.0, flops=obs.PEAK_BF16 / 2, bytes_moved=obs.PEAK_BYTES / 4)
    assert r['pct_mxu'] == pytest.approx(50.0) and r['pct_hbm'] == pytest.approx(25.0)
    assert (obs.PEAK_FP32, obs.PEAK_BF16, obs.PEAK_BYTES) == (67e12, 989e12, 3.35e12)
    assert not any(name.startswith('TPU_') for name in vars(obs))


def test_chip_smoke_takes_its_peaks_from_obs():
    import chip_smoke
    assert (chip_smoke.PEAK_FP32, chip_smoke.PEAK_BF16, chip_smoke.PEAK_BYTES) == (
        obs.PEAK_FP32, obs.PEAK_BF16, obs.PEAK_BYTES)


def test_chained_throughput_rate_is_units_over_seconds():
    calls = []

    def step(c, x):
        calls.append(c)
        y = x * 2
        return y, c + y.sum()

    x = torch.ones(16, 16)
    dt, rate = obs.chained_throughput(step, [x], iters=3, units_per_iter=4.0)
    assert dt > 0 and rate == pytest.approx(4.0 / dt, rel=1e-12)
    # four warm-up calls, then the timed ones from a fresh 0-d carry on the
    # inputs' device, each call fed the last one's carry
    assert len(calls) == obs.WARMUP_CALLS + 3
    timed = calls[obs.WARMUP_CALLS:]
    assert timed[0].dim() == 0 and float(timed[0]) == 0.0 and timed[0].device == x.device
    assert [float(c) for c in timed[1:]] == [512.0, 1024.0]


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with obs.profile_trace(tmp_path / 'trace') as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    files = list((tmp_path / 'trace').glob('*.pt.trace.json'))
    assert len(files) == 1
    trace = json.loads(files[0].read_text())
    assert any('mm' in e.get('name', '') for e in trace['traceEvents'])
    assert any('mm' in e.key for e in prof.key_averages())


def test_bandwidth_probe_runs_on_the_cpu():
    out = obs.effective_bandwidth_probe(size_mb=8, iters=2, device='cpu')
    assert out['copy_gbs'] > 0 and out['reduce_gbs'] > 0 and out['device'] == 'cpu'


def test_bandwidth_probe_refuses_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        obs.effective_bandwidth_probe(size_mb=8, iters=2)
