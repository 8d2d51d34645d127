"""Observability: throughput counters, chained timing, rooflines, traces
(counterpart of ``audiocraft_tpu/obs/__init__.py``).

* :func:`chained_throughput` times ``step_fn(carry, x) -> (out, carry)``
  called eagerly, each call's 0-d carry fed to the next, with one host read
  of the carry after the timed calls; on a CUDA device the clock is read
  after that read, when the queue has drained.
* :class:`Meter`: running counters (audio seconds, tokens, bytes, items)
  with their rates.
* :func:`token_match`: the exact-match share of two token arrays (1.0 is
  bit parity).
* :func:`roofline`: the share of the card's peak compute and bandwidth that
  a measured interval reached (JAX's keys: ``pct_mxu`` is the tensor-core
  share here).
* :func:`effective_bandwidth_probe` measures the bandwidth of a streaming
  copy and a reduction on the device it runs on.
* :func:`profile_trace`: ``torch.profiler`` around a block, written as a
  Chrome trace into a directory.

``PEAK_FP32``, ``PEAK_BF16`` and ``PEAK_BYTES`` are the spec sheet's dense
peaks of one NVIDIA H100 SXM at its 700 W power limit: FP32 outside the
tensor cores, BF16 on the tensor cores (operations a second), and HBM3
bandwidth (bytes a second).  A card set below 700 W reaches less.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import typing as tp
from pathlib import Path

import numpy as np
import torch

PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

WARMUP_CALLS = 4


def _device_of(x: tp.Any) -> torch.device:
    """The device of ``x``, a tensor or a (nested) sequence led by one."""
    while isinstance(x, (list, tuple)):
        x = x[0]
    return x.device if isinstance(x, torch.Tensor) else torch.device('cpu')


def _drain(carry: torch.Tensor) -> float:
    """Read the carry on the host, then wait for the rest of the device's queue."""
    value = float(carry)
    if carry.is_cuda:
        torch.cuda.synchronize(carry.device)
    return value


def chained_throughput(step_fn: tp.Callable, inputs: tp.Sequence, iters: int = 8,
                       units_per_iter: float = 1.0) -> tp.Tuple[float, float]:
    """Time ``step_fn(carry, x) -> (out, scalar carry)`` over ``iters``
    calls, ``x`` cycling through ``inputs``, after four warm-up calls.
    Returns (seconds a call, units a second)."""
    device = _device_of(inputs[0])
    carry = torch.zeros((), device=device)
    for i in range(WARMUP_CALLS):
        _, carry = step_fn(carry, inputs[i % len(inputs)])
    _drain(carry)
    t0 = time.perf_counter()
    carry = torch.zeros((), device=device)
    for i in range(iters):
        _, carry = step_fn(carry, inputs[i % len(inputs)])
    _drain(carry)
    dt = (time.perf_counter() - t0) / iters
    return dt, units_per_iter / dt


def effective_bandwidth_probe(size_mb: int = 1024, iters: int = 8,
                              device: tp.Union[str, torch.device, None] = None
                              ) -> tp.Dict[str, tp.Any]:
    """The bandwidth (GB/s) that a streaming bf16 copy (one read, one write)
    and a full fp32-accumulated reduction reach on ``device`` (None: the
    CUDA card, raising without one), chained as :func:`chained_throughput`
    chains them.  Memory-floor estimates want numbers like these beside the
    spec sheet's."""
    from ..builders import resolve_device
    device = resolve_device(device)
    n = size_mb * 1024 * 1024 // 2
    xs = [(torch.arange(n, device=device, dtype=torch.float32) * (i + 1))
          .to(torch.bfloat16).reshape(n // 128, 128) for i in range(2)]

    def copy_step(c, x):
        y = x + (c.to(x.dtype) + 1)
        return y, y[:8].sum(dtype=torch.float32)

    def reduce_step(c, x):
        return None, x.sum(dtype=torch.float32) + c

    dt_c, _ = chained_throughput(copy_step, xs, iters=iters)
    dt_r, _ = chained_throughput(reduce_step, xs, iters=iters)
    nbytes = n * 2
    name = torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'
    return {'copy_gbs': 2 * nbytes / dt_c / 1e9, 'reduce_gbs': nbytes / dt_r / 1e9,
            'device': name}


@dataclasses.dataclass
class Meter:
    """Running throughput counters for a pipeline (the tokenize CLI, a server)."""
    started: float = dataclasses.field(default_factory=time.perf_counter)
    audio_seconds: float = 0.0
    tokens: int = 0
    bytes_in: int = 0
    items: int = 0

    def add(self, *, audio_seconds: float = 0.0, tokens: int = 0,
            bytes_in: int = 0, items: int = 1) -> None:
        self.audio_seconds += audio_seconds
        self.tokens += tokens
        self.bytes_in += bytes_in
        self.items += items

    @property
    def elapsed(self) -> float:
        return max(time.perf_counter() - self.started, 1e-9)

    def rates(self) -> tp.Dict[str, float]:
        e = self.elapsed
        return {
            'audio_sec_per_s': self.audio_seconds / e,
            'tokens_per_s': self.tokens / e,
            'bytes_per_s': self.bytes_in / e,
            'items_per_s': self.items / e,
            'elapsed_s': e,
        }

    def report(self) -> str:
        r = self.rates()
        return (f"{self.items} items | {self.audio_seconds:.1f} audio-sec "
                f"({r['audio_sec_per_s']:.1f}/s) | {self.tokens} tokens "
                f"({r['tokens_per_s']:.0f}/s) | "
                f"{self.bytes_in / 1e6:.1f} MB ({r['bytes_per_s'] / 1e6:.1f} MB/s)")


def _numpy(x: tp.Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def token_match(codes_a, codes_b) -> float:
    """Exact-match share of two token arrays or tensors (1.0: bit parity;
    0.0 when the shapes differ)."""
    a, b = _numpy(codes_a), _numpy(codes_b)
    if a.shape != b.shape:
        return 0.0
    return float((a == b).mean())


def roofline(seconds: float, flops: float = 0.0, bytes_moved: float = 0.0,
             peak_tflops: float = PEAK_BF16 / 1e12,
             peak_gbs: float = PEAK_BYTES / 1e9) -> tp.Dict[str, float]:
    """Rates and shares of peak reached over a measured interval (the peaks
    default to the H100's bf16 tensor cores and HBM3)."""
    out = {'seconds': seconds}
    if flops:
        out['tflops'] = flops / seconds / 1e12
        out['pct_mxu'] = 100.0 * out['tflops'] / peak_tflops
    if bytes_moved:
        out['gbs'] = bytes_moved / seconds / 1e9
        out['pct_hbm'] = 100.0 * out['gbs'] / peak_gbs
    if flops and bytes_moved:
        out['arithmetic_intensity'] = flops / bytes_moved
    return out


@contextlib.contextmanager
def profile_trace(log_dir: tp.Union[str, Path]) -> tp.Iterator[torch.profiler.profile]:
    """``torch.profiler`` over the block (CPU, and CUDA when a card is
    present); on exit its Chrome trace goes to
    ``log_dir/<pid>.<ns>.pt.trace.json`` (open it in Perfetto or
    chrome://tracing).  Yields the profiler, whose ``key_averages()`` sums
    the events by name."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / f'{os.getpid()}.{time.time_ns()}.pt.trace.json'))
