"""One run of one cell: set-up, the measured window, the program freed, the
comparison with the plain reference, and the result line.

A driver (``drivers/<name>.py``) has four functions:

* ``setup(ctx) -> state``: build the program and its seeded weights and
  inputs, warm up every shape the window uses;
* ``window(ctx, state) -> dict``: the measured window; returns the
  end-to-end metrics (``e2e``), ``attempted`` and ``failed``, and what the
  per-layer readers read (``counters``, ``extra``);
* ``release(state)``: drop the program, so that the reference runs after it;
* ``check(ctx, state)``: the comparison with the plain reference, into
  ``ctx.checks``.

:func:`execute` runs them in that order.  ``ctx.control`` names a control
to run in the program's place (``'reference'``: the plain reference at the
precision below the configuration's; ``'program_int8'``: the program's own
lower-precision path, where it has one), which the check must find not
correct.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time
import types
import typing as tp

from . import spec
from .checks import Checks
from .device import Device
from .trace import Tracer


@dataclasses.dataclass
class Context:
    cell: dict
    cfg: dict
    seed: int
    seconds: float
    device: Device
    trace: bool = False
    control: str = ''         # '' the program; else the control of that name (the drivers)
    warm: bool = True          # False: skip the warm-up (a calibration's seeds)
    t_start: float = dataclasses.field(default_factory=time.perf_counter)
    tracer: Tracer = None
    checks: Checks = None
    # set-up kept across runs of one process (a calibration's seeds)
    reuse: tp.Dict[str, tp.Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.tracer is None:
            self.tracer = Tracer(self.device, self.trace)
        if self.checks is None:
            self.checks = Checks(self.cell['check']['limits'])

    @property
    def traffic(self) -> dict:
        return self.cell['params']


@dataclasses.dataclass
class Record:
    """What a per-layer reader reads."""
    cell: dict
    cfg: dict
    window_s: float
    spans: tp.Dict[str, tp.List[float]]
    counters: tp.Dict[str, float]
    extra: tp.Dict[str, tp.Any]
    trace: tp.Any


def _finite(x: float) -> tp.Optional[float]:
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def execute(ctx: Context, drv: types.ModuleType,
            layer_metrics: tp.Sequence[dict] = ()) -> dict:
    """Run the cell once; returns the result object (without the check of
    imported modules, which ``run.py`` makes)."""
    state = drv.setup(ctx)
    setup_s = time.perf_counter() - ctx.t_start
    out = drv.window(ctx, state)
    ctx.tracer.stop()
    device = ctx.device.describe()
    t_collect = time.perf_counter()
    ctx.tracer.collect()
    if ctx.tracer.trace is not None:
        print(f'trace: {len(ctx.tracer.trace.kernels)} device operations over '
              f'{ctx.tracer.trace.window_s:.3f} s, read in {time.perf_counter() - t_collect:.1f} s',
              file=sys.stderr, flush=True)
    drv.release(state)
    gc.collect()
    ctx.device.free()
    drv.check(ctx, state)
    result: tp.Dict[str, tp.Any] = {'correct': ctx.checks.correct,
                                    'attempted': int(out['attempted']),
                                    'failed': int(out['failed'])}
    if ctx.trace:
        rec = Record(ctx.cell, ctx.cfg, out['window_s'], dict(ctx.tracer.spans),
                     out.get('counters', {}), out.get('extra', {}), ctx.tracer.trace)
        metrics = {}
        for m in layer_metrics:
            value = spec.layer_reader(m['name'])(rec)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
        trace = ctx.tracer.trace
        if trace is not None:
            device['busy_s'] = trace.busy_s
            device['window_s'] = trace.window_s
            result['breakdown'] = {'device_ops': trace.device_ops(),
                                   'idle_gaps': trace.idle_gaps()}
    else:
        metrics = {name: {'value': value, 'unit': unit}
                   for name, (value, unit) in out['e2e'].items()}
        metrics['setup_s'] = {'value': setup_s, 'unit': 's'}
    result['metrics'] = metrics
    result['device'] = device
    result['checks'] = {k: {'value': _finite(v['value']), 'limit': v['limit']}
                        for k, v in ctx.checks.table().items()}
    return result
