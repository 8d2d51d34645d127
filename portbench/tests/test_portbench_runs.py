"""Whole runs of each cell at debug sizes on the CPU, past the harness's look
for a card: the program is found correct; the control (the plain reference
at the precision below the configuration's, or the program's int8 path) is
not; and each fault a cell can have, planted in the program underneath the
timed path, turns ``correct`` false: an answer altered where it is produced,
a step that leaves its state unchanged, half of the batch left out.  The
same control at each cell's own size runs on the card (marker ``card``)."""

from __future__ import annotations

import contextlib
import json
import threading

import pytest
import torch

from portbench.harness import spec
from portbench.harness.session import execute
from portbench.tests import tiny

CELLS = [tiny.TOKENIZE, tiny.BATCH]
SECONDS = {tiny.TOKENIZE: 0.3, tiny.BATCH: 0.5}


def run(name: str, **kw) -> dict:
    ctx = tiny.context(name, seconds=SECONDS[name], **kw)
    result = execute(ctx, spec.driver(ctx.cell['driver']),
                     spec.per_layer(spec.benchmark(), name) if kw.get('trace') else ())
    assert threading.active_count() == 1, threading.enumerate()
    return result


@pytest.mark.parametrize('name', CELLS)
def test_program_is_correct(name):
    result = run(name)
    assert result['correct'], result['checks']
    assert result['failed'] == 0 and result['attempted'] >= 1
    assert set(result['checks']) == set(spec.workload(name)['check']['limits'])
    assert {'setup_s'} < set(result['metrics'])
    json.dumps(result)


@pytest.mark.parametrize('name', CELLS)
def test_traced_run_reads_its_layers(name):
    result = run(name, trace=True)
    assert result['correct']
    assert 'busy_s' in result['device'] and 'window_s' in result['device']
    assert set(result['breakdown']) == {'device_ops', 'idle_gaps'}
    # on the CPU no kernel is traced: the device readers find nothing, and
    # no share of a roofline or a peak is made up as 0
    for metric in result['metrics']:
        assert 'roofline' not in metric and not metric.startswith('idle_share')


@pytest.mark.parametrize('name,control', [(tiny.TOKENIZE, 'reference'),
                                          (tiny.BATCH, 'reference'),
                                          (tiny.BATCH, 'program_int8')])
def test_control_is_not_correct(name, control):
    result = run(name, control=control)
    assert not result['correct'], result['checks']


def test_a_reused_decode_state_still_has_its_logits_read():
    """A calibration's seeds share the model and its decode cache: a greedy
    call whose signature an earlier run captured is still compared."""
    reuse: dict = {}
    for _ in range(2):
        result = run(tiny.BATCH, seed=3, reuse=reuse)
        assert result['correct'], result['checks']


@contextlib.contextmanager
def planted(target, attr, make):
    original = getattr(target, attr)
    setattr(target, attr, make(original))
    try:
        yield
    finally:
        setattr(target, attr, original)


def _codes_altered(original):
    def rvq_encode(x, embeds):
        codes = original(x, embeds)
        codes[0, 0] = (codes[0, 0] + 1) % embeds.shape[1]
        return codes
    return rvq_encode


def _codes_unchanged(original):
    def rvq_encode(x, embeds):
        return torch.zeros(embeds.shape[0], x.shape[0], dtype=torch.int32)
    return rvq_encode


def _half_latent(original):
    def latent(self, x, *args, **kwargs):
        half = x.shape[0] // 2
        out = original(self, x[:half], *args, **kwargs)
        return torch.cat([out, out[:x.shape[0] - half]])
    return latent


def _token_altered(original):
    def write_token(self, logits):
        original(self, logits)
        if int(self.offset) == 3:
            self.seq[..., 3] = (self.seq[..., 3] + self.lm.card // 2) % self.lm.card
    return write_token


def _step_unchanged(original):
    def step(self):
        self.offset.add_(1)
    return step


def _half_rows(original):
    def generate(self, *args, **kwargs):
        out = original(self, *args, **kwargs)
        half = out.shape[0] // 2
        out[half:] = out[:out.shape[0] - half]
        return out
    return generate


def _faults():
    from audiocraft_tpu_torch.codec.encodec import EncodecModel
    from audiocraft_tpu_torch.lm.decode import DecodeState
    from audiocraft_tpu_torch.lm.model import LMModel
    from audiocraft_tpu_torch.quant import vq
    token = (DecodeState, 'write_token', _token_altered)
    step = (DecodeState, 'step', _step_unchanged)
    return {(tiny.TOKENIZE, 'answer altered'): (vq, 'rvq_encode', _codes_altered),
            (tiny.TOKENIZE, 'state unchanged'): (vq, 'rvq_encode', _codes_unchanged),
            (tiny.TOKENIZE, 'half the batch'): (EncodecModel, '_latent', _half_latent),
            (tiny.BATCH, 'token altered'): token,
            (tiny.BATCH, 'step unchanged'): step,
            (tiny.BATCH, 'half the batch'): (LMModel, 'generate', _half_rows)}


FAULTS = [(tiny.TOKENIZE, 'answer altered'), (tiny.TOKENIZE, 'state unchanged'),
          (tiny.TOKENIZE, 'half the batch'), (tiny.BATCH, 'token altered'),
          (tiny.BATCH, 'step unchanged'), (tiny.BATCH, 'half the batch')]


@pytest.mark.parametrize('name,fault', FAULTS)
def test_fault_is_not_correct(name, fault):
    target, attr, make = _faults()[name, fault]
    with planted(target, attr, make):
        result = run(name)
    assert not result['correct'], (fault, result['checks'])


@pytest.mark.card
@pytest.mark.parametrize('name,control', [(tiny.TOKENIZE, 'reference'),
                                          (tiny.BATCH, 'reference'),
                                          (tiny.BATCH, 'program_int8')])
def test_control_at_the_cells_size_on_the_card(name, control):
    """Three seeds of the control at the cell's own size (about 2-6 minutes
    a cell on an H100): each one not correct."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from portbench.calibrate import readings
    seconds = {tiny.TOKENIZE: 2.0, tiny.BATCH: 1.0}[name]
    lines = list(readings(name, [5100000001, 5100000002, 5100000003], control, seconds, {}))
    assert [line['correct'] for line in lines] == [False] * 3, lines
