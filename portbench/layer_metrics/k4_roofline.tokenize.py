"""K4's share of its roofline: the least time of an encode's two fused
stages (counts/codec.k4, each launch bounded on its own) against the device
time of every ``stage_mma_kernel`` launch over the traced batches, in %."""

from portbench.counts import codec
from portbench.harness import readers


def read(rec):
    cfg, c = rec.cfg, rec.counters
    if not c.get('traced_batches'):
        return None
    bound = codec.k4(cfg, c['batch'], int(c['clip_seconds'] * cfg['sample_rate']))
    return readers.roofline(rec, r'stage_mma_kernel', 0.0, per_unit=bound,
                            units=c['traced_batches'])
