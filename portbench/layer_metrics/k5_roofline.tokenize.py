"""K5's share of its roofline at the cell's shape: the least time of one
launch of ``mono_conv_kernel`` (counts/codec.k5, bytes-bound) over its mean
device time in the trace, in %."""

from portbench.counts import codec
from portbench.harness import readers


def read(rec):
    cfg, c = rec.cfg, rec.counters
    s = cfg['seanet']
    work = codec.k5(c['batch'], int(c['clip_seconds'] * cfg['sample_rate']), s['n_filters'],
                    s['kernel_size'])
    return readers.roofline(rec, r'mono_conv_kernel', work.bound_s())
