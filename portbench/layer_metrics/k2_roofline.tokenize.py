"""K2's share of its roofline: the least time of one layer's recurrence
(``lstm_layer_kernel``, counts/codec.k2 without the input projection, which
cuBLAS runs before it) over its mean device time, in %."""

from portbench.counts import codec
from portbench.harness import readers


def read(rec):
    cfg, c = rec.cfg, rec.counters
    s = cfg['seanet']
    hop = 1
    for r in s['ratios']:
        hop *= r
    frames = int(c['clip_seconds'] * cfg['sample_rate']) // hop
    work = codec.k2(frames, c['batch'], s['n_filters'] * 2 ** len(s['ratios']))
    return readers.roofline(rec, r'lstm_layer_kernel', work.bound_s())
