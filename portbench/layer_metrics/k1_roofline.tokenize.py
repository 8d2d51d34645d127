"""K1's share of its roofline: the least time of one quantizer launch
(``rvq_encode_kernel``, counts/codec.k1, float32 operations) over its mean
device time, in %."""

from portbench.counts import codec
from portbench.harness import readers


def read(rec):
    cfg, c = rec.cfg, rec.counters
    q = cfg['quantizer']
    hop = 1
    for r in cfg['seanet']['ratios']:
        hop *= r
    n = c['batch'] * int(c['clip_seconds'] * cfg['sample_rate']) // hop
    return readers.roofline(rec, r'rvq_encode_kernel',
                            codec.k1(n, q['dimension'], q['bins'], q['n_q']).bound_s())
