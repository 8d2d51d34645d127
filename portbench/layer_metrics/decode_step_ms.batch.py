"""ms a step of the LM's generate (the span around ``lm.generate``: cross
keys and values, the prefill, every replayed step, graph captures) over its
forward steps."""

from portbench.harness import readers


def read(rec):
    return readers.span_ms(rec, 'decode_loop', per=readers.steps(rec))
