"""ms of the conditioning provider's call (T5 and the projection over the
descriptions and their null conditions) a generate, from the span around it."""

from portbench.harness import readers


def read(rec):
    return readers.span_ms(rec, 'conditioning')
