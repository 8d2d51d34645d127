"""ms of the codec's decode of a generate's tokens to audio, from the span
around ``compression_model.decode``."""

from portbench.harness import readers


def read(rec):
    return readers.span_ms(rec, 'codec_decode')
