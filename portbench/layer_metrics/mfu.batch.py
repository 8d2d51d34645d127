"""The whole step's share of the card's bf16 peak: the model FLOPs of every
clip generated in the window (T5, the decode of both guidance rows, the
codec decode; counts/lm, counts/codec) over the window's seconds times 989
TFLOP/s, in %."""

from portbench.harness import readers


def read(rec):
    texts = [t for call in rec.extra.get('texts', []) for t in call]
    return readers.mfu(rec, readers.generate_flops(rec, texts))
