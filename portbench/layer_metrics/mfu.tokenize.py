"""The whole step's share of the card's bf16 peak: the model FLOPs of every
clip encoded in the window (counts/codec.encode_flops: convolutions, LSTM,
quantizer distances) over the window's seconds times 989 TFLOP/s, in %."""

from portbench.harness import readers


def read(rec):
    return readers.mfu(rec, readers.tokenize_flops(rec))
