"""Device ms a batch in the library's convolution kernels (cuDNN's and the
layout transforms around them): every traced kernel whose name marks a
convolution, other than the port's own, over the traced batches."""

from portbench.harness import readers

CONV = r'(?i)^(?!.*(mono_conv_kernel|stage_\w*kernel)).*(fprop|conv|cudnn|implicit|nchw|nhwc)'


def read(rec):
    batches = rec.counters.get('traced_batches')
    times = readers.kernels(rec, CONV)
    if not batches or not times:
        return None
    return 1e3 * sum(times) / batches
