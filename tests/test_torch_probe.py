"""The data-movement probe (P1) against the JAX probe's own kernels, and the
gather kernel's path choice, on the CPU.

``scripts/probe_mosaic_ops.py`` runs as it is, with a ``pl`` whose
``pallas_call`` runs in interpret mode and records each kernel, and a
``try_kernel`` that records each gather's kernel, input and output shape
and runs it under one ``jax.jit``.  The port's counterparts run their plain
versions here.  Tolerances: the six gathers equal the JAX kernels bit for
bit; the 3-D split + dot_general within one bf16 step of the JAX kernel body
run outside Pallas (``apps/probe_ops.check``: both sum 256 fp32 products,
in other orders, and round once), since JAX refuses to trace ``k_dotg``
inside ``pallas_call`` (it captures ``taps`` as a constant).
"""

import functools
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from audiocraft_tpu_torch.apps import probe_ops
from audiocraft_tpu_torch.ops import probe

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "probe_mosaic_ops.py"

# the port's counterpart of each gather the JAX script tries, by its name
_GATHERS = {
    'reshape merge 512x64->128x256': lambda x: probe.reshape(x, (128, 256)),
    'reshape merge 512x128->128x512': lambda x: probe.reshape(x, (128, 512)),
    'lane stride slice [:, ::4]': lambda x: probe.strided_slice(x, 1, 4),
    'sublane stride slice [::4, :]': lambda x: probe.strided_slice(x, 4, 1),
    'reshape merge 520x64->130x256': lambda x: probe.reshape(x, (130, 256)),
    'reshape split 512x64->4x128x64': lambda x: probe.reshape(x, (4, 128, 64)),
}
_DOTG = '3d split + dot_general'


class _Ref:
    """Stands in for a Pallas ref outside Pallas: ``ref[...]`` reads and
    writes a whole array."""

    def __init__(self, value=None):
        self.value = value

    def __getitem__(self, index):
        assert index is Ellipsis
        return self.value

    def __setitem__(self, index, value):
        assert index is Ellipsis
        self.value = value


@pytest.fixture(scope="module")
def jax_probe():
    """Run the JAX script's main(): each gather's (kernel, x, out_shape, JAX
    output), the kernel k_dotg, and the lines the script printed."""
    spec = importlib.util.spec_from_file_location("probe_mosaic_ops", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    kernels = []

    def pallas_call(kernel, **kwargs):
        kernels.append(kernel)
        return functools.partial(pl.pallas_call, interpret=True)(kernel, **kwargs)

    mod.pl = types.SimpleNamespace(pallas_call=pallas_call, BlockSpec=pl.BlockSpec)
    gathers = {}

    def try_kernel(name, kernel, x, out_shape):
        out = jax.jit(mod.pl.pallas_call(
            kernel, out_shape=jax.ShapeDtypeStruct(*out_shape),
            in_specs=[pl.BlockSpec(memory_space=mod.pltpu.VMEM)],
            out_specs=pl.BlockSpec(memory_space=mod.pltpu.VMEM)))(x)
        gathers[name] = (kernel, x, out_shape, np.asarray(out))
        return True

    mod.try_kernel = try_kernel
    lines = []
    real_print = print
    mod.print = lambda *a, **k: lines.append(' '.join(map(str, a)))
    np.random.seed(0)
    try:
        mod.main()
    finally:
        mod.print = real_print
    dotg = next(kernel for kernel in kernels if kernel.__name__ == 'k_dotg')
    return dict(gathers=gathers, dotg=dotg, lines=lines)


def _bits(a) -> np.ndarray:
    """The bf16 bit patterns of a JAX or torch bf16 array."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _torch_bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).view(np.uint16).view(np.int16).copy()).view(
        torch.bfloat16)


@pytest.mark.parametrize("name", list(_GATHERS))
def test_gather_equals_the_jax_kernel(jax_probe, name):
    _, x, out_shape, out = jax_probe['gathers'][name]
    port = _GATHERS[name](_torch_bf16(x))
    assert port.dtype == torch.bfloat16 and tuple(port.shape) == tuple(out_shape[0])
    np.testing.assert_array_equal(_bits(port), _bits(out))


def test_split_contract_equals_the_jax_kernel_body(jax_probe):
    kernel = jax_probe['dotg']
    # JAX refuses k_dotg inside pallas_call: the script's own line says FAIL
    assert any(line.startswith(f"{_DOTG}: FAIL") for line in jax_probe['lines'])
    x = jax_probe['gathers']['reshape merge 512x64->128x256'][1]   # main() gives k_dotg this x
    taps = next(cell.cell_contents for cell in kernel.__closure__
                if getattr(cell.cell_contents, 'shape', None) == (4, 64, 32))
    out = _Ref()
    kernel(_Ref(x), out)
    want = np.asarray(out.value)
    assert want.dtype == jnp.bfloat16 and want.shape == (128, 32)
    port = probe.split_contract(_torch_bf16(x), _torch_bf16(taps))
    ok, err = probe_ops.check(port, _torch_bf16(want))
    assert ok, f"max-abs {err} from the JAX kernel body"
    assert len(np.unique(_bits(port))) > 1000


# (rows, cols, row_stride, col_stride, numel, offset) -> (vector, rows, cols, row_stride)
_PLANS = {
    # the probe's six gathers
    'merge 512x64->128x256': ((128, 256, 256, 1, 32768, 0), (1, 1, 32768, 32768)),
    'merge 512x128->128x512': ((128, 512, 512, 1, 65536, 0), (1, 1, 65536, 65536)),
    'lane stride [:, ::4]': ((512, 32, 128, 4, 65536, 0), (4, 512, 32, 128)),
    'sublane stride [::4, :]': ((128, 128, 512, 1, 65536, 0), (1, 128, 128, 512)),
    'merge 520x64->130x256': ((130, 256, 256, 1, 33280, 0), (1, 1, 33280, 33280)),
    'split 512x64->4x128x64': ((512, 64, 64, 1, 32768, 0), (1, 1, 32768, 32768)),
    # at 2048x the rows
    '2048x merge 64': ((262144, 256, 256, 1, 2 ** 26, 0), (1, 1, 2 ** 26, 2 ** 26)),
    '2048x merge 128': ((262144, 512, 512, 1, 2 ** 27, 0), (1, 1, 2 ** 27, 2 ** 27)),
    '2048x [:, ::4]': ((2 ** 20, 32, 128, 4, 2 ** 27, 0), (4, 2 ** 20, 32, 128)),
    '2048x [::4, :]': ((262144, 128, 512, 1, 2 ** 27, 0), (1, 262144, 128, 512)),
    '2048x merge 520': ((266240, 256, 256, 1, 68157440, 0), (1, 1, 68157440, 68157440)),
    '2048x split': ((2 ** 20, 64, 64, 1, 2 ** 26, 0), (1, 1, 2 ** 26, 2 ** 26)),
    # ragged: one element a thread
    'flat count 481': ((13, 37, 37, 1, 481, 0), (0, 1, 481, 481)),
    'col_stride 3': ((64, 32, 96, 3, 6144, 0), (0, 64, 32, 96)),
    'odd row_stride 231': ((21, 77, 231, 1, 4851, 0), (0, 21, 77, 231)),
    'x 6 bytes past 16': ((8, 128, 128, 1, 1024, 6), (0, 1, 1024, 1024)),
    'a vector read past the end': ((2, 8, 8, 4, 37, 0), (0, 2, 8, 8)),
    'over 2^31 elements': ((2 ** 16, 2 ** 15, 2 ** 16, 2, 2 ** 32, 0), (0, 2 ** 16, 2 ** 15, 2 ** 16)),
    # vectors at the other column strides
    'col_stride 2': ((32, 64, 256, 2, 8192, 0), (2, 32, 64, 256)),
    'col_stride 8': ((64, 32, 256, 8, 16384, 0), (8, 64, 32, 256)),
}


@pytest.mark.parametrize("name", list(_PLANS))
def test_gather_plan(name):
    args, want = _PLANS[name]
    assert probe.gather_plan(*args) == want


@pytest.mark.parametrize("name", [n for n, (_, want) in _PLANS.items()
                                  if want[0] == 0 and '2^31' not in n]
                         + ['col_stride 2', 'col_stride 8'])
def test_gather_plain_version_equals_numpy_off_the_probe_shapes(name):
    (rows, cols, row_stride, col_stride, numel, offset), _ = _PLANS[name]
    flat = np.random.RandomState(len(name)).randn(numel + offset // 2).astype(np.float32)
    x = torch.from_numpy(flat).bfloat16()[offset // 2:]
    out = probe.gather(x, rows, cols, row_stride, col_stride)
    r, c = np.arange(rows)[:, None], np.arange(cols)[None, :]
    want = x.float().numpy()[r * row_stride + c * col_stride]
    np.testing.assert_array_equal(out.float().numpy(), want)


def test_contract_plan():
    assert probe.contract_plan(256, 32) == 1                # the probe's [4, 64] x 32
    assert probe.contract_plan(512, 32) == 1
    assert probe.contract_plan(60, 12) == 0                 # depth off 16, another width
    assert probe.contract_plan(256, 64) == 0
    assert probe.contract_plan(528, 32) == 0                # deeper than the kernel takes
    assert probe.contract_plan(256, 32, x_offset=2) == 0
    assert probe.contract_plan(256, 32, taps_offset=8) == 0
