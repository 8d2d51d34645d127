"""Probe the data-movement kernels (P1): seven small bf16 operations, each
run by a CUDA kernel and held against its plain torch result.

    python -m audiocraft_tpu_torch.apps.probe_ops [--device cpu] [--seed 0]

Counterpart of ``scripts/probe_mosaic_ops.py``, which asks which of the same
operations the TPU's Mosaic compiler lowers.  Prints ``name: OK shape`` or
``name: FAIL reason`` for each and exits non-zero on any FAIL.  The card is
the default; ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import sys
import typing as tp

import numpy as np
import torch

from ..builders import resolve_device
from ..ops.probe import reshape, split_contract, strided_slice


def _bf16(rng: np.random.RandomState, *shape: int, device) -> torch.Tensor:
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device, torch.bfloat16)


def probes(device, seed: int = 0,
           scale: int = 1) -> tp.List[tp.Tuple[str, tp.Callable, tp.Callable]]:
    """(name, kernel call, plain torch call) for each of the seven operations,
    at ``scale`` times the probe's rows (1: the shapes of
    ``scripts/probe_mosaic_ops.py``)."""
    if scale == 1:
        rng = np.random.RandomState(seed)
        make = lambda *shape: _bf16(rng, *shape, device=device)
    else:   # hundreds of MiB: drawn where they are used
        gen = torch.Generator(device).manual_seed(seed)
        make = lambda *shape: torch.randn(*shape, generator=gen, device=device).bfloat16()
    r = 512 * scale
    x, x128, xu = make(r, 64), make(r, 128), make(r + 8 * scale, 64)
    taps = make(4, 64, 32)
    m, mu = r // 4, (r + 8 * scale) // 4
    return [
        (f'reshape merge {r}x64->{m}x256', lambda: reshape(x, (m, 256)),
         lambda: x.reshape(m, 256)),
        (f'reshape merge {r}x128->{m}x512', lambda: reshape(x128, (m, 512)),
         lambda: x128.reshape(m, 512)),
        ('3d split + dot_general', lambda: split_contract(x, taps),
         lambda: torch.einsum('msc,scn->mn', x.float().reshape(m, 4, 64),
                              taps.float()).to(torch.bfloat16)),
        ('lane stride slice [:, ::4]', lambda: strided_slice(x128, 1, 4),
         lambda: x128[:, ::4]),
        ('sublane stride slice [::4, :]', lambda: strided_slice(x128, 4, 1),
         lambda: x128[::4, :]),
        (f'reshape merge {r + 8 * scale}x64->{mu}x256', lambda: reshape(xu, (mu, 256)),
         lambda: xu.reshape(mu, 256)),
        (f'reshape split {r}x64->4x{m}x64', lambda: reshape(x, (4, m, 64)),
         lambda: x.reshape(4, m, 64)),
    ]


def check(out: torch.Tensor, ref: torch.Tensor) -> tp.Tuple[bool, float]:
    """Equal shapes and values; the contraction's fp32 sums may round to
    bf16 one step apart from torch's (another summation order)."""
    if out.shape != ref.shape:
        return False, float('inf')
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    return bool((diff <= 2 ** -7 * ref.float().abs() + 1e-6).all()), err


def run(device, seed: int = 0) -> tp.List[tp.Tuple[str, bool, tp.Tuple[int, ...], float]]:
    """Run every probe once: (name, ok, shape, max-abs error) each."""
    results = []
    for name, kernel, plain in probes(device, seed):
        out = kernel()
        ok, err = check(out, plain())
        results.append((name, ok, tuple(out.shape), err))
    return results


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--device', default=None, help="default: the CUDA card; 'cpu' for "
                                                       "the plain versions")
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    failed = 0
    for name, ok, shape, err in run(device, args.seed):
        if ok:
            print(f"{name}: OK {shape}", flush=True)
        else:
            print(f"{name}: FAIL shape {shape}, max-abs {err:.3g} from torch", flush=True)
            failed += 1
    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main())
