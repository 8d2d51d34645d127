"""Run one cell of the benchmark once on the card and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Exits with a code other than 0, and prints no
result, without a CUDA card (or with fewer than the cell asks for), or when
``jax``, ``jaxlib``, ``flax`` or the JAX package ``audiocraft_tpu`` is
loaded once the window has closed.  The last lines of standard error list
every number compared with its limit; the last line of standard output is
the result, one JSON object.  ``--trace 1`` reports the cell's per-layer
metrics instead of its end-to-end ones.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import typing as tp  # noqa: E402

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'audiocraft_tpu')


def forbidden_modules() -> tp.List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`FORBIDDEN`, compared whole."""
    return sorted({name.split('.')[0] for name in sys.modules} & set(FORBIDDEN))


def cache_dirs(root: str) -> tp.Dict[str, str]:
    """Fixed directories inside the checkout for the kernel caches that a
    library would otherwise put in the home directory (the port's own nvcc
    library goes to ``audiocraft_tpu_torch/_build/`` there)."""
    base = os.path.join(root, '.portbench_cache')
    return {'TRITON_CACHE_DIR': os.path.join(base, 'triton'),
            'TORCH_EXTENSIONS_DIR': os.path.join(base, 'torch_extensions'),
            'CUDA_CACHE_PATH': os.path.join(base, 'nv_compute_cache'),
            'USE_FLAX': '0', 'USE_TF': '0'}


def _clean(x: tp.Any) -> tp.Any:
    """JSON without NaN or infinity (as null)."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _clean(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_clean(v) for v in x]
    return x


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from .harness import spec
    os.environ.update(cache_dirs(str(spec.ROOT)))
    import torch

    from .harness.device import Device, power_limit
    from .harness.session import Context, execute

    bench = spec.benchmark()
    cell = spec.workload(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell['chips']):
        print(f'portbench: the cell {args.workload} needs {cell["chips"]} CUDA card(s); '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0} found',
              file=sys.stderr)
        return 2
    ctx = Context(cell=cell, cfg=spec.config(cell['config']), seed=args.seed,
                  seconds=args.seconds, device=Device('cuda'), trace=bool(args.trace),
                  t_start=T_START)
    result = execute(ctx, spec.driver(cell['driver']), spec.per_layer(bench, args.workload))
    if not args.trace:
        listed = {m['name'] for m in spec.end_to_end(bench, args.workload)}
        result['metrics'] = {k: v for k, v in result['metrics'].items() if k in listed}
    found = forbidden_modules()
    if found:
        print(f'portbench: the run loaded {found}, which the port must not import',
              file=sys.stderr)
        return 3
    checks = result.pop('checks')
    result['card'] = f'{power_limit()}; torch {torch.__version__}, CUDA {torch.version.cuda}'
    result['checks'] = checks
    ctx.checks.print(sys.stderr)
    print(json.dumps(_clean(result)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
