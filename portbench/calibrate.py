"""The readings that the check limits of a cell are set from, on the card.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--control-kind reference|program_int8] [--seconds S] [--out FILE]

In one process (set-up is long), each seed runs the cell's set-up, a short
window at the cell's own load and its check, and prints one JSON line with
every number compared (``control: ""``); each control seed runs the
control named by ``--control-kind`` in the program's place (``reference``:
the plain reference at the precision below the configuration's;
``program_int8``: the program's own int8 path, where it has one; see the
drivers).  Program and control seeds alternate, so that a call cut short
still holds readings of both; no seed warms up, which only timing needs.
The lower reading of a number is
the largest over the program's seeds, the upper the smallest over the
control's; ``PERF.md`` gives both beside each limit.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import typing as tp


def readings(cell_name: str, seeds: tp.Sequence[int], control: str, seconds: float,
             reuse: dict) -> tp.Iterator[dict]:
    from .harness import spec
    from .harness.device import Device
    from .harness.session import Context, execute
    cell = spec.workload(cell_name)
    cfg = spec.config(cell['config'])
    drv = spec.driver(cell['driver'])
    for seed in seeds:
        ctx = Context(cell=cell, cfg=cfg, seed=seed, seconds=seconds,
                      device=Device('cuda'), control=control, reuse=reuse, warm=False)
        result = execute(ctx, drv)
        yield {'workload': cell_name, 'seed': seed, 'control': control,
               'correct': result['correct'], 'checks': result['checks'],
               'notes': ctx.checks.notes, 'attempted': result['attempted']}


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', default='')
    parser.add_argument('--control-seeds', default='')
    parser.add_argument('--control-kind', default='reference',
                        choices=('reference', 'program_int8'))
    parser.add_argument('--seconds', type=float, default=5.0)
    parser.add_argument('--out', default=None)
    args = parser.parse_args(argv)
    from .harness import spec
    from .run import cache_dirs
    import os
    os.environ.update(cache_dirs(str(spec.ROOT)))
    seeds = [int(s) for s in args.seeds.split(',') if s]
    controls = [int(s) for s in args.control_seeds.split(',') if s]
    out = open(args.out, 'a') if args.out else None
    reuse: dict = {}
    pairs = itertools.zip_longest([('', s) for s in seeds],
                                  [(args.control_kind, s) for s in controls])
    try:
        for control, seed in (run for pair in pairs for run in pair if run is not None):
            for line in readings(args.workload, [seed], control, args.seconds, reuse):
                text = json.dumps(line)
                print(text, flush=True)
                if out is not None:
                    out.write(text + '\n')
                    out.flush()
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == '__main__':
    sys.exit(main())
