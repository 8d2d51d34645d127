"""Data-parallel tokenization scaling benchmark (counterpart of
``audiocraft_tpu/apps/scale_bench.py``; BASELINE config 5's harness).

    python -m audiocraft_tpu_torch.apps.scale_bench [--devices 1 2 4 8] \
        [--batch-per-device 8] [--seconds 10] [--iters 8] [--debug]
    torchrun --nproc-per-node 4 -m audiocraft_tpu_torch.apps.scale_bench ...
    python -m audiocraft_tpu_torch.apps.scale_bench --cpu-virtual 2 --debug

Measures audio-sec/s tokenized at increasing device counts and reports
scaling efficiency against the first count.  A count of n is a
``torch.distributed`` group of the first n ranks, one card each: under
``torchrun`` the world's first n ranks (``dist.new_group``); started alone
on one card, a world-size-1 NCCL group.  Each rank encodes its own
``--batch-per-device`` rows, and each step sums its codes over the group
(the JAX program's replicated sum over the sharded codes); a count's time is
its slowest rank's, by ``obs.chained_throughput``.  Rank 0 prints one JSON
line a count.

``--cpu-virtual N`` starts N gloo processes on the CPU (``--device cpu``)
on a free local port, each running this same program, and prints
rank 0's lines: it checks the sharded program's correctness, not its
performance.  Without it the ranks run on ``--device`` (default: the CUDA
card, raising without one).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import typing as tp
from pathlib import Path

import torch
import torch.distributed as dist

#: seconds the ``--cpu-virtual`` ranks have to end before they are killed
RANK_TIMEOUT_S = 600


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _run_virtual(argv: tp.List[str], n: int) -> tp.List[dict]:
    """Start ``n`` CPU ranks of this program over gloo; their exit joined
    under :data:`RANK_TIMEOUT_S`, a rank that fails raising with its
    output.  Prints and returns rank 0's JSON lines."""
    init = f'tcp://127.0.0.1:{_free_port()}'
    root = str(Path(__file__).resolve().parents[2])   # the package's parent
    env = dict(os.environ, OMP_NUM_THREADS='1',
               PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get('PYTHONPATH')])))
    procs = [subprocess.Popen(
        [sys.executable, '-m', __spec__.name, *argv, '--device', 'cpu',
         '--init-method', init, '--world', str(n), '--rank', str(r)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(n)]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0].decode(errors='replace'))
    except subprocess.TimeoutExpired:
        raise RuntimeError(f'the {n} ranks did not end within {RANK_TIMEOUT_S} s') from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outputs)):
        if p.returncode != 0:
            raise RuntimeError(f'rank {r} of {n} failed:\n{text[-4000:]}')
    results = [json.loads(line) for line in outputs[0].splitlines() if line.startswith('{')]
    for res in results:
        print(json.dumps(res), flush=True)
    return results


def _join(args, device: torch.device) -> bool:
    """Join the world group (this process's own when it is not launched
    with others); True when this call created it."""
    from ..dist.mesh import in_torchrun, make_data_group
    if dist.is_initialized():
        return False
    backend = 'nccl' if device.type == 'cuda' else 'gloo'
    if args.init_method:
        make_data_group(backend, args.init_method, args.world, args.rank)
    elif in_torchrun():
        make_data_group(backend)
    else:
        make_data_group(backend, f'tcp://127.0.0.1:{_free_port()}', 1, 0)
    return True


def main(argv=None) -> tp.List[dict]:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--devices', type=int, nargs='+', default=None)
    parser.add_argument('--batch-per-device', type=int, default=8)
    parser.add_argument('--seconds', type=int, default=10)
    parser.add_argument('--iters', type=int, default=8)
    parser.add_argument('--cpu-virtual', type=int, default=0)
    parser.add_argument('--debug', action='store_true')
    parser.add_argument('--device', default=None,
                        help="torch device (default: the CUDA card); 'cpu' runs the plain "
                             "versions")
    # set by --cpu-virtual for the ranks it starts
    parser.add_argument('--init-method', default=None, help=argparse.SUPPRESS)
    parser.add_argument('--world', type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument('--rank', type=int, default=None, help=argparse.SUPPRESS)
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser.parse_args(argv)

    if args.cpu_virtual:
        forwarded, skip = [], False
        for a in argv:
            if not skip and a != '--cpu-virtual' and not a.startswith('--cpu-virtual='):
                forwarded.append(a)
            skip = a == '--cpu-virtual'
        # the debug codec, as the JAX CLI's virtual devices run
        return _run_virtual(forwarded + ['--debug'], args.cpu_virtual)

    from ..builders import get_debug_compression_model, get_encodec_32khz, resolve_device
    from ..dist.mesh import in_torchrun
    from ..obs import chained_throughput
    from ..utils.misc import enable_compilation_cache

    device = resolve_device(args.device)
    if device.type == 'cuda' and (in_torchrun() or args.init_method):
        local = int(os.environ.get('LOCAL_RANK', args.rank or 0))
        device = torch.device('cuda', local)
        torch.cuda.set_device(device)
    created = _join(args, device)
    enable_compilation_cache(device)
    try:
        model = (get_debug_compression_model(32000, device=device, seed=0) if args.debug
                 else get_encodec_32khz(device=device, seed=0))
        sr = model.sample_rate
        world, rank = dist.get_world_size(), dist.get_rank()
        counts = args.devices or sorted({1, max(1, world // 2), world})
        counts = [c for c in counts if c <= world]

        results: tp.List[dict] = []
        for n in counts:
            # every rank takes part in making each group, members or not
            group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
            if rank >= n:
                continue
            gen = torch.Generator().manual_seed(rank)
            wav = (torch.randn(args.batch_per_device, 1, sr * args.seconds, generator=gen)
                   * 0.1).to(device)

            def step(carry, x):
                codes = model.encode(x)[0]
                total = codes.sum().float()
                dist.all_reduce(total, group=group)
                return codes, carry + total

            dt, _ = chained_throughput(step, [wav], iters=args.iters)
            slowest = torch.tensor([dt], dtype=torch.float64, device=device)
            dist.all_reduce(slowest, op=dist.ReduceOp.MAX, group=group)
            throughput = args.batch_per_device * n * args.seconds / float(slowest)
            results.append({'devices': n, 'audio_sec_per_s': round(throughput, 1)})
            base = results[0]['audio_sec_per_s']
            eff = throughput / (base * n / results[0]['devices'])
            results[-1]['scaling_efficiency'] = round(eff, 3)
            if rank == 0:
                print(json.dumps(results[-1]), flush=True)
        return results
    finally:
        if created:
            dist.destroy_process_group()


if __name__ == '__main__':
    main()
