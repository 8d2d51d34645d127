"""Start a test file's ranks as gloo processes on this host and collect what
they write: the harness of ``tests/test_torch_dist.py`` for any world size.

A test writes its inputs to ``folder/inputs.pt`` and calls
:func:`run_ranks`, which starts ``python SCRIPT TASK FOLDER RANK PORT`` once
a rank, joins them under a timeout (the suite does not depend on
``pytest-timeout``), kills them if they do not end, fails with a rank's
output if it exits non-zero, and returns each rank's ``folder/rank{r}.pt``.
The script's ``__main__`` reads its arguments with :func:`rank_args`, joins
its group itself (``dist/mesh.make_data_group`` or ``make_mesh``) and
saves with :func:`finish_rank`.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import torch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def run_ranks(script: str, task: str, folder: Path, inputs: dict, world: int,
              timeout_s: int = 240) -> list:
    torch.save(inputs, folder / 'inputs.pt')
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS='1')
    procs = [subprocess.Popen([sys.executable, script, task, str(folder), str(r), str(port)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=timeout_s)[0].decode(errors='replace'))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        raise AssertionError(f'{task}: the ranks did not end within {timeout_s} s')
    for r, (p, text) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f'{task} rank {r} failed:\n{text[-4000:]}'
    return [torch.load(folder / f'rank{r}.pt') for r in range(world)]


def rank_args():
    """(task, folder, rank, port) of a rank started by :func:`run_ranks`."""
    task, folder, rank, port = sys.argv[1:5]
    return task, Path(folder), int(rank), int(port)


def finish_rank(folder: Path, rank: int, out: dict) -> None:
    import torch.distributed as dist
    torch.save(out, folder / f'rank{rank}.pt')
    dist.barrier()
    dist.destroy_process_group()
