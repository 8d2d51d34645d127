"""Finding the benchmark's files by name.

A cell is ``workloads/<cell>.json``, its configuration
``configs/<config>.json``, its traffic ``drivers/<driver>.py`` and each
per-layer metric ``layer_metrics/<metric>.py``: adding a cell, a
configuration or a metric adds files and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import types
import typing as tp
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
ROOT = PACKAGE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / 'BENCHMARK.json')


def cells(package: Path = PACKAGE) -> tp.List[str]:
    """Every cell whose file is in ``workloads/``."""
    return sorted(p.name[:-len('.json')] for p in (package / 'workloads').glob('*.json'))


def workload(name: str, package: Path = PACKAGE) -> dict:
    path = package / 'workloads' / f'{name}.json'
    if not path.is_file():
        raise KeyError(f'no workload {name!r}: {path} is missing (cells: {cells(package)})')
    cell = _json(path)
    if cell.get('name') != name:
        raise ValueError(f'{path} names itself {cell.get("name")!r}')
    return cell


def config(name: str, package: Path = PACKAGE) -> dict:
    return _json(package / 'configs' / f'{name}.json')


def driver(name: str) -> types.ModuleType:
    return importlib.import_module(f'{PACKAGE.name}.drivers.{name}')


def layer_reader(name: str, package: Path = PACKAGE) -> tp.Callable:
    """``read(record)`` of ``layer_metrics/<name>.py`` (names may hold dots)."""
    path = package / 'layer_metrics' / f'{name}.py'
    module_name = '_portbench_metric_' + name.replace('.', '__').replace('-', '_')
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None or spec.loader is None:
        raise KeyError(f'no reader for the metric {name!r} at {path}')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _listed(metric: dict, cell: str) -> bool:
    return 'workloads' not in metric or cell in metric['workloads']


def end_to_end(bench: dict, cell: str) -> tp.List[dict]:
    return [m for m in bench['end_to_end'] if _listed(m, cell)]


def per_layer(bench: dict, cell: str) -> tp.List[dict]:
    """The per-layer metrics a cell reports: those that list it, and those
    without a list whose end-to-end metric the cell reports."""
    e2e = {m['name'] for m in end_to_end(bench, cell)}
    return [m for m in bench['per_layer']
            if (cell in m['workloads'] if 'workloads' in m else m['moves'] in e2e)]
