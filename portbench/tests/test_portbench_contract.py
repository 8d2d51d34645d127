"""``BENCHMARK.json`` against the benchmark's written rules, and files found
by name: a cell, a configuration and a per-layer metric are added as files
alone, without an edit."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench.harness import spec

ROOT = spec.ROOT
BENCH = spec.benchmark()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_.\-/]{1,200}$')
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                          'end_to_end', 'per_layer'}
    assert (ROOT / 'BENCHMARK.json').stat().st_size <= 64 * 1024


def test_paths_and_command():
    assert 1 <= len(BENCH['paths']) <= 16
    for p in BENCH['paths']:
        assert PATH.match(p) and not p.startswith('/') and '..' not in p.split('/')
        assert (ROOT / p).is_dir() and not p.endswith('_torch')
    assert 1 <= len(BENCH['command']) <= 32 and all(_line(w) for w in BENCH['command'])
    for word in BENCH['command']:
        assert not word.startswith('/') and '..' not in word


def test_run_seconds_fits_24_cells():
    r = BENCH['run_seconds']
    assert isinstance(r, int) and 1 <= r <= 51
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    used = {w['config'] for w in BENCH['workloads']}
    names = [c['name'] for c in BENCH['configs']]
    assert len(names) == len(set(names)) and set(names) == used and 1 <= len(names) <= 24
    files = [c['file'] for c in BENCH['configs']]
    assert len(files) == len(set(files))
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert NAME.match(c['name']) and _line(c['why']) and _line(c['source'])
        assert c['source'].startswith('https://')
        assert c['file'].startswith(BENCH['paths'][0] + '/') and (ROOT / c['file']).is_file()
        assert len(c['reduced']) <= 16 and all(NAME.match(k) for k in c['reduced'])
        body = json.loads((ROOT / c['file']).read_text())
        assert body['source'] == c['source'] and body['reduced'] == c['reduced']


def test_workloads_match_their_files():
    cells = [w['name'] for w in BENCH['workloads']]
    assert len(cells) == len(set(cells)) and 1 <= len(cells) <= 24
    assert set(cells) <= set(spec.cells())
    pairs = [(w['config'], w['traffic']) for w in BENCH['workloads']]
    assert len(pairs) == len(set(pairs))
    four = sum(w['chips'] == 4 for w in BENCH['workloads'])
    assert four <= max(1, len(cells) // 4)
    for w in BENCH['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert NAME.match(w['name']) and NAME.match(w['traffic']) and _line(w['why'])
        assert w['chips'] in (1, 4)
        body = spec.workload(w['name'])
        assert {k: body[k] for k in w} == w
        spec.driver(body['driver'])


def test_metrics():
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    assert 'setup_s' in e2e and 1 <= len(e2e) <= 16
    assert e2e['setup_s']['bound'] <= 0.25
    layer_names = [m['name'] for m in BENCH['per_layer']]
    assert len(set(layer_names) | set(e2e)) == len(layer_names) + len(e2e)
    for m in BENCH['end_to_end']:
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source', 'workloads'}
        assert NAME.match(m['name']) and UNIT.match(m['unit']) and m['better'] in ('lower',
                                                                                    'higher')
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in BENCH['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer', 'moves', 'workloads'}
        assert NAME.match(m['name']) and UNIT.match(m['unit']) and _line(m['layer'])
        assert m['source'] in SOURCES and m['moves'] in e2e and m['moves'] != 'setup_s'
        assert m['better'] in ('lower', 'higher')
        for cell in m['workloads']:
            assert m['moves'] in {x['name'] for x in spec.end_to_end(BENCH, cell)}
        assert (spec.PACKAGE / 'layer_metrics' / f'{m["name"]}.py').is_file()
        if '_roofline' in m['name'] or 'mfu' in m['name']:
            assert m['unit'] == '%'
    for w in BENCH['workloads']:
        names = {m['name'] for m in spec.end_to_end(BENCH, w['name'])}
        assert 'setup_s' in names and len(names) >= 2
        assert spec.per_layer(BENCH, w['name'])


def test_each_cell_has_check_limits_for_every_number():
    for w in BENCH['workloads']:
        limits = spec.workload(w['name'])['check']['limits']
        assert limits and all(v >= 0 for v in limits.values())


def test_a_cell_a_config_and_a_metric_are_added_as_files(tmp_path):
    package = tmp_path / 'portbench'
    shutil.copytree(spec.PACKAGE, package, ignore=shutil.ignore_patterns('__pycache__'))
    before = spec.cells(package)
    cell = json.loads((package / 'workloads' / f'{before[0]}.json').read_text())
    cell.update(name='dummy_model.dummy_traffic', config='dummy_model', traffic='dummy_traffic')
    (package / 'workloads' / 'dummy_model.dummy_traffic.json').write_text(json.dumps(cell))
    config = json.loads((package / 'configs' / f'{spec.workload(before[0])["config"]}.json')
                        .read_text())
    (package / 'configs' / 'dummy_model.json').write_text(json.dumps(dict(config, name='x')))
    (package / 'layer_metrics' / 'dummy_share.dummy.py').write_text(
        'def read(rec):\n    return 42.0\n')
    assert spec.cells(package) == sorted(before + ['dummy_model.dummy_traffic'])
    assert spec.workload('dummy_model.dummy_traffic', package)['config'] == 'dummy_model'
    assert spec.config('dummy_model', package)['name'] == 'x'
    assert spec.layer_reader('dummy_share.dummy', package)(None) == 42.0
    bench = dict(BENCH, per_layer=BENCH['per_layer'] + [
        {'name': 'dummy_share.dummy', 'unit': '%', 'better': 'higher', 'source': 'device_trace',
         'layer': 'x', 'moves': BENCH['end_to_end'][0]['name'],
         'workloads': ['dummy_model.dummy_traffic']}])
    assert [m['name'] for m in spec.per_layer(bench, 'dummy_model.dummy_traffic')] == \
        ['dummy_share.dummy']
    # the original package is untouched
    assert spec.cells() == before


def test_an_unknown_cell_is_named():
    with pytest.raises(KeyError, match='no workload'):
        spec.workload('no_such.cell')


def test_names_of_files_come_from_names():
    for p in Path(spec.PACKAGE).rglob('*'):
        if '__pycache__' in p.parts or p.is_dir():
            continue
        assert PATH.match(str(p.relative_to(ROOT))), p
