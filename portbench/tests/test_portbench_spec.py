"""The benchmark's files: every cell, configuration, traffic mix and
metric of ``BENCHMARK.json`` is found by name, and a cell added as new
files runs through the same loader with no file edited."""

import json
import re
import shutil
from types import SimpleNamespace

import pytest

from portbench.core.spec import Cell, ROOT, load_module

BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())
CELLS = [w['name'] for w in BENCH['workloads']]
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['command'] == ['python3', 'portbench/run.py']
    assert BENCH['paths'] == ['portbench']
    assert 1 <= BENCH['run_seconds'] <= 51
    names = [c['name'] for c in BENCH['configs']] + CELLS + [
        m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert len((ROOT / 'BENCHMARK.json').read_bytes()) <= 64 * 1024


@pytest.mark.parametrize('cell', CELLS)
def test_cell_files_load(cell):
    c = Cell(cell)
    assert c.chips == 1
    n, d, k = c.shape
    assert n > 0 and d > 0 and 0 < k < min(n, d)
    assert c.workload['limits'] and set(c.workload['limits']) <= {
        'WT_gap', 'W_gap', 'T_gap', 'sweeps_gap', 'pred_gap', 'rmse_gap'}
    assert c.workload['control'] in ('program_tf32', 'reference_tf32')
    ref = c.module('reference', c.workload['reference']['path'])
    assert callable(ref.fit) and callable(ref.sweep_counts)
    assert callable(c.module('gen', c.config['generator']).make)
    names = [m['name'] for m in c.end_to_end]
    assert 'setup_s' in names and len(names) >= 2
    assert c.per_layer, 'every cell reports a per-layer metric'
    for m in c.per_layer:
        assert m['moves'] in names, (m['name'], m['moves'])


@pytest.mark.parametrize('entry', BENCH['configs'], ids=lambda e: e['name'])
def test_config_entries(entry):
    cfg = json.loads((ROOT / entry['file']).read_text())
    assert entry['file'].startswith('portbench/configs/')
    assert cfg['name'] == entry['name']
    assert cfg['source'] == entry['source']
    assert cfg['reduced'] == entry['reduced'] == []
    assert cfg['dtype'] == 'float32'
    assert 'assumed' in cfg


@pytest.mark.parametrize('metric', BENCH['end_to_end'] + BENCH['per_layer'],
                         ids=lambda m: m['name'])
def test_metric_entries_have_readers(metric):
    assert UNIT.match(metric['unit'])
    assert metric['better'] in ('lower', 'higher')
    assert callable(load_module('metrics', metric['name']).read)
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    if 'layer' in metric:
        assert metric['moves'] in e2e
        assert set(metric['workloads']) <= set(CELLS)
        moved = e2e[metric['moves']]
        assert set(metric['workloads']) <= set(moved.get('workloads', CELLS))
        assert metric['source'] in ('device_trace', 'program_span',
                                    'program_counter', 'host_clock')
    else:
        assert metric['source'] == 'host_clock'
        assert 0.01 <= metric['bound'] <= 0.25


def test_a_cell_added_as_new_files(tmp_path):
    """A later cell (here the fast recipe at k=20) needs a configuration
    file, a cell file and BENCHMARK.json entries; no existing file of the
    benchmark changes."""
    shutil.copytree(ROOT / 'portbench', tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    before = {p: p.read_bytes() for p in (tmp_path / 'portbench').rglob('*')
              if p.is_file()}
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    cfg = json.loads((ROOT / 'portbench/configs/tm-20ng.json').read_text())
    cfg.update(name='tm-20ng-k20', k=20)
    (tmp_path / 'portbench/configs/tm-20ng-k20.json').write_text(
        json.dumps(cfg))
    (tmp_path / 'portbench/workloads/tm-20ng-k20.fit-phase.json').write_text(
        json.dumps({'config': 'tm-20ng-k20', 'traffic': 'fit-phase',
                    'reference': {'path': 'tm_phase', 'max_iter': 300},
                    'limits': {'W_gap': 1e-3, 'T_gap': 1e-3,
                               'sweeps_gap': 0}}))
    bench['configs'].append(dict(bench['configs'][0], name='tm-20ng-k20',
                                 file='portbench/configs/tm-20ng-k20.json'))
    bench['workloads'].append({'name': 'tm-20ng-k20.fit-phase',
                               'config': 'tm-20ng-k20',
                               'traffic': 'fit-phase', 'chips': 1,
                               'why': 'k=20'})
    # its own end-to-end metric: the entries that list cells stay as they
    # are
    bench['end_to_end'].append({'name': 'fit_s.k20', 'unit': 's',
                                'better': 'lower', 'bound': 0.1,
                                'source': 'host_clock',
                                'workloads': ['tm-20ng-k20.fit-phase']})
    (tmp_path / 'portbench/metrics/fit_s.k20.py').write_text(
        (ROOT / 'portbench/metrics/fit_s.py').read_text())
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))
    c = Cell('tm-20ng-k20.fit-phase', tmp_path)
    assert c.shape == (11314, 26214, 20)
    assert c.traffic['nmf_kwargs']['update_order'] == 'phase'
    assert [m['name'] for m in c.end_to_end] == ['setup_s', 'fit_s.k20']
    assert callable(c.module('metrics', 'fit_s.k20').read)
    assert c.module('reference', 'tm_phase').sweep_counts(
        c.config, c.workload['reference'], (SimpleNamespace(nnz=10),))
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_unknown_or_bad_names_raise():
    with pytest.raises(KeyError):
        Cell('no-such-cell')
    with pytest.raises(ValueError):
        load_module('metrics', '../run')
    with pytest.raises(FileNotFoundError):
        load_module('metrics', 'no_such_metric')


def test_files_under_paths_are_named_from_name_characters():
    for p in (ROOT / 'portbench').rglob('*'):
        if '__pycache__' in p.parts or not p.is_file():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r'^[A-Za-z0-9_./\-]{1,200}$', rel), rel
