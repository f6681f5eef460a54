"""A whole run of each cell on the CPU at a small size, past the look for
a card: a sound run comes out correct, and each fault a cell can have,
planted in the program's timed path, comes out not correct against the
cell's own limits. Without a card, and without the program beside it,
``run.py`` prints no result."""

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

import rri_nmf_tpu_torch.nmf as nmf_mod
import rri_nmf_tpu_torch.sklearn_interface as si
from portbench.core.harness import run_cell
from portbench.core.spec import Cell, ROOT

CPU = torch.device('cpu')
SEED = 3_123_456_789
SMALL = {
    'rs-ml1m.fit': dict(n=150, d=100, n_obs=4000, k=5),
    'tm-20ng.fit': dict(n=120, d=300, k=6),
    'tm-20ng.fit-phase': dict(n=120, d=300, k=6),
}
# the sweep each cell's fit builds on the CPU
BUILDERS = {'rs-ml1m.fit': 'make_masked_sweep',
            'tm-20ng.fit': 'make_sweep',
            'tm-20ng.fit-phase': 'make_sparse_sweep'}


def small(name):
    cell = Cell(name)
    cell.config.update(SMALL[name])
    if name.startswith('rs'):
        cell.config['gen'] = dict(cell.config['gen'], max_per_user=80,
                                  zipf_q=10.0)
    else:
        cell.config['gen'] = dict(cell.config['gen'], len_median=40,
                                  len_max=400)
        cell.workload['reference']['max_iter'] = 20
        cell.traffic['params'] = dict(max_iter=20)
    return cell


def run(name, trace=False):
    torch.set_num_threads(2)
    return run_cell(small(name), SEED, 0.2, trace, CPU,
                    time.perf_counter(), log=lambda msg: None)


@pytest.mark.parametrize('name', sorted(SMALL))
def test_sound_run_is_correct(name):
    result, rows = run(name)
    assert list(result)[-1] == 'checks'
    assert result['correct'] is True, rows
    assert result['attempted'] >= 1 and result['failed'] == 0
    cell = Cell(name)
    assert set(result['metrics']) == {m['name'] for m in cell.end_to_end}
    assert all(m['value'] > 0 for m in result['metrics'].values())
    assert [r[0] for r in rows] == list(result['checks'])


@pytest.mark.parametrize('name', sorted(SMALL))
def test_traced_run_reports_its_layers(name):
    result, _ = run(name, trace=True)
    assert result['correct'] is True
    # the host's layers; the device's need a card
    suffix = '.rs' if name.startswith('rs') else ''
    host = {m + suffix for m in ('outside_driver_s', 'first_sweep_s',
                                 'sweep_ms', 'sweep_mfu_pct')}
    assert host <= set(result['metrics'])
    assert 0 < result['metrics']['sweep_mfu_pct' + suffix]['value'] < 100
    assert 'breakdown' in result and 'window_s' in result['device']


def _broken(builder, fault):
    def make(*args, **kwargs):
        inner = builder(*args, **kwargs)

        def sweep(X, W, T, *rest):
            out = inner(X, W, T, *rest)
            W2, T2 = out[0], out[1]
            if fault == 'state_unchanged':
                W2, T2 = W, T
            elif fault == 'half_batch':
                # the second half of the rows (documents, users) left out
                # of the update
                W2 = W2.clone()
                W2[W.shape[0] // 2:] = W[W.shape[0] // 2:]
            return (W2, T2) + tuple(out[2:])
        return sweep
    return make


@pytest.mark.parametrize('fault', ['state_unchanged', 'half_batch'])
@pytest.mark.parametrize('name', sorted(SMALL))
def test_a_broken_sweep_is_not_correct(name, fault, monkeypatch):
    builder = getattr(nmf_mod, BUILDERS[name])
    monkeypatch.setattr(nmf_mod, BUILDERS[name], _broken(builder, fault))
    result, rows = run(name)
    assert result['correct'] is False, rows


@pytest.mark.parametrize('name', sorted(SMALL))
def test_an_altered_answer_is_not_correct(name, monkeypatch):
    real = si.nmf

    def altered(*args, **kwargs):
        soln = real(*args, **kwargs)
        T = soln['T'].clone()
        T[0] = T[1]                 # one topic's row replaced
        soln['T'] = T
        return soln
    monkeypatch.setattr(si, 'nmf', altered)
    result, rows = run(name)
    assert result['correct'] is False, rows


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload', 'rs-ml1m.fit',
         '--seed', str(SEED), '--seconds', '1', '--trace', '0'],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={'PATH': '/usr/bin:/bin', 'CUDA_VISIBLE_DEVICES': ''})
    assert out.returncode == 2, out.stderr
    assert out.stdout == ''


FAKE_CARD = '''
import runpy, sys, torch
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
sys.argv = ['portbench/run.py', '--workload', 'rs-ml1m.fit', '--seed', '1',
            '--seconds', '1', '--trace', '0']
runpy.run_path('portbench/run.py', run_name='__main__')
'''


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(ROOT / 'portbench', tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    out = subprocess.run([sys.executable, '-c', FAKE_CARD], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={'PATH': '/usr/bin:/bin'})
    assert out.returncode not in (0, None), out.stderr
    assert out.stdout == ''
    assert 'does not import' in out.stderr


def test_result_line_is_json():
    result, rows = run('rs-ml1m.fit')
    line = json.dumps(result)
    back = json.loads(line)
    assert list(back) == ['correct', 'attempted', 'failed', 'metrics',
                          'device', 'checks']
    assert back['device']['count'] == 1
