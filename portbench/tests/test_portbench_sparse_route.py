"""The NYTimes cell's route (``tm-nytimes.fit-phase``: the phase sweep on
the gather kernel's layouts of a sparse X) run whole on the CPU at a
small size, the kernel's plain twin standing in: a sound run comes out
correct, and each fault planted in the sparse sweep, or in the answer,
comes out not correct against the cell's own limits."""

import time

import pytest
import torch

import rri_nmf_tpu_torch.nmf as nmf_mod
import rri_nmf_tpu_torch.sklearn_interface as si
from portbench.core.harness import run_cell
from portbench.core.spec import Cell

CPU = torch.device('cpu')
SEED = 3_123_456_789
CELL = 'tm-nytimes.fit-phase'


def small():
    """The cell at 400 × 600, k = 8, 20 sweeps; ``'auto'`` takes the
    layouts on the card only, so the CPU run asks for them."""
    cell = Cell(CELL)
    cell.config.update(n=400, d=600, k=8)
    cell.config['gen'] = dict(cell.config['gen'], len_median=40,
                              len_max=400, n_topics=10)
    cell.workload['reference']['max_iter'] = 20
    cell.traffic['params'] = dict(max_iter=20)
    cell.traffic['nmf_kwargs'] = dict(cell.traffic['nmf_kwargs'],
                                      sparse='mxu')
    return cell


def run(cell, trace=False):
    torch.set_num_threads(2)
    return run_cell(cell, SEED, 0.2, trace, CPU, time.perf_counter(),
                    log=lambda msg: None)


def test_sound_run_is_correct():
    result, rows = run(small(), trace=True)
    assert result['correct'] is True, rows
    assert {'sweep_ms', 'sweep_mfu_pct', 'sparse_plan_s'} <= set(
        result['metrics'])
    assert 0 < result['metrics']['sweep_mfu_pct']['value'] < 100


def _broken(builder, fault):
    def make(*args, **kwargs):
        inner = builder(*args, **kwargs)

        def sweep(X, W, T, *rest):
            out = inner(X, W, T, *rest)
            W2, T2 = out[0], out[1]
            if fault == 'state_unchanged':
                W2, T2 = W, T
            elif fault == 'half_batch':
                # the second half of the documents left out of the update
                W2 = W2.clone()
                W2[W.shape[0] // 2:] = W[W.shape[0] // 2:]
            elif fault == 'stale_topic':
                # one topic's T row left as it came in
                T2 = T2.clone()
                T2[0] = T[0]
            return (W2, T2) + tuple(out[2:])
        return sweep
    return make


@pytest.mark.parametrize('fault', ['state_unchanged', 'half_batch',
                                   'stale_topic'])
def test_a_broken_sparse_sweep_is_not_correct(fault, monkeypatch):
    monkeypatch.setattr(nmf_mod, 'make_sparse_sweep',
                        _broken(nmf_mod.make_sparse_sweep, fault))
    result, rows = run(small())
    assert result['correct'] is False, rows
    assert dict((r[0], r[1]) for r in rows)['WT_gap'] > \
        small().workload['limits']['WT_gap']


def test_an_altered_answer_is_not_correct(monkeypatch):
    real = si.nmf

    def altered(*args, **kwargs):
        soln = real(*args, **kwargs)
        T = soln['T'].clone()
        T[0] = T[1]                 # one topic's row replaced
        soln['T'] = T
        return soln
    monkeypatch.setattr(si, 'nmf', altered)
    result, rows = run(small())
    assert result['correct'] is False, rows
