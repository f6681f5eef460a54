"""The control of each cell, at the cell's own size on the card: the fit
put in the program's place one precision below the configuration's
float32 (TensorFloat-32) comes out not correct against the cell's
limits, and the program's own fit on the same seed comes out correct.
Skipped without a card."""

import pytest
import torch

from portbench.core import check
from portbench.core.spec import Cell
from portbench.readings import reading

CELLS = ['rs-ml1m.fit', 'tm-20ng.fit', 'tm-20ng.fit-phase']
SEED = 4_400_000_001


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', 0)


@pytest.mark.cuda
@pytest.mark.parametrize('cell', CELLS)
def test_control_is_not_correct(cell, card):
    c = Cell(cell)
    variant = c.workload['control']
    found = reading(c, SEED, card, variant)
    ok, rows = check.judge(found, c.workload['limits'])
    assert not ok, rows


@pytest.mark.cuda
@pytest.mark.parametrize('cell', CELLS)
def test_program_is_correct(cell, card):
    c = Cell(cell)
    found = reading(c, SEED, card)
    ok, rows = check.judge(found, c.workload['limits'])
    assert ok, rows


@pytest.mark.parametrize('variant', ['program', 'program_tf32',
                                     'reference_tf32', 'program_f64'])
def test_readings_on_the_cpu(variant):
    """``readings.py``'s fits at a small size: each variant gives every
    number the cell's limits name."""
    c = Cell('rs-ml1m.fit')
    c.config.update(n=150, d=100, n_obs=4000, k=5)
    c.config['gen'] = dict(c.config['gen'], max_per_user=80, zipf_q=10.0)
    torch.set_num_threads(2)
    found = reading(c, SEED, torch.device('cpu'), variant)
    assert set(c.workload['limits']) <= set(found)
    assert found['variant'] == variant and found['sweeps'] >= 1
