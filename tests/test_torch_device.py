"""Where the port's entry points run: on the card unless asked otherwise.

With ``device=None``, numpy, scipy or list data go to the card, and
without a card that raises, naming ``device='cpu'``. A torch tensor keeps
its own device. ``device='cpu'`` runs on the CPU (the parity tests ask
for it throughout). The tests hide any card, so they say the same on a
machine that has one.
"""

import numpy as np
import pytest
import scipy.sparse
import torch

from rri_nmf_tpu_torch import sklearn_interface as tsk
from rri_nmf_tpu_torch.convert import factors_from_numpy
from rri_nmf_tpu_torch.initialization import initialize_nmf
from rri_nmf_tpu_torch.matrixops import fit_device
from rri_nmf_tpu_torch.nmf import nmf
from rri_nmf_tpu_torch.ops import sparse_plan as spl

FAST_TM = dict(update_order='phase', reset_topic_method=None)
ASK_FOR_CPU = "device='cpu'"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


def _X(n=20, d=15, seed=0):
    rng = np.random.RandomState(seed)
    return np.abs(rng.rand(n, 3) @ rng.rand(3, d))


def _pairs(seed=1):
    rng = np.random.RandomState(seed)
    pairs = np.stack([rng.randint(0, 20, 300), rng.randint(0, 15, 300)], 1)
    return pairs, rng.randint(1, 6, 300).astype(float)


def _state():
    rng = np.random.RandomState(2)
    return {'W': rng.rand(20, 3), 'T': rng.rand(3, 15), 'min_rating': 1.0,
            'max_rating': 5.0}


ENTRY_POINTS = {
    'nmf': lambda **kw: nmf(_X(), 3, max_iter=2, random_state=0, **FAST_TM,
                            **kw),
    'nmf, scipy X': lambda **kw: nmf(scipy.sparse.csr_matrix(_X()), 3,
                                     max_iter=2, random_state=0, **FAST_TM,
                                     **kw),
    'initialize_nmf': lambda **kw: initialize_nmf(_X(), 3, 'nndsvd',
                                                  random_state=0, **kw),
    'factors_from_numpy': lambda **kw: factors_from_numpy(
        *(_state()[key] for key in 'WT'), **kw),
    'plan_sparse_matrix': lambda **kw: spl.plan_sparse_matrix(
        scipy.sparse.csr_matrix(_X()), **kw),
    "nmf, sparse='dma'": lambda **kw: nmf(scipy.sparse.csr_matrix(_X()), 3,
                                          max_iter=2, random_state=0,
                                          sparse='dma', **FAST_TM, **kw),
    'NMF_TM_Estimator.fit': lambda **kw: tsk.NMF_TM_Estimator(
        20, 15, 3, max_iter=2, nmf_kwargs=FAST_TM, **kw).fit(_X()),
    'NMF_TM_Estimator.fit_transform, scipy X':
        lambda **kw: tsk.NMF_TM_Estimator(
            20, 15, 3, max_iter=2, nmf_kwargs=FAST_TM,
            **kw).fit_transform(scipy.sparse.csr_matrix(_X())),
    'NMF_TM_Estimator.from_numpy_state':
        lambda **kw: tsk.NMF_TM_Estimator.from_numpy_state(_state(), **kw),
    'NMF_RS_Estimator.fit': lambda **kw: tsk.NMF_RS_Estimator(
        20, 15, 3, max_iter=2, **kw).fit(*_pairs()),
    'NMF_RS_Estimator.fit_from_Xtr': lambda **kw: tsk.NMF_RS_Estimator(
        20, 15, 3, max_iter=2, **kw).fit_from_Xtr(np.round(_X())),
    'NMF_RS_Estimator.from_numpy_state':
        lambda **kw: tsk.NMF_RS_Estimator.from_numpy_state(_state(), **kw),
}


def _device_of(result):
    """The device of an entry point's result, whatever its form."""
    if isinstance(result, tuple):
        result = result[0]
    if isinstance(result, dict):
        result = result['W']
    if hasattr(result, 't_phase'):
        result = result.t_phase.vals
    if hasattr(result, 'W'):
        result = result.W
    return result.device


@pytest.mark.parametrize('entry', sorted(ENTRY_POINTS))
def test_host_data_without_a_card_raises_naming_the_cpu(no_card, entry):
    with pytest.raises(RuntimeError, match=ASK_FOR_CPU):
        ENTRY_POINTS[entry]()


@pytest.mark.parametrize('entry', sorted(ENTRY_POINTS))
def test_device_cpu_runs_on_the_cpu(no_card, entry):
    assert _device_of(ENTRY_POINTS[entry](device='cpu')).type == 'cpu'


def test_a_tensor_keeps_its_device(no_card):
    X = torch.as_tensor(_X())
    assert fit_device(X) == X.device
    res = nmf(X, 3, max_iter=2, random_state=0, **FAST_TM)
    assert res['W'].device == X.device and res['W'].dtype == torch.float64
    pairs, y = _pairs()
    est = tsk.NMF_RS_Estimator(20, 15, 3, max_iter=2).fit(
        torch.as_tensor(pairs), torch.as_tensor(y))
    assert est.W.device.type == 'cpu'


def test_host_data_default_to_the_card():
    """With a card present (faked: the device is only named, nothing is
    placed), host data resolve to it and tensors keep theirs."""
    real = torch.cuda.is_available, torch.cuda.current_device
    try:
        torch.cuda.is_available = lambda: True
        torch.cuda.current_device = lambda: 0
        assert fit_device(_X()) == torch.device('cuda', 0)
        assert fit_device(scipy.sparse.csr_matrix(_X())).type == 'cuda'
        assert fit_device(torch.zeros(2)).type == 'cpu'
        assert fit_device(_X(), 'cpu') == torch.device('cpu')
    finally:
        torch.cuda.is_available, torch.cuda.current_device = real
