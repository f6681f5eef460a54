"""The rest of the port's driver (ROADMAP A.4) against the JAX package,
on the CPU in float64.

- ``nmf(w_row=...)`` — X scaled by ``sqrt(w_row)``, the row-weighted
  objective and the 10-sweep fixed-T W refit on the unscaled X — against
  the JAX ``nmf()`` at 1e-8 in the phase recipe, the interleaved
  default, with a vector ``w_row_sum``, with a sparse X (densified) and
  with the objective tracked (the fit's and the refit's history); unit
  row weights equal the unweighted fit (tests/test_consistency.py).
- ``rri_nmf_tpu_torch.utils.profiling`` on the CPU.
- The leaf functions of ``optimization`` and ``matrixops`` against their
  JAX counterparts at 1e-12.
"""

import json

import numpy as np
import pytest
import scipy.sparse
import torch

from rri_nmf_tpu import matrixops as jmo
from rri_nmf_tpu import optimization as jopt
from rri_nmf_tpu.nmf import nmf as jax_nmf
from rri_nmf_tpu_torch import matrixops as tmo
from rri_nmf_tpu_torch import optimization as topt
from rri_nmf_tpu_torch.nmf import nmf as torch_nmf
from rri_nmf_tpu_torch.utils import profiling

torch.set_num_threads(2)
TOL = 1e-8
LEAF_TOL = 1e-12


def _problem(n=40, d=30, k=4, seed=0):
    rng = np.random.RandomState(seed)
    return np.abs(rng.rand(n, k) @ rng.rand(k, d) + 0.01 * rng.rand(n, d))


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _w_row(n, seed=3):
    return np.random.RandomState(seed).rand(n) + 0.5


W_ROW_CASES = {
    'phase recipe': dict(update_order='phase', reset_topic_method=None),
    'interleaved default': dict(),
    'vector w_row_sum': dict(update_order='phase', reset_topic_method=None,
                             w_row_sum='vector', project_W_each_iter=True),
    'sparse X': dict(update_order='phase', reset_topic_method=None,
                     X='sparse'),
    'tracked objective': dict(update_order='phase', reset_topic_method=None,
                              compute_obj_each_iter=True, w_row_sum=1.0),
}


@pytest.mark.parametrize('case', sorted(W_ROW_CASES))
def test_w_row_matches_jax(case):
    X = _problem()
    kw = dict(W_ROW_CASES[case])
    if kw.pop('X', None) == 'sparse':
        X = scipy.sparse.csr_matrix(X * (X > 0.6))
    if kw.get('w_row_sum') == 'vector':
        kw['w_row_sum'] = np.random.RandomState(4).rand(40) + 0.5
    kw.update(w_row=_w_row(40), max_iter=8, random_state=0)
    a = jax_nmf(X, 4, **kw)
    b = torch_nmf(X, 4, device='cpu', **kw)
    assert np.allclose(_np(b['W']), a['W'], rtol=0, atol=TOL), \
        np.abs(_np(b['W']) - a['W']).max()
    assert np.allclose(_np(b['T']), a['T'], rtol=0, atol=TOL)
    # the fit's stamps, then the refit's
    assert len(b['iter_cputime']) == len(a['iter_cputime']) == 18
    if kw.get('compute_obj_each_iter'):
        oa, ob = np.asarray(a['obj_history']), np.asarray(b['obj_history'])
        assert oa.shape == ob.shape == (18,)
        assert np.allclose(ob, oa, rtol=TOL, atol=0)
        assert b['obj_calculator'].wr is not None
    if 'w_row_sum' in kw:
        s = kw['w_row_sum']
        # the refit's W rows sum to the sqrt-scaled targets, as in JAX
        want = np.sqrt(s) if np.ndim(s) else s
        assert np.allclose(_np(b['W']).sum(1), want, atol=1e-12)


def test_unit_w_row_matches_unweighted():
    """w_row of ones gives the unweighted fit over the shared sweeps
    (tests/test_consistency.py:43-55)."""
    X = _problem(seed=1)
    kw = dict(k=3, max_iter=6, random_state=0, w_row_sum=1.0,
              project_W_each_iter=True, compute_obj_each_iter=True,
              early_stop=False, device='cpu')
    base = torch_nmf(X, **kw)
    weighted = torch_nmf(X, w_row=np.ones((X.shape[0], 1)), **kw)
    m = min(len(base['obj_history']), 6)
    assert np.allclose(base['obj_history'][:m],
                       weighted['obj_history'][:m], rtol=1e-10)
    assert np.allclose(_np(base['T']), _np(weighted['T']), atol=1e-8)


def test_w_row_with_a_sparse_mask_raises_like_jax():
    X = _problem(20, 15, 2)
    M = scipy.sparse.csr_matrix((X > 0.5).astype(float))
    for fit in (jax_nmf, lambda *a, **k: torch_nmf(*a, device='cpu', **k)):
        with pytest.raises(NotImplementedError, match='sparse W_mat'):
            fit(X, 2, W_mat=M, w_row=np.ones(20), max_iter=1,
                reset_topic_method=None)


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_trace_writes_a_chrome_trace(tmp_path):
    X = torch.as_tensor(_problem())
    with profiling.trace(tmp_path / 'prof') as prof:
        with profiling.TraceAnnotation('two sweeps'):
            torch_nmf(X, 4, max_iter=2, update_order='phase',
                      reset_topic_method=None)
    events = json.loads((tmp_path / 'prof' / 'trace.json').read_text())
    names = {e.get('name') for e in events['traceEvents']}
    assert 'two sweeps' in names
    assert any(e.key == 'two sweeps' for e in prof.key_averages())


def test_sweep_timer_marks_cumulative_seconds():
    timer = profiling.SweepTimer()
    x = torch.ones(3)
    marks = [timer.mark(x), timer.mark(), timer.mark(x * 2, x)]
    assert marks == timer.marks and marks == sorted(marks)
    assert np.allclose(np.cumsum(timer.deltas()), marks)
    assert all(d >= 0 for d in timer.deltas())


def test_trace_annotation_is_a_record_function():
    with profiling.TraceAnnotation('region') as ann:
        torch.ones(2).sum()
    assert isinstance(ann, torch.profiler.record_function)


# ---------------------------------------------------------------------------
# leaf functions
# ---------------------------------------------------------------------------

def _close(got, want, tol=LEAF_TOL):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.allclose(got, want, rtol=0, atol=tol), np.abs(got - want).max()


@pytest.mark.parametrize('s,ub', [(1.0, 1.0), (2.0, 0.7), (0.5, 10.0)])
def test_kkt_qf_min_matches_jax(s, ub):
    rng = np.random.RandomState(5)
    w, d = rng.randn(12), rng.rand(12) + 0.1
    _close(topt.kkt_qf_min(w, d, s=s, ub=ub), jopt.kkt_qf_min(w, d, s=s,
                                                              ub=ub))
    _close(topt.kkt_qf_min(torch.as_tensor(w), 0.5, s=s, ub=ub),
           jopt.kkt_qf_min(w, 0.5, s=s, ub=ub))


@pytest.mark.parametrize('s', [1.0, None])
def test_optimize_scipy_matches_jax(s):
    rng = np.random.RandomState(6)
    w, c = rng.randn(8), rng.rand(8) + 0.2
    x, nx = topt.optimize_scipy(w, c, s, 1.0)
    xj, nxj = jopt.optimize_scipy(w, c, s, 1.0)
    _close(x, xj)
    assert nx == pytest.approx(nxj, rel=LEAF_TOL)


def test_projected_gradient_norm_matches_jax():
    rng = np.random.RandomState(7)
    grad = rng.randn(6, 5)
    vec = np.abs(rng.randn(6, 5)) * (rng.rand(6, 5) < 0.6)
    vec[0, :2] = 1.0
    for lb, ub in ((0.0, np.inf), (0.0, 1.0)):
        got = topt.projected_gradient_norm(grad, vec, lb=lb, ub=ub)
        assert got.dim() == 0
        assert float(got) == pytest.approx(float(jopt.projected_gradient_norm(
            grad, vec, lb=lb, ub=ub)), rel=LEAF_TOL)


def test_euclidean_proj_simplex_matches_jax():
    rng = np.random.RandomState(8)
    for v, s in ((rng.randn(10), 1.0), (rng.randn(3, 4), 2.5),
                 (np.full(5, 0.2), 1.0)):
        _close(tmo.euclidean_proj_simplex(v, s),
               jmo.euclidean_proj_simplex(v, s))
    sp = scipy.sparse.csr_matrix(np.abs(rng.randn(1, 6)))
    _close(tmo.euclidean_proj_simplex(sp, 1.0),
           jmo.euclidean_proj_simplex(sp, 1.0))


@pytest.mark.parametrize('form', ['labels', 'column of labels', 'soft',
                                  'normalized'])
def test_labels_to_mat_matches_jax(form):
    rng = np.random.RandomState(9)
    y = {'labels': rng.randint(0, 3, 10),
         'column of labels': rng.randint(0, 3, (10, 1)),
         'soft': np.array([[0, 1, 2], [2, 1, 0], [1, 1, 2], [0, 2, 1.]]),
         'normalized': np.eye(3)[rng.randint(0, 3, 6)]}[form]
    _close(tmo.labels_to_mat(y), jmo.labels_to_mat(y))


def test_harden_distributions_and_col_vector_match_jax():
    W = np.random.RandomState(10).rand(7, 4)
    got = tmo.harden_distributions(torch.as_tensor(W))
    assert got.dtype == torch.float64
    _close(got, jmo.harden_distributions(W))
    x = np.arange(5)
    got = tmo.col_vector(x)
    assert got.dtype == torch.as_tensor(x).dtype
    _close(got, jmo.col_vector(x))


@pytest.mark.parametrize('dim', ['tall', 'fat'])
def test_stack_matrices_matches_jax(dim):
    rng = np.random.RandomState(11)
    L = [rng.rand(2, 3), rng.rand(2, 3)]
    _close(tmo.stack_matrices([torch.as_tensor(a) for a in L], dim=dim),
           jmo.stack_matrices(L, dim=dim))
    D = [{'M': a} for a in L]
    _close(tmo.stack_matrices(D, dict_key='M', dim=dim,
                              transform=lambda r: r.reshape(1, -1)),
           jmo.stack_matrices(D, dict_key='M', dim=dim,
                              transform=lambda r: r.reshape(1, -1)))
