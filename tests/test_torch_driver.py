"""The rest of the port's driver (ROADMAP A.4) against the JAX package,
on the CPU in float64.

- ``nmf(w_row=...)`` — X scaled by ``sqrt(w_row)``, the row-weighted
  objective and the 10-sweep fixed-T W refit on the unscaled X — against
  the JAX ``nmf()`` at 1e-8 in the phase recipe, the interleaved
  default, with a vector ``w_row_sum``, with a sparse X (densified) and
  with the objective tracked (the fit's and the refit's history); unit
  row weights equal the unweighted fit (tests/test_consistency.py).
- ``rri_nmf_tpu_torch.utils.profiling`` on the CPU: the Chrome trace,
  and the ``rri.*`` spans of estimator fits under the profiler (nested,
  stages in order, one a sweep run), which cost nothing and change
  nothing when no profiler records.
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
from rri_nmf_tpu_torch import sklearn_interface as tsk
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
        with profiling.span('two sweeps'):
            torch_nmf(X, 4, max_iter=2, update_order='phase',
                      reset_topic_method=None)
    events = json.loads((tmp_path / 'prof' / 'trace.json').read_text())
    names = {e.get('name') for e in events['traceEvents']}
    assert {'two sweeps', 'rri.nmf', 'rri.nmf.sweep'} <= names
    assert any(e.key == 'two sweeps' for e in prof.key_averages())


def _ratings(n=50, d=40, seed=0):
    rng = np.random.RandomState(seed)
    I, J = np.nonzero(rng.rand(n, d) < 0.3)
    return np.stack([I, J], 1), rng.randint(1, 6, size=len(I)).astype(float)


# estimator fits on the CPU: the TM defaults, the fast-TM recipe, and the
# recommender with its held-out stop (which stops this table after one
# kept sweep, rolling the second back)
FITS = {
    'tm interleaved': lambda: tsk.NMF_TM_Estimator(
        60, 40, 4, max_iter=3, device='cpu').fit(_problem(60, 40, 4)),
    'tm phase': lambda: tsk.NMF_TM_Estimator(
        60, 40, 4, max_iter=3, device='cpu',
        nmf_kwargs=dict(update_order='phase',
                        reset_topic_method=None)).fit(_problem(60, 40, 4)),
    'rs early stop': lambda: tsk.NMF_RS_Estimator(
        50, 40, 4, max_iter=30, device='cpu').fit(*_ratings()),
}
STAGES = ('rri.fit.prepare', 'rri.nmf.input', 'rri.nmf.init',
          'rri.nmf.plan', 'rri.nmf.sweep', 'rri.nmf.score', 'rri.nmf.finish')


def _spans(fit):
    """``(result, [(name, start, end)])``: ``fit()`` under the profiler and
    its ``rri.*`` host spans in order of their start."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fit()
    spans = [(e.name(), e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith('rri.')]
    return out, sorted(spans, key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize('case', sorted(FITS))
def test_fit_spans_nest_and_follow_one_another(case):
    est, spans = _spans(FITS[case])
    named = {}
    for s in spans:
        named.setdefault(s[0], []).append(s)
    assert set(named) == {'rri.fit', 'rri.nmf'} | set(STAGES) - (
        set() if case.startswith('rs') else {'rri.nmf.score'})
    (fit,), (call,) = named['rri.fit'], named['rri.nmf']
    assert _inside(call, fit)
    assert all(_inside(s, fit) for s in spans)
    assert all(_inside(s, call) for s in spans
               if s[0].startswith('rri.nmf.'))
    sweeps = named['rri.nmf.sweep']
    # the objective after a sweep nests in it; the early-stop score at the
    # top of an iteration is a stage of its own
    inner = [s for s in named.get('rri.nmf.score', [])
             if any(_inside(s, w) for w in sweeps)]
    stages = [s for s in spans if s[0] in STAGES and s not in inner]
    assert all(a[2] <= b[1] for a, b in zip(stages, stages[1:])), stages
    order = [s[0] for s in stages]
    assert order[:4] == list(STAGES[:4]) and order[-1] == 'rri.nmf.finish'
    assert set(order[4:-1]) <= {'rri.nmf.sweep', 'rri.nmf.score'}
    kept = len(est.nmf_outputs['iter_cputime'])
    if case.startswith('rs'):
        # every sweep scores its objective; each iteration, and the one
        # that stops the fit, scores the held-out ratings first
        assert kept < 30 and len(sweeps) == kept + 1
        assert len(inner) == len(sweeps)
        assert order.count('rri.nmf.score') == len(sweeps) + 1
    else:
        assert len(sweeps) == kept == 3 and not inner


def test_w_row_refit_nests_its_stages_in_finish():
    X = torch.as_tensor(_problem())
    res, spans = _spans(lambda: torch_nmf(
        X, 4, w_row=_w_row(40), max_iter=2, update_order='phase',
        reset_topic_method=None))
    calls = [s for s in spans if s[0] == 'rri.nmf']
    finish = [s for s in spans if s[0] == 'rri.nmf.finish']
    assert len(calls) == 2 and len(finish) == 2
    outer, refit = calls
    assert _inside(refit, finish[0]) and _inside(finish[1], refit)
    sweeps = [s for s in spans if s[0] == 'rri.nmf.sweep']
    # the fit's 2 sweeps, then the refit's 10
    assert len(sweeps) == len(res['iter_cputime']) == 12
    assert sum(_inside(s, refit) for s in sweeps) == 10


def test_a_fit_that_raises_closes_its_spans():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError, match='non-negative'):
            tsk.NMF_TM_Estimator(40, 30, 4, device='cpu').fit(-_problem())
        with pytest.raises(ValueError, match='update_order'):
            torch_nmf(_problem(), 4, update_order='bogus')
        torch_nmf(_problem(), 4, max_iter=1, device='cpu')
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.name().startswith('rri.')]
    assert names.count('rri.fit.prepare') == 1
    assert names.count('rri.nmf') == names.count('rri.nmf.input') == 2
    assert names.count('rri.nmf.sweep') == 1
    # no stage is left open for a later call to close
    assert getattr(profiling._stages, 'open', None) is None


def test_spans_off_build_nothing(monkeypatch):
    """With no profiler a span is one shared null context: no
    ``record_function`` is made and no device synchronized."""
    def boom(*args, **kwargs):
        raise AssertionError('called with no profiler recording')
    monkeypatch.setattr(profiling, 'record_function', boom)
    monkeypatch.setattr(torch.cuda, 'synchronize', boom)
    off = profiling.span('rri.a')
    assert off is profiling.span('rri.b', 'cuda')
    with off:
        profiling.stage('rri.c', 'cuda')
    for fit in FITS.values():
        fit()


@pytest.mark.parametrize('case', sorted(FITS))
def test_profiler_leaves_the_fit_unchanged(case):
    plain = FITS[case]()
    traced, _ = _spans(FITS[case])
    assert torch.equal(plain.W, traced.W) and torch.equal(plain.T, traced.T)
    assert len(plain.nmf_outputs['iter_cputime']) == \
        len(traced.nmf_outputs['iter_cputime'])


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
