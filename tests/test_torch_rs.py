"""The port's masked WRRI fit (``nmf(W_mat=...)``) and
``NMF_RS_Estimator`` against the JAX package, on the CPU in float64.

- ``nmf()`` with a dense ``W_mat`` against the JAX ``nmf(...,
  use_pallas='interpret')``: W, T and ``obj_history`` at 1e-8, including
  the early-stop rollback.
- The RS estimator's fit, predict, score and transform on the reference
  recsys fixtures against the JAX estimator; carrying a fitted JAX
  estimator into the port.
- A dead topic in a fixed-T fit spends the same ``'random'`` reset budget
  as JAX (the drawn values differ by generator, ROADMAP §C.2).
- The plain replacements of scikit-learn's and the native library's
  helpers: the validation split, the COO scatter, and the numpy
  ``masked_svd_init``, bit for bit.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

from rri_nmf_tpu.initialization import masked_svd_init as jax_msi
from rri_nmf_tpu.nmf import nmf as jax_nmf
from rri_nmf_tpu.sklearn_interface import NMF_RS_Estimator as JaxRS
from rri_nmf_tpu_torch import sklearn_interface as tsk
from rri_nmf_tpu_torch.convert import numpy_state
from rri_nmf_tpu_torch.initialization import masked_svd_init
from rri_nmf_tpu_torch.nmf import nmf as torch_nmf
from rri_nmf_tpu_torch.ops import masked_kernels as mk

torch.set_num_threads(2)
TOL = 1e-8


def _problem(n, d, k, seed=0, density=0.5):
    rng = np.random.RandomState(seed)
    X = np.abs(rng.rand(n, k) @ rng.rand(k, d) + 0.01 * rng.rand(n, d))
    M = (rng.rand(n, d) < density).astype(float)
    return X * M, M


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(a, b, tol=TOL):
    return np.allclose(_np(a), _np(b), rtol=0, atol=tol)


def _same_fit(X, k, **kw):
    a = jax_nmf(X, k, **dict(dict(use_pallas='interpret'), **kw))
    b = torch_nmf(X, k, device='cpu', **kw)
    assert _close(b['W'], a['W']), np.abs(_np(b['W']) - a['W']).max()
    assert _close(b['T'], a['T']), np.abs(_np(b['T']) - a['T']).max()
    if 'obj_history' in a:
        oa, ob = np.asarray(a['obj_history']), np.asarray(b['obj_history'])
        assert oa.shape == ob.shape
        assert np.allclose(ob, oa, rtol=TOL, atol=0)
    assert b['random_state'] == a['random_state']
    assert b['n_resets_remaining'] == a['n_resets_remaining']
    assert len(b['iter_cputime']) == len(a['iter_cputime'])
    return a, b


MASKED_CASES = {
    'rs preset': dict(t_row_sum=1.0),
    'phase order asked': dict(t_row_sum=1.0, update_order='phase'),
    'regularized': dict(t_row_sum=1.0, reg_w_l1=0.01, reg_t_l1=0.02,
                        reg_w_l2=0.1, reg_t_l2=0.05),
    'projected T': dict(project_T_each_iter=True, t_row_sum=1.0),
    'projected W': dict(project_W_each_iter=True, w_row_sum=1.0,
                        t_row_sum=1.0),
    'random init': dict(t_row_sum=1.0, init='random'),
}


@pytest.mark.parametrize('case', sorted(MASKED_CASES))
def test_masked_nmf_matches_jax(case):
    X, M = _problem(60, 45, 4, seed=1)
    kw = dict(W_mat=M, max_iter=12, compute_obj_each_iter=True,
              random_state=0, reset_topic_method=None, **MASKED_CASES[case])
    a, b = _same_fit(X, 4, **kw)
    if not kw.get('project_W_each_iter'):
        ob = np.asarray(b['obj_history'])
        assert np.all(np.diff(ob) <= 1e-12 * np.abs(ob[:-1]))
    assert b['obj_calculator'].true_objective() == pytest.approx(
        a['obj_calculator'].true_objective(), rel=TOL)


def test_masked_nmf_vector_w_row_sum_and_warm_start_match_jax():
    X, M = _problem(50, 30, 3, seed=2)
    rng = np.random.RandomState(3)
    wrs = rng.rand(50) + 0.5
    kw = dict(W_mat=M, max_iter=6, compute_obj_each_iter=True,
              random_state=1, reset_topic_method=None, t_row_sum=1.0,
              w_row_sum=wrs, project_W_each_iter=True,
              W_in=rng.rand(50, 3), T_in=rng.rand(3, 30))
    a, b = _same_fit(X, 3, **kw)
    assert np.allclose(_np(b['W']).sum(1), wrs, atol=1e-12)


def test_masked_nmf_early_stop_rolls_back_like_jax():
    """A callable score that rises after the third call stops both fits
    and restores the previous iterate; so does the tracked objective."""
    X, M = _problem(40, 30, 3, seed=4)

    def make_score():
        calls = []

        def score(X, W, T):
            calls.append(1)
            return -len(calls) if len(calls) < 4 else 10.0
        return score

    kw = dict(W_mat=M, max_iter=10, compute_obj_each_iter=True,
              random_state=2, reset_topic_method=None, t_row_sum=1.0)
    a = jax_nmf(X, 3, early_stop=make_score(), use_pallas='interpret', **kw)
    b = torch_nmf(X, 3, early_stop=make_score(), device='cpu', **kw)
    assert len(b['obj_history']) == len(a['obj_history']) == 2
    assert _close(b['W'], a['W']) and _close(b['T'], a['T'])
    _same_fit(X, 3, early_stop=True, **kw)


def test_fix_T_dead_topic_resets_like_jax():
    """With T fixed, a zero T row leaves its W column dead: the 'random'
    reset fires in both packages and spends the same budget."""
    X, M = _problem(40, 25, 3, seed=5)
    T0 = np.random.RandomState(6).rand(3, 25)
    T0[1] = 0.0
    kw = dict(W_mat=M, T_in=T0, fix_T=True, max_iter=3, n_resets=5,
              reset_topic_method='random', t_row_sum=1.0, random_state=7)
    a = jax_nmf(X, 3, use_pallas='interpret', **kw)
    b = torch_nmf(X, 3, device='cpu', **kw)
    assert a['n_resets_remaining'] < 5
    assert b['n_resets_remaining'] == a['n_resets_remaining']
    assert not np.allclose(_np(b['T'])[1], 0.0)
    c = torch_nmf(X, 3, device='cpu', **kw)   # seeded: repeats exactly
    assert torch.equal(c['W'], b['W']) and torch.equal(c['T'], b['T'])


def _dead_column(n, k, col, seed=13):
    rng = np.random.RandomState(seed)
    W0 = rng.rand(n, k)
    W0[:, col] = 0.0
    return W0


# masked options of the plain sweep (they raised before it was ported):
# held against JAX's make_sweep, a reset firing where one is asked for
# (the 'random' draws injected: jax_draws). A fixed-T fit with
# 'max_resid_document' runs B4 alone, k times a sweep, as JAX's Pallas
# sweep does (ROADMAP §C.2); the others run no B3/B4
MASKED_PLAIN_CASES = {
    'use_pallas=False': dict(use_pallas=False, reset_topic_method=None,
                             t_row_sum=1.0),
    'fix_W': dict(fix_W=True, W_in=np.random.RandomState(14).rand(40, 3),
                  reset_topic_method=None),
    'max_resid_document': dict(reset_topic_method='max_resid_document',
                               t_row_sum=1.0, W_in=_dead_column(40, 3, 1)),
    'random': dict(reset_topic_method='random', t_row_sum=1.0,
                   W_in=_dead_column(40, 3, 2)),
    'fix_T max_resid_document': dict(
        reset_topic_method='max_resid_document', fix_T=True, t_row_sum=1.0,
        T_in=np.vstack([np.random.RandomState(15).rand(2, 30),
                        np.zeros((1, 30))])),
}


@pytest.mark.parametrize('case', sorted(MASKED_PLAIN_CASES))
def test_masked_plain_sweep_matches_jax(case, monkeypatch):
    from rri_nmf_tpu_torch import nmf as tnmf
    from test_torch_sweep import jax_draws
    monkeypatch.setattr(tnmf, 'make_draws', jax_draws)
    X, M = _problem(40, 30, 3, seed=16)
    kw = dict(W_mat=M, max_iter=5, compute_obj_each_iter=True,
              random_state=3, **MASKED_PLAIN_CASES[case])
    if 'W_in' in kw and not kw.get('fix_W'):
        kw['T_in'] = np.random.RandomState(17).rand(3, 30)
    calls = {'phase_a': 0, 'phase_b': 0}
    for name in calls:
        def counted(*args, _fn=getattr(mk, name), _name=name, **kw_):
            calls[_name] += 1
            return _fn(*args, **kw_)
        monkeypatch.setattr(mk, name, counted)
    a, b = _same_fit(X, 3, **kw)
    if case in ('max_resid_document', 'random', 'fix_T max_resid_document'):
        assert b['n_resets_remaining'] == a['n_resets_remaining'] < 23
    b4 = 3 * len(b['obj_history']) if case == 'fix_T max_resid_document' \
        else 0
    assert calls == {'phase_a': 0, 'phase_b': b4}


def test_masked_options_outside_the_slice():
    X, M = _problem(20, 15, 2, seed=8)
    # w_row with a dense mask runs since ROADMAP A.4, as in JAX: the
    # masked fit on the scaled X, then the unmasked fixed-T W refit
    _same_fit(X, 2, W_mat=M, max_iter=4, random_state=0,
              compute_obj_each_iter=True, reset_topic_method=None,
              w_row=np.linspace(0.5, 2.0, 20))
    # a scipy-sparse W_mat runs the sparse-mask sweep, as in JAX
    kw = dict(W_mat=scipy.sparse.csr_matrix(M), max_iter=2, random_state=0,
              reset_topic_method=None)
    a = jax_nmf(X, 2, **kw)
    b = torch_nmf(X, 2, device='cpu', **kw)
    assert _close(b['W'], a['W']) and _close(b['T'], a['T'])
    with pytest.raises(ValueError, match='inner_reps'):
        torch_nmf(X, 2, W_mat=M, reset_topic_method=None, inner_reps=2,
                  device='cpu')
    with pytest.raises(ValueError, match='shape'):
        torch_nmf(X, 2, W_mat=M[:10], reset_topic_method=None,
                  device='cpu')


def test_masked_nmf_on_cpu_launches_no_kernel():
    X, M = _problem(20, 15, 2, seed=9)
    before = dict(mk.LAUNCHES)
    torch_nmf(X, 2, W_mat=M, max_iter=2, reset_topic_method=None,
              device='cpu')
    assert mk.LAUNCHES == before


# ---------------------------------------------------------------------------
# the recommender estimator
# ---------------------------------------------------------------------------

def _pairs(R):
    I, J = R.nonzero()
    return np.stack([I, J], axis=1), R[I, J]


@pytest.mark.parametrize('validation', [True, False])
def test_rs_estimator_matches_jax(recsys_train, recsys_test, validation):
    n, d = recsys_train.shape
    kw = dict(random_state=0, max_iter=8 if validation else 5,
              use_validation_early_stopping=validation)
    J = JaxRS(n, d, 4, **kw).fit_from_Xtr(recsys_train)
    P = tsk.NMF_RS_Estimator(n, d, 4, device='cpu', **kw).fit_from_Xtr(
        recsys_train)
    assert _close(P.W, J.W) and _close(P.T, J.T)
    assert np.allclose(P.nmf_outputs['obj_history'],
                       J.nmf_outputs['obj_history'], rtol=TOL)
    assert (P.min_rating, P.max_rating) == (J.min_rating, J.max_rating)
    pairs, y = _pairs(recsys_test)
    assert _close(P.predict(pairs), J.predict(pairs))
    assert P.score(pairs, y) == pytest.approx(J.score(pairs, y), rel=TOL)
    assert P.score(recsys_test) == pytest.approx(J.score(recsys_test),
                                                 rel=TOL)
    # the gather and the cached full prediction agree
    p1 = P.predict(pairs)
    P.make_Xpred()
    assert np.allclose(P.predict(pairs), p1, rtol=0, atol=1e-12)


def test_rs_transform_matches_jax(recsys_train, recsys_test, monkeypatch):
    """The transform takes JAX's route: the scipy-sparse indicator mask
    and the O(nnz) sparse-mask sweep, never the dense-mask kernels."""
    from rri_nmf_tpu_torch.ops import sweep_masked_sparse as ms
    n, d = recsys_train.shape
    J = JaxRS(n, d, 4, random_state=0, max_iter=6).fit_from_Xtr(
        recsys_train)
    P = tsk.NMF_RS_Estimator.from_numpy_state(
        numpy_state(J), device='cpu', random_state=0, max_iter=6)

    def refuse(*args, **kw):
        raise AssertionError('the transform ran a dense-mask kernel')
    monkeypatch.setattr(mk, 'phase_a', refuse)
    monkeypatch.setattr(mk, 'phase_b', refuse)
    sweeps = []
    real = ms.MaskedSparseSweep.__call__

    def spy(self, plan, *args):
        sweeps.append(type(plan).__name__)
        return real(self, plan, *args)
    monkeypatch.setattr(ms.MaskedSparseSweep, '__call__', spy)
    before = dict(mk.LAUNCHES)
    Wj = np.asarray(J.transform(recsys_test))
    Wp = P.transform(recsys_test)
    assert Wp.shape == Wj.shape and _close(Wp, Wj)
    assert sweeps == ['MaskedCOOPlan'] * 4
    assert mk.LAUNCHES == before
    # the transform keeps the learned topics
    assert np.array_equal(P.T.numpy(), J.T)


def test_rs_estimator_from_jax_state_round_trip(recsys_train, recsys_test):
    n, d = recsys_train.shape
    J = JaxRS(n, d, 3, random_state=0, max_iter=4).fit_from_Xtr(
        recsys_train)
    state = numpy_state(J)
    assert set(state) == {'W', 'T', 'min_rating', 'max_rating'}
    P = tsk.NMF_RS_Estimator.from_numpy_state(state, device='cpu')
    assert (P.n, P.d, P.k) == (n, d, 3)
    back = numpy_state(P)
    assert set(back) == set(state)
    for key in state:
        assert np.array_equal(back[key], state[key]), key
    pairs, y = _pairs(recsys_test)
    assert _close(P.predict(pairs), J.predict(pairs))
    assert P.score(recsys_test) == pytest.approx(J.score(recsys_test),
                                                 rel=TOL)
    P32 = tsk.NMF_RS_Estimator.from_numpy_state(state, device='cpu',
                                                dtype=torch.float32)
    assert P32.W.dtype == torch.float32


def test_rs_fit_from_a_tensor_equals_numpy(recsys_train):
    n, d = recsys_train.shape
    a = tsk.NMF_RS_Estimator(n, d, 3, max_iter=4,
                             device='cpu').fit_from_Xtr(recsys_train)
    b = tsk.NMF_RS_Estimator(n, d, 3, max_iter=4).fit_from_Xtr(
        torch.as_tensor(recsys_train, dtype=torch.float64))
    c = tsk.NMF_RS_Estimator(n, d, 3, max_iter=4, device='cpu').fit_from_Xtr(
        scipy.sparse.csr_matrix(recsys_train))
    assert torch.equal(a.W, b.W) and torch.equal(a.T, b.T)
    assert torch.equal(a.W, c.W) and torch.equal(a.T, c.T)
    # the fitted estimator pickles; the validation scorer is dropped
    e = pickle.loads(pickle.dumps(a))
    assert e.early_stop is None and torch.equal(e.W, a.W)


def test_rs_estimator_params_and_errors(recsys_train):
    n, d = recsys_train.shape
    P = tsk.NMF_RS_Estimator(n, d, 3, device='cpu')
    # the JAX constructor arguments, and the port's device
    assert set(P.get_params()) == set(JaxRS(n, d, 3).get_params()) | {'device'}
    assert P.set_params(max_iter=2, wr1=0.1) is P and P.wr1 == 0.1
    with pytest.raises(ValueError):
        P.set_params(bogus=1)
    with pytest.raises(ValueError, match='not fitted'):
        P.predict(np.array([[0, 0]]))
    pairs, y = _pairs(recsys_train)
    with pytest.raises(ValueError):
        P.fit(pairs, y[:-1])
    with pytest.raises(ValueError):
        P.fit(pairs[:, :1], y)
    # sparse_obs, sparsify/densify and a scipy-sparse transform input run
    # as in the JAX estimator
    S = tsk.NMF_RS_Estimator(n, d, 3, sparse_obs=True, device='cpu').fit(
        pairs, y)
    JS = JaxRS(n, d, 3, sparse_obs=True).fit(pairs, y)
    assert _close(S.W, JS.W) and _close(S.T, JS.T)
    P.fit(pairs, y)
    W_fit = P.W.clone()
    Xs = scipy.sparse.csr_matrix(recsys_train)
    dense_transform = P.transform(recsys_train)
    P.sparsify()
    assert scipy.sparse.issparse(P.W) and scipy.sparse.issparse(P.T)
    assert _close(P.transform(Xs), dense_transform)
    P.densify()
    assert torch.equal(P.W, W_fit)


# ---------------------------------------------------------------------------
# plain replacements of scikit-learn's and the native library's helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('q', [1, 19, 20, 617, 1000])
def test_split_equals_sklearn_train_test_split(q):
    from sklearn.model_selection import train_test_split
    idx = np.arange(q)
    if q == 1:
        with pytest.raises(ValueError):
            train_test_split(idx, test_size=0.05, random_state=0)
        return
    tr_s, te_s = train_test_split(idx, test_size=0.05, random_state=0)
    tr, te = tsk.train_test_split_indices(q)
    assert np.array_equal(tr, tr_s) and np.array_equal(te, te_s)


def test_coo_scatter_equals_native():
    """Ratings (small integers, duplicate pairs summed) scatter exactly as
    the native library does; random floats as np.add.at in float32 (the
    library's numpy semantics; its OpenMP atomics sum duplicates in no
    fixed order)."""
    from rri_nmf_tpu import native
    rng = np.random.RandomState(10)
    n, d, q = 40, 30, 500                      # many duplicate pairs
    rows, cols = rng.randint(0, n, q), rng.randint(0, d, q)
    ratings = rng.randint(1, 6, q).astype(float)
    ratings[:20] = 0.0                         # explicit zeros stay off M
    Xn, Mn = native.coo_to_dense_mask(rows, cols, ratings, n, d)
    Xt, Mt = tsk.coo_to_dense_mask(rows, cols, ratings, n, d)
    assert Xt.dtype == Mt.dtype == torch.float32
    assert np.array_equal(Xt.numpy(), Xn) and np.array_equal(Mt.numpy(), Mn)
    vals = rng.rand(q)
    Xa = np.zeros((n, d), dtype=np.float32)
    np.add.at(Xa, (rows, cols), vals.astype(np.float32))
    Xt, Mt = tsk.coo_to_dense_mask(torch.as_tensor(rows), cols, vals, n, d)
    assert np.array_equal(Xt.numpy(), Xa)
    assert np.array_equal(Mt.numpy(), (Xa != 0).astype(np.float32))
    with pytest.raises(ValueError, match='out of range'):
        tsk.coo_to_dense_mask(np.array([n]), np.array([0]), np.ones(1), n, d)


def test_masked_svd_init_is_bit_identical_to_jax(recsys_train):
    X = recsys_train.astype(float)
    M = (X != 0).astype(float)
    for kw in (dict(random_state=0, n_iter=3), dict(random_state=5)):
        Wj, Hj = jax_msi(X, M, 4, **kw)
        W, H = masked_svd_init(torch.as_tensor(X), M, 4, **kw)
        assert W.dtype == torch.float64
        assert np.array_equal(W.numpy(), Wj) and np.array_equal(H.numpy(), Hj)
    # the device backend (JAX's 'jax', the port's 'torch'), JAX's draws
    # injected: the key split once a round, one (d, k + 10) test matrix
    Wj, Hj = jax_msi(X, M, 4, random_state=3, n_iter=4, backend='jax')
    key, omegas = jax.random.PRNGKey(3), []
    for _ in range(4):
        key, sub = jax.random.split(key)
        omegas.append(np.asarray(jax.random.normal(
            sub, (X.shape[1], 14), dtype=jnp.float64)))
    W, H = masked_svd_init(torch.as_tensor(X), M, 4, n_iter=4,
                           backend='torch', omegas=omegas)
    assert W.dtype == torch.float64 and W.device.type == 'cpu'
    np.testing.assert_allclose(W.numpy(), Wj, rtol=0, atol=1e-9)
    np.testing.assert_allclose(H.numpy(), Hj, rtol=0, atol=1e-9)
    with pytest.raises(ValueError, match="'numpy' or 'torch'"):
        masked_svd_init(X, M, 4, backend='jax')
