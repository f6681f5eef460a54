"""The port's sparse-mask WRRI path (``nmf(W_mat=<sparse>)``, the O(nnz)
interleaved sweep, ``NMF_RS_Estimator(sparse_obs=...)``) against the JAX
package, on the CPU in float64.

- The host arrays of the observed set (``masked_coo_host_arrays``) equal
  JAX's bit for bit: order, padding, values.
- ``make_masked_sparse_sweep`` against JAX's at 1e-9, every branch, with
  JAX's random draws injected (``test_torch_sweep.jax_draws``) so
  ``'random'`` resets and DP noise match value for value; the speculative
  sweep against its eager form.
- ``nmf()`` and the estimator against JAX at 1e-8, the non-mesh cases of
  ``tests/test_masked_sparse.py``: regularizers, projections, vector
  ``w_row_sum``, weights, DP noise, resets firing, the fixed-T transform
  preset, grouped dispatch, a sparse X, the objective and its pickle, the
  guards, ``sparse_obs`` fit and transform, and ``sparsify``/``densify``.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from rri_nmf_tpu.nmf import nmf as jax_nmf
from rri_nmf_tpu.ops import sweep_masked_sparse as jms
from rri_nmf_tpu.ops.sweep_xla import SweepConfig as JaxSweepConfig
from rri_nmf_tpu.sklearn_interface import NMF_RS_Estimator as JaxRS
from rri_nmf_tpu_torch import nmf as tnmf
from rri_nmf_tpu_torch import sklearn_interface as tsk
from rri_nmf_tpu_torch.ops import masked_kernels as mk
from rri_nmf_tpu_torch.ops import sweep_masked_sparse as ms
from rri_nmf_tpu_torch.ops.sweep import SweepConfig
from test_torch_sweep import jax_draws

torch.set_num_threads(2)
ATOL_SWEEP = 1e-9
TOL = 1e-8


def _problem(seed, n=30, d=24, k=4, density=0.35, scale=1.0):
    rng = np.random.RandomState(seed)
    M = (rng.rand(n, d) < density).astype(float)
    X = rng.rand(n, d) * M * scale
    return X, M


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(a, b, tol=TOL):
    return np.allclose(_np(a), _np(b), rtol=0, atol=tol)


@pytest.fixture
def draws(monkeypatch):
    """JAX's random draws in the port's fits."""
    monkeypatch.setattr(tnmf, 'make_draws', jax_draws)


def _same_fit(X, M, k, **kw):
    """JAX's and the port's fit with the sparse mask ``M``: W, T, the
    objective history, the reset budget."""
    a = jax_nmf(X, k, W_mat=sp.csr_matrix(M), **kw)
    b = tnmf.nmf(X, k, W_mat=sp.csr_matrix(M), device='cpu', **kw)
    assert _close(b['W'], a['W']), np.abs(_np(b['W']) - a['W']).max()
    assert _close(b['T'], a['T']), np.abs(_np(b['T']) - a['T']).max()
    if 'obj_history' in a:
        oa, ob = np.asarray(a['obj_history']), np.asarray(b['obj_history'])
        assert oa.shape == ob.shape
        assert np.allclose(ob, oa, rtol=TOL, atol=0)
    assert b['n_resets_remaining'] == a['n_resets_remaining']
    assert len(b['iter_cputime']) == len(a['iter_cputime'])
    return a, b


# ---------------------------------------------------------------------------
# the host arrays
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('case', ['dense X', 'sparse X same pattern',
                                  'sparse X superset', 'weights',
                                  'explicit zeros', 'no padding'])
def test_host_arrays_equal_jax(case):
    n, d = (32, 16) if case == 'no padding' else (23, 17)
    X, M = _problem(13, n=n, d=d, density=1.0 if case == 'no padding'
                    else 0.3)
    Ms = sp.csr_matrix(M)
    Xa = X
    if case == 'sparse X same pattern':
        Xa = sp.csr_matrix((X[M != 0], Ms.indices, Ms.indptr), shape=X.shape)
    elif case == 'sparse X superset':
        Xa = sp.csr_matrix(X + 0.5 * (np.random.RandomState(2).rand(n, d)
                                      < 0.2))
    elif case == 'weights':
        Ms = sp.csr_matrix(M * (0.5 + np.random.RandomState(3).rand(n, d)))
    elif case == 'explicit zeros':
        Ms = sp.csr_matrix(M)
        Ms.data[::3] = 0.0                     # stored zeros: unobserved
    want = jms.masked_coo_host_arrays(Xa, Ms, np.float64)
    got = ms.masked_coo_host_arrays(Xa, Ms, torch.float64)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        else:
            assert g == w
    rows = got[0]
    assert rows.shape[0] % ms._PAD_TO == 0 and np.all(np.diff(rows) >= 0)
    assert float(got[3][got[5]:].sum()) == 0.0
    assert float(got[2][got[5]:].sum()) == 0.0


def test_plan_round_trip_and_torch_inputs():
    """The plan of a torch sparse mask and a torch X equals the scipy
    one; ``to_scipy`` gives the observed set back."""
    X, M = _problem(14, n=19, d=13, density=0.3)
    plan = ms.plan_masked_coo(X, sp.csr_matrix(M), torch.float64,
                              device='cpu')
    assert plan.nnz == int(M.sum()) and plan.shape == (19, 13)
    assert plan.rows.shape[0] % ms._PAD_TO == 0
    M2, X2 = plan.to_scipy()
    assert np.array_equal(M2.toarray(), M)
    assert np.array_equal(X2.toarray(), X * M)
    for Mt in (torch.as_tensor(M).to_sparse(),
               torch.as_tensor(M).to_sparse_csr()):
        p2 = ms.plan_masked_coo(torch.as_tensor(X), Mt, torch.float64)
        for f in ('rows', 'cols', 'x_vals', 'm_vals'):
            assert torch.equal(getattr(p2, f), getattr(plan, f)), f
    # the segments of the sums: row offsets, and the stable column order
    # with its offsets (padding on the last row and column)
    rows, cols = plan.rows.long(), plan.cols.long()
    assert torch.equal(plan.row_ptr, torch.as_tensor(np.searchsorted(
        rows.numpy(), np.arange(20))))
    order = plan.col_order
    assert torch.equal(order, torch.as_tensor(
        np.argsort(cols.numpy(), kind='stable')))
    assert torch.equal(plan.col_ptr, torch.as_tensor(np.searchsorted(
        cols[order].numpy(), np.arange(14))))


def test_predicted_obs_slices_equal_one_pass():
    X, M = _problem(15, n=40, d=30, density=0.5)
    plan = ms.plan_masked_coo(X, sp.csr_matrix(M), torch.float64,
                              device='cpu')
    rng = np.random.RandomState(1)
    W = torch.as_tensor(rng.rand(40, 5))
    Tt = torch.as_tensor(rng.rand(30, 5))
    one = ms._predicted_obs(plan.rows, plan.cols, W, Tt)
    sliced = ms._predicted_obs(plan.rows, plan.cols, W, Tt, chunk=100,
                               budget=0)
    assert torch.equal(one, sliced)
    want = (W @ Tt.T).numpy()[plan.rows.long(), plan.cols.long()]
    assert np.allclose(one.numpy(), want, rtol=0, atol=1e-14)


# ---------------------------------------------------------------------------
# the sweep against JAX's
# ---------------------------------------------------------------------------

SWEEP_CASES = {
    'plain': dict(),
    'regularized': dict(reg_w_l1=0.01, reg_t_l1=0.02, reg_w_l2=0.05,
                        reg_t_l2=0.03),
    'projected': dict(project_T_each_iter=True, t_row_sum=1.0,
                      w_row_sum=1.0, project_W_each_iter=True),
    'vector w_row_sum': dict(w_row_sum_is_vector=True,
                             project_W_each_iter=True),
    'dp noise': dict(dp_sigma=0.05, project_T_each_iter=True, t_row_sum=1.0),
    'fix_T random': dict(fix_T=True, reset_topic_method='random'),
    'fix_W': dict(fix_W=True),
    'random resets': dict(reset_topic_method='random', reg_t_l1=0.3),
    'random seeded': dict(reset_topic_method='random', reg_t_l1=0.3,
                          fix_reset_seed=True),
}


def _sweep_pair(kw, sweeps=3, resets=4, seed=11):
    """JAX's and the port's O(nnz) sweep from one state, draws injected."""
    k = 5
    X, M = _problem(seed, n=25, d=20, k=k, density=0.4,
                    scale=0.05 if 'random' in kw.get(
                        'reset_topic_method', '') else 1.0)
    rng = np.random.RandomState(seed + 1)
    W0, T0 = rng.rand(25, k), rng.rand(k, 20)
    if kw.get('fix_T'):
        T0[2] = 0.0                     # a dead topic for the fixed-T reset
    wrs = 0.5 + rng.rand(25)
    cfg = dict(dict(k=k, masked=True, masked_sparse=True,
                    reset_topic_method=None), **kw)
    extras = [wrs] if kw.get('w_row_sum_is_vector') else []
    jplan = jms.plan_masked_coo(X, sp.csr_matrix(M), np.float64)
    jsweep = jms.make_masked_sparse_sweep(JaxSweepConfig(**cfg))
    jd = jax_draws(3)
    key, left = jd.key, jnp.asarray(resets, jnp.int32)
    W, T = jnp.asarray(W0), jnp.asarray(T0)
    want = []
    for _ in range(sweeps):
        W, T, key, left = jsweep(jplan, W, T, key, left, jd.reset_key,
                                 *[jnp.asarray(e) for e in extras])
        want.append((np.array(W), np.array(T), int(left)))
    plan = ms.plan_masked_coo(X, sp.csr_matrix(M), torch.float64,
                              device='cpu')
    sweep = ms.make_masked_sparse_sweep(SweepConfig(**cfg))
    return sweep, plan, (torch.as_tensor(W0), torch.as_tensor(T0)), \
        [torch.as_tensor(e) for e in extras], resets, want


@pytest.mark.parametrize('case', sorted(SWEEP_CASES))
def test_sweep_matches_jax(case):
    sweep, plan, (W, T), extras, left, want = _sweep_pair(SWEEP_CASES[case])
    draws = jax_draws(3)
    for Wj, Tj, lj in want:
        W, T, left = sweep(plan, W, T, draws, left, *extras)
        assert np.allclose(W.numpy(), Wj, rtol=0, atol=ATOL_SWEEP), \
            np.abs(W.numpy() - Wj).max()
        assert np.allclose(T.numpy(), Tj, rtol=0, atol=ATOL_SWEEP)
        assert left == lj
    if 'random' in case:
        assert left < 4, 'no reset fired'


def test_speculative_sweep_reruns_eagerly_when_a_reset_fires():
    """With budget left and a topic dying the speculative result is
    dropped for the eager one, which equals an eager sweep; with no
    topic dying the speculative sweep is the result."""
    kw = SWEEP_CASES['random resets']
    sweep, plan, (W, T), extras, left, want = _sweep_pair(kw, sweeps=1)
    (W1, T1, _), dead = sweep.speculate(plan, W, T, jax_draws(3), left)
    assert bool(dead)
    W2, T2, l2 = sweep(plan, W, T, jax_draws(3), left)
    W3, T3, l3 = sweep.eager(plan, W, T, jax_draws(3), left)
    assert torch.equal(W2, W3) and torch.equal(T2, T3) and l2 == l3 < left
    assert not torch.equal(W1, W2)
    (W4, T4, l4), dead = sweep.speculate(plan, W2, T2, jax_draws(3), 0)
    assert dead is None and l4 == 0


def test_objective_matches_jax_and_the_dense_form():
    X, M = _problem(16)
    rng = np.random.RandomState(2)
    W, T = rng.rand(30, 4), rng.rand(4, 24)
    regs = dict(reg_w_l2=0.02, reg_t_l2=0.01, reg_w_l1=0.005, reg_t_l1=0.003)
    want = float(jms.make_masked_sparse_objective(**regs)(
        jms.plan_masked_coo(X, sp.csr_matrix(M), np.float64),
        jnp.asarray(W), jnp.asarray(T)))
    got = float(ms.make_masked_sparse_objective(**regs)(
        ms.plan_masked_coo(X, sp.csr_matrix(M), torch.float64, device='cpu'),
        torch.as_tensor(W), torch.as_tensor(T)))
    direct = 0.5 * np.sum(M * (X - W @ T) ** 2) \
        + 0.5 * 0.02 * np.sum(W ** 2) + 0.5 * 0.01 * np.sum(T ** 2) \
        + 0.005 * W.sum() + 0.003 * T.sum()
    assert got == pytest.approx(want, rel=1e-12)
    assert got == pytest.approx(direct, rel=1e-12)


# ---------------------------------------------------------------------------
# nmf() against JAX (the non-mesh cases of tests/test_masked_sparse.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('regs', [
    dict(),                                      # the scale transfer
    dict(reg_w_l1=0.01, reg_t_l1=0.01),
    dict(reg_w_l1=0.05, reg_t_l1=0.0),
    dict(reg_w_l2=0.02, reg_t_l2=0.02),
])
def test_nmf_parity_reg_configs(regs):
    X, M = _problem(0)
    a, b = _same_fit(X, M, 4, max_iter=8, compute_obj_each_iter=True,
                     reset_topic_method=None, random_state=0, **regs)
    ob = np.asarray(b['obj_history'])
    assert np.all(np.diff(ob) <= 1e-12)


def test_nmf_parity_simplex_projected():
    X, M = _problem(4)
    a, b = _same_fit(X, M, 4, max_iter=8, compute_obj_each_iter=True,
                     reset_topic_method=None, project_T_each_iter=True,
                     t_row_sum=1.0, w_row_sum=1.0, project_W_each_iter=True,
                     random_state=4)
    assert np.allclose(b['T'].sum(1).numpy(), 1.0, atol=1e-12)


def test_nmf_parity_vector_w_row_sum_and_weights():
    X, M = _problem(7)
    wrs = 0.5 + np.random.RandomState(7).rand(X.shape[0])
    _same_fit(X, M, 4, max_iter=5, compute_obj_each_iter=True,
              reset_topic_method=None, w_row_sum=wrs,
              project_W_each_iter=True, random_state=7)
    Mw = M * (0.5 + np.random.RandomState(8).rand(*M.shape))
    _same_fit(X, Mw, 4, max_iter=6, compute_obj_each_iter=True,
              reset_topic_method=None, random_state=8)


def test_nmf_parity_dp_noise(draws):
    X, M = _problem(6)
    _same_fit(X, M, 4, max_iter=5, compute_obj_each_iter=True,
              reset_topic_method=None, eps_gauss_t=1e4, delta_gauss_t=0.1,
              project_T_each_iter=True, t_row_sum=1.0, random_state=6)


@pytest.mark.parametrize('fix_seed', [True, False])
def test_nmf_parity_random_resets_fire(fix_seed, draws):
    X, M = _problem(11, n=25, d=20, k=6, density=0.4, scale=0.05)
    a, b = _same_fit(X, M, 6, max_iter=8, compute_obj_each_iter=True,
                     reset_topic_method='random', fix_reset_seed=fix_seed,
                     n_resets=10, reg_t_l1=0.3, random_state=12)
    assert a['n_resets_remaining'] < 10


def test_nmf_parity_fix_T_transform(draws):
    """The RS transform preset: fixed-T sweeps, 'random' resets, a dead
    T row so one fires."""
    rng = np.random.RandomState(5)
    X, M = _problem(5)
    T_in = np.abs(rng.rand(4, X.shape[1]))
    T_in /= T_in.sum(axis=1, keepdims=True)
    T_in[1] = 0.0
    a, b = _same_fit(X, M, 4, max_iter=4, reset_topic_method='random',
                     T_in=T_in, fix_T=True, t_row_sum=1.0,
                     compute_obj_each_iter=True, random_state=5)
    assert a['n_resets_remaining'] < 23


def test_nmf_sparse_X_torch_mask_and_objective():
    """X itself sparse (scipy, or a torch COO tensor), the mask a torch
    CSR tensor; the returned objective keeps evaluating and pickles."""
    X, M = _problem(1)
    common = dict(max_iter=8, compute_obj_each_iter=True,
                  reset_topic_method=None, reg_w_l1=0.01, reg_t_l1=0.01,
                  t_row_sum=1.0, random_state=0)
    a = jax_nmf(sp.csr_matrix(X), 4, W_mat=sp.csr_matrix(M), **common)
    for Xp, Mp in ((sp.csr_matrix(X), sp.csr_matrix(M)),
                   (torch.as_tensor(X).to_sparse(),
                    torch.as_tensor(M).to_sparse_csr())):
        b = tnmf.nmf(Xp, 4, W_mat=Mp, device='cpu', **common)
        assert _close(b['W'], a['W']) and _close(b['T'], a['T'])
        oc = b['obj_calculator']
        assert abs(oc.true_objective() - b['obj_history'][-1]) < 1e-10
        oc2 = pickle.loads(pickle.dumps(oc))
        assert isinstance(oc2.X, tuple) or oc2.X is not oc.X
        assert abs(oc2.true_objective() - b['obj_history'][-1]) < 1e-10


def test_grouped_dispatch_matches_per_iteration():
    X, M = _problem(9)
    Ms = sp.csr_matrix(M)
    common = dict(max_iter=6, reset_topic_method=None, random_state=9,
                  device='cpu')
    r1 = tnmf.nmf(X, 4, W_mat=Ms, **common)
    r2 = tnmf.nmf(X, 4, W_mat=Ms, sweeps_per_dispatch=3, **common)
    assert torch.equal(r1['W'], r2['W']) and torch.equal(r1['T'], r2['T'])


def test_guards_as_jax():
    X, M = _problem(3)
    Ms = sp.csr_matrix(M)
    with pytest.raises(NotImplementedError, match='w_row'):
        tnmf.nmf(X, 4, W_mat=Ms, w_row=np.ones(X.shape[0]), max_iter=1,
                 device='cpu')
    with pytest.raises(ValueError, match='store_gradients'):
        tnmf.nmf(X, 4, W_mat=Ms, store_gradients=True, max_iter=1,
                 device='cpu')
    with pytest.raises(ValueError, match="'dma' has no masked form"):
        tnmf.nmf(X, 4, W_mat=Ms, sparse='dma', max_iter=1, device='cpu')
    with pytest.raises(ValueError, match='sparse=True requires'):
        tnmf.nmf(X, 4, W_mat=Ms, sparse=True, max_iter=1, device='cpu')
    with pytest.raises(TypeError, match='make_mesh'):
        tnmf.nmf(X, 4, W_mat=Ms, mesh=object(), max_iter=1, device='cpu')
    with pytest.raises(ValueError, match='shape'):
        tnmf.nmf(X, 4, W_mat=Ms[:10], max_iter=1, device='cpu')
    # 'max_resid_document' (the default) is turned off, not refused
    r = tnmf.nmf(X, 4, W_mat=Ms, reset_topic_method='max_resid_document',
                 max_iter=2, compute_obj_each_iter=True, random_state=0,
                 device='cpu')
    assert len(r['obj_history']) == 2 and r['n_resets_remaining'] == 23


def test_nmf_on_cpu_launches_no_kernel():
    X, M = _problem(10)
    before = dict(mk.LAUNCHES)
    tnmf.nmf(X, 4, W_mat=sp.csr_matrix(M), max_iter=2, device='cpu')
    assert mk.LAUNCHES == before


# ---------------------------------------------------------------------------
# the recommender estimator with sparse_obs
# ---------------------------------------------------------------------------

def test_estimator_sparse_obs_parity(recsys_train):
    """sparse_obs=True against JAX's, and against the port's dense-mask
    fit (validation early stopping included)."""
    n, d = recsys_train.shape
    I, J = recsys_train.nonzero()
    R = recsys_train[I, J]
    X = np.stack([I, J], axis=1)
    kw = dict(random_state=0, max_iter=8)
    js = JaxRS(n, d, 5, sparse_obs=True, **kw).fit(X, R)
    ps = tsk.NMF_RS_Estimator(n, d, 5, sparse_obs=True, device='cpu',
                              **kw).fit(X, R)
    pd = tsk.NMF_RS_Estimator(n, d, 5, sparse_obs=False, device='cpu',
                              **kw).fit(X, R)
    assert _close(ps.W, js.W) and _close(ps.T, js.T)
    assert np.allclose(ps.nmf_outputs['obj_history'],
                       js.nmf_outputs['obj_history'], rtol=TOL)
    assert _close(ps.W, pd.W, 1e-9) and _close(ps.T, pd.T, 1e-9)
    assert ps.score(X, R) == pytest.approx(js.score(X, R), rel=TOL)
    assert ps.score(X, R) < 1.0
    # the fitted objective pickles with the estimator
    e = pickle.loads(pickle.dumps(ps))
    oc = e.nmf_outputs['obj_calculator']
    assert oc.true_objective() == pytest.approx(
        ps.nmf_outputs['obj_history'][-1], rel=1e-10)


def test_estimator_transform_dense_and_sparse(recsys_train, recsys_test):
    n, d = recsys_train.shape
    js = JaxRS(n, d, 5, random_state=0, max_iter=6,
               sparse_obs=True).fit_from_Xtr(sp.csr_matrix(recsys_train))
    ps = tsk.NMF_RS_Estimator(n, d, 5, random_state=0, max_iter=6,
                              sparse_obs=True, device='cpu').fit_from_Xtr(
        sp.csr_matrix(recsys_train))
    assert _close(ps.W, js.W) and _close(ps.T, js.T)
    for Xnew in (recsys_test, sp.csr_matrix(recsys_test),
                 torch.as_tensor(recsys_test)):
        got = ps.transform(Xnew)
        assert got.shape == (recsys_test.shape[0], 5)
        assert _close(got, np.asarray(js.transform(
            Xnew.numpy() if isinstance(Xnew, torch.Tensor) else Xnew)))


def test_estimator_auto_threshold_and_gram_recipe():
    assert tsk.NMF_RS_Estimator(100, 100, 5)._use_sparse_obs() is False
    assert tsk.NMF_RS_Estimator(100_000, 50_000, 5)._use_sparse_obs() is True
    assert tsk.NMF_RS_Estimator(10, 10, 2,
                                sparse_obs=True)._use_sparse_obs() is True
    # the Gram recipe through the estimator, against JAX's
    rng = np.random.RandomState(0)
    n, d, k = 60, 45, 4
    mask = rng.rand(n, d) < 0.3
    Xr = (rng.rand(n, k) @ rng.rand(k, d)) * mask * 5
    I, J = mask.nonzero()
    X, R = np.stack([I, J], 1), Xr[I, J]
    kw = dict(random_state=0, max_iter=10, sparse_obs=True,
              nmf_kwargs=dict(update_order='phase'))
    j = JaxRS(n, d, k, **kw).fit(X, R)
    p = tsk.NMF_RS_Estimator(n, d, k, device='cpu', **kw).fit(X, R)
    assert _close(p.W, j.W) and _close(p.T, j.T)
    assert len(p.nmf_outputs['obj_history']) >= 2


def test_sparsify_densify_predict_score(recsys_train, recsys_test):
    n, d = recsys_train.shape
    js = JaxRS(n, d, 4, random_state=0, max_iter=4).fit_from_Xtr(
        recsys_train)
    ps = tsk.NMF_RS_Estimator(n, d, 4, random_state=0, max_iter=4,
                              device='cpu').fit_from_Xtr(recsys_train)
    I, J = recsys_test.nonzero()
    pairs, y = np.stack([I, J], 1), recsys_test[I, J]
    js.sparsify()
    ps.sparsify()
    assert sp.issparse(ps.W) and sp.issparse(ps.T)
    assert _close(ps.W.toarray(), js.W.toarray())
    assert _close(ps.predict(pairs), js.predict(pairs))
    assert ps.score(pairs, y) == pytest.approx(js.score(pairs, y), rel=TOL)
    assert ps.score(recsys_test) == pytest.approx(js.score(recsys_test),
                                                  rel=TOL)
    assert _close(ps.transform(recsys_test), np.asarray(js.transform(
        recsys_test)))
    js.densify()
    ps.densify()
    assert isinstance(ps.W, torch.Tensor) and isinstance(ps.T, torch.Tensor)
    assert _close(ps.W, js.W) and _close(ps.T, js.T)
    ps.sparsify()
    ps.sparsify()                       # idempotent
    ps.densify()
    assert ps.W.device.type == 'cpu' and _close(ps.W, js.W)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.cuda
def test_cuda_sweep_repeats_bit_for_bit(cuda_device):
    """No atomics: the sweep's launches and its CUDA graph give the same
    bits, within float32 rounding of the CPU's float64 sweep."""
    X, M = _problem(17, n=900, d=700, k=6, density=0.05)
    plan = ms.plan_masked_coo(X, sp.csr_matrix(M), torch.float32,
                              device=cuda_device)
    rng = np.random.RandomState(1)
    W = torch.as_tensor(rng.rand(900, 6), dtype=torch.float32,
                        device=cuda_device)
    T = torch.as_tensor(rng.rand(6, 700), dtype=torch.float32,
                        device=cuda_device)
    sweep = ms.make_masked_sparse_sweep(SweepConfig(
        k=6, masked=True, masked_sparse=True, reset_topic_method=None))
    outs = [sweep.speculate(plan, W, T, None, 0)[0][:2] for _ in range(2)]
    outs += [sweep(plan, W, T, None, 0)[:2] for _ in range(3)]
    for Wo, To in outs:
        assert torch.equal(Wo, outs[0][0]) and torch.equal(To, outs[0][1])
    cpu = ms.plan_masked_coo(X, sp.csr_matrix(M), torch.float64,
                             device='cpu')
    Wc, Tc, _ = sweep.eager(cpu, W.double().cpu(), T.double().cpu(), None, 0)
    assert _close(outs[0][0].double(), Wc, 1e-3 * float(Wc.abs().max()))
