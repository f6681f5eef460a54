"""The port's ``nmf()`` and ``NMF_TM_Estimator`` on a sparse X against
the JAX package, end to end on the CPU in float64.

- ``nmf()`` on a scipy CSR with ``sparse`` in ``True``, ``'mxu'``,
  ``'dma'``, ``'auto'`` and ``False`` against the JAX ``nmf()`` with the
  same arguments at 1e-8, and against the port's own dense fit at 1e-11.
- A CPU torch sparse tensor (COO or CSR) fits like the scipy matrix.
- The JAX ``ValueError`` s of the sparse modes.
- ``NMF_TM_Estimator`` on a sparse slice of the text fixture: fit,
  stepped ``one_iter`` ≡ batch fit, sparse ``transform``, ``score`` and
  ``score_all`` against JAX at 1e-8.
- Sparse ``tfidf``/``normalize`` bit for bit, and the NNDSVD init of a
  sparse X.
"""

from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from rri_nmf_tpu import matrixops as jm
from rri_nmf_tpu.initialization import initialize_nmf as jax_init
from rri_nmf_tpu.nmf import nmf as jax_nmf
from rri_nmf_tpu.sklearn_interface import NMF_TM_Estimator as JaxTM
from rri_nmf_tpu_torch import matrixops as tm
from rri_nmf_tpu_torch import sklearn_interface as tsk
from rri_nmf_tpu_torch.initialization import initialize_nmf as torch_init
from rri_nmf_tpu_torch.initialization import randomized_svd_torch
from rri_nmf_tpu_torch.nmf import nmf as torch_nmf
from rri_nmf_tpu_torch.ops import dense_kernels as dk
from rri_nmf_tpu_torch.ops import sparse_kernels as sk

torch.set_num_threads(2)
TOL = 1e-8
TOL_DENSE = 1e-11
FAST_TM = dict(update_order='phase', reset_topic_method=None)
REPO = Path(__file__).resolve().parent.parent


def _sparse(n, d, dens, seed):
    """A ragged sparse CSR with one empty 128-column band."""
    rng = np.random.RandomState(seed)
    Xd = rng.rand(n, d) * (rng.rand(n, d) < dens)
    Xd[:, 128:256] = 0.0
    return sp.csr_matrix(Xd)


def _close(a, b, tol):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.abs(a - np.asarray(b)).max() <= tol


CONFIGS = {
    'plain': dict(),
    'tm preset': dict(project_T_each_iter=True, t_row_sum=1.0,
                      w_row_sum=1.0),
    'inner_reps=2': dict(inner_reps=2),
    'vector w_row_sum': dict(
        w_row_sum=np.random.RandomState(9).rand(290) + 0.5,
        project_W_each_iter=True),
}


@pytest.mark.parametrize('config', sorted(CONFIGS))
@pytest.mark.parametrize('mode', [True, 'mxu', 'dma', 'auto', False])
def test_sparse_nmf_matches_jax_and_the_dense_fit(mode, config):
    X = _sparse(290, 270, 0.05, 0)
    kw = dict(max_iter=6, compute_obj_each_iter=True, random_state=0,
              sparse=mode, **FAST_TM, **CONFIGS[config])
    a = jax_nmf(X, 5, **kw)
    b = torch_nmf(X, 5, device='cpu', **kw)
    assert _close(b['W'], a['W'], TOL) and _close(b['T'], a['T'], TOL)
    assert np.allclose(b['obj_history'], a['obj_history'], rtol=TOL, atol=0)
    ob = np.asarray(b['obj_history'])
    assert np.all(np.diff(ob) <= 1e-10 * np.abs(ob[:-1]))
    c = torch_nmf(X.toarray(), 5, device='cpu', **dict(kw, sparse=False))
    assert _close(b['W'], c['W'], TOL_DENSE)
    assert _close(b['T'], c['T'], TOL_DENSE)
    assert np.allclose(b['obj_history'], c['obj_history'], rtol=TOL_DENSE,
                       atol=0)


def test_sparse_nmf_launches_no_kernel_on_the_cpu():
    before = dict(sk.LAUNCHES), dict(dk.LAUNCHES)
    for mode in ('mxu', 'dma'):
        torch_nmf(_sparse(140, 150, 0.05, 1), 3, max_iter=2, random_state=0,
                  sparse=mode, device='cpu', **FAST_TM)
    assert (dict(sk.LAUNCHES), dict(dk.LAUNCHES)) == before


@pytest.mark.parametrize('layout', ['coo', 'csr'])
@pytest.mark.parametrize('mode', [True, 'mxu', 'dma', 'auto'])
def test_torch_sparse_tensor_fits_like_scipy(mode, layout):
    X = _sparse(200, 300, 0.04, 2)
    coo = X.tocoo()
    Xt = torch.sparse_coo_tensor(np.stack([coo.row, coo.col]), coo.data,
                                 X.shape)
    if layout == 'csr':
        Xt = Xt.to_sparse_csr()
    seen = []

    def diag(X, W, T):
        seen.append(X)
        return 0.0

    kw = dict(max_iter=4, compute_obj_each_iter=True, random_state=1,
              sparse=mode, **FAST_TM)
    a = torch_nmf(X, 4, device='cpu', **kw)
    b = torch_nmf(Xt, 4, diagnostics=[diag], **kw)
    assert b['W'].device.type == 'cpu' and b['W'].dtype == torch.float64
    assert _close(b['W'], a['W'].numpy(), TOL_DENSE)
    assert _close(b['T'], a['T'].numpy(), TOL_DENSE)
    assert np.allclose(b['obj_history'], a['obj_history'], rtol=TOL_DENSE)
    # callbacks receive the X the user passed
    assert all(x is Xt for x in seen)


def test_sparse_true_takes_a_dense_X_and_coerces_the_order():
    """JAX's sparse=True takes a dense X (BCOO.fromdense) and runs the
    phase order without resets whatever was asked."""
    X = _sparse(100, 150, 0.1, 3).toarray()
    kw = dict(max_iter=4, compute_obj_each_iter=True, random_state=2,
              sparse=True, update_order='interleaved')
    a = jax_nmf(X, 3, **kw)
    b = torch_nmf(X, 3, device='cpu', **kw)
    assert _close(b['W'], a['W'], TOL) and _close(b['T'], a['T'], TOL)
    assert b['n_resets_remaining'] == a['n_resets_remaining']


def test_sparse_mode_errors_match_jax():
    X = _sparse(60, 50, 0.1, 4)
    cases = [dict(X=X.toarray(), sparse='dma'),
             dict(X=X.toarray(), sparse='mxu'),
             dict(X=X, sparse=True, W_mat=np.ones((60, 50))),
             dict(X=X, sparse='bogus')]
    for kw in cases:
        with pytest.raises(ValueError):
            jax_nmf(k=2, max_iter=1, **FAST_TM, **kw)
        with pytest.raises(ValueError):
            torch_nmf(k=2, max_iter=1, device='cpu', **FAST_TM, **kw)


def test_auto_declines_when_the_settings_differ():
    """'auto' engages only under the sparse sweep's own settings; with
    others the sparse X is densified (and the dense path decides)."""
    X = _sparse(60, 50, 0.1, 5)
    # resets on: densified, the phase order with resets (JAX's Gram-blocked
    # make_sweep, the port's kernel sweep checked after each sweep)
    a = jax_nmf(X, 2, max_iter=3, update_order='phase', random_state=0)
    b = torch_nmf(X, 2, max_iter=3, update_order='phase', random_state=0,
                  device='cpu')
    assert _close(b['W'], a['W'], TOL) and _close(b['T'], a['T'], TOL)
    assert b['n_resets_remaining'] == a['n_resets_remaining']
    W = np.ones((60, 50))
    a = jax_nmf(X, 2, max_iter=3, W_mat=W, reset_topic_method=None,
                random_state=0)
    b = torch_nmf(X, 2, max_iter=3, W_mat=W, reset_topic_method=None,
                  random_state=0, device='cpu')
    assert _close(b['W'], a['W'], TOL) and _close(b['T'], a['T'], TOL)


# ---------------------------------------------------------------------------
# the topic-model estimator
# ---------------------------------------------------------------------------

def _text():
    raw = sp.load_npz(REPO / 'tests' / 'data' / 'text_data_train.npz')
    return raw.tocsr()[:80], raw.tocsr()[80:]


def _tm_params(mode, **kw):
    return dict(random_state=0, max_iter=8, handle_tfidf=True,
                handle_normalization=True,
                nmf_kwargs=dict(FAST_TM, compute_obj_each_iter=True,
                                sparse=mode), **kw)


@pytest.mark.parametrize('mode', [True, 'mxu', 'dma', 'auto'])
def test_sparse_tm_estimator_matches_jax(mode):
    X, Xte = _text()
    n, d = X.shape
    J = JaxTM(n, d, 4, **_tm_params(mode)).fit(X)
    P = tsk.NMF_TM_Estimator(n, d, 4, device='cpu',
                             **_tm_params(mode)).fit(X)
    assert _close(P.W, J.W, TOL) and _close(P.T, J.T, TOL)
    assert np.allclose(P.nmf_outputs['obj_history'],
                       J.nmf_outputs['obj_history'], rtol=TOL)
    assert np.array_equal(P.idf.numpy(), np.asarray(J.idf))
    assert _close(P.transform(Xte), J.transform(Xte), TOL)
    assert P.score(Xte) == pytest.approx(J.score(Xte), rel=TOL)
    sj, sp_ = J.score_all(Xte), P.score_all(Xte)
    for key in ('r2', 'rel_frobenius_error'):
        assert sp_[key] == pytest.approx(sj[key], rel=TOL)
    assert np.allclose(P.T.numpy().sum(1), 1.0, atol=1e-12)


def test_sparse_tm_one_iter_steps_equal_batch_fit():
    X, _ = _text()
    n, d = X.shape
    kw = dict(random_state=0, nmf_kwargs=dict(FAST_TM, sparse='mxu'),
              device='cpu')
    M = tsk.NMF_TM_Estimator(n, d, 5, max_iter=6, **kw).fit(X)
    M2 = tsk.NMF_TM_Estimator(n, d, 5, max_iter=2, do_final_project_W=False,
                              **kw).fit(X)
    for _ in range(4):
        M2 = M2.one_iter(X)
    M2.W = tm.proj_mat_to_simplex(M2.W)
    assert torch.allclose(M2.T, M.T) and torch.allclose(M2.W, M.W)


def test_sparse_tm_estimator_takes_torch_sparse_and_refuses_negatives():
    X, Xte = _text()
    n, d = X.shape
    P = tsk.NMF_TM_Estimator(n, d, 4, device='cpu',
                             **_tm_params('mxu')).fit(X)
    Q = tsk.NMF_TM_Estimator(n, d, 4, **_tm_params('mxu')).fit(
        tm.as_tensor(X).to_sparse_csr())
    assert _close(Q.W, P.W.numpy(), TOL_DENSE)
    assert _close(Q.transform(tm.as_tensor(Xte)), P.transform(Xte).numpy(),
                  TOL_DENSE)
    with pytest.raises(ValueError, match='non-negative'):
        tsk.NMF_TM_Estimator(n, d, 4, device='cpu',
                             **_tm_params('mxu')).fit(-X)


# ---------------------------------------------------------------------------
# sparse leaf math and init
# ---------------------------------------------------------------------------

def test_sparse_tfidf_and_normalize_match_jax_bit_for_bit():
    rng = np.random.RandomState(6)
    X = sp.csr_matrix(rng.poisson(0.4, size=(40, 30)).astype(float))
    X[:, 3] = 0.0
    X.eliminate_zeros()
    want, widf = jm.tfidf(X, return_idf=True)
    got, gidf = tm.tfidf(X, return_idf=True)
    assert sp.issparse(got) and (got != want).nnz == 0
    assert np.array_equal(gidf.numpy(), np.asarray(widf))
    for dim in (0, 1):
        a, b = jm.normalize(want, dim=dim), tm.normalize(got, dim=dim)
        assert sp.issparse(b) and (a != b).nnz == 0
    # torch sparse tensors stay sparse, in their layout
    for Xt in (tm.as_tensor(X), tm.as_tensor(X).to_sparse_csr()):
        t, tidf = tm.tfidf(Xt, return_idf=True)
        assert t.layout == Xt.layout
        assert np.allclose(t.to_dense().numpy(), want.toarray(), rtol=1e-15,
                           atol=0)
        assert np.allclose(tidf.numpy(), np.asarray(widf), rtol=1e-15)
        nrm = tm.normalize(t)
        assert nrm.layout == Xt.layout
        assert np.allclose(nrm.to_dense().numpy(),
                           jm.normalize(want).toarray(), rtol=1e-15, atol=0)


def test_sparse_init_matches_jax():
    X = _sparse(120, 200, 0.08, 7)
    for init in ('nndsvd', 'nndsvda', 'nndsvdar', 'smart_random'):
        Wj, Hj = jax_init(X, 6, init, random_state=3)
        Wp, Hp = torch_init(X, 6, init, random_state=3, device='cpu')
        assert np.array_equal(Wp.numpy(), Wj) and np.array_equal(Hp.numpy(),
                                                                 Hj)
        Wt, Ht = torch_init(tm.as_tensor(X).to_sparse_csr(), 6, init,
                            random_state=3)
        assert np.allclose(Wt.numpy(), Wj, atol=1e-12)
    # the torch backend: sparse range-finder products == dense ones, up to
    # the sign of each component, which neither backend fixes (round-off
    # between the sparse and the dense products can flip a pair). U's
    # column and Vt's row share it: align each pair by <u_sparse, u_dense>.
    omega = torch.as_tensor(np.random.RandomState(8).randn(200, 16))
    Ua, Sa, Vta = randomized_svd_torch(tm.as_tensor(X), 6, omega=omega)
    Ub, Sb, Vtb = randomized_svd_torch(torch.as_tensor(X.toarray()), 6,
                                       omega=omega)
    sign = torch.sign((Ua * Ub).sum(0))
    assert bool((sign != 0).all())
    assert torch.allclose(Sa, Sb, rtol=0, atol=1e-10)
    assert torch.allclose(Ua * sign, Ub, rtol=0, atol=1e-10)
    assert torch.allclose(Vta * sign[:, None], Vtb, rtol=0, atol=1e-10)
    assert torch.allclose((Ua * Sa) @ Vta, (Ub * Sb) @ Vtb, rtol=0,
                          atol=1e-10)
