"""The port's ``nmf()`` and ``NMF_TM_Estimator`` against the JAX
package, end to end on the CPU in float64.

One kwargs dict drives both packages; W, T, ``obj_history`` and the
reset budget left agree at 1e-8. The phase recipe without resets: the
JAX ``nmf()`` runs its XLA phase sweep on the CPU, the port the plain
twins of its kernels — the same coordinate updates. The defaults (the
interleaved order with ``'max_resid_document'`` resets, a reset firing
too) and the options of the plain sweep (``use_pallas=False``, resets in
phase order, gradient stores, DP noise with the draws injected, grouped
dispatch): both packages' ``make_sweep``. Also: the TM estimator with the
fast-TM recipe and with its default preset on the reference's text
fixtures, carrying a fitted JAX estimator into the port, stepped
``one_iter`` ≡ batch fit, the ``NotImplementedError`` of every option
outside the slice, and that importing the port pulls in neither JAX nor
scikit-learn.
"""

import logging
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse
import torch

from rri_nmf_tpu.nmf import nmf as jax_nmf
from rri_nmf_tpu.sklearn_interface import NMF_TM_Estimator as JaxTM
from rri_nmf_tpu_torch import nmf as tnmf
from rri_nmf_tpu_torch import sklearn_interface as tsk
from rri_nmf_tpu_torch.convert import factors_from_numpy
from rri_nmf_tpu_torch.nmf import nmf as torch_nmf
from rri_nmf_tpu_torch.ops import dense_kernels as dk
from test_torch_sweep import jax_draws

torch.set_num_threads(2)
TOL = 1e-8
FAST_TM = dict(update_order='phase', reset_topic_method=None)
REPO = Path(__file__).resolve().parent.parent


def _lowrank(n, d, k, seed=0):
    rng = np.random.RandomState(seed)
    return np.abs(rng.rand(n, k) @ rng.rand(k, d) + 0.01 * rng.rand(n, d))


def _close(a, b, tol=TOL):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.allclose(a, np.asarray(b), rtol=0, atol=tol)


def _same_fit(X, k, **kw):
    a = jax_nmf(X, k, **kw)
    b = torch_nmf(X, k, device='cpu', **kw)
    assert _close(b['W'], a['W']), np.abs(b['W'].numpy() - a['W']).max()
    assert _close(b['T'], a['T']), np.abs(b['T'].numpy() - a['T']).max()
    if 'obj_history' in a:
        oa, ob = np.asarray(a['obj_history']), np.asarray(b['obj_history'])
        assert oa.shape == ob.shape
        assert np.allclose(ob, oa, rtol=TOL, atol=0)
    assert b['random_state'] == a['random_state']
    assert b['n_resets_remaining'] == a['n_resets_remaining']
    assert len(b['iter_cputime']) == len(a['iter_cputime'])
    return a, b


NMF_CASES = {
    'plain': dict(),
    'tm preset': dict(project_T_each_iter=True, t_row_sum=1.0,
                      w_row_sum=1.0),
    'tm preset, project_W': dict(project_T_each_iter=True, t_row_sum=1.0,
                                 w_row_sum=1.0, project_W_each_iter=True),
    'regularized': dict(reg_w_l2=0.1, reg_t_l2=0.2, reg_w_l1=0.01,
                        reg_t_l1=0.02),
    'negative l1 bounded': dict(reg_t_l1=-0.01, t_row_sum=1.0),
    'inner_reps=3': dict(inner_reps=3),
    'random init': dict(init='random'),
    'nndsvda init': dict(init='nndsvda', eps_stop=1e-3),
}


@pytest.mark.parametrize('case', sorted(NMF_CASES))
def test_nmf_matches_jax(case):
    X = _lowrank(60, 45, 4, seed=1)
    kw = dict(max_iter=12, compute_obj_each_iter=True, random_state=0,
              **FAST_TM, **NMF_CASES[case])
    a, b = _same_fit(X, 4, **kw)
    if not kw.get('project_W_each_iter'):
        # exact coordinate steps descend; a per-sweep W projection need not
        ob = np.asarray(b['obj_history'])
        assert np.all(np.diff(ob) <= 1e-10 * np.abs(ob[:-1]))


def test_nmf_vector_w_row_sum_and_fix_T_match_jax():
    X = _lowrank(50, 30, 3, seed=2)
    wrs = np.random.RandomState(3).rand(50) + 0.5
    kw = dict(max_iter=6, compute_obj_each_iter=True, random_state=1,
              w_row_sum=wrs, project_W_each_iter=True, **FAST_TM)
    a, b = _same_fit(X, 3, **kw)
    assert np.allclose(b['W'].numpy().sum(1), wrs, atol=1e-12)
    # a fixed-T transform from the fitted topics, in the default order
    # (fix_T takes the phase path in both packages)
    kw = dict(max_iter=4, T_in=a['T'], fix_T=True, w_row_sum=1.0,
              reset_topic_method=None, random_state=1)
    c, d = _same_fit(X[:20], 3, **kw)
    assert np.allclose(d['T'].numpy(), a['T'])
    assert np.allclose(d['W'].numpy().sum(1), 1.0, atol=1e-12)


def test_nmf_warm_start_early_stop_and_callbacks_match_jax():
    X = _lowrank(40, 30, 3, seed=4)
    rng = np.random.RandomState(5)
    W0, T0 = rng.rand(40, 3), rng.rand(3, 30)
    W0[0, 0] = -1.0                         # clipped to 0 by both

    def frob(X, W, T):
        return float(np.linalg.norm(np.asarray(X) - np.asarray(W)
                                    @ np.asarray(T)))

    kw = dict(max_iter=8, compute_obj_each_iter=True, W_in=W0, T_in=T0,
              early_stop=True, diagnostics=[frob], debug_checks=True,
              random_state=3, **FAST_TM)
    a, b = _same_fit(X, 3, **kw)
    assert np.allclose(b['diagnostics']['frob'], a['diagnostics']['frob'],
                       rtol=TOL)
    assert b['obj_calculator'].true_objective() == pytest.approx(
        a['obj_calculator'].true_objective(), rel=TOL)


def test_nmf_early_stop_rolls_back_like_jax():
    """A callable score that rises after the third call stops the fit and
    restores the previous iterate in both packages."""
    X = _lowrank(30, 25, 3, seed=6)

    def make_score():
        calls = []

        def score(X, W, T):
            calls.append(1)
            return -len(calls) if len(calls) < 4 else 10.0
        return score

    kw = dict(max_iter=10, compute_obj_each_iter=True, random_state=2,
              **FAST_TM)
    a = jax_nmf(X, 3, early_stop=make_score(), **kw)
    b = torch_nmf(X, 3, early_stop=make_score(), device='cpu', **kw)
    assert len(b['obj_history']) == len(a['obj_history']) == 2
    assert _close(b['W'], a['W']) and _close(b['T'], a['T'])


@pytest.mark.parametrize('which', ['t', 'w'])
def test_nmf_unbounded_sentinels_match_jax(which):
    X = _lowrank(10, 8, 2, seed=7)
    kw = dict(reg_t_l2=-0.1) if which == 't' else dict(reg_w_l1=-0.1)
    a = jax_nmf(X, 2, **FAST_TM, **kw)
    b = torch_nmf(X, 2, device='cpu', **FAST_TM, **kw)
    assert _close(b['W'], a['W'], 0) and _close(b['T'], a['T'], 0)
    assert b['obj_history'] == a['obj_history']


def test_nmf_objective_logging_and_dtype():
    X = _lowrank(30, 20, 3, seed=8)
    logger = logging.getLogger('rri_nmf_tpu_torch.nmf')
    old = logger.level
    logger.setLevel(logging.DEBUG)
    try:
        b = torch_nmf(X, 3, max_iter=3, random_state=0, device='cpu',
                      **FAST_TM)
    finally:
        logger.setLevel(old)
    assert len(b['obj_history']) == 3          # DEBUG forces tracking
    c = torch_nmf(X.astype(np.float32), 3, max_iter=3, random_state=0,
                  device='cpu', **FAST_TM)
    assert c['W'].dtype == c['T'].dtype == torch.float32
    d = torch_nmf(X, 3, max_iter=3, random_state=0, dtype='float32',
                  device='cpu', **FAST_TM)
    assert d['T'].dtype == torch.float32


def test_nmf_on_cpu_launches_no_kernel():
    before = dict(dk.LAUNCHES)
    torch_nmf(_lowrank(20, 15, 2), 2, max_iter=2, random_state=0,
              device='cpu', **FAST_TM)
    assert dk.LAUNCHES == before


def _dead_column(n, k, col, seed=10):
    """A warm start whose W column ``col`` is 0: its topic dies in the
    first T-phase, and a reset fires."""
    rng = np.random.RandomState(seed)
    W0 = rng.rand(n, k)
    W0[:, col] = 0.0
    return W0


def test_nmf_defaults_match_jax():
    """``nmf(X, k)`` with every default (the interleaved order,
    ``'max_resid_document'`` resets, 200 sweeps), then from a warm start
    with a dead topic, whose reset picks the same document as JAX."""
    X = _lowrank(60, 45, 4, seed=1)
    _same_fit(X, 4, random_state=0)
    rng = np.random.RandomState(11)
    a, b = _same_fit(X, 4, random_state=0, max_iter=8,
                     compute_obj_each_iter=True, W_in=_dead_column(60, 4, 2),
                     T_in=rng.rand(4, 45))
    assert b['n_resets_remaining'] == a['n_resets_remaining'] < 23
    ob = np.asarray(b['obj_history'])
    assert np.all(np.isfinite(ob))


# options that raised before the plain sweep was ported; each now runs,
# held against JAX (the DP draws injected: jax_draws)
FORMERLY_DEFERRED = {
    'interleaved order': dict(update_order='interleaved',
                              reset_topic_method=None),
    'resets': dict(update_order='phase', W_in=_dead_column(60, 4, 1)),
    'plain sweep': dict(use_pallas=False, **FAST_TM),
    'store_gradients': dict(store_gradients=True,
                            ind_rows_to_store=[0, 3, 5]),
    'dp noise': dict(eps_gauss_t=1e5, delta_gauss_t=1e-3),
    'grouped dispatch': dict(sweeps_per_dispatch=4,
                             compute_obj_each_iter=False),
}


@pytest.mark.parametrize('case', sorted(FORMERLY_DEFERRED))
def test_formerly_deferred_options_match_jax(case, monkeypatch):
    monkeypatch.setattr(tnmf, 'make_draws', jax_draws)
    X = _lowrank(60, 45, 4, seed=1)
    kw = dict(max_iter=6, compute_obj_each_iter=True, random_state=0)
    kw.update(FORMERLY_DEFERRED[case])
    if 'W_in' in kw:
        kw['T_in'] = np.random.RandomState(12).rand(4, 45)
    a, b = _same_fit(X, 4, **kw)
    if case == 'resets':
        assert a['n_resets_remaining'] < 23
    if case == 'grouped dispatch':
        # one clock stamp per sweep, the same for each sweep of a group
        for r in (a, b):
            t = r['iter_cputime']
            assert len(t) == 6 and t[0] == t[3] and t[4] == t[5] != t[3]
    if case == 'store_gradients':
        assert sorted(b['numer_W']) == sorted(a['numer_W']) == list(range(6))
        for key in ('numer_W', 'denom_W'):
            for it in a[key]:
                assert _close(b[key][it], np.asarray(a[key][it]))


# configs the kernels cover by design: where the kernels' gate refuses
# the problem, the fit raises and never falls back to the plain sweep
GATED = {
    'phase': dict(FAST_TM),
    'phase with resets': dict(update_order='phase'),
    'fixed T': dict(fix_T=True, T_in=np.ones((2, 15))),
    'sparse': dict(sparse=True),
    'plain sweep': dict(FAST_TM, use_pallas=False),
    'interleaved': dict(),
}


@pytest.mark.parametrize('case', sorted(GATED))
def test_refused_kernel_gate_raises(case, monkeypatch):
    monkeypatch.setattr(tnmf, 'supports_dense_kernels', lambda *a: False)

    def fit():
        return torch_nmf(_lowrank(20, 15, 2), 2, max_iter=2, random_state=0,
                         device='cpu', **GATED[case])
    if case in ('plain sweep', 'interleaved'):
        # no kernel covers these: the plain sweep runs
        assert fit()['W'].shape == (20, 2)
    else:
        with pytest.raises(ValueError, match='do not fit'):
            fit()


@pytest.mark.cuda
def test_refused_kernel_gate_raises_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    dev = torch.device('cuda')
    assert not dk.gs_fits(4096, torch.float64, dev)
    X = torch.as_tensor(_lowrank(64, 48, 2), device=dev)
    for kw in (FAST_TM, dict(update_order='phase')):
        with pytest.raises(ValueError, match='do not fit'):
            torch_nmf(X, 4096, max_iter=1, **kw)
    r = torch_nmf(X, 4096, max_iter=1, use_pallas=False, **FAST_TM)
    assert torch.isfinite(r['T']).all()


DEFERRED = {
    # a sparse W_mat runs (tests/test_torch_masked_sparse.py and
    # test_torch_masked_gram.py hold it against JAX), and on a mesh since
    # A.12e (test_torch_masked_sparse_mesh.py, test_torch_masked_gram_mesh
    # .py): a mesh that is not a Mesh meets the TypeError
    'W_mat': dict(W_mat=scipy.sparse.csr_matrix(np.ones((20, 15))),
                  mesh=object(), **FAST_TM),
    # w_row, checkpoint and accel run since ROADMAP A.4 and A.9: their
    # cases hold the fit against JAX's (PORTED_SINCE below)
    'w_row': dict(w_row=np.linspace(0.5, 2.0, 20), **FAST_TM),
    # sparse fits run on one device and, since A.12d, on a mesh
    # (tests/test_torch_sparse_mesh.py): a mesh that is not a Mesh meets
    # the TypeError (the dense-X sparse=True fit is held against JAX in
    # test_torch_sparse_tm.py)
    'sparse mode': dict(sparse=True, mesh=object(), **FAST_TM),
    'x_dtype': dict(x_dtype='bfloat16', **FAST_TM),
    'bfloat16 factors': dict(dtype=torch.bfloat16, **FAST_TM),
    # a dense fit runs on a mesh since A.12a-b (tests/test_torch_mesh.py,
    # test_torch_sharded_dense.py hold it against JAX), and its masked
    # form since A.12c (test_torch_sharded_masked.py): a mesh that is not
    # a Mesh meets the TypeError
    'mesh': dict(W_mat=np.ones((20, 15)), mesh=object(), **FAST_TM),
    'checkpoint': dict(checkpoint='ckpt', **FAST_TM),
    'accel': dict(accel='her', **FAST_TM),
    'nndsvd_lrc': dict(init='nndsvd_lrc', **FAST_TM),
}


PORTED_SINCE = {'w_row': 'A.4', 'checkpoint': 'A.9', 'accel': 'A.9',
                'x_dtype': 'A.8', 'bfloat16 factors': 'A.8',
                'nndsvd_lrc': 'A.3'}


@pytest.mark.parametrize('case', sorted(DEFERRED))
def test_options_outside_the_slice_raise(case, tmp_path):
    """Each option that was outside the port (and raised naming its
    ROADMAP item) runs: one ported since runs and equals the JAX fit, and
    a mesh option ported since meets the TypeError of its non-Mesh
    ``mesh=object()``."""
    if case in PORTED_SINCE:
        X = _lowrank(20, 15, 2)
        kw = dict(DEFERRED[case], max_iter=4, random_state=0,
                  compute_obj_each_iter=True)
        if case == 'checkpoint':
            # each package writes its own directory; the second call
            # resumes from the first's step 2
            for tag, fit in (('jax', jax_nmf), ('torch', torch_nmf)):
                run = dict(kw, checkpoint=str(tmp_path / tag),
                           checkpoint_every=2)
                extra = {} if tag == 'jax' else dict(device='cpu')
                fit(X, 2, **dict(run, max_iter=2), **extra)
            a = jax_nmf(X, 2, **dict(kw, checkpoint=str(tmp_path / 'jax')))
            b = torch_nmf(X, 2, device='cpu',
                          **dict(kw, checkpoint=str(tmp_path / 'torch')))
            assert _close(b['W'], a['W']) and _close(b['T'], a['T'])
            assert np.allclose(b['obj_history'], a['obj_history'], rtol=TOL)
        elif PORTED_SINCE[case] == 'A.8':
            # the port's dense sweep is the kernel sweep, which casts the
            # factor down to a bfloat16 X (and stores 16-bit factors in 16
            # bits): JAX's kernel sweep, in interpret mode on the CPU. The
            # 16-bit factors round alike but sum in other orders: the JAX
            # suite's kernel-vs-plain bound 0.02 holds them
            a = jax_nmf(X, 2, use_pallas='interpret', **dict(
                kw, dtype='bfloat16') if 'dtype' in kw else kw)
            b = torch_nmf(X, 2, device='cpu', **kw)
            tol = 0.02 if 'dtype' in kw else TOL
            assert b['W'].dtype == (torch.bfloat16 if 'dtype' in kw
                                    else torch.float64)
            assert _close(b['W'].double(), np.asarray(a['W'], float), tol)
            assert _close(b['T'].double(), np.asarray(a['T'], float), tol)
            assert np.allclose(b['obj_history'], a['obj_history'],
                               rtol=tol)
        else:
            _same_fit(X, 2, **kw)
        return
    with pytest.raises(TypeError, match='must be a rri_nmf_tpu_torch'
                                        '.parallel.Mesh'):
        torch_nmf(_lowrank(20, 15, 2), 2, max_iter=1, device='cpu',
                  **DEFERRED[case])


def test_scipy_sparse_X_raises_and_bad_args_are_value_errors():
    """A scipy-sparse X fits (the sparse slice; tests/
    test_torch_sparse_tm.py holds it against JAX), with the result of its
    dense form; bad arguments are ValueErrors."""
    X = _lowrank(20, 15, 2)
    a = torch_nmf(scipy.sparse.csr_matrix(X), 2, max_iter=3, random_state=0,
                  device='cpu', **FAST_TM)
    b = torch_nmf(X, 2, max_iter=3, random_state=0, device='cpu', **FAST_TM)
    assert _close(a['W'], b['W'], 1e-11) and _close(a['T'], b['T'], 1e-11)
    for kw in (dict(k=0), dict(k=2.5), dict(k=2, update_order='bogus'),
               dict(k=2, sparse='bogus'), dict(k=2, inner_reps=0, **FAST_TM),
               dict(k=2, W_in=np.ones((3, 3)), T_in=np.ones((2, 15)),
                    **FAST_TM)):
        with pytest.raises(ValueError):
            torch_nmf(X, device='cpu', **kw)


# ---------------------------------------------------------------------------
# the topic-model estimator
# ---------------------------------------------------------------------------

def _tm_params(**kw):
    return dict(random_state=0, max_iter=10,
                nmf_kwargs=dict(FAST_TM, compute_obj_each_iter=True), **kw)


def test_tm_estimator_matches_jax(text_train, text_test):
    X, Xte = text_train, text_test
    n, d = X.shape
    J = JaxTM(n, d, 5, **_tm_params()).fit(X)
    P = tsk.NMF_TM_Estimator(n, d, 5, device='cpu', **_tm_params()).fit(X)
    assert _close(P.W, J.W) and _close(P.T, J.T)
    assert np.allclose(P.nmf_outputs['obj_history'],
                       J.nmf_outputs['obj_history'], rtol=TOL)
    assert _close(P.transform(Xte), J.transform(Xte))
    assert P.score(Xte) == pytest.approx(J.score(Xte), rel=TOL)
    sj, sp_ = J.score_all(Xte), P.score_all(Xte)
    for key in ('r2', 'rel_frobenius_error'):
        assert sp_[key] == pytest.approx(sj[key], rel=TOL)
    assert np.allclose(P.T.numpy().sum(1), 1.0, atol=1e-12)


@pytest.mark.parametrize('corpus', ['dense', 'sparse'])
def test_tm_estimator_sparsify_densify_match_jax(text_train, text_test,
                                                 corpus):
    """``sparsify`` turns the fitted W and T into scipy CSR on the host, as
    JAX's does; transform and score still run (T densified on the device
    it came from) and equal JAX's at 1e-8 on a dense and on a sparse
    corpus; ``densify`` brings the same tensors back. JAX's own score
    reads its sparse T with numpy and raises, so its scores are taken
    after its densify (the same factors)."""
    X, Xte = text_train, text_test
    if corpus == 'sparse':
        X, Xte = scipy.sparse.csr_matrix(X), scipy.sparse.csr_matrix(Xte)
    n, d = X.shape
    J = JaxTM(n, d, 5, **_tm_params()).fit(X)
    P = tsk.NMF_TM_Estimator(n, d, 5, device='cpu', **_tm_params()).fit(X)
    W_fit, T_fit = P.W.clone(), P.T.clone()
    J.sparsify()
    P.sparsify()
    assert scipy.sparse.isspmatrix_csr(P.W) and scipy.sparse.isspmatrix_csr(
        P.T)
    assert _close(P.T.toarray(), J.T.toarray())
    got = P.transform(Xte)
    assert isinstance(got, torch.Tensor) and got.device.type == 'cpu'
    assert _close(got, J.transform(Xte))
    score = P.score(Xte)
    J.densify()
    assert score == pytest.approx(J.score(Xte), rel=TOL)
    P.densify()
    assert torch.equal(P.W, W_fit) and torch.equal(P.T, T_fit)
    assert _close(P.transform(Xte), J.transform(Xte))
    assert P.score(Xte) == pytest.approx(J.score(Xte), rel=TOL)


def test_tm_estimator_preprocessing_matches_jax():
    raw = scipy.sparse.load_npz(REPO / 'tests' / 'data' /
                                'text_data_train.npz').toarray()
    n, d = raw.shape
    kw = _tm_params(handle_tfidf=True, handle_normalization=True)
    J = JaxTM(n, d, 4, **kw).fit(raw)
    P = tsk.NMF_TM_Estimator(n, d, 4, device='cpu', **kw).fit(raw)
    assert np.allclose(P.idf.numpy(), np.asarray(J.idf), rtol=1e-14)
    assert _close(P.W, J.W) and _close(P.T, J.T)
    assert _close(P.transform(raw[:30]), J.transform(raw[:30]))


def test_tm_estimator_from_jax_state(text_train, text_test):
    """Carry a fitted JAX estimator into the port: same transform and
    score (convert.py)."""
    n, d = text_train.shape
    J = JaxTM(n, d, 5, **_tm_params()).fit(text_train)
    params = {key: v for key, v in J.get_params().items()
              if key not in ('W', 'T')}
    P = tsk.NMF_TM_Estimator.from_numpy_state(
        {'W': J.W, 'T': J.T}, device='cpu', **params)
    assert isinstance(P.T, torch.Tensor) and P.k == 5
    assert _close(P.transform(text_test), J.transform(text_test))
    assert P.score(text_test) == pytest.approx(J.score(text_test), rel=TOL)
    W, T = factors_from_numpy(J.W, J.T, device='cpu', dtype=torch.float32)
    assert W.dtype == torch.float32 and T.device.type == 'cpu'


def test_tm_estimator_from_jax_state_with_idf():
    raw = scipy.sparse.load_npz(REPO / 'tests' / 'data' /
                                'text_data_train.npz').toarray()
    n, d = raw.shape
    kw = _tm_params(handle_tfidf=True, handle_normalization=True)
    J = JaxTM(n, d, 4, **kw).fit(raw)
    P = tsk.NMF_TM_Estimator.from_numpy_state(
        {'W': J.W, 'T': J.T, 'idf': J.idf}, device='cpu', **kw)
    assert _close(P.transform(raw[:25]), J.transform(raw[:25]))


def test_tm_one_iter_steps_equal_batch_fit(text_train):
    """Stepped fits compose exactly with batch fits (the pattern of
    tests/test_nmf.py::test_convergence_TM_Estimator)."""
    X = text_train
    n, d = X.shape
    M = tsk.NMF_TM_Estimator(n, d, 5, random_state=0, max_iter=10,
                             nmf_kwargs=FAST_TM, device='cpu').fit(X)
    M2 = tsk.NMF_TM_Estimator(n, d, 5, random_state=0, max_iter=2,
                              do_final_project_W=False,
                              nmf_kwargs=FAST_TM, device='cpu').fit(X)
    for _ in range(8):
        M2 = M2.one_iter(X)
    from rri_nmf_tpu_torch.matrixops import proj_mat_to_simplex
    M2.W = proj_mat_to_simplex(M2.W)
    assert torch.allclose(M2.T, M.T) and torch.allclose(M2.W, M.W)


def test_tm_estimator_params_and_errors(text_train):
    n, d = text_train.shape
    P = tsk.NMF_TM_Estimator(n, d, 3, nmf_kwargs=FAST_TM, device='cpu')
    params = P.get_params()
    # the JAX constructor arguments, and the port's device
    assert set(params) == set(JaxTM(n, d, 3).get_params()) | {'device'}
    assert P.set_params(max_iter=2, tr2=0.5) is P and P.tr2 == 0.5
    with pytest.raises(ValueError):
        P.set_params(bogus=1)
    with pytest.raises(ValueError, match='non-negative'):
        P.fit(-text_train)
    W = P.fit_transform(text_train)
    assert W.shape == (n, 3) and np.allclose(W.sum(1).numpy(), 1.0)
    # the default preset (interleaved order with resets) runs, as in JAX
    P = tsk.NMF_TM_Estimator(n, d, 3, max_iter=1,
                             device='cpu').fit(text_train)
    J = JaxTM(n, d, 3, max_iter=1).fit(text_train)
    assert _close(P.W, J.W) and _close(P.T, J.T)


def test_tm_estimator_default_preset_matches_jax(text_train, text_test):
    """The TM estimator with its default preset (the interleaved order,
    resets, ``nmf_kwargs={}``): fit, fit_transform, transform, score and
    score_all against JAX at 1e-8; the transform (fixed T, phase order)
    runs B1's twin, and its Gram-blocked re-run when a topic is dead."""
    X, Xte = text_train, text_test
    n, d = X.shape
    kw = dict(random_state=0, max_iter=10,
              nmf_kwargs=dict(compute_obj_each_iter=True))
    J = JaxTM(n, d, 5, **kw).fit(X)
    P = tsk.NMF_TM_Estimator(n, d, 5, device='cpu', **kw)
    W = P.fit_transform(X)
    assert W is P.W and _close(P.W, J.W) and _close(P.T, J.T)
    assert np.allclose(P.nmf_outputs['obj_history'],
                       J.nmf_outputs['obj_history'], rtol=TOL)
    assert (P.nmf_outputs['n_resets_remaining']
            == J.nmf_outputs['n_resets_remaining'])
    assert np.allclose(P.T.numpy().sum(1), 1.0, atol=1e-12)
    assert _close(P.transform(Xte), J.transform(Xte))
    assert P.score(Xte) == pytest.approx(J.score(Xte), rel=TOL)
    sj, sp_ = J.score_all(Xte), P.score_all(Xte)
    for key in ('r2', 'rel_frobenius_error'):
        assert sp_[key] == pytest.approx(sj[key], rel=TOL)
    # a dead topic: the transform's W column dies, and a reset fires
    T = J.T.copy()
    T[2] = 0.0
    J.T = T
    P.T = torch.as_tensor(T)
    assert _close(P.transform(Xte), J.transform(Xte))


def test_tm_one_iter_steps_equal_batch_fit_default_preset(text_train):
    """Stepped fits compose exactly with batch fits with the default
    preset too (no reset fires on this fixture)."""
    X = text_train
    n, d = X.shape
    M = tsk.NMF_TM_Estimator(n, d, 5, random_state=0, max_iter=6,
                             device='cpu').fit(X)
    M2 = tsk.NMF_TM_Estimator(n, d, 5, random_state=0, max_iter=2,
                              do_final_project_W=False, device='cpu').fit(X)
    for _ in range(4):
        M2 = M2.one_iter(X)
    from rri_nmf_tpu_torch.matrixops import proj_mat_to_simplex
    M2.W = proj_mat_to_simplex(M2.W)
    assert M.nmf_outputs['n_resets_remaining'] == 23
    assert torch.allclose(M2.T, M.T) and torch.allclose(M2.W, M.W)


def test_metrics_match_jax(text_train):
    from rri_nmf_tpu import metrics as jmet
    from rri_nmf_tpu_torch import metrics as tmet
    rng = np.random.RandomState(9)
    X = text_train
    W, T = rng.rand(X.shape[0], 4), rng.rand(4, X.shape[1])
    for name in ('frobenius_relative_error', 'r2_reconstruction'):
        assert getattr(tmet, name)(X, W, T) == pytest.approx(
            getattr(jmet, name)(X, W, T), rel=1e-12)
    R = (rng.rand(30, 20) < 0.3) * rng.randint(1, 6, size=(30, 20))
    Wr, Tr = rng.rand(30, 3), rng.rand(3, 20)
    assert tmet.rmse_observed(R, Wr, Tr, 1, 5) == pytest.approx(
        jmet.rmse_observed(R, Wr, Tr, 1, 5), rel=1e-12)
    counts = (rng.rand(40, 25) < 0.2).astype(float)
    Tc = rng.rand(5, 25)
    assert tmet.umass_coherence(counts, Tc, top_n=6) == pytest.approx(
        jmet.umass_coherence(counts, Tc, top_n=6), rel=1e-12)


def test_import_pulls_in_neither_jax_nor_sklearn():
    # the package and its mesh modules, in a fresh interpreter
    code = ('import sys, rri_nmf_tpu_torch, rri_nmf_tpu_torch.parallel, '
            'rri_nmf_tpu_torch.parallel.mesh, '
            'rri_nmf_tpu_torch.parallel.sharded_dense; '
            'bad = [m for m in ("jax", "sklearn", "rri_nmf_tpu", "triton") '
            'if m in sys.modules]; '
            'assert not bad, bad')
    subprocess.run([sys.executable, '-c', code], cwd=REPO, check=True,
                   timeout=120)
