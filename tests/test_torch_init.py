"""Parity of the port's initialization with the JAX package.

- The NNDSVD goldens of the reference (``small_X_W_T``), bit for bit
  through the sklearn backend.
- ``_nndsvd_from_svd`` on the same (U, S, Vt): the numpy path bit for
  bit, the tensor path at 1e-14.
- ``svd_backend='torch'`` against ``randomized_svd_jax`` given the same
  Gaussian test matrix Ω (drawn here with ``jax.random.normal``): S and
  the NNDSVD factors at 1e-8 (two LAPACK eigensolvers agree to rounding
  on a well-separated spectrum).
- The numpy random streams (``random``, ``smart_random``, ``nndsvdar``)
  bit for bit.
- The scikit-learn-free copy of scikit-learn's randomized SVD bit for
  bit against ``sklearn.utils.extmath.randomized_svd``, and its float64
  form for the card (run here on the CPU) within 1e-10 in S and in
  U·diag(S)·Vt.
- NNSVD-LRC: the host form at 1e-12, the device form (kernel B1's twin
  in the correction) at 1e-9 with JAX's test matrix injected;
  ``coherence_pmi`` at 1e-12; and the JAX suite's single-device cases of
  ``tests/test_initialization.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

from rri_nmf_tpu import initialization as ji
from rri_nmf_tpu_torch import initialization as ti

torch.set_num_threads(2)


def _init(*args, **kw):
    """The port's ``initialize_nmf`` on the CPU."""
    return ti.initialize_nmf(*args, device='cpu', **kw)


def _lowrank(n, d, k, seed):
    rng = np.random.RandomState(seed)
    return np.abs(rng.rand(n, k) @ rng.rand(k, d) + 0.05 * rng.rand(n, d))


def test_nndsvd_goldens_exact(small_X_W_T):
    X, Wt, Tt = small_X_W_T
    W, T = _init(X, 2, init='nndsvd', random_state=0)
    Wj, Tj = ji.initialize_nmf(X, 2, init='nndsvd', random_state=0)
    assert np.array_equal(W.numpy(), np.asarray(Wj))
    assert np.array_equal(T.numpy(), np.asarray(Tj))
    assert np.allclose(W.numpy(), Wt) and np.allclose(T.numpy(), Tt)


@pytest.mark.parametrize('seed', [0, 1])
def test_nndsvd_from_svd_matches_jax(seed):
    X = _lowrank(40, 30, 6, seed)
    U, S, Vt = np.linalg.svd(X, full_matrices=False)
    U, S, Vt = U[:, :6], S[:6], Vt[:6]
    Wj, Hj = ji._nndsvd_from_svd(U, S, Vt, 1e-6)
    Wn, Hn = ti._nndsvd_from_svd(U, S, Vt, 1e-6)
    assert np.array_equal(Wn, Wj) and np.array_equal(Hn, Hj)
    Wt, Ht = ti._nndsvd_from_svd(*(torch.as_tensor(a) for a in (U, S, Vt)),
                                 1e-6)
    assert np.allclose(Wt.numpy(), Wj, rtol=0, atol=1e-14)
    assert np.allclose(Ht.numpy(), Hj, rtol=0, atol=1e-14)


@pytest.mark.parametrize('shape', [(80, 50, 5), (60, 120, 8)])
def test_torch_svd_backend_matches_jax_given_omega(shape):
    n, d, k = shape
    X = _lowrank(n, d, k, seed=n)
    p = min(k + 10, min(n, d))
    omega = jax.random.normal(jax.random.PRNGKey(3), (d, p),
                              dtype=jnp.float64)
    Uj, Sj, Vj = jax.jit(ji.randomized_svd_jax, static_argnums=1)(
        jnp.asarray(X), k, jax.random.PRNGKey(3))
    Ut, St, Vt = ti.randomized_svd_torch(
        torch.as_tensor(X), k, omega=torch.as_tensor(np.array(omega)))
    assert np.allclose(St.numpy(), np.asarray(Sj), rtol=1e-8, atol=0)
    Wj, Hj = ji._nndsvd_from_svd(np.asarray(Uj), np.asarray(Sj),
                                 np.asarray(Vj), 1e-6)
    Wt, Ht = ti._nndsvd_from_svd(Ut, St, Vt, 1e-6)
    assert np.allclose(Wt.numpy(), Wj, rtol=0, atol=1e-8)
    assert np.allclose(Ht.numpy(), Hj, rtol=0, atol=1e-8)
    # and the torch backend as a whole reconstructs like the exact SVD
    W, H = _init(X, k, 'nndsvd', random_state=0,
                             svd_backend='torch')
    We, He = ji.initialize_nmf(X, k, 'nndsvd', random_state=0)
    err = np.linalg.norm(X - W.numpy() @ H.numpy())
    err_e = np.linalg.norm(X - We @ He)
    assert abs(err - err_e) <= 1e-6 * np.linalg.norm(X)


def test_ortho_eigh_is_orthonormal_on_rank_deficient_input():
    rng = np.random.RandomState(4)
    Y = torch.as_tensor(rng.rand(200, 3) @ rng.rand(3, 12))
    Q = ti._ortho_eigh(Y)
    assert torch.isfinite(Q).all()
    Yj = np.asarray(ji._ortho_eigh(jnp.asarray(Y.numpy())))
    # the range of the rank-3 part is what must agree
    P, Pj = Q[:, -3:] @ Q[:, -3:].T, Yj[:, -3:] @ Yj[:, -3:].T
    assert np.allclose(P.numpy(), Pj, atol=1e-8)


@pytest.mark.parametrize('init', ['random', 'smart_random', 'nndsvd',
                                  'nndsvda', 'nndsvdar'])
def test_initialize_nmf_matches_jax(init):
    X = _lowrank(30, 20, 4, seed=5)
    W, H = _init(X, 4, init, random_state=7)
    Wj, Hj = ji.initialize_nmf(X, 4, init, random_state=7)
    assert np.array_equal(W.numpy(), np.asarray(Wj))
    assert np.array_equal(H.numpy(), np.asarray(Hj))


def test_initialize_nmf_row_normalize_and_default_rule():
    X = _lowrank(30, 20, 4, seed=6)
    W, H = _init(X, 4, random_state=0, row_normalize=True)
    Wj, Hj = ji.initialize_nmf(X, 4, random_state=0, row_normalize=True)
    assert np.allclose(H.numpy(), np.asarray(Hj), rtol=0, atol=1e-15)
    assert np.allclose(H.numpy().sum(1), 1.0)
    # k >= d: the default rule picks the random init, like the JAX one
    W, H = _init(X[:, :3], 4, random_state=1)
    Wj, Hj = ji.initialize_nmf(X[:, :3], 4, random_state=1)
    assert np.array_equal(W.numpy(), Wj) and np.array_equal(H.numpy(), Hj)


def test_initialize_nmf_tensor_input_keeps_device_and_dtype():
    X = torch.as_tensor(_lowrank(30, 20, 4, seed=8), dtype=torch.float32)
    W, H = ti.initialize_nmf(X, 4, 'nndsvd', random_state=0,
                             svd_backend='torch')
    assert W.dtype == H.dtype == torch.float32
    assert W.device == H.device == X.device
    assert (W >= 0).all() and (H >= 0).all()


def test_initialize_nmf_errors():
    X = _lowrank(10, 8, 2, seed=9)
    with pytest.raises(ValueError):
        _init(X, 9, 'nndsvd')
    with pytest.raises(ValueError):
        _init(X, 2, 'bogus')
    with pytest.raises(ValueError):
        _init(X, 2, 'nndsvd', svd_backend='jax')
    # NNSVD-LRC and the PMI beam search run (ROADMAP A.3): JAX's factors
    for init in ('nndsvd_lrc', 'coherence_pmi'):
        W, H = _init(X, 2, init, random_state=0)
        Wj, Hj = ji.initialize_nmf(X, 2, init, random_state=0)
        assert np.allclose(W.numpy(), Wj, rtol=0, atol=1e-12)
        assert np.allclose(H.numpy(), Hj, rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# scikit-learn's randomized SVD: the host copy and the float64 card form
# ---------------------------------------------------------------------------

def _svd_inputs():
    rng = np.random.RandomState(11)
    tall = _lowrank(120, 70, 6, seed=12)
    return {
        'tall, n_iter 7': (tall, 5),
        'tall, n_iter 4': (tall, 9),
        'wide (transposed)': (_lowrank(50, 140, 5, seed=13), 6),
        'float32': (tall.astype(np.float32), 5),
        'scipy sparse': (scipy.sparse.random(150, 90, density=0.1,
                                             random_state=rng,
                                             format='csr'), 7),
        'U[0,1] factors': (rng.rand(200, 12) @ rng.rand(12, 160), 8),
    }


@pytest.mark.parametrize('case', sorted(_svd_inputs()))
def test_randomized_svd_copy_is_sklearn_bit_for_bit(case):
    from sklearn.utils.extmath import randomized_svd
    X, k = _svd_inputs()[case]
    for rs in (0, 7):
        got = ti.randomized_svd_np(X, k, random_state=rs)
        want = randomized_svd(X, k, random_state=rs)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    # a RandomState passes through and advances as scikit-learn's does
    r1, r2 = np.random.RandomState(3), np.random.RandomState(3)
    ti.randomized_svd_np(X, k, random_state=r1)
    randomized_svd(X, k, random_state=r2)
    assert r1.randint(2 ** 31) == r2.randint(2 ** 31)


@pytest.mark.parametrize('case', sorted(_svd_inputs()))
def test_float64_svd_for_the_card_matches_the_host_copy(monkeypatch, case):
    """randomized_svd_f64 (torch.linalg in float64, X upcast a block of
    rows at a time; a torch sparse X through torch.sparse.mm) on the same
    test matrix as the host copy: S and U·diag(S)·Vt within 1e-10."""
    from rri_nmf_tpu_torch.ops import quantized as tq
    X, k = _svd_inputs()[case]
    if scipy.sparse.issparse(X):
        Xt = torch.sparse_csr_tensor(X.indptr, X.indices, X.data, X.shape)
    else:
        Xt = torch.as_tensor(X)
        # a tiny buffer: ragged blocks in every product
        monkeypatch.setattr(tq, 'UPCAST_BYTES', 8 * 500)
    U, S, Vt = ti.randomized_svd_np(X, k, random_state=0)
    U, S, Vt = (a.astype(np.float64) for a in (U, S, Vt))
    Ug, Sg, Vg = ti.randomized_svd_f64(Xt, k, random_state=0)
    assert Ug.dtype == Sg.dtype == Vg.dtype == torch.float64
    assert Ug.shape == U.shape and Vg.shape == Vt.shape
    tol = 1e-10 if X.dtype == np.float64 else 1e-5   # float32: the copy's
    np.testing.assert_allclose(Sg.numpy(), S, rtol=tol)
    R, Rg = (U * S) @ Vt, (Ug * Sg) @ Vg
    assert np.abs(Rg.numpy() - R).max() <= tol * np.abs(R).max()
    # the sklearn backend on a torch tensor takes the host SVD; the
    # factors of one init agree with the dense numpy input's
    if not scipy.sparse.issparse(X):
        W, H = ti.initialize_nmf(Xt, k, 'nndsvd', random_state=0,
                                 device='cpu')
        Wn, Hn = ti.initialize_nmf(X, k, 'nndsvd', random_state=0,
                                   device='cpu')
        assert torch.equal(W, Wn) and torch.equal(H, Hn)


def test_lu_pl_is_scipy_s_permuted_l():
    from scipy import linalg
    A = np.random.RandomState(5).randn(40, 7)
    want = linalg.lu(A, permute_l=True)[0]
    got = ti._lu_pl(torch.as_tensor(A)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)


# ---------------------------------------------------------------------------
# NNSVD-LRC and the PMI beam search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('shape', [(300, 200, 10, 10), (90, 150, 5, 7)])
def test_nndsvd_lrc_card_form_matches_the_host_form(monkeypatch, shape):
    """For a CUDA X the sklearn backend's NNSVD-LRC keeps the float64
    card SVD on the card and corrects there through kernel B1 (four
    launches: two a pass). Here the card SVD runs on a CPU tensor and B1
    as its twin: within 1e-9 of the numpy host form, B1 called four
    times."""
    from rri_nmf_tpu_torch.ops import dense_kernels as dk
    n, d, ktrue, k = shape
    rng = np.random.RandomState(n)
    X = np.abs(rng.rand(n, ktrue) @ rng.rand(ktrue, d)) + 0.01 * rng.rand(n, d)
    Wh, Hh = ti._nndsvd_lrc_host(X, k, 0, 1e-6)
    assert isinstance(Wh, np.ndarray)
    calls = []
    real = dk.gs_update

    def counted(*args, **kwargs):
        calls.append(args[2].dtype)
        return real(*args, **kwargs)
    monkeypatch.setattr(dk, 'gs_update', counted)
    monkeypatch.setattr(ti, '_randomized_svd_sklearn',
                        lambda X, p, rs, device=None: ti.randomized_svd_f64(
                            torch.as_tensor(X), p, random_state=rs))
    W, H = ti._nndsvd_lrc_host(X, k, 0, 1e-6)
    assert calls == [torch.float64] * 4
    assert W.dtype == H.dtype == torch.float64
    np.testing.assert_allclose(W.numpy(), Wh, rtol=0, atol=1e-9)
    np.testing.assert_allclose(H.numpy(), Hh, rtol=0, atol=1e-9)

@pytest.mark.parametrize('shape', [(300, 200, 10, 10), (400, 300, 8, 16),
                                   (90, 150, 5, 7)])
def test_nndsvd_lrc_host_form_matches_jax(shape):
    n, d, ktrue, k = shape
    rng = np.random.RandomState(n)
    X = np.abs(rng.rand(n, ktrue) @ rng.rand(ktrue, d)) + 0.01 * rng.rand(n, d)
    for rs in (0, 4):
        W, H = _init(X, k, 'nndsvd_lrc', random_state=rs, row_normalize=rs)
        Wj, Hj = ji.initialize_nmf(X, k, 'nndsvd_lrc', random_state=rs,
                                   row_normalize=rs)
        np.testing.assert_allclose(W.numpy(), Wj, rtol=0, atol=1e-12)
        np.testing.assert_allclose(H.numpy(), Hj, rtol=0, atol=1e-12)


@pytest.mark.parametrize('shape', [(250, 180, 12), (120, 200, 9)])
def test_nndsvd_lrc_device_form_matches_jax_given_omega(shape):
    """The device form (the float32-or-X's-dtype range finder, the split,
    the correction's topic loops through B1's twin) against JAX's jitted
    one, whose test matrix is drawn here from JAX's key."""
    n, d, k = shape
    rng = np.random.RandomState(1)
    X = np.abs(rng.rand(n, 12) @ rng.rand(12, d)) + 0.02 * rng.rand(n, d)
    p = ti._lrc_rank(k, n, d)[0]
    key = jax.random.PRNGKey(0)
    omega = jax.random.normal(key, (d, min(p + 10, min(n, d))),
                              dtype=jnp.float64)
    Wj, Hj = ji._nndsvd_lrc_device_jit(k, p, 1e-6, 2)(jnp.asarray(X), key)
    W, H = ti._nndsvd_lrc_device(torch.as_tensor(X), k, 1e-6,
                                 omega=torch.as_tensor(np.array(omega)))
    np.testing.assert_allclose(W.numpy(), np.asarray(Wj), rtol=0, atol=1e-9)
    np.testing.assert_allclose(H.numpy(), np.asarray(Hj), rtol=0, atol=1e-9)
    # through the dispatch: the torch backend lands at the host form's
    # corrected error (the JAX suite's bound)
    Wt, Ht = _init(X, k, 'nndsvd_lrc', random_state=0, svd_backend='torch')
    Wh, Hh = _init(X, k, 'nndsvd_lrc', random_state=0)
    xn = np.linalg.norm(X)
    et = np.linalg.norm(X - (Wt @ Ht).numpy()) / xn
    eh = np.linalg.norm(X - (Wh @ Hh).numpy()) / xn
    assert abs(eh - et) < 0.05 * eh + 1e-3


@pytest.mark.parametrize('source', ['numpy', 'scipy', 'torch sparse'])
def test_coherence_pmi_matches_jax(text_train, source):
    X = text_train
    Wj, Tj = ji.initialize_nmf(X, 4, 'coherence_pmi', n_words_beam=6)
    Xs = {'numpy': X, 'scipy': scipy.sparse.csr_matrix(X),
          'torch sparse': torch.as_tensor(X).to_sparse()}[source]
    W, T = _init(Xs, 4, 'coherence_pmi', n_words_beam=6)
    assert W.dtype == T.dtype == torch.float64
    np.testing.assert_allclose(T.numpy(), Tj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(W.numpy(), Wj, rtol=0, atol=1e-12)
    assert np.array_equal(T.numpy() > 0, np.asarray(Tj) > 0)


# ---------------------------------------------------------------------------
# the JAX suite's single-device cases (tests/test_initialization.py)
# ---------------------------------------------------------------------------

def _data(n=30, d=20, k=4, seed=0):
    rng = np.random.RandomState(seed)
    return np.abs(rng.rand(n, k) @ rng.rand(k, d))


def test_jax_suite_dispatch_and_fills():
    X = _data()
    W, T = _init(np.ones((5, 7)), 3, init='random', random_state=42)
    rng = np.random.RandomState(42)
    assert np.allclose(T.numpy(), rng.rand(3, 7))
    assert np.allclose(W.numpy(), rng.rand(5, 3))
    W, T = _init(X, 4, init='smart_random', random_state=0)
    avg = np.sqrt(X.mean() / 4)
    assert (W >= 0).all() and (T >= 0).all()
    assert 0.3 * avg < float(W.mean()) < 2.0 * avg
    W1, T1 = _init(X, 4, init=None, random_state=0)
    W2, T2 = _init(X, 4, init='nndsvd', random_state=0)
    assert torch.equal(W1, W2) and torch.equal(T1, T2)
    for variant in ('nndsvda', 'nndsvdar'):
        W, T = _init(X, 4, init=variant, random_state=0)
        assert (W > 0).all() and (T > 0).all()
        nz = W2 > 0
        assert torch.allclose(W[nz], W2[nz])
    _, T = _init(X, 4, init='nndsvd', random_state=0, row_normalize=True)
    assert np.allclose(T.numpy().sum(1), 1.0, atol=1e-12)
    with pytest.raises(ValueError, match='n_components'):
        _init(np.abs(np.random.RandomState(0).rand(12, 8)), 9, 'nndsvd')
    W, H = _init(np.abs(np.random.RandomState(0).rand(12, 8)), 9, 'random',
                 random_state=0)
    assert W.shape == (12, 9) and H.shape == (9, 8)


def test_jax_suite_device_backend_accuracy():
    X = _data(n=40, d=25, k=5)
    W1, T1 = _init(X, 5, init='nndsvd', random_state=0)
    W2, T2 = _init(X, 5, init='nndsvd', random_state=0, svd_backend='torch')
    r1 = np.linalg.norm(X - (W1 @ T1).numpy())
    r2 = np.linalg.norm(X - (W2 @ T2).numpy())
    assert r2 < r1 * 1.05 + 1e-8
    X = _data(n=50, d=30, k=6)
    U, S, Vt = ti.randomized_svd_torch(torch.as_tensor(X), 6,
                                       generator=torch.Generator()
                                       .manual_seed(0))
    Us, Ss, Vts = np.linalg.svd(X)
    assert np.allclose(S.numpy(), Ss[:6], rtol=1e-6)
    recon = (U * S) @ Vt
    exact = np.linalg.norm(X - (Us[:, :6] * Ss[:6]) @ Vts[:6])
    assert np.linalg.norm(X - recon.numpy()) <= max(exact * (1 + 1e-6), 1e-10)
    # a RandomState seeds the device backend too
    rng = np.random.RandomState(0)
    X = np.abs(rng.rand(24, 5) @ rng.rand(5, 16))
    W, H = _init(X, 3, 'nndsvd', random_state=np.random.RandomState(0),
                 svd_backend='torch')
    assert W.shape == (24, 3) and torch.isfinite(W).all()
    W2, H2 = _init(X, 4, 'nndsvd_lrc', random_state=np.random.RandomState(0),
                   svd_backend='torch')
    assert W2.shape == (24, 4) and torch.isfinite(H2).all()


def test_jax_suite_mean_dominated_no_dead_topics():
    rng = np.random.RandomState(0)
    n, d, k = 1024, 512, 32
    X = (rng.rand(n, k) @ rng.rand(k, d)).astype(np.float32)
    Wt, Tt = ti.initialize_nmf(torch.as_tensor(X), k, 'nndsvd',
                               random_state=0, svd_backend='torch')
    Ws, Ts = _init(X.astype(np.float64), k, 'nndsvd', random_state=0)
    assert int((Wt.sum(0) == 0).sum()) == 0
    et = np.linalg.norm(X - (Wt @ Tt).numpy()) / np.linalg.norm(X)
    es = np.linalg.norm(X - (Ws @ Ts).numpy()) / np.linalg.norm(X)
    assert abs(et - es) < 0.02, (et, es)


def test_jax_suite_masked_svd_init_and_coherence(text_train):
    rng = np.random.RandomState(0)
    Wg, Tg = np.abs(rng.rand(40, 3)), np.abs(rng.rand(3, 25))
    X_full = Wg @ Tg
    M = (rng.rand(40, 25) < 0.5).astype(float)
    for backend in ('numpy', 'torch'):
        W, T = ti.masked_svd_init(X_full * M, M, 3, random_state=0,
                                  backend=backend, device='cpu')
        assert W.shape == (40, 3) and T.shape == (3, 25)
        assert (W >= 0).all() and (T >= 0).all()
        recon = (W @ T).numpy()
        obs = M > 0
        err = np.mean((recon[obs] - X_full[obs]) ** 2)
        base = np.mean((X_full[obs].mean() - X_full[obs]) ** 2)
        assert err < base
    W, T = _init(text_train, 3, init='coherence_pmi', n_words_beam=5)
    assert W.shape == (text_train.shape[0], 3)
    assert np.allclose(T.numpy().sum(1), 1.0, atol=1e-12)
    assert np.all((T.numpy() > 0).sum(1) <= 5)


def test_jax_suite_nndsvd_lrc_cases():
    for seed, (n, d, ktrue, k) in enumerate(
            [(300, 200, 10, 10), (400, 300, 8, 16)]):
        rng = np.random.RandomState(seed)
        X = np.abs(rng.rand(n, ktrue) @ rng.rand(ktrue, d)) \
            + 0.01 * rng.rand(n, d)
        Wa, Ha = _init(X, k, 'nndsvd', random_state=0)
        Wb, Hb = _init(X, k, 'nndsvd_lrc', random_state=0)
        assert (Wb >= 0).all() and (Hb >= 0).all()
        xn = np.linalg.norm(X)
        ea = np.linalg.norm(X - (Wa @ Ha).numpy()) / xn
        eb = np.linalg.norm(X - (Wb @ Hb).numpy()) / xn
        assert eb < ea, 'lrc %.4f vs nndsvd %.4f' % (eb, ea)
        Wb2, Hb2 = _init(X, k, 'nndsvd_lrc', random_state=0)
        assert torch.equal(Wb, Wb2) and torch.equal(Hb, Hb2)
    # k near full rank (the fallback to nndsvd where the signed parts
    # cannot give k candidates): valid factors, JAX's
    X = np.abs(np.random.RandomState(0).rand(9, 6))
    for k in (6, 9):
        init = 'nndsvd_lrc' if k == 6 else 'random'
        W, H = _init(X, k, init, random_state=0)
        Wj, Hj = ji.initialize_nmf(X, k, init, random_state=0)
        assert W.shape == (9, k) and H.shape == (k, 6)
        assert (W >= 0).all() and (H >= 0).all()
        assert np.allclose(W.numpy(), Wj, atol=1e-12)
    # degenerate only past min(n, d): nndsvd's error, as in JAX
    assert ti._lrc_rank(12, 9, 6) == (6, True)
    for fn in (_init, ji.initialize_nmf):
        with pytest.raises(ValueError, match='n_components'):
            fn(X, 12, 'nndsvd_lrc', random_state=0)
    # through nmf(): monotone, a better start than nndsvd's
    from rri_nmf_tpu.nmf import nmf as jax_nmf
    from rri_nmf_tpu_torch.nmf import nmf as torch_nmf
    rng = np.random.RandomState(2)
    X = np.abs(rng.rand(60, 8) @ rng.rand(8, 40)) + 0.01 * rng.rand(60, 40)
    kw = dict(max_iter=8, random_state=0, early_stop=False,
              compute_obj_each_iter=True, reset_topic_method=None)
    s_lrc = torch_nmf(X, 6, init='nndsvd_lrc', device='cpu', **kw)
    oh = s_lrc['obj_history']
    assert all(b <= a + 1e-9 for a, b in zip(oh, oh[1:]))
    assert oh[0] <= torch_nmf(X, 6, init='nndsvd', device='cpu',
                              **kw)['obj_history'][0] + 1e-9
    j = jax_nmf(X, 6, init='nndsvd_lrc', **kw)
    assert np.allclose(oh, j['obj_history'], rtol=1e-8)
