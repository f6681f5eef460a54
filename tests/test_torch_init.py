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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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
    for init in ('nndsvd_lrc', 'coherence_pmi'):
        with pytest.raises(NotImplementedError, match='A.3'):
            _init(X, 2, init)
