"""Parity of the port's leaf math with the JAX package: simplex
projections, normalization, tfidf, qf_min and the stopping rules.

Same inputs (numpy, from a seed) through both packages on the CPU in
float64. Tolerances: bit for bit where the JAX code is exact by
construction (feasible rows, counts); 1e-13 elsewhere — the two
frameworks sum in different orders, which moves the last few bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rri_nmf_tpu import matrixops as jm
from rri_nmf_tpu import optimization as jo
from rri_nmf_tpu_torch import matrixops as tm
from rri_nmf_tpu_torch import optimization as to

torch.set_num_threads(2)
TOL = 1e-13


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rows(seed, n=12, d=9):
    rng = np.random.RandomState(seed)
    V = rng.randn(n, d) * 2
    V[0] = [0.5, 0.25, 0.25, 0, 0, 0, 0, 0, 0]          # on the simplex
    V[1] = np.full(d, 1.0 / 8)                           # sum 9/8
    V[2] = 0.0                                            # all zero
    V[3, :4] = [0.125, 0.375, 0.25, 0.25]                 # on the simplex
    V[3, 4:] = 0
    return V


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('s', [1.0, 0.3, 2.5])
def test_proj_simplex_matches_jax(seed, s):
    V = _rows(seed)
    want = np.asarray(jax.vmap(jm._proj_simplex_core)(
        jnp.asarray(V), jnp.full((V.shape[0],), s)))
    got = _np(tm._proj_simplex_core(torch.as_tensor(V), s))
    assert np.allclose(got, want, rtol=0, atol=TOL), np.abs(got - want).max()
    assert np.allclose(got.sum(1), s, atol=1e-12)
    assert got.min() >= 0


def test_proj_simplex_feasible_rows_bit_for_bit():
    V = _rows(0)
    got = _np(tm._proj_simplex_core(torch.as_tensor(V), 1.0))
    assert np.array_equal(got[0], V[0])
    assert np.array_equal(got[3], V[3])


def test_proj_mat_to_simplex_vector_s_and_axis():
    V = np.abs(_rows(4))
    s = np.linspace(0.5, 2.0, V.shape[0])
    want = np.asarray(jm.proj_mat_to_simplex(V, s))
    got = _np(tm.proj_mat_to_simplex(V, s))
    assert np.allclose(got, want, rtol=0, atol=TOL)
    want0 = np.asarray(jm.proj_mat_to_simplex(V, 1.0, axis=0))
    got0 = _np(tm.proj_mat_to_simplex(V, 1.0, axis=0))
    assert np.allclose(got0, want0, rtol=0, atol=TOL)
    with pytest.raises(ValueError):
        tm.proj_mat_to_simplex(V, s[:3])
    with pytest.raises(ValueError):
        tm.proj_mat_to_simplex(V, 1.0, axis=2)


def test_reproject_row_if_drifted():
    V = np.abs(_rows(5))
    got = _np(tm.reproject_row_if_drifted(torch.as_tensor(V), 1.0))
    for i, row in enumerate(V):
        want = np.asarray(jm.reproject_row_if_drifted(
            jnp.asarray(row), 1.0, jnp.float64))
        assert np.allclose(got[i], want, rtol=0, atol=TOL)
    # rows already summing to 1 pass through untouched
    assert np.array_equal(got[0], V[0])


@pytest.mark.parametrize('dim', [0, 1])
@pytest.mark.parametrize('zero_sum_fix', [True, False])
def test_normalize_matches_jax(dim, zero_sum_fix):
    X = np.abs(_rows(6))
    X[5] = 0.0
    X[:, 2] = 0.0
    want = np.asarray(jm.normalize(X, dim=dim, zero_sum_fix=zero_sum_fix))
    got = _np(tm.normalize(X, dim=dim, zero_sum_fix=zero_sum_fix))
    assert np.allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize('dim', [0, 1])
def test_normalize_l2_matches_jax(dim):
    X = _rows(7)
    want = np.asarray(jm.normalize_l2(X, dim=dim))
    got = _np(tm.normalize_l2(X, dim=dim))
    assert np.allclose(got, want, rtol=0, atol=TOL)


def test_tfidf_dense_matches_jax():
    rng = np.random.RandomState(8)
    X = rng.poisson(0.7, size=(40, 25)).astype(np.float64)
    X[:, 3] = 0.0                                       # a word never seen
    want, widf = jm.tfidf(X, return_idf=True)
    got, gidf = tm.tfidf(X, return_idf=True)
    assert np.allclose(_np(gidf), np.asarray(widf), rtol=1e-15, atol=0)
    assert np.allclose(_np(got), np.asarray(want), rtol=1e-15, atol=0)
    assert np.allclose(_np(tm.tfidf(X)), np.asarray(want), rtol=1e-15)


def test_as_tensor_rejects_sparse_and_casts_ints():
    """A scipy-sparse X becomes a coalesced torch sparse COO tensor (the
    sparse slice); integer data casts to the default float."""
    import scipy.sparse as sp
    X = sp.coo_matrix((np.array([1, 2, 3]), (np.array([0, 0, 2]),
                                             np.array([1, 1, 2]))),
                      shape=(3, 3))
    t = tm.as_tensor(X)
    assert t.layout == torch.sparse_coo and t.is_coalesced()
    assert t.dtype == torch.float64
    assert np.array_equal(t.to_dense().numpy(), X.toarray())
    assert tm.as_tensor(np.arange(4)).dtype == torch.float64
    assert tm.default_float('cpu') == torch.float64


QF_CASES = [
    # (c, s, ub): scalar curvature, both signs, with and without sums
    (2.0, None, None), (2.0, 1.0, 1.0), (2.0, None, 0.7),
    (-1.0, 1.0, None), (-1.0, None, 0.5), (0.0, 2.0, None),
]


@pytest.mark.parametrize('c,s,ub', QF_CASES)
def test_qf_min_scalar_matches_jax(c, s, ub):
    w = np.random.RandomState(9).randn(15)
    xj, nj = jo.qf_min(w, c, s=s, ub=ub)
    xt, nt = to.qf_min(w, c, s=s, ub=ub)
    assert np.allclose(_np(xt), np.asarray(xj), rtol=0, atol=TOL)
    assert abs(float(nt) - float(nj)) <= TOL * max(1, abs(float(nj)))


@pytest.mark.parametrize('s,ub', [(None, 0.8), (1.0, 0.6), (1.0, None)])
def test_qf_min_vector_matches_jax(s, ub):
    rng = np.random.RandomState(10)
    w = rng.randn(15)
    c = rng.rand(15) - 0.2
    xj, nj = jo.qf_min(w, c, s=s, ub=ub)
    xt, nt = to.qf_min(w, c, s=s, ub=ub)
    assert np.allclose(_np(xt), np.asarray(xj), rtol=0, atol=TOL)
    assert abs(float(nt) - float(nj)) <= TOL * max(1, abs(float(nj)))


def test_qf_min_raises_like_jax():
    w = np.ones(4)
    with pytest.raises(ValueError):
        to.qf_min(w, -1.0, s=None, ub=None)
    with pytest.raises(NotImplementedError):
        to.qf_min(w, -1.0, s=1.0, ub=0.5)
    with pytest.raises(ValueError):
        to.qf_min(w, np.ones(3), s=1.0, ub=1.0)


@pytest.mark.parametrize('hist', [[], [5.0], [5.0, 4.0, 3.99999], [5, 4, 3],
                                  [1.0, 0.5, 0.5]])
def test_stopping_conditions_match_jax(hist):
    assert to.universal_stopping_condition(hist) == \
        jo.universal_stopping_condition(hist)
    assert to.first_last_stopping_condition(hist, 0.7) == \
        jo.first_last_stopping_condition(hist, 0.7)
