"""NMF initialization: the NNDSVD family and the random inits.

Counterpart of :mod:`rri_nmf_tpu.initialization` for ``random``,
``smart_random``, ``nndsvd``, ``nndsvda`` and ``nndsvdar``. Two SVD
backends:

- ``svd_backend='sklearn'``: ``sklearn.utils.extmath.randomized_svd`` on
  the host (imported only when this backend runs), so the reference's
  byte-exact NNDSVD goldens reproduce;
- ``svd_backend='torch'``: the randomized range-finder SVD
  (Halko-Martinsson-Tropp) on X's device, orthonormalizing through the
  (p, p) Gram's ``torch.linalg.eigh`` (:func:`_ortho_eigh`), like the JAX
  package's device backend.

A sparse X (scipy, or a torch COO/CSR tensor) is never densified: the
sklearn backend takes a scipy matrix as it is (bit for bit with the JAX
package; a torch sparse tensor is copied to one), the torch backend runs
its range-finder products on the sparse tensor, and the means of
``smart_random`` and ``nndsvda``/``nndsvdar`` are all-entries means.

``random``/``smart_random`` and ``nndsvdar``'s fill keep the reference's
``np.random.RandomState`` streams, so they stay bit-exact with the JAX
package. :func:`masked_svd_init`, the recommender's init, runs its
host (numpy) backend. ``nndsvd_lrc``, ``coherence_pmi`` and the device
backend of ``masked_svd_init`` arrive later (ROADMAP A.3).
"""

import numpy as np
import torch

from rri_nmf_tpu_torch.matrixops import (as_tensor, default_float,
                                         fit_device,
                                         is_scipy_sparse, is_torch_sparse,
                                         normalize, to_torch_sparse)


def _to_scipy(X):
    """The torch sparse ``X`` as a scipy CSR matrix on the host
    (duplicates summed)."""
    import scipy.sparse as sp
    from rri_nmf_tpu_torch.ops.sparse_plan import host_coo
    rows, cols, vals, shape = host_coo(X)
    return sp.coo_matrix((vals, (rows, cols)), shape=shape).tocsr()


def _randomized_svd_sklearn(X, k, random_state):
    """Exact-parity host backend (the reference calls the same function).
    SciPy-sparse input passes through: ``randomized_svd`` takes it."""
    from sklearn.utils.extmath import randomized_svd
    if is_torch_sparse(X):
        X = _to_scipy(X)
    elif isinstance(X, torch.Tensor):
        X = X.cpu().numpy()
    if not is_scipy_sparse(X):
        X = np.asarray(X)
    return randomized_svd(X, k, random_state=random_state)


def _ortho_eigh(Y):
    """Orthonormal basis of range(Y) through the (p, p) Gram
    eigendecomposition, two passes (the CholeskyQR2 regime). Eigenvalues
    are floored at the Gram's rounding level ε·λmax, never zeroed: a
    zeroed direction stays dead, a floored one is re-orthonormalized by
    the second pass (see :func:`rri_nmf_tpu.initialization._ortho_eigh`)."""
    fi = torch.finfo(Y.dtype)
    for _ in range(2):
        lam, V = torch.linalg.eigh(Y.T @ Y)             # ascending
        lmax = lam[-1].clamp_min(fi.tiny)
        inv = 1.0 / torch.sqrt(torch.maximum(lam, lmax * fi.eps))
        Y = Y @ (V * inv)
    return Y


def randomized_svd_torch(X, k, generator=None, n_oversamples=10, n_iter=4,
                         omega=None):
    """Randomized SVD (Halko et al. 2011) of the tensor ``X`` on its
    device, returning ``(U, S, Vt)``. The Gaussian test matrix is drawn
    from ``generator`` unless ``omega`` (d, k + n_oversamples) is given.
    A torch sparse ``X`` stays sparse: every product against it is a
    ``torch.sparse.mm`` (with a coalesced copy of Xᵀ)."""
    n, d = X.shape
    p = min(k + n_oversamples, min(n, d))
    if omega is None:
        omega = torch.randn(d, p, generator=generator, dtype=X.dtype,
                            device=X.device)
    if is_torch_sparse(X):
        Xs = to_torch_sparse(X)
        Xts = Xs.t().coalesce()

        def mm(A):
            return torch.sparse.mm(Xs, A)

        def tmm(A):
            return torch.sparse.mm(Xts, A)

        def qtx(Q):
            return tmm(Q).T
    else:
        def mm(A):
            return X @ A

        def tmm(A):
            return X.T @ A

        def qtx(Q):
            return Q.T @ X
    Q = _ortho_eigh(mm(omega))
    for _ in range(n_iter):
        Q = _ortho_eigh(mm(_ortho_eigh(tmm(Q))))
    B = qtx(Q)                                          # (p, d)
    # SVD of the small panel via its Gram: B = Ub S Vt
    lam, Ub = torch.linalg.eigh(B @ B.T)
    order = torch.argsort(lam).flip(0)
    lam = lam[order].clamp_min(0.0)
    Ub = Ub[:, order]
    S = torch.sqrt(lam)
    Vt = (Ub.T @ B) / torch.where(S > 0, S, 1.0)[:, None]
    return (Q @ Ub)[:, :k], S[:k], Vt[:k]


class _TorchNS:
    """The numpy names :func:`_nndsvd_from_svd` uses, for tensors."""
    sqrt = staticmethod(torch.sqrt)
    abs = staticmethod(torch.abs)
    where = staticmethod(torch.where)

    @staticmethod
    def maximum(a, b):
        return a.clamp_min(b)

    @staticmethod
    def minimum(a, b):
        return a.clamp_max(b)

    @staticmethod
    def sum(a, axis):
        return a.sum(dim=axis)

    @staticmethod
    def concatenate(xs, axis):
        return torch.cat(xs, dim=axis)


def _nndsvd_from_svd(U, S, Vt, eps):
    """Boutsidis-Gallopoulos NNDSVD section split, vectorized over all
    components; numpy in, numpy out (the JAX package's host code, line
    for line) or tensors in, tensors out."""
    xp = _TorchNS if isinstance(U, torch.Tensor) else np

    # leading singular triplet is already non-negative (Perron-Frobenius)
    W0 = xp.sqrt(S[0]) * xp.abs(U[:, 0])
    H0 = xp.sqrt(S[0]) * xp.abs(Vt[0, :])

    Xc = U[:, 1:]
    Yc = Vt[1:, :]
    x_p, y_p = xp.maximum(Xc, 0), xp.maximum(Yc, 0)
    x_n, y_n = xp.abs(xp.minimum(Xc, 0)), xp.abs(xp.minimum(Yc, 0))

    x_p_nrm = xp.sqrt(xp.sum(x_p ** 2, axis=0))
    y_p_nrm = xp.sqrt(xp.sum(y_p ** 2, axis=1))
    x_n_nrm = xp.sqrt(xp.sum(x_n ** 2, axis=0))
    y_n_nrm = xp.sqrt(xp.sum(y_n ** 2, axis=1))

    m_p = x_p_nrm * y_p_nrm
    m_n = x_n_nrm * y_n_nrm
    pick_p = m_p > m_n

    def _safe(nrm):
        return xp.where(nrm == 0, 1.0, nrm)

    u = xp.where(pick_p[None, :], x_p / _safe(x_p_nrm)[None, :],
                 x_n / _safe(x_n_nrm)[None, :])
    v = xp.where(pick_p[:, None], y_p / _safe(y_p_nrm)[:, None],
                 y_n / _safe(y_n_nrm)[:, None])
    sigma = xp.where(pick_p, m_p, m_n)
    lbd = xp.sqrt(S[1:] * sigma)

    W = xp.concatenate([W0[:, None], lbd[None, :] * u], axis=1)
    H = xp.concatenate([H0[None, :], lbd[:, None] * v], axis=0)
    W[W < eps] = 0
    H[H < eps] = 0
    return W, H


def _randomized_svd_numpy(X, k, rng, n_oversamples=10, n_iter=4):
    """Host randomized SVD (Halko et al.); NumPy/BLAS QR and panel SVD
    (:func:`rri_nmf_tpu.initialization._randomized_svd_numpy`)."""
    n, d = X.shape
    p = min(k + n_oversamples, min(n, d))
    Q, _ = np.linalg.qr(X @ rng.standard_normal((d, p)))
    for _ in range(n_iter):
        Z, _ = np.linalg.qr(X.T @ Q)
        Q, _ = np.linalg.qr(X @ Z)
    Ub, S, Vt = np.linalg.svd(Q.T @ X, full_matrices=False)
    return (Q @ Ub)[:, :k], S[:k], Vt[:k, :]


def _host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else a


def masked_svd_init(X, W_mat, n_components, random_state=None, n_iter=10,
                    eps=1e-6, backend='numpy'):
    """Elementwise-weighted (masked) SVD initialization for WRRI
    (:func:`rri_nmf_tpu.initialization.masked_svd_init`): fill the
    unobserved entries (``W_mat == 0``) with the observed mean, then
    ``n_iter`` times take a rank-``n_components`` randomized SVD and refill
    them from its reconstruction; the NNDSVD section split of the last
    factorization gives ``(W, H)``.

    ``X`` and ``W_mat`` are numpy arrays or tensors (on any device). Only
    ``backend='numpy'`` is ported: it runs on the host in float64, with
    the JAX package's numpy random stream, so the result is bit for bit
    the JAX package's. Returns float64 tensors on the CPU."""
    if backend != 'numpy':
        raise NotImplementedError(
            "masked_svd_init(backend=%r) is not ported yet; the device "
            "backend arrives with ROADMAP A.3 (use backend='numpy')"
            % (backend,))
    X = np.asarray(_host(X), dtype=np.float64)
    M = np.asarray(_host(W_mat), dtype=np.float64)
    rng = np.random.RandomState(0 if random_state is None else random_state)
    obs_mean = (M * X).sum() / max(M.sum(), 1.0)
    Xf = M * X + (1 - M) * obs_mean
    U = S = Vt = None
    for _ in range(n_iter):
        U, S, Vt = _randomized_svd_numpy(Xf, n_components, rng)
        Xf = M * X + (1 - M) * ((U * S) @ Vt)
    W, H = _nndsvd_from_svd(U, S, Vt, eps)
    return torch.as_tensor(W), torch.as_tensor(H)


def _seed_int(random_state):
    """Integer seed from any accepted ``random_state`` form."""
    if random_state is None:
        return 0
    if isinstance(random_state, np.random.RandomState):
        return int(random_state.randint(2 ** 31))
    return int(random_state)


def _rng(random_state):
    return random_state if isinstance(random_state, np.random.RandomState) \
        else np.random.RandomState(random_state)


def _mean(X):
    """The mean of all n·d entries of X (a sparse X is not densified)."""
    if is_torch_sparse(X):
        vals = to_torch_sparse(X).values()
        return float(vals.sum() / (X.shape[0] * X.shape[1]))
    if is_scipy_sparse(X):
        return float(X.mean())
    return float(X.mean()) if isinstance(X, torch.Tensor) \
        else float(np.asarray(X).mean())


def initialize_nmf(X, n_components, init=None, eps=1e-6, random_state=None,
                   row_normalize=False, svd_backend='sklearn', dtype=None,
                   device=None):
    """Initial ``(W, H)`` for ``X ≈ W H``, as tensors on ``device``
    (default: X's device for a tensor, the card for a numpy or
    scipy-sparse ``X``; ``device='cpu'`` runs on the CPU) in ``dtype``
    (default: X's float dtype, else the device's default float). The
    sklearn SVD backend runs on the host whatever the device.

    Mirrors :func:`rri_nmf_tpu.initialization.initialize_nmf`: the
    default rule (``nndsvd`` when ``n_components < n_features``, else
    ``random``), the numpy random streams, and the nndsvd/nndsvda/
    nndsvdar family."""
    if svd_backend not in ('sklearn', 'torch'):
        raise ValueError("svd_backend must be 'sklearn' or 'torch', got %r"
                         % (svd_backend,))
    device = fit_device(X, device)
    if dtype is None:
        dtype = (X.dtype if isinstance(X, torch.Tensor)
                 and X.dtype.is_floating_point else default_float(device))
    n_samples, n_features = X.shape
    k = n_components

    def out(W, H):
        W = as_tensor(W, device=device, dtype=dtype)
        H = as_tensor(H, device=device, dtype=dtype)
        return W, (normalize(H) if row_normalize else H)

    if init is None:
        init = 'nndsvd' if k < n_features else 'random'

    if init == 'random':
        rng = _rng(random_state)
        T = rng.rand(k, n_features)
        W = rng.rand(n_samples, k)
        return out(W, T)

    if init == 'smart_random':
        avg = np.sqrt(_mean(X) / k)
        rng = _rng(random_state)
        H = np.abs(avg * rng.randn(k, n_features))
        W = np.abs(avg * rng.randn(n_samples, k))
        return out(W, H)

    if init in ('nndsvd_lrc', 'coherence_pmi'):
        raise NotImplementedError(
            'init=%r is not ported yet; it arrives with ROADMAP A.3' % init)
    if init not in ('nndsvd', 'nndsvda', 'nndsvdar'):
        raise ValueError(
            'Invalid init parameter: got %r instead of one of %r' % (
                init, (None, 'random', 'smart_random', 'nndsvd', 'nndsvda',
                       'nndsvdar')))
    if k > min(n_samples, n_features):
        raise ValueError(
            "init=%r requires n_components <= min(n_samples, n_features) "
            "= %d, got %d; use init='random' for overcomplete "
            'factorizations' % (init, min(n_samples, n_features), k))

    if svd_backend == 'torch':
        Xt = as_tensor(X, device=device, dtype=dtype)
        gen = torch.Generator(device=device).manual_seed(
            _seed_int(random_state))
        U, S, Vt = randomized_svd_torch(Xt, k, generator=gen)
    else:
        U, S, Vt = _randomized_svd_sklearn(X, k, random_state)
    W, H = _nndsvd_from_svd(U, S, Vt, eps)

    if init == 'nndsvda':
        avg = _mean(X)
        W[W == 0] = avg
        H[H == 0] = avg
    elif init == 'nndsvdar':
        rng = _rng(random_state)
        avg = _mean(X)
        for A in (W, H):
            fill = np.abs(avg * rng.randn(int((A == 0).sum())) / 100)
            A[A == 0] = (torch.as_tensor(fill, dtype=A.dtype, device=A.device)
                         if isinstance(A, torch.Tensor) else fill)
    return out(W, H)
