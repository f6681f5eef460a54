"""NMF initialization: the NNDSVD family, NNSVD-LRC, the random inits,
the PMI-coherence beam search and the masked SVD init.

Counterpart of :mod:`rri_nmf_tpu.initialization`. Two SVD backends:

- ``svd_backend='sklearn'``: scikit-learn's randomized SVD in float64.
  On the host (a numpy, scipy-sparse or CPU-tensor X) it is
  :func:`randomized_svd_np`, a scikit-learn-free copy of
  ``sklearn.utils.extmath.randomized_svd`` (scikit-learn 1.9.0's
  ``_randomized_svd``, bit for bit), so the reference's byte-exact
  NNDSVD goldens reproduce. On the card (a CUDA
  X, dense or sparse) it is :func:`randomized_svd_f64`: the same
  algorithm, the same numpy test matrix, with ``torch.linalg`` LU, QR and
  SVD in float64 on the card, X upcast a block of rows at a time inside
  the products (no float64 copy of X). That is the JAX ``nmf()``'s init
  for every X that is not quantized.
- ``svd_backend='torch'``: the randomized range-finder SVD
  (Halko-Martinsson-Tropp) on X's device, orthonormalizing through the
  (p, p) Gram's ``torch.linalg.eigh`` (:func:`_ortho_eigh`), ``n_iter=4``:
  the counterpart of the JAX package's device backend, which ``nmf()``
  uses for a :class:`~rri_nmf_tpu_torch.ops.quantized.QuantizedX` (its
  products fold the scale, :func:`~rri_nmf_tpu_torch.ops.quantized.
  qx_rmul`). A 16-bit X computes in float32.

A sparse X (scipy, or a torch COO/CSR tensor) is never densified: the
host backend takes a scipy matrix as it is (a torch sparse tensor is
copied to one), the card backends run their products on the sparse
tensor, and the means of ``smart_random`` and ``nndsvda``/``nndsvdar``
are all-entries means.

``random``/``smart_random`` and ``nndsvdar``'s fill keep the reference's
``np.random.RandomState`` streams, so they stay bit-exact with the JAX
package. ``nndsvd_lrc`` (NNSVD-LRC, arXiv:1807.04020) takes a half-rank
SVD, keeps both signed parts of each component as candidates and
corrects them with two low-rank HALS passes: on the host in numpy
(:func:`_lrc_correct_np`), on X's device through kernel B1
(:func:`_lrc_correct_torch`; the torch backend, and the float64 card
SVD of a CUDA X). ``coherence_pmi`` runs the
beam search with torch on X's device. :func:`masked_svd_init`, the
recommender's init, has the host (numpy) backend and the torch backend.
"""

import numpy as np
import torch

from rri_nmf_tpu_torch.matrixops import (as_tensor, default_float,
                                         fit_device,
                                         is_scipy_sparse, is_torch_sparse,
                                         normalize, tfidf, to_torch_sparse)
from rri_nmf_tpu_torch.ops.quantized import (NARROW, QuantizedX, qx_lmul_t,
                                             qx_mean, qx_rmul, work_dtype,
                                             xmm)
from rri_nmf_tpu_torch.parallel.multihost import RankBlock


def _to_scipy(X):
    """The torch sparse ``X`` as a scipy CSR matrix on the host
    (duplicates summed)."""
    import scipy.sparse as sp
    from rri_nmf_tpu_torch.ops.sparse_plan import host_coo
    rows, cols, vals, shape = host_coo(X)
    return sp.coo_matrix((vals, (rows, cols)), shape=shape).tocsr()


# ---------------------------------------------------------------------------
# scikit-learn's randomized SVD, on the host and on the card
# ---------------------------------------------------------------------------

def _check_random_state(seed):
    """scikit-learn's ``check_random_state``: None is numpy's global
    RandomState, an int seeds a new one, a RandomState passes through."""
    if seed is None or seed is np.random:
        return np.random.mtrand._rand
    if isinstance(seed, np.random.RandomState):
        return seed
    return np.random.RandomState(seed)


def _svd_flip_np(u, v, u_based_decision=True):
    """scikit-learn's ``svd_flip``: the sign of each component that makes
    the largest-magnitude entry of u's column (or of v's row) positive."""
    if u_based_decision:
        idx = np.argmax(np.abs(u.T), axis=1)
        signs = np.sign(u.T[np.arange(u.shape[1]), idx])
    else:
        idx = np.argmax(np.abs(v), axis=1)
        signs = np.sign(v[np.arange(v.shape[0]), idx])
    u *= signs[np.newaxis, :]
    v *= signs[:, np.newaxis]
    return u, v


def randomized_svd_np(M, n_components, n_oversamples=10, n_iter='auto',
                      random_state=None):
    """A scikit-learn-free copy of scikit-learn 1.9.0's
    ``randomized_svd`` (``_randomized_svd`` with the defaults ``nmf()``
    uses), on numpy and scipy: ``n_iter='auto'`` is 7 when
    ``n_components < 0.1 min(n, d)``, else 4; the transpose when n < d;
    a Gaussian test matrix ``check_random_state(random_state).normal``
    (float32 for a float32 M); LU-normalized power iterations
    (``scipy.linalg.lu(permute_l=True)``); an economic QR; the SVD of the
    projected panel by ``gesdd``; ``svd_flip`` (on v when transposed).
    ``M`` is a numpy array or a scipy-sparse matrix. Returns
    ``(U, S, Vt)``."""
    from scipy import linalg
    if not is_scipy_sparse(M):
        M = np.asarray(M)
        if not np.issubdtype(M.dtype, np.floating):
            M = M.astype(np.float64)
    random_state = _check_random_state(random_state)
    n_random = n_components + n_oversamples
    n_samples, n_features = M.shape
    if n_iter == 'auto':
        n_iter = 7 if n_components < 0.1 * min(M.shape) else 4
    transpose = n_samples < n_features
    if transpose:
        M = M.T
    # the range finder
    Q = random_state.normal(size=(M.shape[1], n_random))
    if M.dtype == np.float32:
        Q = Q.astype(np.float32, copy=False)
    for _ in range(n_iter):
        Q, _ = linalg.lu(M @ Q, permute_l=True, check_finite=False)
        Q, _ = linalg.lu(M.T @ Q, permute_l=True, check_finite=False)
    Q, _ = linalg.qr(M @ Q, mode='economic', check_finite=False)
    B = Q.T @ M
    Uhat, s, Vt = linalg.svd(B, full_matrices=False, lapack_driver='gesdd')
    del B
    U = Q @ Uhat
    U, Vt = _svd_flip_np(U, Vt, u_based_decision=not transpose)
    if transpose:
        return (Vt[:n_components, :].T, s[:n_components],
                U[:, :n_components].T)
    return U[:, :n_components], s[:n_components], Vt[:n_components, :]


def _lu_pl(A):
    """``P L`` of the LU factorization with partial pivoting of the tall
    ``A`` (scipy's ``lu(permute_l=True)``), without forming the n x n
    permutation: L's rows are placed where the pivoting took them from."""
    LU, piv = torch.linalg.lu_factor(A)
    n, p = A.shape
    L = torch.tril(LU, -1)
    L.diagonal().fill_(1.0)
    perm = np.arange(n)
    for i, j in enumerate(piv.cpu().numpy() - 1):      # LAPACK swaps
        perm[i], perm[j] = perm[j], perm[i]
    PL = torch.empty_like(L)
    PL[torch.as_tensor(perm, device=A.device)] = L
    return PL


def _svd_flip_torch(u, v, u_based_decision=True):
    """:func:`_svd_flip_np` for tensors."""
    if u_based_decision:
        idx = torch.argmax(u.abs(), dim=0)
        signs = torch.sign(u[idx, torch.arange(u.shape[1], device=u.device)])
    else:
        idx = torch.argmax(v.abs(), dim=1)
        signs = torch.sign(v[torch.arange(v.shape[0], device=v.device), idx])
    return u * signs[None, :], v * signs[:, None]


def randomized_svd_f64(X, n_components, n_oversamples=10, n_iter='auto',
                       random_state=None, omega=None):
    """:func:`randomized_svd_np` on X's device in float64: the same test
    matrix, drawn on the host from ``random_state`` (or ``omega``, (d',
    n_components + n_oversamples) for the transposed or plain M), then
    ``torch.linalg`` LU (:func:`_lu_pl`), QR and SVD. ``X`` is a dense
    tensor of any float dtype, upcast to float64 a block of rows at a
    time inside each product (:func:`~rri_nmf_tpu_torch.ops.quantized.
    xmm`), or a torch sparse tensor (float64 values, ``torch.sparse.mm``).
    Returns float64 ``(U, S, Vt)`` on X's device."""
    f64 = torch.float64
    n, d = X.shape
    n_random = n_components + n_oversamples
    if n_iter == 'auto':
        n_iter = 7 if n_components < 0.1 * min(n, d) else 4
    transpose = n < d
    if is_torch_sparse(X):
        Xs = to_torch_sparse(X, f64)
        Xts = Xs.t().coalesce()

        def x_mm(A):                 # X @ A
            return torch.sparse.mm(Xs, A)

        def xt_mm(A):                # Xᵀ @ A
            return torch.sparse.mm(Xts, A)
    else:
        def x_mm(A):
            return xmm(X, A, f64)

        def xt_mm(A):
            return xmm(A.T, X, f64).T
    # M = Xᵀ when transposed: M @ Q and Mᵀ @ Q
    m_mm, mt_mm = (xt_mm, x_mm) if transpose else (x_mm, xt_mm)
    if omega is None:
        omega = _check_random_state(random_state).normal(
            size=(n if transpose else d, n_random))
    Q = torch.as_tensor(np.asarray(omega), dtype=f64, device=X.device)
    for _ in range(n_iter):
        Q = _lu_pl(m_mm(Q))
        Q = _lu_pl(mt_mm(Q))
    Q, _ = torch.linalg.qr(m_mm(Q), mode='reduced')
    B = mt_mm(Q).T                                    # Qᵀ M
    Uhat, s, Vt = torch.linalg.svd(B, full_matrices=False)
    del B
    U = Q @ Uhat
    U, Vt = _svd_flip_torch(U, Vt, u_based_decision=not transpose)
    k = n_components
    if transpose:
        return Vt[:k].T, s[:k], U[:, :k].T
    return U[:, :k], s[:k], Vt[:k]


def _randomized_svd_sklearn(X, k, random_state, device=None):
    """The ``'sklearn'`` backend: scikit-learn's algorithm in float64, on
    the card for a CUDA X (:func:`randomized_svd_f64`) and for a
    scipy-sparse X whose init runs on the card (``device``; its nonzeros
    are what crosses), else on the host (:func:`randomized_svd_np`; a
    scipy-sparse X passes through)."""
    if (is_scipy_sparse(X) and device is not None
            and torch.device(device).type == 'cuda'):
        X = to_torch_sparse(X, torch.float64, device)
    if isinstance(X, torch.Tensor) and X.is_cuda:
        return randomized_svd_f64(X, k, random_state=random_state)
    if is_torch_sparse(X):
        X = _to_scipy(X)
    elif isinstance(X, torch.Tensor):
        # numpy has no bfloat16: a 16-bit X is read in float32 (exact)
        X = (X.float() if X.dtype in NARROW else X).cpu().numpy()
    return randomized_svd_np(X, k, random_state=random_state)


# ---------------------------------------------------------------------------
# the device backend
# ---------------------------------------------------------------------------

def _same(a):
    return a


def _ortho_eigh(Y, total=_same):
    """Orthonormal basis of range(Y) through the (p, p) Gram
    eigendecomposition, two passes (the CholeskyQR2 regime). Eigenvalues
    are floored at the Gram's rounding level ε·λmax, never zeroed: a
    zeroed direction stays dead, a floored one is re-orthonormalized by
    the second pass (see :func:`rri_nmf_tpu.initialization._ortho_eigh`).
    On a mesh Y is a block of rows and ``total`` sums its Gram over the
    ranks that hold the other rows."""
    fi = torch.finfo(Y.dtype)
    for _ in range(2):
        lam, V = torch.linalg.eigh(total(Y.T @ Y))      # ascending
        lmax = lam[-1].clamp_min(fi.tiny)
        inv = 1.0 / torch.sqrt(torch.maximum(lam, lmax * fi.eps))
        Y = Y @ (V * inv)
    return Y


def randomized_svd_torch(X, k, generator=None, n_oversamples=10, n_iter=4,
                         omega=None, mesh=None):
    """Randomized SVD (Halko et al. 2011) of ``X`` on its device,
    returning ``(U, S, Vt)`` in X's work dtype (float32 for 16 bits). The
    Gaussian test matrix is drawn from ``generator`` unless ``omega`` (d, k +
    n_oversamples) is given. ``X`` is a dense tensor (a 16-bit one read a
    block of rows at a time in float32), a torch sparse tensor (every
    product a ``torch.sparse.mm``, with a coalesced copy of Xᵀ) or a
    :class:`~rri_nmf_tpu_torch.ops.quantized.QuantizedX` (the scale folded
    outside each product).

    On a ``mesh`` X is this rank's
    :class:`~rri_nmf_tpu_torch.parallel.multihost.RankBlock` (its block a
    dense tensor or a QuantizedX) and every rank of the mesh calls
    together. Ω is drawn whole on every rank (one seed) and each takes
    its rows of it; ``X @ A`` is summed over ``tp``, ``XᵀQ`` and ``QᵀX``
    over ``dp``, the Gram of an (n, p) panel over ``dp`` and of a (d, p)
    panel over ``tp``, and ``B Bᵀ`` over ``tp``; the (p, p) eigensolves
    run on every rank on the same values. U comes back as this rank's
    rows, Vt as its columns; a (1, 1) mesh computes what the whole X
    does, bit for bit."""
    split = None
    if isinstance(X, RankBlock):
        if mesh is None:
            raise ValueError('a RankBlock X is a rank\'s block: pass its '
                             'mesh=')
        X, split = X.block, X.split
    n, d = X.shape if split is None else (split.n, split.d)
    sum_dp = _same if mesh is None else mesh.sum_dp
    sum_tp = _same if mesh is None else mesh.sum_tp
    p = min(k + n_oversamples, min(n, d))
    # float32 for a 16-bit X: its tail spectrum is noise at bf16 precision
    comp = work_dtype(X.dtype)
    if omega is None:
        omega = torch.randn(d, p, generator=generator, dtype=comp,
                            device=X.device)
    if split is not None:
        omega = omega[split.c0:split.c1]
    if isinstance(X, QuantizedX):
        def mm(A):
            return qx_rmul(X, A, comp)

        def tmm(A):
            return qx_lmul_t(X, A, comp)

        def qtx(Q):
            return tmm(Q).T
    elif is_torch_sparse(X):
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
            return xmm(X, A, comp)

        def tmm(A):
            return xmm(A.T, X, comp).T

        def qtx(Q):
            return xmm(Q.T, X, comp)
    Q = _ortho_eigh(sum_tp(mm(omega)), sum_dp)
    for _ in range(n_iter):
        Z = _ortho_eigh(sum_dp(tmm(Q)), sum_tp)
        Q = _ortho_eigh(sum_tp(mm(Z)), sum_dp)
    B = sum_dp(qtx(Q))                                  # (p, d)
    # SVD of the small panel via its Gram: B = Ub S Vt
    lam, Ub = torch.linalg.eigh(sum_tp(B @ B.T))
    order = torch.argsort(lam).flip(0)
    lam = lam[order].clamp_min(0.0)
    Ub = Ub[:, order]
    S = torch.sqrt(lam)
    Vt = (Ub.T @ B) / torch.where(S > 0, S, 1.0)[:, None]
    return (Q @ Ub)[:, :k], S[:k], Vt[:k]


# ---------------------------------------------------------------------------
# NNDSVD
# ---------------------------------------------------------------------------

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


def _nndsvd_from_svd(U, S, Vt, eps, mesh=None):
    """Boutsidis-Gallopoulos NNDSVD section split, vectorized over all
    components; numpy in, numpy out (the JAX package's host code, line
    for line) or tensors in, tensors out. On a ``mesh`` U is a rank's
    rows and Vt its columns (:func:`randomized_svd_torch` of a
    RankBlock): the squared norms of the positive and negative parts are
    summed over ``dp`` for U and over ``tp`` for Vt, so every rank picks
    the same sections, and W, H come back as the rank's rows and
    columns."""
    xp = _TorchNS if isinstance(U, torch.Tensor) else np
    sum_dp = _same if mesh is None else mesh.sum_dp
    sum_tp = _same if mesh is None else mesh.sum_tp

    # leading singular triplet is already non-negative (Perron-Frobenius)
    W0 = xp.sqrt(S[0]) * xp.abs(U[:, 0])
    H0 = xp.sqrt(S[0]) * xp.abs(Vt[0, :])

    Xc = U[:, 1:]
    Yc = Vt[1:, :]
    x_p, y_p = xp.maximum(Xc, 0), xp.maximum(Yc, 0)
    x_n, y_n = xp.abs(xp.minimum(Xc, 0)), xp.abs(xp.minimum(Yc, 0))

    x_p_nrm = xp.sqrt(sum_dp(xp.sum(x_p ** 2, axis=0)))
    y_p_nrm = xp.sqrt(sum_tp(xp.sum(y_p ** 2, axis=1)))
    x_n_nrm = xp.sqrt(sum_dp(xp.sum(x_n ** 2, axis=0)))
    y_n_nrm = xp.sqrt(sum_tp(xp.sum(y_n ** 2, axis=1)))

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


# ---------------------------------------------------------------------------
# NNSVD-LRC (low-rank corrected)
# ---------------------------------------------------------------------------

def _lrc_rank(k, n, d):
    """NNSVD-LRC's half rank: ``(p, degenerate)``, the SVD rank
    ``p ≈ k/2 + 1`` clipped to min(n, d), and whether the signed-part
    construction cannot yield k candidates (k near full rank: callers
    fall back to plain nndsvd)."""
    p = min(max(-(-k // 2) + 1, 2), min(n, d))
    return p, 2 * (p - 1) + 1 < k


def _nndsvd_lrc_split(U, S, Vt, k):
    """The signed-part candidates of NNSVD-LRC
    (:func:`rri_nmf_tpu.initialization._nndsvd_lrc_split`): the Perron
    pair, then both the positive and the negative part of each further
    component, ranked by energy ``σ‖u±‖‖v±‖``, the top k - 1 kept.
    numpy in, numpy out, or tensors. Returns (W (n, k), H (k, d))."""
    if isinstance(U, torch.Tensor):
        cat, relu, sqrt = torch.cat, torch.relu, torch.sqrt

        def norms(A, axis):
            return sqrt((A ** 2).sum(axis))

        def top(e):
            return torch.argsort(-e, stable=True)[:k - 1]
    else:
        cat, sqrt = np.concatenate, np.sqrt

        def relu(A):
            return np.maximum(A, 0)

        def norms(A, axis):
            return sqrt(np.sum(A ** 2, axis=axis))

        def top(e):
            return np.argsort(-e)[:k - 1]
    W0 = sqrt(S[0]) * abs(U[:, 0])
    H0 = sqrt(S[0]) * abs(Vt[0, :])
    Uc, Vc = U[:, 1:], Vt[1:, :]
    u_p, u_n = relu(Uc), relu(-Uc)
    v_p, v_n = relu(Vc), relu(-Vc)
    cand_u = cat([u_p, u_n], 1)
    cand_v = cat([v_p, v_n], 0)
    un = cat([norms(u_p, 0), norms(u_n, 0)])
    vn = cat([norms(v_p, 1), norms(v_n, 1)])
    sig = cat([S[1:], S[1:]])
    energy = sig * un * vn
    order = top(energy)
    safe_u = un.copy() if isinstance(un, np.ndarray) else un.clone()
    safe_v = vn.copy() if isinstance(vn, np.ndarray) else vn.clone()
    safe_u[un == 0] = 1.0
    safe_v[vn == 0] = 1.0
    lbd = sqrt(energy[order])
    W_rest = cand_u[:, order] / safe_u[order][None, :] * lbd[None, :]
    H_rest = cand_v[order, :] / safe_v[order][:, None] * lbd[:, None]
    W = cat([W0[:, None], W_rest], 1)
    H = cat([H0[None, :], H_rest], 0)
    return W, H


def _lrc_correct_np(Us, Vt, W, H, iters=2):
    """The low-rank HALS correction (host form): a few exact cyclic
    Gauss-Seidel passes of ``min ‖X_p − WH‖²`` with ``X_p = Us Vt`` used
    implicitly, every contraction through the (·, p) panels
    (:func:`rri_nmf_tpu.initialization._lrc_correct_np`, line for
    line)."""
    tiny = np.finfo(W.dtype).tiny
    k = W.shape[1]
    for _ in range(iters):
        G = W.T @ W                               # (k, k)
        N = (W.T @ Us) @ Vt                       # (k, d) — never n×d
        for t in range(k):
            corr = G[t] @ H - G[t, t] * H[t]
            H[t] = np.maximum(0.0, (N[t] - corr) / max(G[t, t], tiny))
        Gh = H @ H.T
        Nw = Us @ (Vt @ H.T)                      # (n, k)
        for t in range(k):
            corr = W @ Gh[:, t] - Gh[t, t] * W[:, t]
            W[:, t] = np.maximum(0.0,
                                 (Nw[:, t] - corr) / max(Gh[t, t], tiny))
    return W, H


def _lrc_correct_torch(Us, Vt, W, H, iters=2):
    """:func:`_lrc_correct_np` on the factors' device, in their dtype:
    the Gauss-Seidel topic loops of each pass through kernel B1
    (:func:`~rri_nmf_tpu_torch.ops.dense_kernels.gs_update`, its plain
    twin on the CPU; the counterpart of the JAX package's
    ``gs_topics_blocked``)."""
    from rri_nmf_tpu_torch.ops.dense_kernels import gs_update
    inf = float('inf')
    for _ in range(iters):
        N = ((W.T @ Us) @ Vt).contiguous()
        H = gs_update((W.T @ W).contiguous(), N, H.contiguous(), 0.0, 0.0,
                      inf)
        Nw = ((H @ Vt.T) @ Us.T).contiguous()              # (k, n)
        W = gs_update((H @ H.T).contiguous(), Nw, W.T.contiguous(), 0.0,
                      0.0, inf).T
    return W, H


def _nndsvd_lrc_host(X, k, random_state, eps, lrc_iters=2, device=None):
    """NNSVD-LRC with the ``'sklearn'`` backend's float64 SVD at the half
    rank, the split, the correction, entries below ``eps`` zeroed. On the
    host numpy factors through :func:`_lrc_correct_np`; for an X whose
    SVD ran on the card (:func:`_randomized_svd_sklearn`) float64 tensors
    there, corrected through kernel B1 (:func:`_lrc_correct_torch`)."""
    n, d = X.shape
    p, degenerate = _lrc_rank(k, n, d)
    assert not degenerate, 'half-rank construction cannot yield k candidates'
    U, S, Vt = _randomized_svd_sklearn(X, p, random_state, device)
    W, H = _nndsvd_lrc_split(U, S, Vt, k)
    if isinstance(U, torch.Tensor):
        W, H = _lrc_correct_torch(U * S, Vt, W, H, iters=lrc_iters)
        return torch.where(W < eps, 0.0, W), torch.where(H < eps, 0.0, H)
    W, H = _lrc_correct_np(U * S, Vt, W, H, iters=lrc_iters)
    W[W < eps] = 0
    H[H < eps] = 0
    return W, H


def _nndsvd_lrc_device(X, k, eps, generator=None, omega=None, lrc_iters=2,
                       mesh=None):
    """NNSVD-LRC with the torch backend on X's device
    (:func:`rri_nmf_tpu.initialization._nndsvd_lrc_device_jit`): the
    half-rank :func:`randomized_svd_torch` (test matrix from
    ``generator`` or ``omega``), the split, and
    :func:`_lrc_correct_torch`, in the SVD's computation dtype. For a
    rank's block on a ``mesh`` the SVD runs through the mesh and its
    (n, p) and (p, d) factors are gathered whole, so every rank corrects
    the same whole candidates."""
    n, d = X.shape
    p, degenerate = _lrc_rank(k, n, d)
    assert not degenerate, 'half-rank construction cannot yield k candidates'
    U, S, Vt = randomized_svd_torch(X, p, generator=generator, omega=omega,
                                    mesh=mesh)
    if isinstance(X, RankBlock):
        U = mesh.gather_rows(U, X.split)
        Vt = mesh.gather_cols(Vt, X.split)
    W, H = _nndsvd_lrc_split(U, S, Vt, k)
    W, H = _lrc_correct_torch(U * S, Vt, W, H, iters=lrc_iters)
    W = torch.where(W < eps, 0.0, W)
    H = torch.where(H < eps, 0.0, H)
    return W, H


# ---------------------------------------------------------------------------
# the PMI-coherence beam search
# ---------------------------------------------------------------------------

def init_coherence_beam_search(X, n_components, n_words_beam=20,
                               device=None):
    """PMI-coherence greedy beam search topic initialization
    (:func:`rri_nmf_tpu.initialization.init_coherence_beam_search`), in
    float64 with torch on ``device`` (default: X's device for a tensor,
    the card for host data): ``X`` densified and normalized as tf-idf
    rows, the word co-occurrence ``C = XᵀX`` (d, d), and per topic a
    greedy beam of ``n_words_beam`` words, each word's PMI score against
    the topic kept as a running sum. Returns float64 ``(W, T)`` tensors
    on the device."""
    device = fit_device(X, device)
    if is_scipy_sparse(X):
        X = X.toarray()
    elif is_torch_sparse(X):
        X = X.to_dense()
    X = as_tensor(X, device=device, dtype=torch.float64)
    X = normalize(tfidf(X))
    C = X.T @ X
    k = n_components
    eps = float(np.spacing(1))
    P_i = torch.log(C.sum(1) + eps)
    P_ij = torch.log(C.add_(eps))                        # C is not read again
    del C
    xs = X.sum(0).clone()
    ninf = torch.tensor(float('-inf'), dtype=torch.float64, device=device)
    topics = []
    for _ in range(k):
        j = int(torch.argmax(xs))
        xs[j] = 0
        tpc = [j]
        scores = P_ij[:, j] - P_i - P_i[j]
        for _ in range(1, n_words_beam):
            best = int(torch.argmax(torch.where(xs > 0, scores, ninf)))
            tpc.append(best)
            xs[best] = 0
            scores = scores + P_ij[:, best] - P_i - P_i[best]
        topics.append(tpc)
    del P_ij
    xs = X.sum(0)
    T = torch.zeros(k, X.shape[1], dtype=torch.float64, device=device)
    for t, tpc in enumerate(topics):
        # weight of a word in a topic proportional to its global importance
        idx = torch.as_tensor(tpc, device=device)
        T[t, idx] = xs[idx]
    T = normalize(T)
    W = normalize((X @ T.T).clamp_min(0))
    return W, T


# ---------------------------------------------------------------------------
# the masked SVD init
# ---------------------------------------------------------------------------

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
                    eps=1e-6, backend='numpy', omegas=None, device=None):
    """Elementwise-weighted (masked) SVD initialization for WRRI
    (:func:`rri_nmf_tpu.initialization.masked_svd_init`): fill the
    unobserved entries (``W_mat == 0``) with the observed mean, then
    ``n_iter`` times take a rank-``n_components`` randomized SVD and refill
    them from its reconstruction; the NNDSVD section split of the last
    factorization gives ``(W, H)``.

    ``X`` and ``W_mat`` are numpy arrays or tensors (on any device).

    - ``backend='numpy'`` runs on the host in float64 with the JAX
      package's numpy random stream, bit for bit the JAX package's;
      float64 tensors on the CPU.
    - ``backend='torch'`` (JAX's ``backend='jax'``) runs on ``device``
      (default: X's for a tensor, the card for host data) in X's float
      dtype (the device's default float for host data), each round
      through :func:`randomized_svd_torch`. Its test matrices come from a
      ``torch.Generator`` seeded with ``random_state``, or from
      ``omegas``, one (d, n_components + 10) matrix a round (JAX splits
      its key once a round: the tests inject those draws)."""
    if backend == 'numpy':
        X = np.asarray(_host(X), dtype=np.float64)
        M = np.asarray(_host(W_mat), dtype=np.float64)
        rng = np.random.RandomState(0 if random_state is None
                                    else random_state)
        obs_mean = (M * X).sum() / max(M.sum(), 1.0)
        Xf = M * X + (1 - M) * obs_mean
        U = S = Vt = None
        for _ in range(n_iter):
            U, S, Vt = _randomized_svd_numpy(Xf, n_components, rng)
            Xf = M * X + (1 - M) * ((U * S) @ Vt)
        W, H = _nndsvd_from_svd(U, S, Vt, eps)
        return torch.as_tensor(W), torch.as_tensor(H)
    if backend != 'torch':
        raise ValueError("backend must be 'numpy' or 'torch', got %r"
                         % (backend,))
    device = fit_device(X, device)
    dtype = (X.dtype if isinstance(X, torch.Tensor)
             and X.dtype.is_floating_point else default_float(device))
    X = as_tensor(X, device=device, dtype=dtype)
    M = as_tensor(W_mat, device=device, dtype=dtype)
    gen = None
    if omegas is None:
        gen = torch.Generator(device=device).manual_seed(
            0 if random_state is None else int(random_state))
    obs_mean = (M * X).sum() / M.sum().clamp_min(1.0)
    MX = M * X
    Xf = MX + (1 - M) * obs_mean
    U = S = Vt = None
    for i in range(n_iter):
        omega = None if omegas is None else as_tensor(
            omegas[i], device=device, dtype=dtype)
        U, S, Vt = randomized_svd_torch(Xf, n_components, generator=gen,
                                        omega=omega)
        Xf = MX + (1 - M) * ((U * S) @ Vt)
    return _nndsvd_from_svd(U, S, Vt, eps)


# ---------------------------------------------------------------------------
# public dispatch
# ---------------------------------------------------------------------------

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


def _mean(X, mesh=None):
    """The mean of all n·d entries of X (a sparse or quantized X is not
    densified); of a rank's block, its sum over the mesh over n·d."""
    if isinstance(X, RankBlock):
        n, d = X.shape
        B = X.block
        total = (qx_mean(B) * (B.shape[0] * B.shape[1])
                 if isinstance(B, QuantizedX) else
                 B.sum(dtype=torch.float64) if B.dtype in NARROW
                 else B.sum())
        return float(mesh.sum_all(total.reshape(1))[0] / (n * d))
    if isinstance(X, QuantizedX):
        return float(qx_mean(X))
    if is_torch_sparse(X):
        vals = to_torch_sparse(X).values()
        return float(vals.sum() / (X.shape[0] * X.shape[1]))
    if is_scipy_sparse(X):
        return float(X.mean())
    if isinstance(X, torch.Tensor):
        return float(X.mean(dtype=torch.float64) if X.dtype in NARROW
                     else X.mean())
    return float(np.asarray(X).mean())


INITS = (None, 'random', 'smart_random', 'nndsvd', 'nndsvda', 'nndsvdar',
         'nndsvd_lrc', 'coherence_pmi')


def initialize_nmf(X, n_components, init=None, eps=1e-6, random_state=None,
                   row_normalize=False, n_words_beam=20,
                   svd_backend='sklearn', dtype=None, device=None, mesh=None):
    """Initial ``(W, H)`` for ``X ≈ W H``, as tensors on ``device``
    (default: X's device for a tensor or a
    :class:`~rri_nmf_tpu_torch.ops.quantized.QuantizedX`, the card for a
    numpy or scipy-sparse ``X``; ``device='cpu'`` runs on the CPU) in
    ``dtype`` (default: X's float dtype, else the device's default float).

    Mirrors :func:`rri_nmf_tpu.initialization.initialize_nmf`: the
    default rule (``nndsvd`` when ``n_components < n_features``, else
    ``random``), the numpy random streams, the nndsvd/nndsvda/nndsvdar
    family, ``nndsvd_lrc`` (plain nndsvd when k is near full rank) and
    ``coherence_pmi``. A ``QuantizedX`` takes ``svd_backend='torch'``
    for the SVD family and refuses ``coherence_pmi``, which walks X.

    With ``mesh``, X is this rank's
    :class:`~rri_nmf_tpu_torch.parallel.multihost.RankBlock` of a matrix
    no rank holds whole, and every rank of the mesh calls together: the
    random inits draw from the shape alone, the means are one mesh sum
    over n·d, the SVD family runs :func:`randomized_svd_torch` through the
    mesh (``svd_backend='torch'``, the JAX package's device backend for a
    process-spanning X), and every rank gets the whole W and H.
    ``coherence_pmi`` raises."""
    if svd_backend not in ('sklearn', 'torch'):
        raise ValueError("svd_backend must be 'sklearn' or 'torch', got %r"
                         % (svd_backend,))
    blocked = isinstance(X, RankBlock)
    if blocked and mesh is None:
        raise ValueError('a RankBlock X initializes through its mesh; pass '
                         'mesh=')
    quant = isinstance(X.block if blocked else X, QuantizedX)
    device = X.device if (quant or blocked) and device is None \
        else fit_device(X, device)
    if dtype is None:
        dtype = (X.dtype if (quant or blocked or isinstance(X, torch.Tensor))
                 and X.dtype.is_floating_point else default_float(device))
    n_samples, n_features = X.shape
    k = n_components

    def out(W, H, blocks=False):
        if blocks:
            # this rank's rows of W and columns of H, made whole
            W, H = mesh.gather_rows(W, X.split), mesh.gather_cols(H, X.split)
        W = as_tensor(W, device=device, dtype=dtype)
        H = as_tensor(H, device=device, dtype=dtype)
        return W, (normalize(H) if row_normalize else H)

    if init is None:
        init = 'nndsvd' if k < n_features else 'random'
    if init not in INITS:
        raise ValueError(
            'Invalid init parameter: got %r instead of one of %r'
            % (init, INITS))

    if init == 'random':
        rng = _rng(random_state)
        T = rng.rand(k, n_features)
        W = rng.rand(n_samples, k)
        return out(W, T)

    if init == 'smart_random':
        avg = np.sqrt(_mean(X, mesh) / k)
        rng = _rng(random_state)
        H = np.abs(avg * rng.randn(k, n_features))
        W = np.abs(avg * rng.randn(n_samples, k))
        return out(W, H)

    if init == 'coherence_pmi':
        if quant or blocked:
            raise ValueError("init='coherence_pmi' walks X; with a "
                             'QuantizedX or a rank-block X initialize '
                             'explicitly and pass W_in/T_in')
        return out(*init_coherence_beam_search(
            X, k, n_words_beam=n_words_beam, device=device))

    if quant and svd_backend != 'torch':
        raise ValueError("a QuantizedX initializes through "
                         "svd_backend='torch' (no host SVD reads its code)")
    if blocked and svd_backend != 'torch':
        raise ValueError("a rank-block X initializes through "
                         "svd_backend='torch' (no rank holds X for a host "
                         'SVD)')

    if init == 'nndsvd_lrc':
        if _lrc_rank(k, n_samples, n_features)[1]:
            init = 'nndsvd'     # k near full rank: the construction fails
        elif svd_backend == 'torch':
            Xt = X if quant or blocked else as_tensor(X, device=device)
            gen = torch.Generator(device=device).manual_seed(
                _seed_int(random_state))
            return out(*_nndsvd_lrc_device(Xt, k, float(eps),
                                           generator=gen, mesh=mesh))
        else:
            return out(*_nndsvd_lrc_host(X, k, random_state, eps,
                                         device=device))

    if k > min(n_samples, n_features):
        raise ValueError(
            "init=%r requires n_components <= min(n_samples, n_features) "
            "= %d, got %d; use init='random' for overcomplete "
            'factorizations' % (init, min(n_samples, n_features), k))

    if svd_backend == 'torch':
        Xt = X if quant or blocked else as_tensor(X, device=device)
        if not (quant or blocked) and not is_torch_sparse(Xt) and (
                not Xt.dtype.is_floating_point):
            Xt = Xt.to(dtype)
        gen = torch.Generator(device=device).manual_seed(
            _seed_int(random_state))
        U, S, Vt = randomized_svd_torch(Xt, k, generator=gen, mesh=mesh)
    else:
        U, S, Vt = _randomized_svd_sklearn(X, k, random_state, device)
    W, H = _nndsvd_from_svd(U, S, Vt, eps, mesh)

    if init == 'nndsvda':
        avg = _mean(X, mesh)
        W[W == 0] = avg
        H[H == 0] = avg
    elif init == 'nndsvdar':
        rng = _rng(random_state)
        avg = _mean(X, mesh)
        if blocked:
            # the fill draws in the whole factors' order
            W, H = mesh.gather_rows(W, X.split), mesh.gather_cols(H, X.split)
            blocked = False
        for A in (W, H):
            fill = np.abs(avg * rng.randn(int((A == 0).sum())) / 100)
            A[A == 0] = (torch.as_tensor(fill, dtype=A.dtype, device=A.device)
                         if isinstance(A, torch.Tensor) else fill)
    return out(W, H, blocks=blocked)
