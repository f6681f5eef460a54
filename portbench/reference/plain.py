"""Plain PyTorch pieces the references share: the arithmetic of a
precision, the simplex projection, scikit-learn's randomized SVD and the
NNDSVD initialization (Boutsidis and Gallopoulos, 2008).

Written from the published algorithms: nothing here imports the
program, JAX or either package of this repository.

``Precision('float64')`` is the reference. ``Precision('tf32')`` is the
control of a float32 program: every value float32 and the operands of
every product rounded to TensorFloat-32 (10 explicit mantissa bits,
round to nearest even), the step below float32 that the card offers.
"""

import numpy as np
import torch

# the reference's guard against a zero denominator (np.spacing(10))
EPS = float(np.spacing(10))


def round_tf32(x):
    """``x`` (float32) rounded to TensorFloat-32."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class Precision(object):
    """The dtype a reference computes in, and its products."""

    def __init__(self, name):
        if name not in ('float64', 'tf32'):
            raise ValueError('precision must be float64 or tf32')
        self.name = name
        self.dtype = torch.float64 if name == 'float64' else torch.float32

    def _r(self, a):
        return round_tf32(a) if self.name == 'tf32' else a

    def mm(self, a, b):
        """``a @ b`` (matrices or vectors)."""
        return self._r(a) @ self._r(b)

    def sparse(self, X, device):
        """The scipy matrix ``X`` as a CSR tensor on ``device`` in this
        precision, its values rounded as a product's operands are."""
        X = X.tocsr()
        vals = torch.as_tensor(X.data, dtype=torch.float64, device=device)
        return torch.sparse_csr_tensor(
            torch.as_tensor(X.indptr, dtype=torch.int64, device=device),
            torch.as_tensor(X.indices, dtype=torch.int64, device=device),
            self._r(vals.to(self.dtype)), size=X.shape)

    def spmm(self, Xs, B):
        """``Xs @ B`` for a CSR tensor from :meth:`sparse` and a dense B
        (a matrix, or a vector)."""
        if B.dim() == 1:
            return torch.sparse.mm(Xs, self._r(B)[:, None])[:, 0]
        return torch.sparse.mm(Xs, self._r(B))


def proj_simplex_rows(V, s=1.0):
    """Each row of ``V`` projected onto ``{x >= 0, Σx = s}`` (Duchi et
    al., 2008); a row already on it is returned as it is."""
    n = V.shape[-1]
    on = (V.sum(-1) == s) & (V >= 0).all(-1)
    u = torch.sort(V, dim=-1, descending=True).values
    css = torch.cumsum(u, dim=-1)
    j = torch.arange(1, n + 1, dtype=V.dtype, device=V.device)
    cond = u * j > (css - s)
    rho = torch.where(cond, torch.arange(n, device=V.device), 0).max(-1)
    theta = (css.gather(-1, rho.values[..., None])[..., 0] - s) \
        / (rho.values.to(V.dtype) + 1.0)
    out = (V - theta[..., None]).clamp_min(0.0)
    return torch.where(on[..., None], V, out)


def normalize_rows(A):
    """Rows scaled to sum 1; a row summing below 1e-10 becomes uniform."""
    s = A.sum(1, keepdim=True) + np.spacing(1)
    return torch.where(s < 1e-10, 1.0 / A.shape[1], A / s)


def _flip(u, v, u_based):
    """scikit-learn's ``svd_flip``: each component's sign makes the
    largest-magnitude entry of u's column (v's row) positive."""
    if u_based:
        idx = u.abs().argmax(0)
        signs = torch.sign(u[idx, torch.arange(u.shape[1], device=u.device)])
    else:
        idx = v.abs().argmax(1)
        signs = torch.sign(v[torch.arange(v.shape[0], device=v.device), idx])
    return u * signs[None, :], v * signs[:, None]


def _pl(A):
    """``P L`` of A's LU factorization with partial pivoting."""
    P, L, _ = torch.linalg.lu(A)
    return P @ L


def randomized_svd(M, k, random_state, n_oversamples=10):
    """scikit-learn's ``randomized_svd(M, k, random_state=...)`` with its
    defaults (Halko et al., 2011): a Gaussian test matrix from numpy's
    ``RandomState(random_state).normal``, ``n_iter`` 7 when k < 0.1
    min(n, d) else 4, LU-normalized power iterations on M or, when
    n < d, on Mᵀ, an economic QR, the SVD of the projected panel and
    ``svd_flip``. ``M`` is a dense float64 tensor. Returns ``(U, S, Vt)``.
    """
    n, d = M.shape
    n_iter = 7 if k < 0.1 * min(n, d) else 4
    transpose = n < d
    A = M.T if transpose else M
    omega = np.random.RandomState(random_state).normal(
        size=(A.shape[1], k + n_oversamples))
    Q = torch.as_tensor(omega, dtype=M.dtype, device=M.device)
    for _ in range(n_iter):
        Q = _pl(A @ Q)
        Q = _pl(A.T @ Q)
    Q, _ = torch.linalg.qr(A @ Q, mode='reduced')
    Uh, S, Vt = torch.linalg.svd(Q.T @ A, full_matrices=False)
    U, Vt = _flip(Q @ Uh, Vt, u_based=not transpose)
    if transpose:
        return Vt[:k].T, S[:k], U[:, :k].T
    return U[:, :k], S[:k], Vt[:k]


def nndsvd(M, k, random_state, eps=1e-6):
    """``(W, H)``: NNDSVD of the nonnegative M from
    :func:`randomized_svd`; entries below ``eps`` set to 0."""
    U, S, Vt = randomized_svd(M, k, random_state)
    W = torch.zeros(M.shape[0], k, dtype=M.dtype, device=M.device)
    H = torch.zeros(k, M.shape[1], dtype=M.dtype, device=M.device)
    W[:, 0] = S[0].sqrt() * U[:, 0].abs()
    H[0] = S[0].sqrt() * Vt[0].abs()
    for j in range(1, k):
        x, y = U[:, j], Vt[j]
        xp, yp = x.clamp_min(0), y.clamp_min(0)
        xn, yn = (-x).clamp_min(0), (-y).clamp_min(0)
        xpn, ypn = xp.norm(), yp.norm()
        xnn, ynn = xn.norm(), yn.norm()
        mp, mn = xpn * ypn, xnn * ynn
        if mp > mn:
            u, v, sigma = xp / xpn, yp / ypn, mp
        else:
            u, v, sigma = (xn / torch.where(xnn == 0, 1.0, xnn),
                           yn / torch.where(ynn == 0, 1.0, ynn), mn)
        lam = (S[j] * sigma).sqrt()
        W[:, j] = lam * u
        H[j] = lam * v
    W[W < eps] = 0
    H[H < eps] = 0
    return W, H
