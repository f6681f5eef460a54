"""Plain reference of the recommender estimator's fit on the sparse
observed set in phase order: weighted rank-one residue iteration (Ho,
2008, the masked form) with every T row updated, then every W column,
computed on the observed pairs themselves.

What the estimator derives from the ratings, worked out again:

- the observed set: the distinct (user, item) pairs, a repeated pair's
  ratings summed; with the held-out stop off every rating trains;
- the start: NNDSVD of the sparse ratings X from scikit-learn's
  randomized SVD (a Gaussian test matrix from numpy's
  ``RandomState(random_state).normal``, 7 LU-normalized power
  iterations when k < 0.1 min(n, d), else 4; an economic QR, the SVD of
  the projected panel, ``svd_flip``), every product with X through
  ``torch.sparse.mm``; T's rows scaled to sum 1, as ``plain.py`` does.

A sweep, from the residual r = x − (WT) on the observed pairs (formed at
the sweep's start, kept current with rank-one updates):

- T phase, W frozen, per topic t over the items j, with sums over the
  ratings of each item: ``numer = Σ w_i (r_ij + w_i T[t, j])``, ``nw =
  Σ w_i²``; the row ``min([numer]₊ / (nw + eps), 1)`` (0 where nw = 0);
  r takes ``w_i (T_old − T_new)``. No scale transfer.
- W phase, T frozen, per topic t over the users, the same with sums over
  each user's ratings and no cap.

After the sweep the objective ``0.5 Σ r²`` is recorded from a residual
formed afresh, and the fit stops once its last change is at most 1e-4
of its first, or after ``max_iter`` sweeps.

Departures from the program, by design:

- the program's sweep (the Gram-phase sweep) reads every per-topic sum
  from the contractions A = Wᵀ(M⊙X), C = (M⊙X)Tᵀ and the Gram tensors
  Γ and Θ, in panels; this reference never forms Γ or Θ, and takes the
  same sums from the residual, topic by topic;
- the program's objective is the Gram identity (three terms that cancel
  in float32); this one sums the squared residual;
- the LU normalizer forms P·L from the pivots, not the n × n P;
- the sums are segment sums over the pairs sorted by item (T phase) or
  by user (W phase), never atomics, so two runs agree bit for bit;
- no pair is held out, so ``predict`` and ``truth`` (the compared
  RMSE) are a seeded 5% of the training pairs: the first of numpy's
  ``RandomState(0).permutation`` of the pairs in row-major order, the
  predictions clipped to the range of all ratings.

``Precision('tf32')`` rounds the operands of every product, in the SVD
as in the sweeps (the cell's control); ``'float64'`` is the reference.
"""

import math

import numpy as np
import scipy.sparse as sp
import torch

from portbench.reference.plain import EPS, Precision, _flip, normalize_rows

# a slice of pairs whose (slice, k) gathers are made at once
CHUNK = 1 << 20
# the program's Γ/Θ memory budget (bytes), past which it takes k-panels
GRAM_BUDGET_BYTES = 4e9


class Observed(object):
    """The observed set on ``device``: pairs in row-major order (``I``,
    ``J``, ratings ``x``), their item-major order (``col``: a stable
    permutation of the row-major positions), and the segment lengths of
    users (``row_len``) and items (``col_len``)."""

    def __init__(self, pairs, ratings, n, d, device):
        I = torch.as_tensor(np.asarray(pairs)[:, 0], device=device).long()
        J = torch.as_tensor(np.asarray(pairs)[:, 1], device=device).long()
        x = torch.as_tensor(np.asarray(ratings), dtype=torch.float64,
                            device=device)
        key, inv = torch.unique(I * d + J, sorted=True, return_inverse=True)
        self.x = torch.zeros(key.shape[0], dtype=torch.float64,
                             device=device).index_add_(0, inv, x)
        self.I, self.J = key // d, key % d
        self.col = torch.sort(self.J, stable=True).indices
        self.row_len = torch.bincount(self.I, minlength=n)
        self.col_len = torch.bincount(self.J, minlength=d)
        self.shape = (n, d)
        self.lo, self.hi = float(x.min()), float(x.max())

    @property
    def nnz(self):
        return self.x.shape[0]

    def csr(self, transpose=False):
        """X (or Xᵀ) as a scipy CSR matrix on the host."""
        I, J = self.I.cpu().numpy(), self.J.cpu().numpy()
        if transpose:
            I, J = J, I
        n, d = self.shape
        return sp.csr_matrix((self.x.cpu().numpy(), (I, J)),
                             shape=(d, n) if transpose else (n, d))


def _predicted(I, J, W, T, p):
    """``(WT)`` at the pairs ``(I, J)``, a slice of pairs at a time."""
    out = torch.empty(I.shape[0], dtype=W.dtype, device=W.device)
    Tt = T.T
    for a in range(0, I.shape[0], CHUNK):
        b = min(a + CHUNK, I.shape[0])
        out[a:b] = (p._r(W[I[a:b]]) * p._r(Tt[J[a:b]])).sum(1)
    return out


def _pl(A):
    """``P L`` of A's LU factorization with partial pivoting, from the
    pivots: row i of L goes to the row the swaps brought to place i."""
    LU, piv = torch.linalg.lu_factor(A)
    L = torch.tril(LU, -1)
    L.diagonal().fill_(1.0)
    perm = np.arange(A.shape[0])
    for i, j in enumerate(piv.cpu().numpy() - 1):
        perm[i], perm[j] = perm[j], perm[i]
    PL = torch.empty_like(L)
    PL[torch.as_tensor(perm, device=A.device)] = L
    return PL


def randomized_svd(obs, k, random_state, p, n_oversamples=10):
    """scikit-learn's ``randomized_svd`` of the sparse X of ``obs`` with
    its defaults (``plain.randomized_svd``, whose operand is dense), the
    products through ``p.spmm``. Returns ``(U, S, Vt)``."""
    n, d = obs.shape
    dev = obs.x.device
    n_iter = 7 if k < 0.1 * min(n, d) else 4
    transpose = n < d
    Xs = p.sparse(obs.csr(), dev)
    Xts = p.sparse(obs.csr(transpose=True), dev)
    A, At = (Xts, Xs) if transpose else (Xs, Xts)
    omega = np.random.RandomState(random_state).normal(
        size=(n if transpose else d, k + n_oversamples))
    Q = torch.as_tensor(omega, dtype=p.dtype, device=dev)
    for _ in range(n_iter):
        Q = _pl(p.spmm(A, Q))
        Q = _pl(p.spmm(At, Q))
    Q, _ = torch.linalg.qr(p.spmm(A, Q), mode='reduced')
    Uh, S, Vt = torch.linalg.svd(p.spmm(At, Q).T, full_matrices=False)
    U, Vt = _flip(p.mm(Q, Uh), Vt, u_based=not transpose)
    if transpose:
        return Vt[:k].T, S[:k], U[:, :k].T
    return U[:, :k], S[:k], Vt[:k]


def nndsvd(obs, k, random_state, p, eps=1e-6):
    """``(W, H)``: NNDSVD (Boutsidis and Gallopoulos, 2008) of the sparse
    X from :func:`randomized_svd`; entries below ``eps`` set to 0."""
    U, S, Vt = randomized_svd(obs, k, random_state, p)
    n, d = obs.shape
    W = torch.zeros(n, k, dtype=U.dtype, device=U.device)
    H = torch.zeros(k, d, dtype=U.dtype, device=U.device)
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


def _phase(r, seg_of, other_of, F, G, lengths, p, cap):
    """One phase in place: for each topic t, the row ``F[t]`` (indexed
    by the segments) updated from the frozen ``G[t]`` (indexed by the
    other key) and the residual ``r`` of the pairs in segment order."""
    for t in range(F.shape[0]):
        g = p._r(G[t][other_of])
        f = F[t][seg_of]
        numer = torch.segment_reduce(g * p._r(r + g * p._r(f)), 'sum',
                                     lengths=lengths)
        curv = torch.segment_reduce(g * g, 'sum', lengths=lengths)
        new = torch.where(curv > 0, numer.clamp_min(0) / (curv + EPS), 0.0)
        if cap is not None:
            new = new.clamp_max(cap)
        r -= g * p._r(new[seg_of] - f)
        F[t] = new


def sweep(obs, W, T, r, p):
    """One phase-order sweep of W and T in place, from the residual ``r``
    of the pairs in row-major order, which it keeps current."""
    Wt = W.T.contiguous()
    rc = r[obs.col]
    _phase(rc, obs.J[obs.col], obs.I[obs.col], T, Wt, obs.col_len, p, 1.0)
    r[obs.col] = rc
    _phase(r, obs.I, obs.J, Wt, T, obs.row_len, p, None)
    W.copy_(Wt.T)


def fit(inputs, config, preset, random_state, device, precision='float64'):
    """The fit of ``inputs = (pairs, ratings)``: ``dict(W, T, sweeps,
    predict, truth)``."""
    p = Precision(precision)
    n, d, k = int(config['n']), int(config['d']), int(config['k'])
    obs = Observed(*inputs, n, d, device)
    W, H = nndsvd(obs, k, random_state, p)
    T = normalize_rows(H).clamp_min(0).to(p.dtype)
    W = W.clamp_min(0).to(p.dtype)
    x = obs.x.to(p.dtype)

    def residual():
        return x - _predicted(obs.I, obs.J, W, T, p)

    q = obs.nnz
    pick = torch.as_tensor(np.random.RandomState(0).permutation(q)[
        :int(math.ceil(0.05 * q))], device=device)
    Iv, Jv, xv = obs.I[pick], obs.J[pick], obs.x[pick]

    def predict(W, T):
        """The clipped predictions of the sampled pairs, in float64."""
        W, T = W.to(device, torch.float64), T.to(device, torch.float64)
        return _predicted(Iv, Jv, W, T, Precision('float64')).clamp(
            obs.lo, obs.hi)

    eps_stop = float(preset.get('eps_stop', 1e-4))
    objs = []
    r = residual()
    for _ in range(int(preset['max_iter'])):
        sweep(obs, W, T, r, p)
        r = residual()
        objs.append(0.5 * float((r.double() ** 2).sum()))
        if len(objs) > 1 and abs(objs[-1] - objs[-2]) <= eps_stop * abs(
                objs[0] - objs[1]):
            break
    return dict(W=W, T=T, sweeps=len(objs), predict=predict, truth=xv)


def sweep_counts(config, preset, inputs):
    """``(ops, bytes)`` a sweep needs over the ratings of ``inputs =
    (pairs, ratings)``, in phase order: per topic and phase a pass over
    the ratings (value and index, the segment pointers) with a
    numerator, a curvature and a rank-one residual update (2·nnz each),
    the factors read and written once a pass, and once a sweep the
    objective (3·nnz)."""
    n, d, k = int(config['n']), int(config['d']), int(config['k'])
    nnz = len(inputs[1])
    ops = 2 * k * 6 * nnz + 3 * nnz
    nbytes = k * (2 * nnz * 8 + (n + 1) * 4 + (d + 1) * 4
                  + 2 * (n * k + k * d) * 4)
    return ops, nbytes


def gram_panels(k, n, d, itemsize=4, budget=GRAM_BUDGET_BYTES):
    """The program's Γ/Θ split at rank k on an (n, d) mask: the rows of
    each launch of one contraction, ``[k(k+1)/2]`` (whole, its unique
    rows) where the whole (k², n + d) tensors fit ``budget``, else the
    p·k rows of each k-panel, the last one shorter."""
    unit = k * float(n + d) * itemsize
    if k * unit <= budget:
        return [k * (k + 1) // 2]
    p = max(1, int(min(k - 1, budget // max(unit, 1.0))))
    return [min(p, k - t0) * k for t0 in range(0, k, p)]


def gram_counts(rows, m, ncols, nnz, k, itemsize=4):
    """``(ops, bytes)`` of one Gram-kernel launch (``csrc/gram.cu``):
    ``rows`` Khatri-Rao rows of an (m, k) factor contracted with a mask
    of ``nnz`` observations into ``ncols`` output columns. Operations:
    ``2·rows·nnz`` (a product and a sum per observation and row).
    Bytes, each once: the factor's rows (k rounded up to whole 32-byte
    tiles), the layout (a 4-byte index and a value per observation, the
    column pointers) and the output."""
    ti = 32 // itemsize
    kp = -(-k // ti) * ti
    return (2 * rows * nnz,
            m * kp * itemsize + nnz * (4 + itemsize) + (ncols + 1) * 4
            + rows * ncols * itemsize)
