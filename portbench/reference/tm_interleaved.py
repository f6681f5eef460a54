"""Plain reference of the topic-model estimator's default fit: rank-one
residue iteration (Ho, 2008) in the interleaved order, T rows on the
simplex, resets of dead topics to the document with the largest positive
residual, W rows projected onto the simplex at the end.

It follows the published algorithm of the reference implementation
(``rri_nmf``'s ``nmf()``: ``nmf.py:415-478, 633-816``) with the
estimator's preset: per topic t,

- T side: ``wR = (WᵀX)[t] − Tᵀ(Wᵀw)`` with topic t's own term left out,
  ``x = [wR]₊ / (‖w‖² + eps)``, the row the simplex projection of x (all
  mass on the largest ``wR`` when ``‖w‖² = 0``), and W's column t scaled
  by ``Σx`` (the scale transfer); a row summing to at most 1e-10 resets
  while the budget lasts, a row off the simplex by more than 1e-15 is
  projected again;
- W side: ``Rt = X t − W(T t)`` with t's term left out,
  ``w = [Rt]₊ / (‖t‖² + eps)`` (where ``‖t‖² = 0``: 1 where ``Rt > 0``,
  else 0); a dead column resets while the budget lasts.

A reset sets the row to the positive residual ``[X_i − W_i T]₊`` of the
document i with the largest squared one (the first such) and the column
to the indicator of i. ``(WᵀX)`` is formed once a sweep: column t of W
is unchanged until its own topic. The products with X read its nonzeros
(CSR on the device); the residual scans of a reset read X dense.
"""

import torch

from portbench.reference.plain import (EPS, Precision, nndsvd,
                                       normalize_rows, proj_simplex_rows)

ALIVE = 1e-10


def init(X, k, random_state):
    """The estimator's start: NNDSVD, T rows and W rows scaled to sum 1,
    T projected onto the simplex."""
    W, H = nndsvd(X, k, random_state)
    T = proj_simplex_rows(normalize_rows(H).clamp_min(0), 1.0)
    return normalize_rows(W).clamp_min(0), T


def _max_resid_doc(X, W, T, p, block=4096):
    best, at = -1.0, 0
    for i in range(0, X.shape[0], block):
        R = (X[i:i + block] - p.mm(W[i:i + block], T)).clamp_min(0)
        s = (R * R).sum(1)
        j = int(torch.argmax(s))
        if float(s[j]) > best:
            best, at = float(s[j]), i + j
    return at


def _reset(X, W, T, t, p):
    i = _max_resid_doc(X, W, T, p)
    T[t] = (X[i] - p.mm(W[i], T)).clamp_min(0)
    W[:, t] = 0
    W[i, t] = 1


def sweep(X, W, T, p, budget):
    """One interleaved sweep in place; returns the budget left. ``X`` is
    ``(dense, csr, csr of Xᵀ)``."""
    X, Xs, Xts = X
    k = W.shape[1]
    WX = p.spmm(Xts, W).T
    wn = (W * W).sum(0).tolist()
    for t in range(k):
        w = W[:, t]
        wW = p.mm(W.T, w)
        wW[t] = 0
        wR = WX[t] - p.mm(T.T, wW)
        if wn[t] > 0:
            x = wR.clamp_min(0) / (wn[t] + EPS)
            scale = x.sum()
            row = proj_simplex_rows(x[None], 1.0)[0]
        else:
            row = torch.zeros_like(wR)
            row[int(torch.argmax(wR))] = 1.0
            scale = 1.0
        W[:, t] *= scale
        T[t] = row
        if budget > 0 and not T[t].sum() > ALIVE:
            _reset(X, W, T, t, p)
            budget -= 1
        elif abs(float(T[t].sum()) - 1.0) > 1e-15 and T[t].sum() > ALIVE:
            T[t] = proj_simplex_rows(T[t][None], 1.0)[0]
        tr = T[t]
        Tt = p.mm(T, tr)
        Tt[t] = 0
        Rt = p.spmm(Xs, tr) - p.mm(W, Tt)
        nt = tr @ tr
        if nt > 0:
            W[:, t] = Rt.clamp_min(0) / (nt + EPS)
        else:
            W[:, t] = torch.where(Rt > nt, 1.0, 0.0).to(W.dtype)
        if budget > 0 and not W[:, t].sum() > ALIVE:
            _reset(X, W, T, t, p)
            budget -= 1
    return budget


def dense(X, dtype, device):
    """The scipy CSR input as a dense tensor."""
    A = torch.zeros(X.shape, dtype=dtype, device=device)
    coo = X.tocoo()
    A[torch.as_tensor(coo.row, device=device).long(),
      torch.as_tensor(coo.col, device=device).long()] = torch.as_tensor(
          coo.data, dtype=dtype, device=device)
    return A


def fit(inputs, config, preset, random_state, device, precision='float64'):
    """The fit of ``inputs = (X,)`` (scipy CSR): ``dict(W, T, sweeps)``."""
    p = Precision(precision)
    k = int(config['k'])
    X = dense(inputs[0], torch.float64, device)
    W, T = init(X, k, random_state)
    X = (X.to(p.dtype), p.sparse(inputs[0], device),
         p.sparse(inputs[0].T, device))
    W, T = W.to(p.dtype), T.to(p.dtype)
    budget = int(preset.get('n_resets', 23))
    sweeps = int(preset['max_iter'])
    for _ in range(sweeps):
        budget = sweep(X, W, T, p, budget)
    W = proj_simplex_rows(W, 1.0)
    return dict(W=W, T=T, sweeps=sweeps, resets_left=budget)


def sweep_counts(config, preset, inputs):
    """``(ops, bytes)`` a sweep needs: per topic a pass over the
    nonzeros of ``inputs = (X,)`` (value and column index, and the row pointers) and over the
    factors (read and written once); the operations of the two
    contractions with X (2·nnz each) and of the products with the
    factors (4·n·k + 4·k·d)."""
    n, d, k = int(config['n']), int(config['d']), int(config['k'])
    nnz = int(inputs[0].nnz)
    ops = k * (4 * nnz + 4 * n * k + 4 * k * d)
    nbytes = k * (nnz * 8 + (n + 1) * 4 + 2 * (n * k + k * d) * 4)
    return ops, nbytes
