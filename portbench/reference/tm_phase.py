"""Plain reference of the topic-model estimator's fast recipe
(``update_order='phase'``, no resets): each sweep updates every T row,
then every W column, Gauss-Seidel over the topics from the Grams and the
numerators formed once a phase.

- T phase: ``G = WᵀW``, ``N = WᵀX``; per topic
  ``v = N[t] − G[t]T + G[t,t]T[t]``, the row the simplex projection of
  ``[v]₊ / (G[t,t] + eps)`` (all mass on the largest ``v`` when
  ``G[t,t] = 0``), projected again if its sum is off by more than 1e-15;
- W phase: ``G = TTᵀ``, ``N = TXᵀ``; per topic
  ``v = N[t] − G[t]Wᵀ + G[t,t]W[:, t]``, the column ``[v]₊ / (G[t,t] +
  eps)`` (when ``G[t,t] = 0``: 1 where ``v > G[t,t]``, else 0);
- at the end W's rows projected onto the simplex.

No scale transfer in this order. The start is the default fit's
(:func:`portbench.reference.tm_interleaved.init`).
"""

import torch

from portbench.reference.plain import EPS, Precision, proj_simplex_rows
from portbench.reference.tm_interleaved import dense, init


def sweep(X, W, T, p):
    """One phase-order sweep; returns ``(W, T)``. ``X`` is ``(csr, csr
    of Xᵀ)``."""
    Xs, Xts = X
    k = W.shape[1]
    G = p.mm(W.T, W)
    N = p.spmm(Xts, W).T
    pos = (G.diagonal() > 0).tolist()
    for t in range(k):
        v = N[t] - p.mm(G[t], T) + G[t, t] * T[t]
        if pos[t]:
            row = proj_simplex_rows((v.clamp_min(0) / (G[t, t] + EPS))[None],
                                    1.0)[0]
        else:
            row = torch.zeros_like(v)
            row[int(torch.argmax(v))] = 1.0
        off = (row.sum() - 1.0).abs() > 1e-15
        T[t] = torch.where(off, proj_simplex_rows(row[None], 1.0)[0], row)
    G = p.mm(T, T.T)
    N = p.spmm(Xs, T.T).T
    F = W.T.contiguous()
    for t in range(k):
        v = N[t] - p.mm(G[t], F) + G[t, t] * F[t]
        F[t] = torch.where(G[t, t] > 0, v.clamp_min(0) / (G[t, t] + EPS),
                           torch.where(G[t, t] - v < 0, 1.0, 0.0))
    return F.T.contiguous(), T


def fit(inputs, config, preset, random_state, device, precision='float64'):
    """The fit of ``inputs = (X,)`` (scipy CSR): ``dict(W, T, sweeps)``."""
    p = Precision(precision)
    k = int(config['k'])
    W, T = init(dense(inputs[0], torch.float64, device), k, random_state)
    X = (p.sparse(inputs[0], device), p.sparse(inputs[0].T, device))
    W, T = W.to(p.dtype), T.to(p.dtype)
    sweeps = int(preset['max_iter'])
    for _ in range(sweeps):
        W, T = sweep(X, W, T, p)
    return dict(W=proj_simplex_rows(W, 1.0), T=T, sweeps=sweeps)


def sweep_counts(config, preset, inputs):
    """``(ops, bytes)`` a sweep needs: two passes over the nonzeros of
    ``inputs = (X,)`` (WᵀX and TXᵀ: value, column index, row pointers) and over
    the factors (read and written once a pass); the two contractions
    (2·nnz·k each), the two Grams (2·k²·(n + d)) and the Gauss-Seidel
    passes over both panels (2·k²·(n + d))."""
    n, d, k = int(config['n']), int(config['d']), int(config['k'])
    nnz = int(inputs[0].nnz)
    ops = 4 * nnz * k + 4 * k * k * (n + d)
    nbytes = 2 * (nnz * 8 + (n + 1) * 4 + 2 * (n * k + k * d) * 4)
    return ops, nbytes
