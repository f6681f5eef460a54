"""Per-topic quadratic subproblem solver and stopping conditions.

Counterpart of :mod:`rri_nmf_tpu.optimization`: ``qf_min`` solves

    min_{0 <= x <= ub, sum(x) = s}  w^T x + 0.5 x^T diag(c) x

in closed form, with the reference's branch semantics
(``optimization.py:42-88``) kept branch by branch:

- scalar ``c > 0``: ``x = [-w]_+ / (c + eps)``; the returned norm is the
  pre-projection l1 norm; simplex-project only when ``s`` is given; ``ub``
  is NOT enforced on this branch;
- scalar ``c <= 0``: vertex solution — with ``s`` all mass on the first
  ``argmin(w)``; without it, coordinates with ``w + c < 0`` saturate at
  ``ub``; the returned norm is 1.0;
- vector ``c``: ``[-w]_+ / c`` on the ``c > 0`` coordinates, clip to
  ``ub``, rescale (guarded against a zero sum) to ``s``.

The scalar branches are the per-topic update the dense kernels run
(:mod:`rri_nmf_tpu_torch.ops.dense_kernels`). Both curvature branches are
computed and selected with ``torch.where``, so a device ``c`` needs no
host round trip.

Besides: the host-side oracles :func:`kkt_qf_min` and
:func:`optimize_scipy` (NumPy and SciPy, as in the JAX package),
:func:`projected_gradient_norm` and the stopping conditions.
"""

import numpy as np
import torch

from rri_nmf_tpu_torch.matrixops import (EPS_DIV_BY_ZERO, _proj_simplex_core,
                                         as_tensor)


def _normalize_ub(s, ub):
    """Reference ``optimization.py:43-49``: reconcile sum and upper bounds
    (static numbers or None; truthiness gates, like the reference)."""
    if s:
        if ub:
            return min(ub, s)
        return s
    return ub


def _ub_eff(s, ub, like):
    if ub is None or np.isscalar(ub):
        return _normalize_ub(s, ub)
    ub = as_tensor(ub, device=like.device, dtype=like.dtype).reshape(-1)
    return ub.clamp_max(s) if s else ub


def qf_min_scalar_free(numer, c, ub, zeros=None, norm=True):
    """``qf_min_scalar_c(-numer, c, None, ub)``: the scalar-curvature
    subproblem without a sum constraint, taking the negated linear term
    ``numer`` (what the sweeps compute) and ``c`` a 0-d tensor.

    ``[numer]₊ / (c + eps)`` where ``c > 0``; else ``ub`` (inf when None)
    on the coordinates where ``numer > c`` (that is ``w + c < 0``), 0
    elsewhere. The per-topic sweeps call it twice a topic, so it makes
    few launches: ``zeros`` (a zero vector shaped as ``numer``) may be
    passed in, and ``norm=False`` skips the norm. Returns ``(x, nx)``, or
    ``x`` without ``norm``."""
    pos = c > 0
    x_pos = numer.clamp_min(0.0).div_(c + EPS_DIV_BY_ZERO)
    if zeros is None:
        zeros = torch.zeros_like(numer)
    x = torch.where(pos, x_pos, torch.where(
        numer > c, float('inf') if ub is None else ub, zeros))
    if not norm:
        return x
    return x, torch.where(pos, x_pos.sum(), 1.0)


def qf_min_scalar_c(w, c, s, ub):
    """qf_min for a scalar curvature ``c`` (a number or 0-d tensor).

    ``s`` is a number or None; ``ub`` a number, None or a per-coordinate
    vector. Returns ``(x, nx)`` with the reference's norm contract."""
    c = torch.as_tensor(c, dtype=w.dtype, device=w.device)
    ub_eff = _ub_eff(s, ub, w)
    if s is None:
        return qf_min_scalar_free(-w, c, ub_eff)

    x_pos = (-w).clamp_min(0.0) / (c + EPS_DIV_BY_ZERO)
    nx_pos = x_pos.sum()
    x_pos = _proj_simplex_core(x_pos, s)
    # the vertex is scattered: indexing by a 0-d tensor would read it on
    # the host
    x_neg = torch.zeros_like(w).scatter_(
        0, torch.argmin(w).reshape(1), float(s))
    pos = c > 0
    return torch.where(pos, x_pos, x_neg), torch.where(pos, nx_pos, 1.0)


def qf_min_vector_c(w, c, s, ub):
    """qf_min for a per-coordinate curvature ``c`` (WRRI path, reference
    ``optimization.py:75-88``)."""
    return qf_min_vector_c_sharded(w, c, s, ub, None)


def qf_min_vector_c_sharded(w, c, s, ub, total):
    """:func:`qf_min_vector_c` on one rank's block of a solution split
    over a mesh axis: ``total`` sums the block's l1 norm over that axis
    (``Mesh.sum_tp``, say), so the rescale to ``s`` and the returned norm
    are the whole vector's (:func:`rri_nmf_tpu.parallel.sharded_pallas.
    _qf_min_vector_psum`). ``total=None`` is the single-device function,
    bit for bit."""
    ub_eff = _ub_eff(s, ub, w)
    pos = c > 0
    denom_safe = torch.where(pos, c, 1.0) + EPS_DIV_BY_ZERO
    x = torch.where(pos, (-w).clamp_min(0.0) / denom_safe, 0.0)
    if isinstance(ub_eff, torch.Tensor):
        x = torch.minimum(x, ub_eff)
    elif ub_eff is not None:
        # a number bounds in place: a scalar tensor made on the card would
        # be a host-to-device copy, which waits for the stream
        x = x.clamp_max(ub_eff)
    nx = x.sum()
    if total is not None:
        nx = total(nx)
    if s is not None:
        x = torch.where(nx > 0, s * x / torch.where(nx > 0, nx, 1.0), x)
    return x, nx


def qf_min(w, c, s=1.0, ub=1.0, x0=None):
    """Minimize ``w^T x + 0.5 x^T diag(c) x`` over ``{0 <= x <= ub,
    sum x = s}``; returns ``(x, nx)``, ``nx`` the l1 norm of ``x`` before
    the final projection/rescale (the reference's contract,
    ``optimization.py:12-88``). Raises ``ValueError`` for unbounded
    configurations and ``NotImplementedError`` for a concave objective
    whose sum constraint meets a binding upper bound, like
    :func:`rri_nmf_tpu.optimization.qf_min`."""
    w = as_tensor(w)
    d = w.numel()
    _ub_vec = ub is not None and not np.isscalar(ub)
    ub_full = (np.broadcast_to(np.asarray(ub, dtype=float).reshape(-1),
                               (d,)) if _ub_vec else None)
    if s and ub is not None:
        cap = (float(np.sum(np.minimum(ub_full, s))) if _ub_vec
               else d * min(float(ub), s))
        if cap < s:
            raise ValueError('Impossible to satisfy sum and upper bound '
                             'constraints.')

    if np.isscalar(c) or np.ndim(c) == 0:
        c = float(c)
        if c <= 0 and s is None and ub is None:
            raise ValueError(
                'Minimum objective is unbounded. w={w}, c={c}, s={s}, ub={ub}'
                .format(w=w, c=c, s=s, ub=ub))
        if c <= 0 and s is not None and ub is not None:
            ub_min = float(np.min(ub_full)) if _ub_vec else float(ub)
            if ub_min < s:
                raise NotImplementedError(
                    'qf_min: concave objective with a sum constraint and '
                    'binding upper bounds (ub < s) is not supported')
        return qf_min_scalar_c(w, c, s, ub)
    if np.shape(w) == tuple(np.shape(c)):
        c = as_tensor(c, device=w.device, dtype=w.dtype)
        if bool((c < 0).any()) and (s is None and ub is None):
            raise ValueError(
                'Minimum objective is unbounded. w={w}, c={c}, s={s}, ub={ub}'
                .format(w=w, c=c, s=s, ub=ub))
        return qf_min_vector_c(w, c, s, ub)
    raise ValueError('c must be a scalar or have the shape of w')


def _host_np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def kkt_qf_min(w, d, s=1.0, ub=1.0):
    """Active-set KKT solver for ``min wᵀx + xᵀdiag(d)x`` on
    ``{0 <= x <= ub, Σx = s}`` with positive per-coordinate curvature
    ``d`` (a scalar or one per coordinate); returns the optimal x as a
    float64 tensor on the CPU.

    A host-side oracle, as :func:`rri_nmf_tpu.optimization.kkt_qf_min` is
    (the reference's exploratory ``kkt_qf_min``,
    ``optimization.py:110-150``): ``x_i(λ) = clip(-(w_i + λ) / (2 d_i), 0,
    ub)`` for the multiplier λ of the sum constraint, whose ``Σ x_i(λ)``
    is piecewise linear and non-increasing in λ, so the KKT system is a
    1-D root found exactly on the breakpoint grid."""
    w = _host_np(w).astype(float)
    d = _host_np(d).astype(float)
    if np.ndim(d) == 0:
        d = np.full_like(w, float(d))
    assert np.all(d > 0), 'kkt_qf_min requires positive curvature'
    assert w.size * ub >= s - 1e-15, 'infeasible: n*ub < s'

    def x_of(lam):
        return np.clip(-(w + lam) / (2.0 * d), 0.0, ub)

    # breakpoints where coordinates hit the box faces
    bps = np.unique(np.concatenate([-w, -w - 2.0 * d * ub]))
    sums = np.array([x_of(b).sum() for b in bps])  # non-increasing in λ
    j = int(np.searchsorted(-sums, -s, side='left'))
    if j == 0:
        lam = bps[0]
    elif j >= len(bps):
        lam = bps[-1]
    else:
        lo, hi = bps[j - 1], bps[j]
        slo, shi = sums[j - 1], sums[j]
        lam = lo if slo == shi else lo + (slo - s) * (hi - lo) / (slo - shi)
    x = x_of(lam)
    # the interpolation is exact; a float residue rescales on the interior
    interior = (x > 0) & (x < ub)
    resid = s - x.sum()
    if abs(resid) > 1e-12 and interior.any():
        x[interior] += resid / interior.sum()
        x = np.clip(x, 0.0, ub)
    return torch.as_tensor(x)


def optimize_scipy(w, c, s, ub, x0=None):
    """SLSQP solver of the ``qf_min`` QP ``min wᵀx + 0.5 xᵀdiag(c)x`` on
    ``{0 <= x <= ub, Σx = s}`` (no sum constraint when ``s`` is falsy),
    a test oracle on the host (:func:`rri_nmf_tpu.optimization.
    optimize_scipy`; the reference's ``optimization.py:232-282`` with its
    missing return). Returns ``(x, ||x||_1)``, x a float64 tensor on the
    CPU; raises ``ValueError`` when the solver violates the constraints
    by more than 1e-8."""
    from scipy.optimize import minimize
    w = _host_np(w).astype(float)
    c = _host_np(c).astype(float)
    if np.ndim(c) == 0:
        c = np.full_like(w, float(c))
    bounds = [(0.0, ub)] * w.size

    def f(x):
        return float(np.sum(w * x) + 0.5 * np.sum(c * x * x))

    def jac(x):
        return w + c * x

    constraints = []
    if s:
        constraints = [{'type': 'eq', 'fun': lambda x: np.sum(x) - s,
                        'jac': lambda x: np.ones_like(x)}]
    if x0 is None:
        x0 = np.zeros_like(w)
        pos = c > 0
        x0[pos] = np.maximum(-w[pos], 0) / (c[pos] + EPS_DIV_BY_ZERO)
        if s:
            if x0.sum() > EPS_DIV_BY_ZERO:
                x0 = s * x0 / x0.sum()
            else:
                x0[np.argmin(w + c)] = min(ub, s) if ub else s
    else:
        x0 = _host_np(x0).astype(float)
    res = minimize(f, x0, bounds=bounds, jac=jac, method='SLSQP',
                   constraints=constraints, options={'maxiter': 200})
    cv = abs(np.sum(res.x) - s) if s else 0.0
    cv += float(np.clip(-res.x, 0, None).sum())
    if cv > 1e-8:
        raise ValueError('solver violated constraints by %g' % cv)
    x = np.clip(res.x, 0.0, None)
    return torch.as_tensor(x), float(np.sum(np.abs(x)))


def projected_gradient_norm(grad, vec, lb=0.0, ub=np.inf,
                            zero=EPS_DIV_BY_ZERO):
    """Squared Frobenius norm of the projected gradient (C.-J. Lin's
    stopping criterion for NMF; reference ``nmf.py:882-911``): inside the
    box a coordinate contributes its gradient, at the lower bound only a
    negative one, at the upper bound only a positive one. A 0-d tensor on
    ``grad``'s device."""
    grad = as_tensor(grad)
    vec = as_tensor(vec, device=grad.device)
    lo = lb + zero
    hi = ub - zero
    interior = (vec > lo) & (vec < hi)
    gpe = torch.where(interior, grad,
                      torch.where(vec <= lo, grad.clamp_max(0.0),
                                  grad.clamp_min(0.0)))
    return (gpe * gpe).sum()


def universal_stopping_condition(obj_history, eps_stop=1e-4):
    """Stop when the last objective change is <= ``eps_stop`` × the first
    change (reference ``optimization.py:284-291``)."""
    if len(obj_history) < 2:
        return False
    d1 = abs(obj_history[0] - obj_history[1])
    de = abs(obj_history[-1] - obj_history[-2])
    return de <= eps_stop * d1


def first_last_stopping_condition(obj_history, eps_stop=1e-4):
    """Stop when the objective has shrunk to ``eps_stop`` × its initial
    value (reference ``optimization.py:294-297``)."""
    if len(obj_history) < 2:
        return False
    return obj_history[-1] <= obj_history[0] * eps_stop
