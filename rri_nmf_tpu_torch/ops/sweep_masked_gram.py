"""The Gram-phase sweep of the sparse-mask WRRI path.

Counterpart of :mod:`rri_nmf_tpu.ops.sweep_masked_gram`. In phase order
(all T rows, then all W columns; no scale transfer, no resets) the other
factor is frozen for a whole phase, so every per-topic masked quantity
factors through two weighted Gram tensors built once per phase:

    Γ[t, s] = (w_t ⊙ w_s)ᵀ M   ∈ R^d        (T-phase, (k, k, d))
    Θ[t, s] = M (t_t ⊙ t_s)    ∈ R^n        (W-phase, (k, k, n))

and, with A = Wᵀ(M⊙X) (k, d) and C = (M⊙X)Tᵀ (k, n), the Gauss-Seidel
topic ``t`` reads ``A[t] − Σ_{s≠t} Γ[t, s] ⊙ T[s]`` over ``Γ[t, t]``
(the W side likewise from C and Θ), with the current, partly updated
factor. All O(nnz) work is four contractions per sweep: A and C with a
k-row factor stack, Γ and Θ with the k(k+1)/2 unique Khatri-Rao rows
``w_t ⊙ w_s`` (t ≤ s; Γ and Θ are symmetric in (t, s)).

Two backends, as in JAX:

- ``'mxu'`` runs the four contractions on the gather kernel that
  serves B5 (``csrc/sparse.cu``, :func:`rri_nmf_tpu_torch.ops.
  sparse_kernels.gather_contract`, counted under ``LAUNCHES['mxu']``):
  one output-column layout per direction, derived from the MASK's B5
  plan, with M⊙X as a second value set on the same nonzeros (A and C);
  one launch per contraction. The default on a card; on the CPU the
  kernel's plain twin runs.
- ``'segsum'`` computes them with gathers and ``index_add_`` over slices
  of the observations: the CPU default and the oracle.

Past :data:`GRAM_BUDGET_BYTES` of Γ and Θ the sweep takes them in
(p, k, ·) panels (:func:`auto_panel`), which run the same Gauss-Seidel
updates. JAX's SMEM split of large plans and its barriers that order the
panels have no meaning here: a whole direction is one launch, and eager
torch builds one panel at a time.

The objective factors through the same tensors::

    ‖√M ⊙ (X − WT)‖² = Σ m x² − 2 Σ_t w_tᵀ C[t] + Σ_{t,s} w_tᵀ Θ[t,s] w_s
"""

from functools import lru_cache

import numpy as np
import torch

from rri_nmf_tpu_torch.matrixops import (_proj_simplex_core, fit_device,
                                         reproject_row_if_drifted)
from rri_nmf_tpu_torch.optimization import qf_min_vector_c
from rri_nmf_tpu_torch.ops import sparse_kernels
from rri_nmf_tpu_torch.ops.sparse_plan import (TILE, ContractPlan,
                                               _plan_direction_np,
                                               layout_values, numpy_dtype)
from rri_nmf_tpu_torch.ops.sweep import precision_scope, resolve_mixed_dtypes
from rri_nmf_tpu_torch.ops.sweep_masked_sparse import (coo_plan,
                                                       masked_coo_host_arrays)

# full-tensor Γ/Θ budget (JAX's memory policy): past it, k-panels
GRAM_BUDGET_BYTES = 4e9
# observation slice of the segsum backend's O(nnz·k²) temporaries
_SEG_CHUNK = 1 << 16


class MaskedGramPlan(object):
    """The observed set for the Gram-phase sweep
    (:class:`rri_nmf_tpu.ops.sweep_masked_gram.MaskedGramPlan`).

    ``coo``: the :class:`~rri_nmf_tpu_torch.ops.sweep_masked_sparse.
    MaskedCOOPlan` (the segsum backend's input and the pickle form).
    With ``backend='mxu'``: ``m_t``/``m_w``, the mask's B5
    :class:`~rri_nmf_tpu_torch.ops.sparse_plan.ContractPlan` of each
    direction (Γ: contracted over rows, output columns; Θ: the
    transpose), and ``mx_t_vals``/``mx_w_vals``, M⊙X in the same plans'
    slots (1, nslots). ``sum_mx2``: ``Σ m x²`` (a 0-d tensor, at least
    float32)."""

    def __init__(self, coo, m_t, m_w, mx_t_vals, mx_w_vals, sum_mx2, shape,
                 nnz, group, backend):
        self.coo = coo
        self.m_t = m_t
        self.m_w = m_w
        self.mx_t_vals = mx_t_vals
        self.mx_w_vals = mx_w_vals
        self.sum_mx2 = sum_mx2
        self.shape = (int(shape[0]), int(shape[1]))
        self.nnz = int(nnz)
        self.group = int(group)
        self.backend = backend
        self._mx = {}

    def mx_layout_values(self, direction):
        """M⊙X in the order of the mask layout of ``direction`` (``'t'``
        or ``'w'``), mapped once and kept."""
        if direction not in self._mx:
            plan, vals = ((self.m_t, self.mx_t_vals) if direction == 't'
                          else (self.m_w, self.mx_w_vals))
            self._mx[direction] = layout_values(plan, vals)
        return self._mx[direction]

    def to_scipy(self):
        return self.coo.to_scipy()


def plan_masked_gram(X, W_mat, dtype, backend=None, group=8, device=None):
    """The :class:`MaskedGramPlan` of the mask ``W_mat`` and ``X``
    (:func:`rri_nmf_tpu.ops.sweep_masked_gram.plan_masked_gram`), built on
    the host once and copied to ``device`` (default: X's device for a
    tensor, else the card). ``backend=None`` picks ``'mxu'`` on a CUDA
    device and ``'segsum'`` on the CPU, as JAX picks ``'mxu'`` only on a
    TPU. The two directions' B5 plans of the mask carry M⊙X in the same
    slots (``_plan_direction_np``'s second value set)."""
    device = fit_device(X, device)
    if backend is None:
        backend = 'mxu' if device.type == 'cuda' else 'segsum'
    if backend not in ('mxu', 'segsum'):
        raise ValueError("backend must be 'mxu' or 'segsum', got %r"
                         % (backend,))
    dtype = numpy_dtype(dtype)
    rows_h, cols_h, x_np, m_np, shape, nz = masked_coo_host_arrays(
        X, W_mat, dtype)
    coo = coo_plan(rows_h, cols_h, x_np, m_np, shape, nz, device)
    # padding entries carry m = x = 0
    sum_mx2 = torch.tensor(np.float64(m_np).dot(np.float64(x_np) ** 2),
                           dtype=torch.promote_types(
                               torch.from_numpy(np.zeros(0, dtype)).dtype,
                               torch.float32), device=device)
    if backend == 'segsum':
        return MaskedGramPlan(coo, None, None, None, None, sum_mx2, shape,
                              nz, group, 'segsum')
    n, d = shape
    rows, cols = rows_h[:nz], cols_h[:nz]
    m = m_np[:nz]
    mx = (m * x_np[:nz]).astype(dtype, copy=False)
    m = m.astype(dtype, copy=False)

    def direction(g, s, ngt, nst):
        v, gl, sl, ft, ot, mask, v2 = _plan_direction_np(
            g, s, m, ngt, nst, TILE, group, dtype, extra=mx)
        arrays = dict(vals=v, gloc=gl, sloc=sl, ftile=ft, otile=ot,
                      mask=mask)
        plan = ContractPlan(ngt, **{key: torch.from_numpy(
            np.ascontiguousarray(a)).to(device) for key, a in
            arrays.items()})
        return plan, torch.from_numpy(v2).to(device)

    n_rt, n_ct = -(-n // TILE), -(-d // TILE)
    m_t, mx_t = direction(rows, cols, n_rt, n_ct)
    m_w, mx_w = direction(cols, rows, n_ct, n_rt)
    return MaskedGramPlan(coo, m_t, m_w, mx_t, mx_w, sum_mx2, shape, nz,
                          group, 'mxu')


def auto_panel(k, n, d, itemsize, budget=None):
    """The Γ/Θ tiling at rank k (:func:`rri_nmf_tpu.ops.sweep_masked_gram.
    auto_panel` without its TPU compile cap, ``VMEM_GRAM_ROWS``): None
    when the full (k², n + d) tensors fit ``budget`` (default
    :data:`GRAM_BUDGET_BYTES`, read at call time); a panel size
    ``1 <= p < k`` when (p·k, n + d) tiles do; 0 when not even one
    panel row does."""
    if budget is None:
        budget = GRAM_BUDGET_BYTES
    unit = k * float(n + d) * itemsize
    if k * unit <= budget:
        return None
    return int(min(k - 1, budget // max(unit, 1.0)))


def supports_masked_gram(cfg):
    """Whether the Gram-phase sweep covers ``cfg`` (the JAX gate): the
    sparse-mask mode in phase order, no resets, no gradient stores (DP
    noise and ``inner_reps`` included)."""
    return (cfg.masked and cfg.masked_sparse
            and cfg.update_order == 'phase'
            and cfg.reset_topic_method is None
            and not cfg.store_gradients)


@lru_cache(maxsize=32)
def _sym_pairs(k):
    """``(idx_t, idx_s, unpack)``: the k(k+1)/2 unique pairs t ≤ s and,
    at ``t·k + s``, the pair row of ``(min(t, s), max(t, s))`` (numpy)."""
    idx_t, idx_s = np.triu_indices(k)
    pair_of = np.zeros((k, k), np.int64)
    pair_of[idx_t, idx_s] = np.arange(idx_t.size)
    pair_of[idx_s, idx_t] = pair_of[idx_t, idx_s]
    return idx_t, idx_s, pair_of.reshape(-1)


def _pairs_on(k, device):
    return tuple(torch.as_tensor(a, dtype=torch.long, device=device)
                 for a in _sym_pairs(k))


# ---------------------------------------------------------------------------
# contraction backends: (plan, factor, acc) -> A/C, (Γ or Θ)
# ---------------------------------------------------------------------------

def _contract(plan, direction, Ft, rows, ncols, mx=False):
    """``out (rows, ncols)``: the mask (or with ``mx`` M⊙X) contracted
    with Fᵀ's rows ``Ft`` in one gather-kernel launch (its twin on the
    CPU)."""
    p = plan.m_t if direction == 't' else plan.m_w
    vals = plan.mx_layout_values(direction) if mx else None
    return sparse_kernels.gather_contract(p, Ft, rows, ncols, 'mxu', vals)


def _mxu_gram_t_A(plan, W, acc):
    """A = Wᵀ(M⊙X) (k, d): W itself is Fᵀ."""
    return _contract(plan, 't', W.to(acc), W.shape[1], plan.shape[1],
                     mx=True)


def _mxu_gram_t_panel(plan, W, t0, p, acc):
    """Γ[t0:t0+p] (p, k, d) from the p·k rows ``w_t ⊙ w_s``."""
    n, d = plan.shape
    k = W.shape[1]
    Wa = W.to(acc)
    KR = (Wa[:, t0:t0 + p, None] * Wa[:, None, :]).reshape(n, p * k)
    return _contract(plan, 't', KR, p * k, d).reshape(p, k, d)


def _mxu_gram_w_C(plan, T, acc):
    """C = (M⊙X)Tᵀ (k, n): Tᵀ is Fᵀ."""
    return _contract(plan, 'w', T.to(acc).T, T.shape[0], plan.shape[0],
                     mx=True)


def _mxu_gram_w_panel(plan, T, t0, p, acc):
    """Θ[t0:t0+p] (p, k, n) from the p·k rows ``t_t ⊙ t_s``."""
    n, d = plan.shape
    k = T.shape[0]
    Tt = T.to(acc).T
    KRt = (Tt[:, t0:t0 + p, None] * Tt[:, None, :]).reshape(d, p * k)
    return _contract(plan, 'w', KRt, p * k, n).reshape(p, k, n)


def _mxu_gram_t(plan, W, acc):
    """(A, Γ) from the frozen W; Γ from its k(k+1)/2 unique rows."""
    n, d = plan.shape
    k = W.shape[1]
    Wa = W.to(acc)
    A = _contract(plan, 't', Wa, k, d, mx=True)
    it, is_, unpack = _pairs_on(k, W.device)
    Gp = _contract(plan, 't', Wa[:, it] * Wa[:, is_], it.shape[0], d)
    return A, Gp[unpack].reshape(k, k, d)


def _mxu_gram_w(plan, T, acc):
    """(C, Θ) from the frozen T, Θ as Γ."""
    n, d = plan.shape
    k = T.shape[0]
    Tt = T.to(acc).T.contiguous()
    C = _contract(plan, 'w', Tt, k, n, mx=True)
    it, is_, unpack = _pairs_on(k, T.device)
    Hp = _contract(plan, 'w', Tt[:, it] * Tt[:, is_], it.shape[0], n)
    return C, Hp[unpack].reshape(k, k, n)


def _seg_chunked(coo, fn, out_dim, seg_ids, width, acc):
    """``out (out_dim, width)``: ``fn(rows, cols, m, x) -> (slice,
    width)`` over slices of :data:`_SEG_CHUNK` observations, added by
    ``seg_ids`` (padding entries carry m = 0)."""
    nnz = coo.rows.shape[0]
    out = torch.zeros(out_dim, width, dtype=acc, device=coo.rows.device)
    for a in range(0, nnz, _SEG_CHUNK):
        b = min(a + _SEG_CHUNK, nnz)
        out.index_add_(0, seg_ids[a:b],
                       fn(coo.rows[a:b], coo.cols[a:b],
                          coo.m_vals[a:b].to(acc), coo.x_vals[a:b].to(acc)))
    return out


def _seg_gram_t_A(plan, W, acc):
    Wa = W.to(acc)
    coo = plan.coo
    return _seg_chunked(coo, lambda r, c, m, x: Wa[r] * (m * x)[:, None],
                        plan.shape[1], coo.cols, W.shape[1], acc).T


def _seg_gram_t_panel(plan, W, t0, p, acc):
    Wa = W.to(acc)
    k = W.shape[1]
    d = plan.shape[1]
    coo = plan.coo

    def vals(r, c, m, x):
        P = Wa[r]
        KR = (P[:, t0:t0 + p, None] * P[:, None, :]).reshape(-1, p * k)
        return KR * m[:, None]
    return _seg_chunked(coo, vals, d, coo.cols, p * k, acc).T.reshape(p, k, d)


def _seg_gram_w_C(plan, T, acc):
    Tt = T.to(acc).T
    coo = plan.coo
    return _seg_chunked(coo, lambda r, c, m, x: Tt[c] * (m * x)[:, None],
                        plan.shape[0], coo.rows, T.shape[0], acc).T


def _seg_gram_w_panel(plan, T, t0, p, acc):
    Tt = T.to(acc).T
    k = T.shape[0]
    n = plan.shape[0]
    coo = plan.coo

    def vals(r, c, m, x):
        P = Tt[c]
        KR = (P[:, t0:t0 + p, None] * P[:, None, :]).reshape(-1, p * k)
        return KR * m[:, None]
    return _seg_chunked(coo, vals, n, coo.rows, p * k, acc).T.reshape(p, k, n)


def _seg_gram(plan, F, acc, side):
    """(A, Γ) (``side='t'``, F = W) or (C, Θ) (``'w'``, F = Tᵀ): the k
    numerator columns and the k² Gram columns in one pass."""
    coo = plan.coo
    k = F.shape[1]
    out_dim = plan.shape[1] if side == 't' else plan.shape[0]
    seg = coo.cols if side == 't' else coo.rows

    def vals(r, c, m, x):
        P = F[r] if side == 't' else F[c]
        outer = (P[:, :, None] * P[:, None, :]).reshape(-1, k * k)
        return torch.cat([P * (m * x)[:, None], outer * m[:, None]], 1)
    out = _seg_chunked(coo, vals, out_dim, seg, k + k * k, acc)
    return out[:, :k].T, out[:, k:].T.reshape(k, k, out_dim)


def _seg_gram_t(plan, W, acc):
    return _seg_gram(plan, W.to(acc), acc, 't')


def _seg_gram_w(plan, T, acc):
    return _seg_gram(plan, T.to(acc).T, acc, 'w')


_BACKENDS = {
    'mxu': (_mxu_gram_t, _mxu_gram_w, _mxu_gram_t_A, _mxu_gram_t_panel,
            _mxu_gram_w_C, _mxu_gram_w_panel),
    'segsum': (_seg_gram_t, _seg_gram_w, _seg_gram_t_A, _seg_gram_t_panel,
               _seg_gram_w_C, _seg_gram_w_panel),
}


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

class MaskedGramSweep(object):
    """The Gram-phase sweep (:func:`rri_nmf_tpu.ops.sweep_masked_gram.
    make_masked_gram_sweep`) for a config :func:`supports_masked_gram`
    accepts::

        sweep(plan, W, T, draws, resets_left[, w_row_sum_vec])
            -> (W, T, resets_left)

    ``resets_left`` passes through (no resets here); ``draws`` gives the
    DP noise. ``panel`` (1 <= panel < k) builds Γ/Θ in (panel, k, ·)
    tiles: the same updates in the same order, at ``panel·k·max(n, d)``
    words of Gram memory. The inputs are not written. It is not a CUDA
    graph: its gather-kernel launches are counted by their wrapper."""

    def __init__(self, cfg, backend='segsum', panel=None):
        if not supports_masked_gram(cfg):
            raise ValueError('config not supported by the Gram-phase masked '
                             'sweep')
        if panel is not None and not 1 <= panel < cfg.k:
            raise ValueError('panel must satisfy 1 <= panel < k')
        if backend not in _BACKENDS:
            raise ValueError("backend must be 'mxu' or 'segsum', got %r"
                             % (backend,))
        self.cfg = cfg
        self.backend = backend
        self.panel = panel

    def __call__(self, plan, W, T, draws, resets_left, *extras):
        if plan.backend != self.backend:
            raise ValueError('a %r plan for a %r sweep' % (plan.backend,
                                                          self.backend))
        with precision_scope(self.cfg.matmul_precision):
            W, T = self._body(plan, W, T, draws, extras)
        return W, T, resets_left

    def _body(self, plan, W, T, draws, extras):
        cfg = self.cfg
        k = cfg.k
        (gram_t, gram_w, gram_A, gram_t_panel, gram_C,
         gram_w_panel) = _BACKENDS[self.backend]
        wrs = extras[0].reshape(-1) if cfg.w_row_sum_is_vector else None
        ub_w = wrs if cfg.w_row_sum_is_vector else cfg.w_row_sum
        _, acc, _ = resolve_mixed_dtypes(W.dtype, W.dtype)
        # the factors are copied, never written: row t of Wt is W[:, t]
        Wt = W.T.to(acc).contiguous()
        T = T.to(acc).clone(memory_format=torch.contiguous_format)
        proj_t = bool(cfg.t_row_sum and cfg.project_T_each_iter)
        panels = [(t0, min(self.panel, k - t0))
                  for t0 in range(0, k, self.panel)] if self.panel else None

        def t_topic(t, Gt, A):
            """T row t from Gt = Γ[t] (k, d), the current T."""
            wR = A[t] - ((Gt * T).sum(0) - Gt[t] * T[t])
            nw = Gt[t]
            if cfg.dp_sigma is not None:
                # Gaussian mechanism (reference nmf.py:422-435), drawn per
                # topic in phase order
                z1, z2 = draws.normal(wR, nw.shape)
                wR = wR + cfg.dp_sigma * z1
                nw = (nw + cfg.dp_sigma * z2).clamp_min(0.0)
            t_new, _ = qf_min_vector_c(-(wR - cfg.reg_t_l1),
                                       nw + cfg.reg_t_l2, s=cfg.t_update_s,
                                       ub=cfg.t_row_sum)
            if proj_t:
                t_new = reproject_row_if_drifted(t_new, cfg.t_row_sum)
            T[t] = t_new

        def w_topic(t, Ht, C):
            """W column t from Ht = Θ[t] (k, n), the current W."""
            Rt = C[t] - ((Ht * Wt).sum(0) - Ht[t] * Wt[t])
            nt = Ht[t]
            Wt[t] = qf_min_vector_c(-(Rt - cfg.reg_w_l1), nt + cfg.reg_w_l2,
                                    s=None, ub=ub_w)[0]

        # ---- T-phase: W frozen, A and Γ exact for the whole phase ----
        if not cfg.fix_T:
            W_fro = Wt.T
            if panels is None:
                A, G = gram_t(plan, W_fro, acc)
                for i in range(cfg.inner_reps * k):
                    t = i % k
                    t_topic(t, G[t], A)
                del G
            else:
                A = gram_A(plan, W_fro, acc)
                for _ in range(cfg.inner_reps):
                    for t0, p in panels:
                        Gp = gram_t_panel(plan, W_fro, t0, p, acc)
                        for j in range(p):
                            t_topic(t0 + j, Gp[j], A)
                        del Gp

        # ---- W-phase: T frozen, C and Θ exact ----
        if not cfg.fix_W:
            if panels is None:
                C, H = gram_w(plan, T, acc)
                for i in range(cfg.inner_reps * k):
                    t = i % k
                    w_topic(t, H[t], C)
                del H
            else:
                C = gram_C(plan, T, acc)
                for _ in range(cfg.inner_reps):
                    for t0, p in panels:
                        Hp = gram_w_panel(plan, T, t0, p, acc)
                        for j in range(p):
                            w_topic(t0 + j, Hp[j], C)
                        del Hp

        W = Wt.T.contiguous()
        # per-iteration W row projection (reference nmf.py:481-484)
        if (cfg.project_W_each_iter and not cfg.fix_W
                and (cfg.w_row_sum is not None or cfg.w_row_sum_is_vector)):
            W = _proj_simplex_core(W, wrs if cfg.w_row_sum_is_vector
                                   else float(cfg.w_row_sum))
        return W, T


def make_masked_gram_sweep(cfg, backend='segsum', panel=None):
    """The :class:`MaskedGramSweep` for ``cfg``."""
    return MaskedGramSweep(cfg, backend, panel)


def make_masked_gram_objective(backend='segsum', reg_w_l2=0.0, reg_t_l2=0.0,
                               reg_w_l1=0.0, reg_t_l1=0.0, panel=None):
    """``objective(plan, W, T)`` through the Gram identity
    (:func:`rri_nmf_tpu.ops.sweep_masked_gram.make_masked_gram_objective`):
    ``0.5 (Σ m x² − 2·cross + quad)`` plus the regularizers, from one C
    and one Θ contraction (Θ in (panel, k, n) tiles with ``panel``). In
    float32 the three terms cancel: the result is good to about float32
    eps times ``Σ m x²``."""
    (_, gram_w, _, _, gram_C, gram_w_panel) = _BACKENDS[backend]

    def objective(plan, W, T):
        _, acc, _ = resolve_mixed_dtypes(W.dtype, W.dtype)
        Wa = W.to(acc)
        Ta = T.to(acc)
        if panel is None:
            C, H = gram_w(plan, Ta, acc)
            cross = (C * Wa.T).sum()
            quad = torch.einsum('tsi,it,is->', H, Wa, Wa)
        else:
            C = gram_C(plan, Ta, acc)
            cross = (C * Wa.T).sum()
            quad = torch.zeros((), dtype=acc, device=W.device)
            for t0 in range(0, Ta.shape[0], panel):
                p = min(panel, Ta.shape[0] - t0)
                Hp = gram_w_panel(plan, Ta, t0, p, acc)
                quad = quad + torch.einsum('tsi,it,is->', Hp,
                                           Wa[:, t0:t0 + p], Wa)
        obj = 0.5 * (plan.sum_mx2.to(acc) - 2.0 * cross + quad)
        obj = obj + 0.5 * reg_w_l2 * (Wa ** 2).sum()
        obj = obj + 0.5 * reg_t_l2 * (Ta ** 2).sum()
        obj = obj + reg_t_l1 * Ta.abs().sum()
        obj = obj + reg_w_l1 * Wa.abs().sum()
        return obj

    return objective
