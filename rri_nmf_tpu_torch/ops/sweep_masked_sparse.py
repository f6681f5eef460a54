"""The sparse-mask WRRI sweep: masked WRRI on the observed entries only.

Counterpart of :mod:`rri_nmf_tpu.ops.sweep_masked_sparse`. A scipy-sparse
(or torch sparse) ``W_mat`` keeps the observed set as a sorted COO list
end to end: O(nnz) memory, where the dense-mask sweep
(:mod:`rri_nmf_tpu_torch.ops.masked_kernels`) streams (n, d) arrays. Per
Ho's Lemma 6.5 every per-topic quantity is an observed-entry
contraction:

    numer_T = wᵀ(M⊙R) + t ⊙ nw,   nw = (w²)ᵀ M
    numer_W = (M⊙R) t + w ⊙ nt,   nt = M t²

With the masked residual ``r = m ⊙ (x − (W T)_obs)`` carried as an
(nnz,) vector (refreshed from the factors once per sweep), a topic costs
two gathers of a factor at the observed rows or columns, four segment
sums (keyed by column for the T side, by row for the W side) and two
rank-one patches of ``r``. JAX runs no TPU kernel here, and neither does
the port: these are plain torch gathers and ``torch.segment_reduce``
over the plan's segments, the row-major order's row offsets and a
stable column permutation with its column offsets. No sum goes through
atomics: each segment adds its entries in one fixed order, so a sweep
repeats bit for bit on the card too. (This sweep carries a rounding
difference far into the factors: on an H100 an ``index_add_`` with
atomics moved the objective of one sweep at 25M observations by ~0.2%
from run to run.)

The sweep runs as :class:`rri_nmf_tpu_torch.ops.sweep.Sweep` does:
speculatively, with no reset firing and no host read (one CUDA graph on
the card), checked once after the sweep, and re-run eagerly, with JAX's
reset semantics, only when a topic died with ``'random'`` budget left. A
reset draws a fresh topic and patches the carried residual in O(nnz).

On a ``(dp, 1)`` mesh (``cfg.mesh``, :mod:`rri_nmf_tpu_torch.parallel.
masked_sparse_mesh`) the plan holds this rank's row block of
observations (local rows, global columns) and W its rows; T is whole on
every rank. The two column-keyed sums of a topic's T-phase go into one
all-reduce of a (2, d) buffer over ``dp``, and the T row is solved the
same on every rank; the W-phase and the residual are row-keyed and stay
local. A (1, 1) mesh makes no call.
"""

import numpy as np
import torch

from rri_nmf_tpu_torch.matrixops import (_proj_simplex_core, fit_device,
                                         reproject_row_if_drifted)
from rri_nmf_tpu_torch.optimization import qf_min_vector_c
from rri_nmf_tpu_torch.ops.sparse_plan import (coo_segments, host_coo,
                                               numpy_dtype)
from rri_nmf_tpu_torch.ops.sweep import (ALIVE, Sweep, _dead_topics,
                                         make_reset_rowcol, mesh_sums,
                                         precision_scope,
                                         resolve_mixed_dtypes)

# nnz padding quantum (JAX's): padding entries carry m = x = 0 and add
# exactly 0 to every contraction
_PAD_TO = 512
# the largest (nnz, k) gather temporary of the predicted-entries pass,
# and the slice of observations it takes past that
GATHER_BUDGET = 2 << 30
CHUNK = 1 << 18


class MaskedCOOPlan(object):
    """The observed set as sorted COO tensors on one device
    (:class:`rri_nmf_tpu.ops.sweep_masked_sparse.MaskedCOOPlan`).

    ``rows``/``cols`` (nnz_pad,) int32 and ``x_vals``/``m_vals`` (nnz_pad,)
    in the fit's dtype, row-major; padding entries at the tail on the
    last row and the last column with ``x = m = 0``. ``shape`` is (n, d),
    ``nnz`` the number of real observations. The segments of the sums,
    derived on the plan's device: ``row_ptr`` (n+1,), row i's entries
    are ``row_ptr[i]:row_ptr[i+1]``; ``col_order`` (nnz_pad,) int64, the
    entries stably sorted by column, and ``col_ptr`` (d+1,) its column
    offsets (:func:`~rri_nmf_tpu_torch.ops.sparse_plan.coo_segments`).
    The sweep takes the plan where the dense sweeps take X: it
    has X's ``shape``, ``is_cuda`` and ``data_ptr``."""

    def __init__(self, rows, cols, x_vals, m_vals, shape, nnz):
        self.rows = rows
        self.cols = cols
        self.x_vals = x_vals
        self.m_vals = m_vals
        self.shape = (int(shape[0]), int(shape[1]))
        self.nnz = int(nnz)
        self.row_ptr, self.col_order, self.col_ptr = coo_segments(
            rows, cols, self.shape)

    @property
    def device(self):
        return self.rows.device

    @property
    def is_cuda(self):
        return self.rows.is_cuda

    def data_ptr(self):
        return self.rows.data_ptr()

    def to_scipy(self):
        """``(W_mat, X)`` as scipy COO matrices, padding dropped."""
        import scipy.sparse as sp
        nz = self.nnz
        r = self.rows[:nz].cpu().numpy()
        c = self.cols[:nz].cpu().numpy()
        M = sp.coo_matrix((self.m_vals[:nz].cpu().numpy(), (r, c)),
                          shape=self.shape)
        X = sp.coo_matrix((self.x_vals[:nz].cpu().numpy(), (r, c)),
                          shape=self.shape)
        return M, X

    def host_arrays(self):
        """``(rows, cols, x, m)`` as numpy arrays (the pickle form)."""
        return tuple(a.cpu().numpy() for a in (self.rows, self.cols,
                                               self.x_vals, self.m_vals))


def host_sparse(A):
    """``A`` on the host: a torch sparse tensor as a scipy COO matrix, a
    dense tensor as a numpy array, anything else as it is."""
    if not isinstance(A, torch.Tensor):
        return A
    if A.layout in (torch.sparse_coo, torch.sparse_csr):
        import scipy.sparse as sp
        rows, cols, vals, shape = host_coo(A)
        return sp.coo_matrix((vals, (rows, cols)), shape=shape)
    return A.detach().cpu().numpy()


def masked_coo_host_arrays(X, W_mat, dtype):
    """The observed set on the host, ``(rows, cols, x, m, shape, nnz)``
    (:func:`rri_nmf_tpu.ops.sweep_masked_sparse.masked_coo_host_arrays`,
    line for line, so the arrays match bit for bit): the mask's nonzeros
    (explicit zeros dropped, duplicates summed) in row-major order, X's
    values there, padded to :data:`_PAD_TO` entries on the last row and
    column with ``x = m = 0``. ``W_mat`` and ``X`` may be scipy-sparse,
    torch sparse or dense (X); ``dtype`` the values' (torch or numpy)."""
    dtype = numpy_dtype(dtype)
    X = host_sparse(X)
    Mc = host_sparse(W_mat).tocsr()
    Mc.eliminate_zeros()
    Mc.sum_duplicates()
    M = Mc.tocoo()   # csr->coo is row-major sorted
    rows = M.row.astype(np.int32)
    cols = M.col.astype(np.int32)
    m = np.asarray(M.data, dtype=dtype)
    if hasattr(X, 'tocsr'):
        Xc = X.tocsr()
        Xc.sum_duplicates()
        if (Xc.indptr.shape == Mc.indptr.shape
                and np.array_equal(Xc.indptr, Mc.indptr)
                and np.array_equal(Xc.indices, Mc.indices)):
            # X and the mask share their pattern (both built from the same
            # triples): the CSR values already lie in the COO order
            x = np.asarray(Xc.data, dtype=dtype)
        else:
            x = np.asarray(Xc[rows, cols]).ravel().astype(dtype)
    else:
        x = np.asarray(X)[rows, cols].astype(dtype)
    nnz = rows.shape[0]
    pad = (-nnz) % _PAD_TO
    if pad:
        # the last row and column keep the row stream sorted
        pr = rows[-1] if nnz else np.int32(max(X.shape[0] - 1, 0))
        pc = np.int32(max(X.shape[1] - 1, 0))
        rows = np.pad(rows, (0, pad), constant_values=pr)
        cols = np.pad(cols, (0, pad), constant_values=pc)
        x = np.pad(x, (0, pad))
        m = np.pad(m, (0, pad))
    return rows, cols, x, m, (int(X.shape[0]), int(X.shape[1])), int(nnz)


def coo_plan(rows, cols, x, m, shape, nnz, device):
    """A :class:`MaskedCOOPlan` of host arrays, copied to ``device``."""
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return MaskedCOOPlan(dev(rows), dev(cols), dev(x), dev(m), shape, nnz)


def plan_masked_coo(X, W_mat, dtype, device=None):
    """The :class:`MaskedCOOPlan` of the mask ``W_mat`` and ``X``'s values
    at its nonzeros (:func:`rri_nmf_tpu.ops.sweep_masked_sparse.
    plan_masked_coo`), on ``device`` (default: X's device for a tensor,
    else the card). X never has to exist dense: a sparse X with values
    on (a superset of) the mask's pattern does."""
    device = fit_device(X, device)
    return coo_plan(*masked_coo_host_arrays(X, W_mat, dtype), device)


def supports_masked_sparse(cfg):
    """Whether the O(nnz) sweep covers ``cfg`` (the JAX gate): the
    sparse-mask mode in the interleaved order, resets off or
    ``'random'``, no gradient stores."""
    return (cfg.masked and cfg.masked_sparse
            and cfg.update_order == 'interleaved'
            and cfg.reset_topic_method in (None, 'random')
            and not cfg.store_gradients)


def _predicted_obs(rows, cols, W, Tt, chunk=CHUNK, budget=GATHER_BUDGET):
    """``(W T)`` at the observed coordinates, (nnz_pad,): one gather of
    W's rows and Tᵀ's rows per observation, in slices of ``chunk``
    observations when the whole (nnz, k) temporary would pass ``budget``
    bytes (the slices are fixed by the shapes: no host read)."""
    nnz = rows.shape[0]
    k = W.shape[1]
    if nnz * k * W.element_size() <= budget:
        return (W[rows] * Tt[cols]).sum(1)
    out = torch.empty(nnz, dtype=W.dtype, device=W.device)
    for a in range(0, nnz, chunk):
        b = min(a + chunk, nnz)
        out[a:b] = (W[rows[a:b]] * Tt[cols[a:b]]).sum(1)
    return out


def _masked_sparse_body(cfg, reset_rowcol, plan, W, T, draws, resets,
                        extras):
    """One O(nnz) sweep: ``(W, T, dead)``, ``dead`` as in
    :func:`rri_nmf_tpu_torch.ops.sweep._sweep_body`. The inputs are not
    written."""
    k = cfg.k
    method = cfg.reset_topic_method
    wrs = extras[0].reshape(-1) if cfg.w_row_sum_is_vector else None
    ub_w = wrs if cfg.w_row_sum_is_vector else cfg.w_row_sum
    _, acc, _ = resolve_mixed_dtypes(W.dtype, W.dtype)
    n, d = plan.shape
    rows, cols = plan.rows, plan.cols
    x = plan.x_vals.to(acc)
    m = plan.m_vals.to(acc)
    # the factors are copied, never written: row t of Wt is W[:, t]
    Wt = W.T.to(acc).contiguous()
    T = T.to(acc).clone(memory_format=torch.contiguous_format)
    l1t, l2t, l1w, l2w = (cfg.reg_t_l1, cfg.reg_t_l2, cfg.reg_w_l1,
                          cfg.reg_w_l2)
    proj_t = bool(cfg.t_row_sum and cfg.project_T_each_iter)

    def seg_cols(data):
        return torch.segment_reduce(data[plan.col_order], 'sum',
                                    offsets=plan.col_ptr, unsafe=True)

    def seg_rows(data):
        return torch.segment_reduce(data, 'sum', offsets=plan.row_ptr,
                                    unsafe=True)

    def sum_dp(x):
        # a mesh's sum of the T-phase's column-keyed partials
        return x if cfg.mesh is None else cfg.mesh.sum_dp(x)

    # the masked residual at the observed entries, fresh every sweep
    r = m * (x - _predicted_obs(rows, cols, Wt.T, T.T.contiguous()))

    def check(t, alive_vec):
        """The 'random' reset (reference nmf.py:750-816): a dead row or
        column with budget left draws a fresh topic, and the carried
        residual is patched by the rank-one difference, O(nnz)."""
        nonlocal r
        if method is None or not resets(lambda: alive_vec.sum() > ALIVE):
            return
        t_pre, w_pre = T[t].clone(), Wt[t].clone()
        row, col = reset_rowcol(plan, Wt.T, T, t, draws)
        Wt[t] = col
        T[t] = row
        r = r + m * (w_pre[rows] * t_pre[cols] - Wt[t][rows] * T[t][cols])

    for t in range(k):
        # ---- T-phase (reference nmf.py:687-714, O(nnz) form) ----
        if not cfg.fix_T:
            wr = Wt[t][rows]
            # (w²)ᵀM and wᵀ(M⊙R), (d,) each: one all-reduce on a mesh
            nw, wR = sum_dp(torch.stack([seg_cols(wr * wr * m),
                                         seg_cols(wr * r)]))
            wR = wR + T[t] * nw
            if cfg.dp_sigma is not None:
                # Gaussian mechanism (reference nmf.py:422-435)
                z1, z2 = draws.normal(wR, nw.shape)
                wR = wR + cfg.dp_sigma * z1
                nw = (nw + cfg.dp_sigma * z2).clamp_min(0.0)
            t_new, nt1 = qf_min_vector_c(-(wR - l1t), nw + l2t,
                                         s=cfg.t_update_s, ub=cfg.t_row_sum)
            t_old = T[t].clone()
            wr_eff = wr
            if cfg.scale_transfer:
                Wt[t] *= nt1
                wr_eff = wr * nt1
            if proj_t:
                # the drift re-projection hoisted before the residual
                # update, so r tracks T exactly
                t_new = reproject_row_if_drifted(
                    t_new, cfg.t_row_sum,
                    extra_pred=(t_new.sum() > ALIVE
                                if method is not None else None))
            T[t] = t_new
            r = r + m * (wr * t_old[cols] - wr_eff * T[t][cols])
            check(t, T[t])

        # ---- W-phase (reference nmf.py:735-746, O(nnz) form) ----
        if not cfg.fix_W:
            tc = T[t][cols]
            nt = seg_rows(tc * tc * m)                            # (n,)
            w_old = Wt[t].clone()
            Rt = seg_rows(r * tc) + w_old * nt                    # (n,)
            w_new, _ = qf_min_vector_c(-(Rt - l1w), nt + l2w, s=None,
                                       ub=ub_w)
            Wt[t] = w_new
            r = r + m * ((w_old - w_new)[rows] * tc)
            check(t, Wt[t])

    dead = None
    if method is not None and not resets.eager and resets.budget > 0:
        dead = _dead_topics(Wt, T, not cfg.fix_T, not cfg.fix_W)
    W = Wt.T.contiguous()
    # per-iteration W row projection (reference nmf.py:481-484)
    if (cfg.project_W_each_iter and not cfg.fix_W
            and (cfg.w_row_sum is not None or cfg.w_row_sum_is_vector)):
        W = _proj_simplex_core(W, wrs if cfg.w_row_sum_is_vector
                               else float(cfg.w_row_sum))
    return W, T, dead


class MaskedSparseSweep(Sweep):
    """The O(nnz) sweep for a config :func:`supports_masked_sparse`
    accepts (:func:`rri_nmf_tpu.ops.sweep_masked_sparse.
    make_masked_sparse_sweep`)::

        sweep(plan, W, T, draws, resets_left[, w_row_sum_vec])
            -> (W, T, resets_left)

    ``plan`` a :class:`MaskedCOOPlan`; ``draws`` and ``resets_left`` as
    for :class:`rri_nmf_tpu_torch.ops.sweep.Sweep`, whose speculative
    run, single check, eager re-run and CUDA graph this sweep shares (on
    a mesh the graph only where the mesh's collectives can be captured,
    :attr:`~rri_nmf_tpu_torch.parallel.mesh.Mesh.graphable`)."""

    def __init__(self, cfg):
        if not supports_masked_sparse(cfg):
            raise ValueError('config not supported by the masked sparse '
                             'sweep')
        method = cfg.reset_topic_method
        self.cfg = cfg
        self.reset_rowcol = (make_reset_rowcol(cfg) if method is not None
                             else None)
        self.random = method == 'random' or cfg.dp_sigma is not None
        self.graphable = cfg.dp_sigma is None and (cfg.mesh is None
                                                   or cfg.mesh.graphable)
        self._graph = self._seen = None

    def _body(self, plan, W, T, draws, resets, extras):
        with precision_scope(self.cfg.matmul_precision):
            W, T, dead = _masked_sparse_body(self.cfg, self.reset_rowcol,
                                             plan, W, T, draws, resets,
                                             extras)
        return (W, T, resets.budget), dead


def make_masked_sparse_sweep(cfg):
    """The :class:`MaskedSparseSweep` for ``cfg``."""
    return MaskedSparseSweep(cfg)


def make_masked_sparse_objective(reg_w_l2=0.0, reg_t_l2=0.0, reg_w_l1=0.0,
                                 reg_t_l1=0.0, mesh=None):
    """``objective(plan, W, T)``: ``0.5 Σ_obs m·(x − (WT))²`` plus the
    four regularizers over a :class:`MaskedCOOPlan`
    (:func:`rri_nmf_tpu.ops.sweep_masked_sparse.
    make_masked_sparse_objective`); no n×d product is formed. On a
    ``(dp, 1)`` ``mesh`` the plan and W are this rank's row block and T
    is whole: the observed entries' sum and the W terms are summed over
    ``dp`` and the T terms taken once, in one all-reduce
    (:func:`~rri_nmf_tpu_torch.ops.sweep.mesh_sums`)."""

    def objective(plan, W, T):
        _, acc, _ = resolve_mixed_dtypes(W.dtype, W.dtype)
        Wa = W.to(acc)
        Ta = T.to(acc)
        pred = _predicted_obs(plan.rows, plan.cols, Wa, Ta.T.contiguous())
        res = plan.x_vals.to(acc) - pred
        total, (w2, w1), (t2, t1) = mesh_sums(
            mesh, (plan.m_vals.to(acc) * res * res).sum(),
            ((Wa ** 2).sum(), Wa.abs().sum()),
            ((Ta ** 2).sum(), Ta.abs().sum()))
        obj = 0.5 * total
        obj = obj + 0.5 * reg_w_l2 * w2
        obj = obj + 0.5 * reg_t_l2 * t2
        obj = obj + reg_t_l1 * t1
        obj = obj + reg_w_l1 * w1
        return obj

    return objective
