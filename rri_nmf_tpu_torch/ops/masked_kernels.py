"""Masked dense WRRI sweep: two hand-written CUDA streaming kernels.

Counterpart of :mod:`rri_nmf_tpu.ops.sweep_pallas`. The masked (weighted)
problem ``min 0.5 ||M ⊙ (X - WT)||²`` has per-coordinate curvatures, so
each topic's T row and W column come from reductions over the masked
residual ``M ⊙ R``. The sweep keeps ``R = X - WT`` (rebuilt with one
GEMM at the start of every sweep, which bounds float drift to one sweep)
and updates it with rank-one corrections; per topic it makes two fused
streaming passes over R and M:

- **B3** (``csrc/masked.cu``, wrapper :func:`phase_a`), the T-phase: the
  pending rank-one update ``R += dw·t_prevᵀ`` left by the previous
  topic's W-phase, then the column sums ``wR0 = wᵀ(M⊙R)`` and
  ``nw = (w²)ᵀM``.
- **B4** (wrapper :func:`phase_b`), the W-phase: ``R += w·t_oldᵀ −
  w_eff·t_newᵀ``, then the row sums ``(M⊙R)·t_new`` and ``M·t_new²``.
  The fixed-T sweep (the RS estimator's transform) runs B4 alone, with
  ``w_eff = 0``.

Each wrapper updates R in place, like the Pallas kernels that alias it,
and writes its two sums into ``out`` when given: the sweep allocates
them once per sweep, so a topic's launch allocates nothing.
A CPU tensor goes to the plain PyTorch twin (:func:`phase_a_ref`,
:func:`phase_b_ref`, which update their CPU R the same way); a CUDA tensor
launches the kernel, or the wrapper raises. ``LAUNCHES`` counts kernel
launches.

**16-bit storage** (``dtype=torch.bfloat16`` or ``float16``): R, M, X and
the factors are stored in 16 bits and the kernels' sums are float32, as
the JAX package's ``_acc_of`` has them. The elementwise steps round to 16
bits where JAX computes in 16 bits (each product and sum of the rank-one
updates, ``M ⊙ R``, ``w²``), and each such product enters its float32 sum
exactly. The twins do the same: torch's 16-bit elementwise ops round per
op, and their sums widen the rounded terms. On the card both kernels take
a 16-byte form (8 values a lane a load) where d % 8 == 0 and the operands
are 16-byte aligned, else their scalar forms (``csrc/masked.cu``).

Unlike the TPU kernels nothing is padded, so the ``row_ok``/``col_ok``
masks and ``_pick_tiles`` have no counterpart: no coordinate outside
(n, d) exists, so a negative L1 regularizer cannot give phantom mass to
one.

**On a mesh** (``cfg.mesh``; :mod:`rri_nmf_tpu_torch.parallel.
sharded_masked`) the same topic loop runs on this rank's blocks of X, M
and R: B3's two (d_loc,) sums are summed over ``dp`` and B4's two
(n_loc,) sums over ``tp``, each pair in one all-reduce, and the T solve's
l1 norm over ``tp`` where it is read. The rank-one residual updates stay
local.
"""

import functools

import torch

from rri_nmf_tpu_torch.matrixops import (_proj_simplex_core,
                                         reproject_row_if_drifted)
from rri_nmf_tpu_torch.optimization import (qf_min_vector_c,
                                            qf_min_vector_c_sharded)
from rri_nmf_tpu_torch.ops._build import check_operands, launch
from rri_nmf_tpu_torch.ops.quantized import work_dtype
from rri_nmf_tpu_torch.ops.sweep import make_reset_rowcol, precision_scope

# Kernel launches per wrapper since the last reset_launches(). A wrapper
# adds one right after its kernel launched, and nowhere else.
LAUNCHES = {'phase_a': 0, 'phase_b': 0}

# B3's decomposition, as csrc/masked.cu has it (A_TILE, A_WARPS): rows in
# tiles of B3_TILE, dealt to B3_WARPS warps a block; the cluster of
# blocks that owns a column stripe has at most B3_MAX_CLUSTER blocks and
# is sized for about B3_BLOCKS blocks in all, two on each of an H100's
# 132 SMs (at 6040×3952 in 16 bits the cap leaves 16 stripes × 8 = 128).
B3_TILE = 32
B3_WARPS = 8
B3_MAX_CLUSTER = 8
B3_BLOCKS = 264


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def phase_a_layout(n, d, itemsize):
    """B3's launch geometry for an (n, d) problem of ``itemsize``-byte
    words: ``(stripes, cluster, ranges)``. A stripe is 32 lanes × 16
    bytes of columns (128 float32, 64 float64, 256 in 16 bits) and is
    owned by one
    cluster of ``cluster`` blocks; ``ranges[r]`` is the ``(start, stop)``
    of the rows cluster rank r sums (whole tiles of ``B3_TILE`` rows;
    empty when the rows run out first). A function of the shape alone,
    so the order of every sum is fixed."""
    stripes = -(-d // (32 * (16 // itemsize)))
    cluster = max(1, min(B3_MAX_CLUSTER, -(-B3_BLOCKS // stripes)))
    tiles = -(-n // B3_TILE)
    rows = -(-tiles // cluster) * B3_TILE        # rows a rank, whole tiles
    ranges = tuple((min(n, r * rows), min(n, (r + 1) * rows))
                   for r in range(cluster))
    return stripes, cluster, ranges


def supports_masked_kernels(cfg):
    """Whether the masked sweep covers ``cfg`` (the gate of
    :func:`rri_nmf_tpu.ops.sweep_pallas.supports_pallas`): a dense mask,
    no resets except in a fixed-T sweep, no gradient stores, no DP
    noise, W free."""
    return (cfg.masked
            and not cfg.masked_sparse
            and (cfg.reset_topic_method is None or cfg.fix_T)
            and not cfg.store_gradients
            and cfg.dp_sigma is None
            and not cfg.fix_W)


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------

def phase_a_ref(R, M, dw, t_prev, w):
    """Plain version of B3: ``R += dw·t_prevᵀ`` in place, then returns
    ``(wᵀ(M⊙R), (w²)ᵀM)``, each (d,), in its work dtype (float32 for 16
    bits)."""
    R += dw[:, None] * t_prev[None, :]
    a = work_dtype(R.dtype)
    return w.to(a) @ (M * R).to(a), (w * w).to(a) @ M.to(a)


def phase_b_ref(R, M, w, w_eff, t_old, t_new):
    """Plain version of B4: ``R += w·t_oldᵀ − w_eff·t_newᵀ`` in place,
    then returns ``((M⊙R)·t_new, M·t_new²)``, each (n,), in
    its work dtype (float32 for 16 bits)."""
    R += w[:, None] * t_old[None, :]
    R -= w_eff[:, None] * t_new[None, :]
    a = work_dtype(R.dtype)
    return (M * R).to(a) @ t_new.to(a), M.to(a) @ (t_new * t_new).to(a)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _into(out, sums):
    """The twin's sums, copied into ``out`` when given (the CPU path of a
    wrapper called with ``out=``)."""
    if out is None:
        return sums
    for o, s in zip(out, sums):
        o.copy_(s)
    return out


def _check_sums(R, sums):
    """The two sum outputs: contiguous, in the work dtype of R's dtype
    (:func:`~rri_nmf_tpu_torch.ops.quantized.work_dtype`), on R's
    device."""
    first = next(iter(sums.values()))[0]
    if first.dtype != work_dtype(R.dtype) or first.device != R.device:
        raise ValueError('the sums must be %s on %s, got %s on %s' % (
            work_dtype(R.dtype), R.device, first.dtype, first.device))
    check_operands(first, sums)


def phase_a(R, M, dw, t_prev, w, out=None):
    """B3 (see :func:`phase_a_ref`): updates ``R`` in place and returns
    ``(wR0, nw)``, written into ``out`` (a pair of (d,) tensors) when
    given, so a caller may allocate them once. A CPU ``R`` runs the plain
    twin; a CUDA ``R`` launches ``csrc/masked.cu`` once, with every
    operand a contiguous tensor of ``R``'s dtype on its device (the sums
    in its work dtype)."""
    if R.device.type == 'cpu':
        return _into(out, phase_a_ref(R, M, dw, t_prev, w))
    n, d = R.shape
    if out is None:
        out = (torch.empty(d, dtype=work_dtype(R.dtype), device=R.device),
               torch.empty(d, dtype=work_dtype(R.dtype), device=R.device))
    wR0, nw = out
    check_operands(R, {'R': (R, (n, d)), 'M': (M, (n, d)),
                       'dw': (dw, (n,)), 't_prev': (t_prev, (d,)),
                       'w': (w, (n,))})
    _check_sums(R, {'wR0': (wR0, (d,)), 'nw': (nw, (d,))})
    cluster = phase_a_layout(n, d, R.element_size())[1]
    launch('rri_masked_phase_a', R, R.data_ptr(), M.data_ptr(),
           dw.data_ptr(), t_prev.data_ptr(), w.data_ptr(), wR0.data_ptr(),
           nw.data_ptr(), n, d, cluster)
    LAUNCHES['phase_a'] += 1
    return out


def phase_b(R, M, w, w_eff, t_old, t_new, out=None):
    """B4 (see :func:`phase_b_ref`): updates ``R`` in place and returns
    ``(Rt0, mt2)``, written into ``out`` (a pair of (n,) tensors) when
    given. A CPU ``R`` runs the plain twin; a CUDA ``R`` launches
    ``csrc/masked.cu``."""
    if R.device.type == 'cpu':
        return _into(out, phase_b_ref(R, M, w, w_eff, t_old, t_new))
    n, d = R.shape
    if out is None:
        out = (torch.empty(n, dtype=work_dtype(R.dtype), device=R.device),
               torch.empty(n, dtype=work_dtype(R.dtype), device=R.device))
    Rt, mt2 = out
    check_operands(R, {'R': (R, (n, d)), 'M': (M, (n, d)),
                       'w': (w, (n,)), 'w_eff': (w_eff, (n,)),
                       't_old': (t_old, (d,)), 't_new': (t_new, (d,))})
    _check_sums(R, {'Rt': (Rt, (n,)), 'mt2': (mt2, (n,))})
    launch('rri_masked_phase_b', R, R.data_ptr(), M.data_ptr(),
           w.data_ptr(), w_eff.data_ptr(), t_old.data_ptr(),
           t_new.data_ptr(), Rt.data_ptr(), mt2.data_ptr(), n, d)
    LAUNCHES['phase_b'] += 1
    return out


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def make_masked_sweep(cfg):
    """Build ``sweep(X, W, T, M, draws, resets_left, w_row_sum_vec=None)
    -> (W, T, resets_left)``: one masked WRRI sweep in the reference's
    interleaved topic order (T row, then W column, per topic), for a
    config :func:`supports_masked_kernels` accepts. The counterpart of
    :func:`rri_nmf_tpu.ops.sweep_pallas.make_masked_sweep_pallas`.

    ``X``, ``M`` (n, d), ``W`` (n, k) and ``T`` (k, d) are tensors of one
    dtype on one device; the inputs are not modified. ``draws``
    (:class:`rri_nmf_tpu_torch.ops.sweep.GeneratorDraws`) gives the
    random numbers of the resets of a fixed-T sweep and ``resets_left``
    (an int) their remaining budget. ``w_row_sum_vec``
    (n,) is the per-row W bound when ``cfg.w_row_sum_is_vector``.

    With ``cfg.mesh`` the arrays are this rank's blocks and the config
    one that :func:`rri_nmf_tpu_torch.parallel.sharded_masked.
    supports_sharded_masked` accepts (see the module docstring)."""
    mesh = cfg.mesh
    if mesh is None:
        ok = supports_masked_kernels(cfg)
    else:
        from rri_nmf_tpu_torch.parallel.sharded_masked import \
            supports_sharded_masked
        ok = supports_sharded_masked(cfg)
    if not ok:
        raise ValueError('config not supported by the masked kernels')
    k = cfg.k
    reset_fn = (make_reset_rowcol(cfg)
                if cfg.reset_topic_method is not None else None)
    # the collectives (an axis of one rank makes none; no mesh, no call);
    # the T solve's norm is summed only where the rescale or the scale
    # transfer reads it
    sum_dp = mesh.sum_dp if mesh is not None else None
    sum_tp = mesh.sum_tp if mesh is not None else None
    t_total = (sum_tp if cfg.scale_transfer or cfg.t_update_s is not None
               else None)

    def sweep(X, W, T, M, draws, resets_left, w_row_sum_vec=None):
        n, d = X.shape
        dtype = W.dtype
        acc = work_dtype(dtype)
        ub_w = (w_row_sum_vec.reshape(-1).to(dtype)
                if cfg.w_row_sum_is_vector else cfg.w_row_sum)
        # the factors as lists of contiguous rows: a topic's update binds
        # a new tensor in its slot, so the inputs are never written
        cols = list(W.T.contiguous().unbind(0))     # W[:, t], each (n,)
        rows = list(T.contiguous().unbind(0))       # T[t], each (d,)
        with precision_scope(cfg.matmul_precision):
            R = X - W @ T       # fresh residual each sweep bounds drift
        pend_dw = torch.zeros(n, dtype=dtype, device=X.device)
        pend_t = torch.zeros(d, dtype=dtype, device=X.device)
        # the kernels' outputs, written anew by every topic (each topic
        # reads them before the next launch, and keeps nothing of them);
        # each phase's pair is one buffer, so one all-reduce sums both
        a_buf = torch.empty(2, d, dtype=acc, device=X.device)
        b_buf = torch.empty(2, n, dtype=acc, device=X.device)
        a_out, b_out = a_buf.unbind(0), b_buf.unbind(0)

        for t in range(k):
            w = cols[t]
            if cfg.fix_T:
                # W-phase only: B4 applies the previous topic's deferred
                # update (w_eff = 0 leaves the T side alone)
                Rt0, mt2 = phase_b(R, M, pend_dw, torch.zeros_like(w),
                                   pend_t, rows[t], out=b_out)
                if sum_tp is not None:
                    sum_tp(b_buf)
                w_eff = w
            else:
                # ---- T-phase: one pass (pending update + reductions)
                wR0, nw = phase_a(R, M, pend_dw, pend_t, w, out=a_out)
                if sum_dp is not None:
                    sum_dp(a_buf)
                wR = torch.addcmul(wR0, rows[t].to(acc), nw)  # rank-one
                # restore
                t_new, nt1 = qf_min_vector_c_sharded(
                    cfg.reg_t_l1 - wR,
                    nw + cfg.reg_t_l2 if cfg.reg_t_l2 else nw,
                    s=cfg.t_update_s, ub=cfg.t_row_sum, total=t_total)
                t_old = rows[t]
                # scale transfer: the reference's W[:, t] *= nt1 is
                # overwritten by the W-phase below, so only the residual
                # sees it, through w_eff
                w_eff = w * nt1.to(dtype) if cfg.scale_transfer else w
                # the stored row (16 bits: rounded once), re-projected
                t_new = t_new.to(dtype)
                if cfg.project_T_each_iter and cfg.t_row_sum:
                    t_new = reproject_row_if_drifted(t_new, cfg.t_row_sum)
                rows[t] = t_new
                # ---- W-phase: one pass (T update + reductions) with the
                # stored row, so R tracks T exactly
                Rt0, mt2 = phase_b(R, M, w, w_eff, t_old, t_new,
                                   out=b_out)
                if sum_tp is not None:
                    sum_tp(b_buf)
            Rt = torch.addcmul(Rt0, w_eff.to(acc), mt2)  # rank-one restore
            w_new, _ = qf_min_vector_c(
                cfg.reg_w_l1 - Rt, mt2 + cfg.reg_w_l2 if cfg.reg_w_l2
                else mt2, s=None, ub=ub_w)
            w_new = w_new.to(dtype)
            cols[t] = w_new
            # this topic's W update is deferred into the next topic's pass
            pend_dw = w_eff - w_new
            pend_t = rows[t]

            if (reset_fn is not None and resets_left > 0
                    and not bool(w_new.sum() > 1e-10)):
                # a dead column (fixed-T sweeps only): reset it on the
                # unmasked X, W and T (JAX's reset_fn(Xp[:n, :d], ...)),
                # rebuild R and drop the deferred update, as the JAX sweep
                # does
                rows[t], cols[t] = reset_fn(X, torch.stack(cols, 1),
                                            torch.stack(rows), t, draws)
                resets_left -= 1
                with precision_scope(cfg.matmul_precision):
                    R = X - torch.stack(cols, 1) @ torch.stack(rows)
                pend_dw = torch.zeros_like(pend_dw)
                pend_t = torch.zeros_like(pend_t)

        W = torch.stack(cols, 1)
        # per-iteration W row projection (reference nmf.py:481-484); W's
        # rows are this rank's own on a mesh
        if (cfg.project_W_each_iter
                and (cfg.w_row_sum is not None or cfg.w_row_sum_is_vector)):
            W = _proj_simplex_core(W, ub_w)
        return W, torch.stack(rows), resets_left

    return sweep
