"""The ``nmf()`` entry point.

Counterpart of :mod:`rri_nmf_tpu.nmf`, with the same signature and
defaults so one kwargs dict drives both packages. The sweep is routed as
the JAX ``nmf()`` routes it (``rri_nmf_tpu/nmf.py:1489-1596``):

- the phase order without resets, gradient stores or DP noise (the
  "fast-TM recipe") on a dense X through
  :func:`rri_nmf_tpu_torch.ops.dense_kernels.make_dense_phase_sweep`
  (torch GEMMs plus kernels B1 and B2);
- the same recipe on a sparse X (scipy, or a torch COO/CSR tensor),
  never densified, through
  :func:`rri_nmf_tpu_torch.ops.sweep_sparse.make_sparse_sweep`: the
  two numerator products by ``torch.sparse.mm`` (``sparse=True``), kernel
  B5 (``'mxu'``) or kernel B6 (``'dma'``), around B1 and B2;
- the phase order with resets (a fixed-T call such as the TM estimator's
  transform included) through
  :class:`rri_nmf_tpu_torch.ops.dense_kernels.DenseResetSweep`: the
  kernel sweep, checked once after the sweep, and the plain
  Gram-blocked sweep only when a topic died with budget left;
- masked WRRI with a dense ``W_mat`` and no resets (or ``fix_T`` with
  ``'random'``) through
  :func:`rri_nmf_tpu_torch.ops.masked_kernels.make_masked_sweep`
  (kernels B3 and B4), in the interleaved order;
- masked WRRI with a sparse ``W_mat`` (scipy, or a torch sparse tensor)
  on its observed entries only: in phase order without resets through
  the Gram-phase sweep
  :func:`rri_nmf_tpu_torch.ops.sweep_masked_gram.make_masked_gram_sweep`
  (its contractions on the gather kernel of B5 on a card), else the
  O(nnz) interleaved sweep
  :func:`rri_nmf_tpu_torch.ops.sweep_masked_sparse.
  make_masked_sparse_sweep`;
- everything else — the defaults (the interleaved order with
  ``'max_resid_document'`` resets), ``use_pallas=False``, masked fits
  with resets or ``fix_W``, DP noise and gradient stores — through the
  plain sweep :func:`rri_nmf_tpu_torch.ops.sweep.make_sweep`.

Around them: initialization, objective tracking and the
relative-progress stop, early-stop rollback, ``max_time``, grouped
dispatch, diagnostics, ``debug_checks``, the final W projection and the
result dict.

Every option outside the port so far raises ``NotImplementedError``
naming the ROADMAP item that brings it.
"""

import dataclasses
import logging
import math
import numbers
import time
import warnings

import numpy as np
import torch

from rri_nmf_tpu_torch.initialization import initialize_nmf
from rri_nmf_tpu_torch.matrixops import (as_tensor, default_float,
                                         fit_device, is_sparse, normalize,
                                         proj_mat_to_simplex, to_torch_sparse)
from rri_nmf_tpu_torch.optimization import universal_stopping_condition
from rri_nmf_tpu_torch.ops.dense_kernels import (DenseResetSweep,
                                                 make_dense_phase_sweep,
                                                 supports_dense_kernels)
from rri_nmf_tpu_torch.ops.masked_kernels import (make_masked_sweep,
                                                  supports_masked_kernels)
from rri_nmf_tpu_torch.ops.sparse_plan import (plan_sparse_matrix,
                                               plan_sparse_matrix_dma)
from rri_nmf_tpu_torch.ops.sweep import (SweepConfig, make_draws,
                                         make_objective, make_sweep)
from rri_nmf_tpu_torch.ops.sweep_masked_gram import (
    MaskedGramPlan, auto_panel, make_masked_gram_objective,
    make_masked_gram_sweep, plan_masked_gram)
from rri_nmf_tpu_torch.ops.sweep_masked_sparse import (
    coo_plan, host_sparse, make_masked_sparse_objective,
    make_masked_sparse_sweep, plan_masked_coo)
from rri_nmf_tpu_torch.ops.sweep_sparse import (TorchSparseX,
                                                make_sparse_objective,
                                                make_sparse_sweep)

# logger levels follow the reference convention (nmf.py:36-48):
# INFO — per-iteration summaries; DEBUG — objective deltas (forces
# compute_obj_each_iter)
logger = logging.getLogger(__name__)


def _size(a):
    return a.numel() if isinstance(a, torch.Tensor) else int(np.size(a))


def _not_yet(what, item):
    raise NotImplementedError(
        '%s is not ported to rri_nmf_tpu_torch yet; it arrives with '
        'ROADMAP %s' % (what, item))


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


class TrueObjComputer(object):
    """Full-objective calculator returned as ``rtv['obj_calculator']``:
    holds X, the mask ``Wm`` (None for an unmasked fit) and the current
    W/T and computes ``0.5 Σ Wm ⊙ (X - WT)²`` + regularizers.

    The residual is summed over 8192-row blocks when the whole ``W @ T``
    temporary would pass ~2 GB in the accumulator dtype (the JAX
    package's rule). With ``sparse``, X is a coalesced torch sparse COO
    tensor and the objective never forms ``W @ T``
    (:func:`rri_nmf_tpu_torch.ops.sweep_sparse.make_sparse_objective`).
    With ``masked_sparse``, X is the sparse-mask fit's plan: a
    ``'mxu'`` Gram plan evaluates through one C and one Θ contraction
    (:func:`~rri_nmf_tpu_torch.ops.sweep_masked_gram.
    make_masked_gram_objective`, Θ in panels past the Gram budget), any
    other through the observed entries (:func:`~rri_nmf_tpu_torch.ops.
    sweep_masked_sparse.make_masked_sparse_objective`).
    It pickles (the estimators carry it in their fitted state): the
    objective function is rebuilt after a load, and a sparse-mask plan
    travels as its host COO arrays and comes back as the observed-entry
    form, on W's device."""

    def __init__(self, X, W, T, reg_w_l2, reg_t_l2, reg_w_l1, reg_t_l1,
                 Wm=None, matmul_precision=None, sparse=False,
                 masked_sparse=False):
        self.X = X
        self.sparse = sparse
        self.masked_sparse = masked_sparse
        self.W = W
        self.T = T
        self.Wm = Wm
        self.reg_w_l2 = reg_w_l2
        self.reg_t_l2 = reg_t_l2
        self.reg_w_l1 = reg_w_l1
        self.reg_t_l1 = reg_t_l1
        self.matmul_precision = matmul_precision
        self.obj = np.inf
        self._fn = None

    def __getstate__(self):
        state = dict(self.__dict__)
        state['_fn'] = None      # a closure; rebuilt on the next use
        if self.masked_sparse and not isinstance(self.X, tuple):
            coo = self.X.coo if isinstance(self.X, MaskedGramPlan) \
                else self.X
            state['X'] = (('masked_coo',) + coo.host_arrays()
                          + (coo.shape, coo.nnz))
        return state

    def _masked_sparse_fn(self):
        regs = dict(reg_w_l2=self.reg_w_l2, reg_t_l2=self.reg_t_l2,
                    reg_w_l1=self.reg_w_l1, reg_t_l1=self.reg_t_l1)
        if isinstance(self.X, tuple):            # restored from a pickle
            self.X = coo_plan(*self.X[1:], device=self.W.device)
        if isinstance(self.X, MaskedGramPlan) and self.X.backend == 'mxu':
            n, d = self.X.shape
            p = auto_panel(self.W.shape[1], n, d, self.W.element_size())
            return make_masked_gram_objective(
                'mxu', panel=1 if p == 0 else p, **regs)
        fn = make_masked_sparse_objective(**regs)
        if isinstance(self.X, MaskedGramPlan):
            # a segsum Gram plan: the observed-entry form is the cheaper
            return lambda plan, W, T: fn(plan.coo, W, T)
        return fn

    def true_objective(self):
        if self._fn is None and self.masked_sparse:
            self._fn = self._masked_sparse_fn()
        if self._fn is None and self.sparse:
            self._fn = make_sparse_objective(
                reg_w_l2=self.reg_w_l2, reg_t_l2=self.reg_t_l2,
                reg_w_l1=self.reg_w_l1, reg_t_l1=self.reg_t_l1)
        if self._fn is None:
            n, d = self.X.shape
            big = n * d * self.X.element_size() > 2e9 and n > 8192
            self._fn = make_objective(
                masked=self.Wm is not None, reg_w_l2=self.reg_w_l2,
                reg_t_l2=self.reg_t_l2, reg_w_l1=self.reg_w_l1,
                reg_t_l1=self.reg_t_l1, block_rows=8192 if big else None,
                matmul_precision=self.matmul_precision)
        args = (self.X, self.W, self.T) + (
            () if self.sparse or self.masked_sparse else (self.Wm,))
        self.obj = float(self._fn(*args))
        return self.obj


def nmf(X, k, w_row=None, W_mat=None, fix_W=False, fix_T=False,
        random_state=None, init='nndsvd', T_in=[], W_in=[], max_iter=200,
        max_time=600, eps_stop=1e-4, compute_obj_each_iter=False,
        project_W_each_iter=False, w_row_sum=None,
        do_final_project_W=True, project_T_each_iter=False,
        t_row_sum=None, early_stop=None,
        reset_topic_method='max_resid_document', fix_reset_seed=False,
        n_resets=23,
        reg_w_l2=0, reg_t_l2=0, reg_w_l1=0, reg_t_l1=0,
        diagnostics=[], store_gradients=False,
        ind_rows_to_store=None, eps_gauss_t=None, delta_gauss_t=None,
        dtype=None, x_dtype=None, use_pallas=None, checkpoint=None,
        checkpoint_every=10,
        debug_checks=False, mesh=None, sweeps_per_dispatch=1,
        update_order='interleaved', sparse='auto', matmul_precision=None,
        inner_reps=1, accel=None, accel_opts=None, device=None):
    """Factorize the non-negative (n, d) ``X`` as non-negative ``W @ T``
    by rank-one residue iterations.

    Minimizes ``0.5 ||X - WT||_F^2`` (entrywise-weighted by ``W_mat``) +
    L1/L2 regularizers on both factors. Parameter names, defaults and
    meanings are those of :func:`rri_nmf_tpu.nmf.nmf`; what differs:

    - **Where it runs.** On the card unless asked otherwise. ``device``
      (the port's own argument) picks it; with ``device=None`` a torch
      tensor X fits on its own device (dense, or sparse COO/CSR) and
      numpy, scipy-sparse or list data on the card, and without a card
      that raises, naming ``device='cpu'``, which is how a caller asks
      for the CPU. float64 by default on the CPU, float32 on the card
      for host data; a tensor keeps its float dtype; ``dtype`` overrides.
      ``W_in``/``T_in`` and ``w_row_sum`` vectors may be numpy arrays or
      tensors.
    - **What it covers.** Every ``update_order`` and
      ``reset_topic_method`` (the defaults included), ``fix_W``/``fix_T``,
      the regularizers and projections, ``inner_reps``, a dense ``W_mat``
      (a numpy array or tensor of X's shape; the interleaved order,
      whichever order is asked for, the JAX rule; W initialized on
      ``W_mat * X``), ``store_gradients`` with ``ind_rows_to_store``
      (``'numer_W'``/``'denom_W'`` hold tensors), DP noise
      (``eps_gauss_t``/``delta_gauss_t``) and ``sweeps_per_dispatch``. A
      fixed-T call takes the phase order itself, as in the JAX ``nmf()``.
      A sparse ``W_mat`` (scipy, or a torch COO/CSR tensor) as in JAX;
      see **Sparse masks** below. Not ported yet, each raising
      ``NotImplementedError``: ``w_row`` (A.4), ``x_dtype`` and
      16-bit factors (A.8), ``mesh`` (A.12, sparse and sparse-mask fits
      on a mesh included), ``checkpoint`` and ``accel`` (A.9),
      ``init='nndsvd_lrc'`` and ``'coherence_pmi'`` (A.3).
    - **Sparse masks.** A sparse ``W_mat`` keeps the observed set as COO
      end to end, built on the host once per call (X dense or sparse; X
      is read only where the mask is nonzero). With
      ``update_order='phase'`` and no resets the fit runs the Gram-phase
      sweep (``sparse='mxu'`` or a card: its contractions on the gather
      kernel; the CPU default: segment sums; Γ/Θ in k-panels past 4 GB),
      else the O(nnz) interleaved sweep, a ``'phase'`` request it cannot
      honour falling back with a ``RuntimeWarning``;
      ``'max_resid_document'`` resets are turned off (``'random'`` ones
      run), ``store_gradients`` and ``sparse='dma'``/``True`` raise
      ``ValueError``, and W is initialized on ``W_mat ⊙ X``, dense below
      2 GB.
    - **Sparse X** (scipy, or a torch sparse tensor) with the phase
      recipe is never densified: ``sparse=True`` runs the two numerator
      products with ``torch.sparse.mm``, ``'mxu'`` with kernel B5 and
      ``'dma'`` with kernel B6 on a host plan of the nonzeros. The
      default ``'auto'`` engages under the JAX conditions (phase order,
      no resets, no mask, ``w_row``, DP or ``x_dtype``): on the CPU the
      ``torch.sparse`` form; on a card it densifies on the device when
      the dense form fits 45% of the card's memory, else B5. Otherwise,
      and with ``sparse=False``, X is densified on its device.
      ``sparse=True`` also takes a dense X, and forces the phase order
      without resets, as in the JAX package.
    - **use_pallas** keeps its name and means the hand-written kernels
      (:mod:`rri_nmf_tpu_torch.ops.dense_kernels`,
      :mod:`rri_nmf_tpu_torch.ops.masked_kernels`): ``None``, ``True`` and
      ``'interpret'`` all take them where they cover the config — on a
      CUDA X the CUDA kernels, on a CPU X their plain PyTorch twins.
      Where B1's or B2's gate refuses a config they cover (phase order,
      no DP noise, no gradient stores; a sparse fit whatever
      ``use_pallas``), the fit raises ``ValueError``. ``False`` takes the
      plain sweep (in phase order its Gram-blocked form).
    - **Resets** are decided without a host sync per topic: a sweep runs
      as if none fired and its factors are checked once after it; only
      when a topic died with budget left does the sweep run again,
      resetting as JAX does (:mod:`rri_nmf_tpu_torch.ops.sweep`).
      ``'max_resid_document'`` picks the same document as JAX. The
      ``'random'`` reset and the DP noise draw from a ``torch.Generator``
      on the fit's device seeded with ``random_state``: the same budget
      is spent as in the JAX package, with other random values.
    - **Initialization** of the NNDSVD family runs its randomized SVD
      with sklearn on the host for a CPU X (the reference's goldens) and
      with ``torch.linalg`` on the card for a CUDA X.
    - **matmul_precision** takes the JAX names; ``None`` keeps exact
      float32 products on the card (TF32 off).
    - **Callbacks** (``diagnostics``, a callable ``early_stop``) receive
      ``(X, W, T)``: W and T as tensors on the fit's device, a sparse X
      (and any X of a sparse-mask fit) as the user passed it, a dense X
      as a tensor on the fit's device.

    Returns the dict of the JAX ``nmf()``, with ``'W'`` (n, k) and ``'T'`` (k, d)
    as tensors on the fit's device; ``'obj_history'`` and
    ``'obj_calculator'`` with ``compute_obj_each_iter``, ``'diagnostics'``
    when given, ``'numer_W'``/``'denom_W'`` with ``store_gradients``,
    ``'iter_cputime'``, ``'random_state'`` and ``'n_resets_remaining'``.
    """
    rtv = {}
    if not (isinstance(k, numbers.Integral)
            or (isinstance(k, numbers.Real) and float(k).is_integer())) \
            or k < 1:
        raise ValueError('k must be a positive integer number of topics, '
                         'got %r' % (k,))
    k = int(k)
    if update_order not in ('interleaved', 'phase'):
        raise ValueError("update_order must be 'interleaved' or 'phase', "
                         'got %r' % (update_order,))
    if isinstance(sparse, np.bool_):
        sparse = bool(sparse)
    if not (sparse is True or sparse is False or sparse is None
            or sparse in ('auto', 'mxu', 'dma')):
        raise ValueError("sparse must be one of True, False, 'auto', "
                         "'mxu', 'dma'; got %r" % (sparse,))
    masked = W_mat is not None
    # ---- sparse-mask WRRI mode (reference nmf.py:843-882): the observed
    # set as COO end to end, O(nnz) memory
    masked_sparse = masked and is_sparse(W_mat)
    gram_backend = None
    if masked_sparse:
        if w_row is not None:
            raise NotImplementedError(
                'w_row with a sparse W_mat is not supported: the row '
                'weighting pre-scales X on the host and re-fits W against '
                'the unscaled dense X; scale the observed values by '
                'sqrt(w_row) yourself or pass a dense W_mat')
        if store_gradients:
            raise ValueError(
                'store_gradients needs the dense masked sweep (the stored '
                'numerators are dense d-vectors built from the dense '
                'residual); pass a dense W_mat')
        if reset_topic_method == 'max_resid_document':
            logger.info("sparse-mask mode: reset_topic_method="
                        "'max_resid_document' scans the full unmasked "
                        "residual, which has no O(nnz) form; disabling "
                        "resets (pass 'random' to keep budgeted resets)")
            reset_topic_method = None
        if mesh is not None:
            _not_yet('a sparse-mask fit on a mesh', 'A.12')
        # the sparse kwarg is the Gram-backend hint (reference
        # nmf.py:988-998): 'mxu' forces the gather-kernel contractions
        if sparse == 'dma':
            raise ValueError("sparse='dma' has no masked form; use "
                             "sparse='mxu' (or the default)")
        if sparse == 'mxu':
            gram_backend = 'mxu'
            sparse = 'auto'
    # With T fixed only the W-phase runs, so both orders are the same
    # computation (the JAX nmf()'s rule) — take the phase path.
    if fix_T and not fix_W and not masked and update_order == 'interleaved':
        update_order = 'phase'

    # ---- the sparse mode (reference nmf.py:963-1042) ---------------------
    X_is_sparse = is_sparse(X)
    _viable = (W_mat is None and w_row is None and not store_gradients
               and not (eps_gauss_t and delta_gauss_t))
    sparse_mode = False
    backend = None
    if sparse in ('mxu', 'dma'):
        if not X_is_sparse:
            raise ValueError('sparse=%r requires a scipy-sparse or torch '
                             'sparse X' % (sparse,))
        backend = sparse
    if sparse is True or backend is not None:
        if not _viable:
            raise ValueError(
                'sparse=True requires: no W_mat, no w_row, no '
                'store_gradients, no DP noise')
        sparse_mode = True
        if update_order != 'phase':
            logger.info('sparse mode uses the phase update order')
            update_order = 'phase'
        if reset_topic_method is not None:
            logger.info('sparse mode disables topic resets (they scan '
                        'residual rows)')
            reset_topic_method = None
    elif sparse == 'auto' and X_is_sparse:
        # only when the settings already match the sparse sweep: no silent
        # change of semantics against densify-and-proceed
        sparse_mode = (_viable and update_order == 'phase'
                       and reset_topic_method is None and x_dtype is None)

    # ---- options not ported yet -----------------------------------------
    if w_row is not None:
        _not_yet('w_row (row weights and the W refit)', 'A.4')
    if x_dtype is not None:
        _not_yet('x_dtype (mixed or quantized X storage)', 'A.8')
    if mesh is not None:
        _not_yet('a sparse fit on a mesh' if sparse in (True, 'mxu', 'dma')
                 else 'mesh (distributed fits)', 'A.12')
    if checkpoint is not None:
        _not_yet('checkpoint', 'A.9')
    if accel is not None or accel_opts:
        _not_yet("accel='her'", 'A.9')

    # ---- X on its device, in the working dtype ---------------------------
    # callbacks receive a sparse X as the user passed it
    X_user = X
    host = not isinstance(X, torch.Tensor)
    device = fit_device(X, device)
    if masked_sparse:
        # X stays where it is: the plan reads its values at the observed
        # coordinates on the host
        if host and not hasattr(X, 'tocsr'):
            X = np.asarray(X)
    elif X_is_sparse and not sparse_mode:
        # densified on its device (a scipy matrix on the host)
        X = X.to_dense() if isinstance(X, torch.Tensor) else X.toarray()
    if not masked_sparse and (not X_is_sparse or not sparse_mode):
        X = as_tensor(X, device=device)
    n, d = X.shape
    if dtype is None:
        dtype = X.dtype if isinstance(X, torch.Tensor) \
            else torch.from_numpy(np.zeros(0, X.dtype)).dtype
        # host data takes the card's default float there (the JAX rule:
        # float64 only where x64 is on)
        if not dtype.is_floating_point or (host and device.type != 'cpu'):
            dtype = default_float(device)
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if not isinstance(dtype, torch.dtype):
        dtype = as_tensor(np.zeros(0, dtype=dtype)).dtype
    if dtype not in (torch.float32, torch.float64):
        _not_yet('%s factors (16-bit storage)' % dtype, 'A.8')
    if sparse_mode and backend is None:
        backend = 'torch'
        if sparse == 'auto' and device.type == 'cuda':
            # the JAX package's policy (reference nmf.py:1343-1374):
            # densify on the card when the dense form fits, else the B5
            # chunk-plan contractions
            budget = 0.45 * torch.cuda.mem_get_info(device)[1]
            dense_bytes = n * d * dtype.itemsize
            if dense_bytes <= budget:
                logger.info('sparse auto: the dense form (%.2f GB) fits '
                            'the card; densifying on the device',
                            dense_bytes / 1e9)
                X = to_torch_sparse(X, dtype, device).to_dense()
                sparse_mode = False
            else:
                logger.info('sparse auto: the dense form (%.2f GB) exceeds '
                            'the card\'s budget; B5 chunk-plan '
                            'contractions', dense_bytes / 1e9)
                backend = 'mxu'
    if masked_sparse:
        X_dev = None            # planned below, after the initialization
    elif sparse_mode:
        X_dev = (plan_sparse_matrix_dma(X, dtype, device=device)
                 if backend == 'dma' else
                 plan_sparse_matrix(X, dtype, device=device)
                 if backend == 'mxu' else
                 TorchSparseX(to_torch_sparse(X, dtype, device)))
    else:
        X = X.to(dtype).contiguous()
        X_dev = X
    Wm = None
    if masked_sparse:
        if tuple(W_mat.shape) != (n, d):
            raise ValueError('W_mat must have the shape of X, %s; got %s'
                             % ((n, d), tuple(W_mat.shape)))
    elif masked:
        # the mask on the fit's device in the fit's dtype
        Wm = as_tensor(W_mat, device=device, dtype=dtype).contiguous()
        if tuple(Wm.shape) != (n, d):
            raise ValueError('W_mat must have the shape of X, %s; got %s'
                             % ((n, d), tuple(Wm.shape)))

    # ---- configuration validation (reference nmf.py:280-315) -------------
    if project_T_each_iter and np.any([reg_w_l1, reg_t_l1]):
        logger.warning(
            'This implementation can not solve project_T_each_iter=True '
            'with regularization, because WT is no longer scale invariant. '
            'Setting project_T_each_iter to False.')
        project_T_each_iter = False
    if project_W_each_iter and reg_w_l2 < 0:
        logger.warning(
            'project_W_each_iter=%s and reg_w_l2=%s<0 doesnt converge with '
            'the current implementation.', project_W_each_iter, reg_w_l2)

    w_row_sum_is_vector = w_row_sum is not None and np.ndim(w_row_sum) > 0
    _w_sum_unset = (w_row_sum is None
                    or (not w_row_sum_is_vector and not float(w_row_sum)))
    _sentinel_extra = {'random_state': random_state,
                       'n_resets_remaining': n_resets}
    if (not project_T_each_iter and not t_row_sum) and (reg_t_l1 < 0 or
                                                        reg_t_l2 < 0):
        logger.error(
            'Unbounded objective. reg_t_l1=%s, reg_t_l2=%s but '
            'project_T_each_iter=%s and t_row_sum=%s.',
            reg_t_l1, reg_t_l2, project_T_each_iter, t_row_sum)
        return {'W': torch.ones(n, k, dtype=dtype, device=device),
                'T': torch.ones(k, d, dtype=dtype, device=device) * 1e6,
                'obj_history': [-np.inf], 'iter_cputime': [0],
                **_sentinel_extra}
    if (not project_W_each_iter and _w_sum_unset) and (reg_w_l1 < 0 or
                                                       reg_w_l2 < 0):
        logger.error(
            'Unbounded objective. reg_w_l1=%s, reg_w_l2=%s but '
            'project_W_each_iter=%s and w_row_sum=%s.',
            reg_w_l1, reg_w_l2, project_W_each_iter, w_row_sum)
        return {'W': torch.ones(n, k, dtype=dtype, device=device) * 1e6,
                'T': torch.ones(k, d, dtype=dtype, device=device),
                'obj_history': [-np.inf], 'iter_cputime': [0],
                **_sentinel_extra}

    # the Gram-phase sweep (reference nmf.py:884-961): phase order, no
    # resets, and Γ/Θ within the Gram budget in full or in k-panels
    gram_panel = None
    masked_gram = False
    if masked_sparse:
        gram_panel = auto_panel(k, n, d, dtype.itemsize)
        gram_fits = gram_panel is None or gram_panel >= 1
        masked_gram = (update_order == 'phase' and reset_topic_method is None
                       and gram_fits)
        if update_order == 'phase' and not masked_gram:
            why = ('reset_topic_method=%r is set (a mid-phase reset would '
                   'rewrite the frozen factor)' % (reset_topic_method,)
                   if reset_topic_method is not None else
                   'even single-row Γ/Θ panels exceed the Gram budget '
                   '(sweep_masked_gram.GRAM_BUDGET_BYTES; k=%d, shape %s)'
                   % (k, (n, d)))
            warnings.warn(
                "masked update_order='phase' cannot take the Gram-phase "
                'sweep because ' + why + '; falling back to the '
                'interleaved (reference) order, whose O(nnz) gathers and '
                'segment sums run once per topic', RuntimeWarning,
                stacklevel=2)
            update_order = 'interleaved'

    # The dense masked sweep is interleaved by construction (the JAX
    # rule, nmf.py:1162): the order that runs decides the scale transfer
    if masked and update_order == 'phase' and not masked_gram:
        logger.info('masked path ignores the phase update order; running '
                    'the interleaved (reference) order')
        update_order = 'interleaved'

    if type(diagnostics) is not list:
        diagnostics = [diagnostics]
    if len(diagnostics) > 0:
        rtv['diagnostics'] = {f.__name__: [] for f in diagnostics}

    if random_state is None:
        random_state = int(time.time()) % 4294967296

    t_global_start = time.time()
    max_time = max_time - 10  # reserve time for the final W projection

    if w_row_sum_is_vector:
        w_row_sum = as_tensor(w_row_sum, device=device,
                              dtype=dtype).reshape(-1, 1)
    elif w_row_sum is not None:
        w_row_sum = float(w_row_sum)

    if n <= k:
        init = 'random'

    start_time = time.perf_counter()
    X_init, Wm_init = X, Wm
    if masked_sparse:
        X_init, Wm_init = None, None
        if _size(W_in) == 0 or _size(T_in) == 0:
            X_init = _masked_init_matrix(X, W_mat)
    W, T = _initialize_and_validate(
        W_in=W_in, T_in=T_in, W_mat=Wm_init, X=X_init, k=k, init=init,
        random_state=random_state, project_T_each_iter=project_T_each_iter,
        project_W_each_iter=project_W_each_iter, w_row_sum=w_row_sum,
        t_row_sum=t_row_sum, fix_W=fix_W, fix_T=fix_T, n=n, d=d,
        device=device, dtype=dtype)

    # ---- differential privacy noise scale (reference nmf.py:422-435) -----
    dp_sigma = None
    if eps_gauss_t and delta_gauss_t:
        c2 = 2 * math.log(1.25 / float(delta_gauss_t)) + 0.001
        df2 = 1000.0  # upper bound on the l2 sensitivity (nmf.py:428)
        dp_sigma = math.sqrt(c2 * df2 ** 2 * (1.0 / float(eps_gauss_t)) ** 2)

    inner_reps = int(inner_reps)
    if inner_reps < 1:
        raise ValueError('inner_reps must be >= 1')
    if inner_reps > 1 and (update_order != 'phase'
                           or (masked and not masked_gram)
                           or reset_topic_method is not None
                           or store_gradients or dp_sigma is not None):
        raise ValueError(
            "inner_reps > 1 requires update_order='phase', no dense W_mat "
            '(a sparse W_mat rides the Gram-phase sweep, which reuses A/Γ '
            'exactly), reset_topic_method=None, no store_gradients, no DP '
            'noise (the extra Gauss-Seidel passes reuse the per-phase '
            'numerators, which those features invalidate)')
    cfg = SweepConfig(
        k=k, fix_W=fix_W, fix_T=fix_T, masked=masked,
        masked_sparse=masked_sparse,
        project_T_each_iter=project_T_each_iter,
        project_W_each_iter=project_W_each_iter,
        t_row_sum=float(t_row_sum) if t_row_sum is not None else None,
        w_row_sum=(w_row_sum if not w_row_sum_is_vector else None),
        w_row_sum_is_vector=w_row_sum_is_vector,
        reg_w_l2=float(reg_w_l2), reg_t_l2=float(reg_t_l2),
        reg_w_l1=float(reg_w_l1), reg_t_l1=float(reg_t_l1),
        reset_topic_method=reset_topic_method,
        fix_reset_seed=bool(fix_reset_seed), dp_sigma=dp_sigma,
        store_gradients=bool(store_gradients),
        store_rows=(tuple(int(i) for i in ind_rows_to_store)
                    if (store_gradients and ind_rows_to_store is not None)
                    else None),
        update_order=update_order, matmul_precision=matmul_precision,
        inner_reps=inner_reps)
    wrs = w_row_sum if w_row_sum_is_vector else None
    extras = [x for x in (Wm, wrs) if x is not None]
    draws = make_draws(random_state, device)
    resets_left = int(n_resets)
    stored = ()
    # the kernel sweeps where they cover the config (use_pallas keeps its
    # JAX meaning), else the plain sweep, as the JAX nmf() routes. A
    # config the kernels cover by design runs them on the card or raises:
    # it never falls back to the plain sweep there
    kernel_cfg = dataclasses.replace(cfg, reset_topic_method=None)
    kernel_shaped = (sparse_mode or use_pallas is not False) and not masked \
        and update_order == 'phase' and not store_gradients \
        and dp_sigma is None
    dense_ok = kernel_shaped and supports_dense_kernels(kernel_cfg, d, dtype,
                                                        device)
    if kernel_shaped and not dense_ok:
        raise ValueError(
            'the CUDA kernels do not fit this problem (k=%d, d=%d, %s): see '
            'dense_kernels.gs_fits / tm_proj_fits; use_pallas=False takes '
            'the plain sweep' % (k, d, dtype))
    if use_pallas is True and not sparse_mode and not dense_ok and not (
            masked and supports_masked_kernels(cfg)):
        logger.warning('use_pallas requested but config unsupported by the '
                       'kernels; falling back to the plain sweep.')
    if masked_sparse:
        # the observed set, planned on the host once for this call
        if masked_gram:
            X_dev = plan_masked_gram(X, W_mat, dtype, backend=gram_backend,
                                     device=device)
            if gram_panel is not None:
                logger.info('Gram-phase masked sweep: k=%d exceeds the '
                            'full-tensor budget; tiling Γ/Θ in %d-panel '
                            'tiles', k, gram_panel)
            masked_sweep = make_masked_gram_sweep(cfg, X_dev.backend,
                                                  gram_panel)
        else:
            X_dev = plan_masked_coo(X, W_mat, dtype, device=device)
            masked_sweep = make_masked_sparse_sweep(cfg)

        def sweep_fn(X, W, T):
            nonlocal resets_left
            W, T, resets_left = masked_sweep(X, W, T, draws, resets_left,
                                             *extras)
            return W, T
    elif sparse_mode:
        sparse_sweep = make_sparse_sweep(cfg, backend)

        def sweep_fn(X, W, T):
            return sparse_sweep(X, W, T, wrs)
    elif (masked and use_pallas is not False and supports_masked_kernels(cfg)
          and reset_topic_method != 'max_resid_document'):
        # B3/B4. A fixed-T fit with 'max_resid_document' takes the plain
        # masked sweep, where the JAX package takes its Pallas sweep: the
        # same math (ROADMAP §C)
        masked_sweep = make_masked_sweep(cfg)

        def sweep_fn(X, W, T):
            nonlocal resets_left
            W, T, resets_left = masked_sweep(X, W, T, Wm, draws, resets_left,
                                             wrs)
            return W, T
    elif dense_ok and reset_topic_method is None:
        dense_sweep = make_dense_phase_sweep(cfg)

        def sweep_fn(X, W, T):
            return dense_sweep(X, W, T, wrs)
    else:
        plain = DenseResetSweep(cfg) if dense_ok else make_sweep(cfg)

        def sweep_fn(X, W, T):
            nonlocal resets_left, stored
            W, T, resets_left, *stored = plain(X, W, T, draws, resets_left,
                                               *extras)
            return W, T

    # ---- early stopping state (reference nmf.py:360-363) ------------------
    _es_active = bool(early_stop) and (callable(early_stop)
                                       or compute_obj_each_iter)
    if early_stop and not _es_active:
        logger.warning(
            'early_stop=%r scores from the tracked objective, but '
            'compute_obj_each_iter=False — no score is ever computed, so '
            'early stopping will never trigger. Pass '
            'compute_obj_each_iter=True (or a callable early_stop).',
            early_stop)
    if _es_active:
        last_score = np.inf
        W_prev, T_prev = W, T

    obj_history = []
    iter_cputime = []
    if logger.getEffectiveLevel() <= logging.DEBUG:
        compute_obj_each_iter = True
    OBJ = None
    if compute_obj_each_iter:
        # the plan modes' X is a chunk plan: the sparse objective's cross
        # term wants the plain coordinate list (reference nmf.py:1762-1790)
        X_obj = X_dev if masked_sparse else X
        if sparse_mode:
            X_obj = (X_dev.coo if backend == 'torch'
                     else to_torch_sparse(X, dtype, device))
        OBJ = TrueObjComputer(X_obj, W, T, reg_w_l1=reg_w_l1,
                              reg_t_l2=reg_t_l2, reg_w_l2=reg_w_l2,
                              reg_t_l1=reg_t_l1, Wm=Wm,
                              matmul_precision=matmul_precision,
                              sparse=sparse_mode,
                              masked_sparse=masked_sparse)

    X_cb = X_user if X_is_sparse or masked_sparse else X
    for func in diagnostics:
        rtv['diagnostics'][func.__name__].append(func(X_cb, W, T))
    if store_gradients:
        rtv['numer_W'] = {}
        rtv['denom_W'] = {}

    # grouped sweeps (the JAX nmf()'s sweeps_per_dispatch,
    # rri_nmf_tpu/nmf.py:1843-1916): with no per-sweep host work asked
    # for, the loop syncs, stamps the clock and checks max_time only at
    # the end of each group of sweeps
    group = int(sweeps_per_dispatch)
    if (group < 1 or _es_active or compute_obj_each_iter or diagnostics
            or store_gradients or debug_checks):
        group = 1

    # ---- outer iteration loop (reference nmf.py:377-514) ------------------
    for iter_no in range(max_iter):
        logger.info('Iteration %d', iter_no)

        if _es_active:
            if callable(early_stop):
                this_score = float(early_stop(X_cb, W, T))
            elif compute_obj_each_iter and len(obj_history) > 0:
                this_score = obj_history[-1]
            else:
                this_score = np.inf
            logger.info('Iter %d stopping score %.3f', iter_no, this_score)
            if this_score > last_score:  # STOP EARLY (nmf.py:391-403)
                logger.info('Stopping early at iter %d', iter_no)
                W, T = W_prev, T_prev
                obj_history = obj_history[:-1]
                iter_cputime = iter_cputime[:-1]
                for func in diagnostics:
                    rtv['diagnostics'][func.__name__] = \
                        rtv['diagnostics'][func.__name__][:-1]
                break
            last_score = this_score
            W_prev, T_prev = W, T

        it_start_time = time.time()
        _md = None
        if OBJ is not None and logger.getEffectiveLevel() <= logging.DEBUG:
            from rri_nmf_tpu_torch.utils.debug import MeasureDelta
            OBJ.W, OBJ.T = W, T
            _md = MeasureDelta(OBJ.true_objective,
                               'iter %d sweep' % iter_no, log=logger)
            _md.__enter__()

        W, T = sweep_fn(X_dev, W, T)
        if (iter_no + 1) % group and iter_no + 1 < max_iter:
            continue                        # inside a group of sweeps
        if store_gradients:
            rtv['numer_W'][iter_no], rtv['denom_W'][iter_no] = stored

        if _md is not None:
            OBJ.W, OBJ.T = W, T
            _md.__exit__(None, None, None)

        if debug_checks:
            from rri_nmf_tpu_torch.utils.debug import validate_factors
            validate_factors(W, T, w_row_sum=w_row_sum, t_row_sum=t_row_sum,
                             project_W_each_iter=project_W_each_iter,
                             project_T_each_iter=project_T_each_iter)

        if compute_obj_each_iter:
            OBJ.W, OBJ.T = W, T
            obj_history.append(OBJ.true_objective())
            logger.info('\tObj: %3.3e', obj_history[-1])
        else:
            _sync(device)   # keep the host clock honest
        # one stamp for each sweep of the group just ended
        iter_cputime.extend([time.perf_counter()]
                            * (iter_no + 1 - len(iter_cputime)))

        for func in diagnostics:
            dval = func(X_cb, W, T)
            rtv['diagnostics'][func.__name__].append(dval)
            logger.info('\t%s: %s', func.__name__, dval)

        logger.info('\tTime: %.3fsec', time.time() - it_start_time)

        if time.time() - t_global_start >= max_time:
            logger.info('STOPPING because max_time after iter %d', iter_no)
            break
        if compute_obj_each_iter and universal_stopping_condition(
                obj_history, eps_stop=eps_stop):
            logger.info('STOPPING because obj_history after iter %d', iter_no)
            break

    iter_cputime = [x - start_time for x in iter_cputime]

    # ---- final W projection (reference nmf.py:519-529) --------------------
    if (not project_W_each_iter and w_row_sum is not None and not fix_W
            and do_final_project_W):
        logger.info('Post completion W row projection')
        W = proj_mat_to_simplex(W, w_row_sum if not w_row_sum_is_vector
                                else w_row_sum.reshape(-1))

    rtv['W'] = W.contiguous()
    rtv['T'] = T.contiguous()
    rtv['n_resets_remaining'] = resets_left
    if compute_obj_each_iter:
        rtv['obj_history'] = obj_history
        OBJ.W, OBJ.T = rtv['W'], rtv['T']
        rtv['obj_calculator'] = OBJ
    rtv['iter_cputime'] = iter_cputime
    rtv['random_state'] = random_state
    return rtv


def _masked_init_matrix(X, W_mat):
    """``W_mat ⊙ X`` on the host for a sparse mask (reference
    nmf.py:2130-2142): elementwise, as scipy CSR, densified when its
    dense float64 form is at most 2 GB so a small fit initializes as the
    dense-mask one does."""
    X_init = host_sparse(W_mat).tocsr().multiply(host_sparse(X)).tocsr()
    if X_init.shape[0] * X_init.shape[1] * 8 <= 2e9:
        return np.asarray(X_init.toarray())
    return X_init


def _initialize_and_validate(W_in, T_in, W_mat, X, k, init, random_state,
                             project_T_each_iter, project_W_each_iter,
                             w_row_sum, t_row_sum, fix_W, fix_T, n, d, device,
                             dtype):
    """Initialize W, T or validate warm starts (reference
    ``_initialize_and_validate``, ``nmf.py:819-880``): a fresh init runs
    on the masked matrix ``W_mat * X`` when masked, fresh factors get
    their row sums scaled to ``t_row_sum``/``w_row_sum``, warm starts are
    shape-checked, negatives clipped, and the initial simplex projections
    applied when per-iteration projection is on. A sparse X (scipy or a
    torch sparse tensor) initializes as it is, never densified. Returns
    tensors on ``device`` in ``dtype``."""
    W = T = None
    if _size(W_in) == 0 or _size(T_in) == 0:
        # the SVD backend follows X: sklearn on the host for a CPU X (the
        # reference's goldens), torch.linalg on the card for a CUDA X
        backend = 'torch' if device.type == 'cuda' else 'sklearn'
        W, T = initialize_nmf(X if W_mat is None else W_mat * X, k, init,
                              random_state=random_state,
                              row_normalize=False, svd_backend=backend,
                              device=device)
        if t_row_sum is not None:
            T = normalize(T) * t_row_sum
        if w_row_sum is not None:
            W = normalize(W) * w_row_sum
    if _size(W_in) > 0:
        if tuple(np.shape(W_in)) != (n, k):
            raise ValueError('W_in has wrong dimensions, must be n*k')
        W = W_in
    if _size(T_in) > 0:
        if tuple(np.shape(T_in)) != (k, d):
            raise ValueError('T_in has wrong dimensions, must be k*d')
        T = T_in

    W = as_tensor(W, device=device, dtype=dtype).clamp_min(0)
    T = as_tensor(T, device=device, dtype=dtype).clamp_min(0)

    if project_W_each_iter and not fix_W and w_row_sum is not None:
        logger.debug('Projecting W rows after initialization')
        W = proj_mat_to_simplex(W, w_row_sum if isinstance(w_row_sum, float)
                                else w_row_sum.reshape(-1))
    if project_T_each_iter and not fix_T and t_row_sum is not None:
        logger.debug('Projecting T rows after initialization')
        T = proj_mat_to_simplex(T, t_row_sum)
    return W, T

