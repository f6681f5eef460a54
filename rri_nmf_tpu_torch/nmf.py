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
  two numerator products by ``torch.sparse.mm`` (``sparse=True``) or by
  the gather kernel on X's output-column layouts (``'mxu'`` and
  ``'dma'``, JAX's B5 and B6: one kernel here), around B1 and B2;
- the phase order with resets (a fixed-T call such as the TM estimator's
  transform included) through
  :class:`rri_nmf_tpu_torch.ops.dense_kernels.DenseResetSweep`: the
  kernel sweep, checked once after the sweep, and the plain
  Gram-blocked sweep only when a topic died with budget left;
- masked WRRI with a dense ``W_mat`` and no resets (or ``fix_T`` with
  either reset) through
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

X is stored as the JAX package stores it (``x_dtype``): in the factors'
dtype by default; as bfloat16 beside float32 factors (``x_dtype=
'bfloat16'``, the products read the 16-bit X and sum in float32); or as
a column-scaled int16 code (``x_dtype='int16'``, or a
:class:`~rri_nmf_tpu_torch.ops.quantized.QuantizedX` passed as X), which
only the dense kernel sweep reads, through scale-folded products. The
factors may be 16-bit themselves (``dtype=torch.bfloat16`` or
``float16``): the kernels store them in 16 bits and work them in float32.

On a mesh (``mesh=``, :mod:`rri_nmf_tpu_torch.parallel`) every rank of a
``torch.distributed`` world passes the whole X and fits its own block: the
phase recipe through
:func:`rri_nmf_tpu_torch.parallel.sharded_dense.make_sharded_dense_sweep`
(B1 and B2 on each rank's block), a dense mask through
:func:`rri_nmf_tpu_torch.parallel.sharded_masked.
make_sharded_masked_sweep` (B3 and B4), a sparse X through
:mod:`rri_nmf_tpu_torch.parallel.sparse_mesh` (each rank's block of
nonzeros), a sparse mask on a ``(dp, 1)`` mesh through
:mod:`rri_nmf_tpu_torch.parallel.masked_gram_mesh` (the Gram-phase
sweep) or :mod:`rri_nmf_tpu_torch.parallel.masked_sparse_mesh` (the
O(nnz) sweep) on each rank's row block of observations, the rest through
the plain sweep and
:class:`~rri_nmf_tpu_torch.ops.dense_kernels.DenseResetSweep` with their
collectives. Across hosts (:mod:`rri_nmf_tpu_torch.parallel.multihost`)
no rank holds X whole: each passes its own block (a ``RankBlock`` from
``distribute_dense``) or its pre-built plan (``distribute_sparse_coo``,
``distribute_masked_coo``), and the same sweeps run on it.

Around them: initialization, HER extrapolation (``accel='her'``,
:mod:`rri_nmf_tpu_torch.ops.accel`, wrapping whichever sweep was picked),
checkpoint/resume (:mod:`rri_nmf_tpu_torch.checkpoint`), row weights
(``w_row``, with the fixed-T W refit on the unscaled X), objective
tracking and the relative-progress stop, early-stop rollback,
``max_time``, grouped dispatch, diagnostics, ``debug_checks``, the final
W projection and the result dict.
"""

import dataclasses
import logging
import math
import numbers
import time
import warnings

import numpy as np
import torch

from rri_nmf_tpu_torch.checkpoint import (NMFCheckpointer, NMFState,
                                          restore_shared)
from rri_nmf_tpu_torch.initialization import initialize_nmf
from rri_nmf_tpu_torch.matrixops import (as_tensor, default_float,
                                         fit_device, is_sparse, normalize,
                                         proj_mat_to_simplex, to_torch_sparse)
from rri_nmf_tpu_torch.optimization import universal_stopping_condition
from rri_nmf_tpu_torch.ops.accel import (make_her_step, make_residual_obj,
                                         supports_her)
from rri_nmf_tpu_torch.ops.dense_kernels import (DenseResetSweep,
                                                 make_dense_phase_sweep,
                                                 supports_dense_kernels)
from rri_nmf_tpu_torch.ops.masked_kernels import (make_masked_sweep,
                                                  supports_masked_kernels)
from rri_nmf_tpu_torch.ops.quantized import (NARROW, QuantizedX,
                                             dequantize_x, quantize_x,
                                             work_dtype)
from rri_nmf_tpu_torch.ops.sparse_plan import plan_sparse_matrix
from rri_nmf_tpu_torch.ops.sweep import (SweepConfig, make_draws,
                                         make_objective, make_sweep,
                                         resolve_mixed_dtypes)
from rri_nmf_tpu_torch.ops.sweep_masked_gram import (
    MaskedGramPlan, auto_panel, make_masked_gram_objective,
    make_masked_gram_sweep, plan_masked_gram)
from rri_nmf_tpu_torch.ops.sweep_masked_sparse import (
    coo_plan, host_sparse, make_masked_sparse_objective,
    make_masked_sparse_sweep, plan_masked_coo)
from rri_nmf_tpu_torch.ops.sweep_sparse import (TorchSparseX,
                                                make_sparse_objective,
                                                make_sparse_sweep)
from rri_nmf_tpu_torch.parallel.masked_gram_mesh import (
    make_sharded_masked_gram_sweep, partition_masked_gram)
from rri_nmf_tpu_torch.parallel.masked_sparse_mesh import (
    make_sharded_masked_sparse_sweep, partition_masked_coo)
from rri_nmf_tpu_torch.parallel.mesh import Mesh
from rri_nmf_tpu_torch.parallel.multihost import (RankBlock, plan_kind,
                                                  plan_values)
from rri_nmf_tpu_torch.parallel.sharded_dense import make_sharded_dense_sweep
from rri_nmf_tpu_torch.parallel.sharded_masked import (
    make_sharded_masked_sweep, supports_sharded_masked)
from rri_nmf_tpu_torch.parallel.sparse_mesh import (
    make_sharded_mxu_sweep, make_sharded_sparse_objective,
    make_sharded_sparse_sweep, partition_coo, partition_mxu)
from rri_nmf_tpu_torch.utils.profiling import span, spanned, stage

# logger levels follow the reference convention (nmf.py:36-48):
# INFO — per-iteration summaries; DEBUG — objective deltas (forces
# compute_obj_each_iter)
logger = logging.getLogger(__name__)


def _size(a):
    if isinstance(a, RankBlock):
        a = a.block
    return a.numel() if isinstance(a, torch.Tensor) else int(np.size(a))


def _check_premade(X, mesh, W_mat, W_in, T_in, diagnostics, early_stop):
    """The guards of a pre-built plan as X (reference nmf.py:751-841)."""
    if mesh is None:
        raise ValueError('X is a pre-built mesh plan but mesh=None; pass the '
                         'mesh it was partitioned over')
    if W_mat is not None:
        raise ValueError('a pre-built mesh plan already carries its '
                         'observation structure; leave W_mat=None (masked '
                         'plans ARE the observed set)')
    s = X.split
    if s != mesh.split(s.n, s.d):
        m = mesh.split(s.n, s.d)
        raise ValueError(
            'the plan was partitioned for rows [%d, %d) and columns [%d, %d) '
            'of the (%d, %d) problem, but this mesh gives this rank rows '
            '[%d, %d) and columns [%d, %d); rebuild it over this mesh'
            % (s.r0, s.r1, s.c0, s.c1, s.n, s.d, m.r0, m.r1, m.c0, m.c1))
    if _size(W_in) == 0 or _size(T_in) == 0:
        raise ValueError(
            'a pre-built mesh plan carries no X to initialize from; pass '
            'W_in AND T_in (initialize on every rank, e.g. random draws '
            'from a shared seed, and place them with '
            'parallel.distribute_factors)')
    # (None or an empty tuple is no callback: reference fault 1 not copied)
    if [f for f in (diagnostics if isinstance(diagnostics, (list, tuple))
                    else [diagnostics]) if f is not None] \
            or callable(early_stop):
        raise ValueError(
            'diagnostics callbacks and a callable early_stop consume the '
            'host X, which a pre-built mesh plan does not carry; compute '
            'diagnostics from the returned factors instead')


def _check_rank_block(X, mesh, W_mat, w_row, sparse):
    """The guards of a :class:`~rri_nmf_tpu_torch.parallel.multihost.
    RankBlock` X (reference nmf.py:1044-1066)."""
    if mesh is None:
        raise ValueError('X spans processes but mesh=None; pass the global '
                         'mesh (parallel.make_global_mesh) the block was '
                         'built over')
    if sparse is True or sparse in ('mxu', 'dma') or (
            W_mat is not None and is_sparse(W_mat)):
        raise NotImplementedError(
            'a rank-block DENSE X cannot drive the sparse sweeps; partition '
            'the sparse corpus per rank with parallel.distribute_sparse_coo '
            'and pass the plan as X (masked observed sets: '
            'parallel.distribute_masked_coo)')
    if w_row is not None:
        raise NotImplementedError(
            'w_row pre-scales X on the host; with a rank-block X apply '
            'sqrt(w_row) row scaling before distribute_dense and run the W '
            're-fit explicitly')
    if not X.block.dtype.is_floating_point:
        raise ValueError('a rank-block X must be floating point')
    if X.split != mesh.split(*X.shape):
        raise ValueError('the X block is the %r, but this mesh gives this '
                         'rank the %r; rebuild it over this mesh'
                         % (X.split, mesh.split(*X.shape)))


def _premade_device(X, device):
    """A pre-built plan's device; ``device``, when given, must be it."""
    where = plan_values(X).device
    asked = None if device is None else torch.device(device)
    if asked is not None and (asked.type != where.type or asked.index
                              not in (None, where.index)):
        raise ValueError('the plan lies on %s, not on device=%s; build it '
                         'there' % (where, device))
    return where


def _parse_dtype(dtype):
    """A dtype given as a torch dtype, a name (``'bfloat16'``,
    ``'int16'``, ...) or a numpy dtype (ml_dtypes' bfloat16 too) as a
    torch dtype; None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise ValueError('unknown dtype %r' % (dtype,))
    return out


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


class TrueObjComputer(object):
    """Full-objective calculator returned as ``rtv['obj_calculator']``:
    holds X, the mask ``Wm`` (None for an unmasked fit), the row weights
    ``wr`` (n, 1) of a ``w_row`` fit (else None) and the current W/T and
    computes ``0.5 Σ wr ⊙ Wm ⊙ (X - WT)²`` + regularizers. As in the JAX
    package, a ``w_row`` fit's X is already scaled by ``sqrt(w_row)``
    and ``wr`` weights it once more.

    The residual is summed over 8192-row blocks when the whole ``W @ T``
    temporary would pass ~2 GB in the accumulator dtype (the JAX
    package's rule); a quantized X (a
    :class:`~rri_nmf_tpu_torch.ops.quantized.QuantizedX`) is read in
    dequantized blocks, and pickles as its int16 code and scale. With
    ``sparse``, X is a coalesced torch sparse COO tensor and the
    objective never forms ``W @ T``
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
    form, on W's device.

    On a ``mesh`` X, W, T, ``Wm`` and ``wr`` are this rank's blocks (a
    sparse-mask X this rank's plan), the objective is summed over the
    mesh (every rank calls it together and gets the same value), and
    ``whole`` holds the whole X, ``Wm`` and ``wr`` the caller gave every
    rank (references, not copies; X is None for a sparse X or a sparse
    mask, which no rank holds whole) and, once the fit ends, the whole W
    and T. A pickle keeps JAX's contract (``rri_nmf_tpu/nmf.py:229-317``):
    the mesh and the rank's blocks are dropped and the whole arrays
    travel, so a loaded dense or dense-mask calculator evaluates the
    whole objective on one device, while a sparse or sparse-mask one
    raises ``ValueError`` on :meth:`true_objective`."""

    def __init__(self, X, W, T, reg_w_l2, reg_t_l2, reg_w_l1, reg_t_l1,
                 Wm=None, matmul_precision=None, sparse=False,
                 masked_sparse=False, wr=None, mesh=None, whole=None):
        self.X = X
        self.mesh = mesh
        self.whole = whole
        self.sparse = sparse
        self.masked_sparse = masked_sparse
        self.W = W
        self.T = T
        self.Wm = Wm
        self.wr = wr
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
        if self.mesh is not None:
            # the mesh and this rank's blocks stay behind; the whole
            # arrays travel (X None for a sparse X or a sparse mask)
            state.update(state.pop('whole') or dict(X=None), mesh=None,
                         whole=None)
        X = state['X']
        if self.masked_sparse and X is not None \
                and not isinstance(X, tuple):
            coo = X.coo if isinstance(X, MaskedGramPlan) else X
            state['X'] = (('masked_coo',) + coo.host_arrays()
                          + (coo.shape, coo.nnz))
        elif isinstance(X, QuantizedX):
            # the int16 code and scale; re-wrapped on the next use
            state['X'] = ('quantized_x', X.q.cpu(), X.s.cpu())
        return state

    def _masked_sparse_fn(self):
        regs = dict(reg_w_l2=self.reg_w_l2, reg_t_l2=self.reg_t_l2,
                    reg_w_l1=self.reg_w_l1, reg_t_l1=self.reg_t_l1)
        if isinstance(self.X, tuple):            # restored from a pickle
            self.X = coo_plan(*self.X[1:], device=self.W.device)
        if isinstance(self.X, MaskedGramPlan) and self.X.backend == 'mxu':
            # Θ in panels past the budget at the plan's rows (on a mesh
            # the rank's)
            n, d = self.X.shape
            p = auto_panel(self.W.shape[1], n, d, self.W.element_size())
            return make_masked_gram_objective(
                'mxu', panel=1 if p == 0 else p, mesh=self.mesh, **regs)
        fn = make_masked_sparse_objective(mesh=self.mesh, **regs)
        if isinstance(self.X, MaskedGramPlan):
            # a segsum Gram plan: the observed-entry form is the cheaper
            return lambda plan, W, T: fn(plan.coo, W, T)
        return fn

    def true_objective(self):
        if self.X is None:
            raise ValueError(
                'this TrueObjComputer was pickled from a mesh-sharded fit '
                'whose X no rank holds whole (a sparse X or mask, a rank '
                'block or a pre-built plan), which cannot be serialized; '
                're-fit (or construct a new calculator) to evaluate the '
                'objective')
        if self._fn is None and self.masked_sparse:
            self._fn = self._masked_sparse_fn()
        if self._fn is None and self.sparse:
            regs = dict(reg_w_l2=self.reg_w_l2, reg_t_l2=self.reg_t_l2,
                        reg_w_l1=self.reg_w_l1, reg_t_l1=self.reg_t_l1)
            self._fn = (make_sparse_objective(**regs) if self.mesh is None
                        else make_sharded_sparse_objective(self.mesh,
                                                           **regs))
        if isinstance(self.X, tuple) and self.X[0] == 'quantized_x':
            self.X = QuantizedX(self.X[1].to(self.W.device),
                                self.X[2].to(self.W.device))
        if self._fn is None:
            n, d = self.X.shape
            # sized by the accumulator dtype, as the residual is widened
            acc = resolve_mixed_dtypes(self.X.dtype, self.W.dtype)[1]
            big = n * d * acc.itemsize > 2e9 and n > 8192
            self._fn = make_objective(
                masked=self.Wm is not None,
                row_weighted=self.wr is not None,
                reg_w_l2=self.reg_w_l2,
                reg_t_l2=self.reg_t_l2, reg_w_l1=self.reg_w_l1,
                reg_t_l1=self.reg_t_l1, block_rows=8192 if big else None,
                matmul_precision=self.matmul_precision, mesh=self.mesh)
        args = (self.X, self.W, self.T) + (
            () if self.sparse or self.masked_sparse
            else (self.Wm, self.wr))
        self.obj = float(self._fn(*args))
        return self.obj


@spanned('rri.nmf')
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
      see **Sparse masks** below. ``w_row`` (numpy or a tensor) scales X
      by ``sqrt(w_row)`` on the fit's device (a sparse X is densified,
      a vector ``w_row_sum`` sqrt-scaled) and ends with the JAX
      package's 10-sweep fixed-T W refit on the unscaled X, whose
      objectives and stamps extend ``obj_history`` and
      ``iter_cputime``. ``accel='her'`` with ``accel_opts`` wraps the
      sweep that runs (see **HER** below). ``mesh`` takes a fit onto a
      ``torch.distributed`` mesh (see **Meshes** below).
    - **Storage** (``x_dtype``, ``dtype``) as in the JAX package:
      ``x_dtype='bfloat16'`` stores X in 16 bits beside the factors'
      dtype; ``x_dtype='int16'`` (or a QuantizedX as X) stores it as the
      column-scaled int16 code, encoded on the host for host data (only
      the code crosses to the card) or on a tensor's own device, and runs
      only on the dense kernel sweep (phase order, no resets, no gradient
      stores or DP noise, float32/float64 factors), raising JAX's
      ``ValueError`` otherwise; ``x_dtype`` is ignored on the masked
      paths and refused in the sparse modes, and ``sparse='auto'``
      densifies a sparse X when it is set. Host data stored narrower
      than it came (an ``x_dtype``, 16-bit factors) is converted on the
      host, and the init reads the host X, as JAX's does. 16-bit factors
      (``dtype=torch.bfloat16``/``float16``) run every sweep; with a
      dense mask and ``use_pallas=None`` the plain masked sweep, as in
      JAX.
    - **HER** (``accel='her'``) refuses what the JAX package refuses
      (resets, gradient stores, DP noise, a sparse mode or sparse mask,
      a fixed factor) with its ``ValueError``\\ s. Its step reads nothing
      on the host, so with ``sweeps_per_dispatch`` a group of HER sweeps
      syncs once. The fit returns the best accepted iterate unless an
      early stop rolled back.
    - **Checkpoints** (``checkpoint``: a directory or an
      :class:`~rri_nmf_tpu_torch.checkpoint.NMFCheckpointer`) are
      written with ``torch.save``; a fit resumes from the latest step,
      its factors placed on the fit's device, and a resumed fit equals
      the straight one. The generator state rides the checkpoint; one
      written on another device type cannot be set, so the generator
      then re-seeds from ``random_state`` (logged as a warning), while
      the factors, history and budget resume.
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
      products with ``torch.sparse.mm``; ``'mxu'`` and ``'dma'`` (JAX's
      B5 and B6) both build one output-column layout of X per product
      from X's COO on the card and run the gather kernel on it, so the
      two give equal fits. The default ``'auto'`` engages under the JAX
      conditions (phase order, no resets, no mask, ``w_row``, DP or
      ``x_dtype``): on the CPU the ``torch.sparse`` form; on a card it
      densifies on the device when the dense form fits 45% of the card's
      memory, else the layouts (``'mxu'``). Otherwise, and with
      ``sparse=False``, X is densified on its device.
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
    - **Initialization** of the NNDSVD family runs scikit-learn's
      randomized SVD in float64: on the host for host data (the
      reference's goldens; scikit-learn or its copy), with
      ``torch.linalg`` in float64 on the card for a CUDA X and for a
      scipy-sparse X fitting on the card (its nonzeros cross); a
      QuantizedX takes the float32 device backend
      (``svd_backend='torch'``), as JAX's does.
    - **matmul_precision** takes the JAX names; ``None`` keeps exact
      float32 products on the card (TF32 off).
    - **Meshes** (``mesh``: a :class:`rri_nmf_tpu_torch.parallel.Mesh`
      from :func:`~rri_nmf_tpu_torch.parallel.make_mesh`, after
      ``torch.distributed.init_process_group``): every rank of the mesh
      calls ``nmf()`` with the same arguments and the whole X, and fits
      its block (X's rows over ``dp``, columns over ``tp``; uneven where
      a shape does not divide the mesh, with JAX's warning). A fresh init
      runs on the first rank and is shared; the draws come from one seed
      on every rank. The fit returns the whole W and T and the same
      ``obj_history`` on every rank. A checkpoint holds the whole factors,
      written by the first rank once every rank has gathered them, so a
      single-device checkpoint resumes on a mesh and the other way round.
      A dense ``W_mat`` is split like X, and runs B3/B4 on each rank's
      block where the kernels' mesh gate passes
      (:func:`~rri_nmf_tpu_torch.parallel.sharded_masked.
      supports_sharded_masked`), else the plain masked sweep with its
      collectives. ``store_gradients`` returns the whole stores on every
      rank. A sparse X is split into each rank's block of nonzeros
      (``sparse=True``, ``'mxu'`` and ``'auto'``, which engages as JAX's
      does and never densifies on a mesh); ``'dma'`` and, with ``tp > 1``,
      a T-row sum constraint raise JAX's ``ValueError``. A sparse mask
      runs on a ``(dp, 1)`` mesh, each rank planning its row block of
      observations: in phase order without resets the Gram-phase sweep
      (one all-reduce of A and Γ a T-phase, the gather kernel on each
      rank's plan on a card; Γ/Θ in k-panels past the budget at n / dp
      rows), else the O(nnz) sweep (one (2, d) all-reduce a topic). As in
      JAX, ``tp > 1``, a ``'random'`` reset and a per-row ``w_row_sum``
      vector raise ``ValueError``. The objective calculator of a mesh
      fit pickles without the mesh: a dense or dense-mask one evaluates
      the whole objective on one device after a load, a sparse or
      sparse-mask one raises ``ValueError``. A checkpointed mesh fit
      restores what the first rank reads, on every rank, so ranks that
      see different directories resume (or start) together.
    - **Slabs and plans** (:mod:`rri_nmf_tpu_torch.parallel.multihost`),
      for a mesh across hosts where no rank holds X whole. X may be this
      rank's ``RankBlock`` (``distribute_dense`` of its row slab): n and d
      come from its split, it is not blocked again, nor is a
      ``RankBlock`` ``W_mat`` or ``W_in`` (``distribute_factors``); a
      fresh init runs on every rank through the mesh (``'random'`` from
      the shape, the means one mesh sum, the SVD family
      :func:`~rri_nmf_tpu_torch.initialization.randomized_svd_torch`
      through the mesh; ``'coherence_pmi'`` raises), ``x_dtype`` works
      (the int16 scales from each column's maximum over ``dp``), a sparse
      mode, a sparse mask and ``w_row`` raise JAX's
      ``NotImplementedError``, and callbacks get X gathered whole. Or X
      may be a pre-built plan (``distribute_sparse_coo``,
      ``distribute_masked_coo``): its type names the sweep (the COO
      block: ``sparse=True``; the ``'mxu'`` plan: the gather kernel; the
      masked COO plan: the O(nnz) sweep, a ``'phase'`` request warning;
      the Gram plan: the Gram-phase sweep, which needs
      ``update_order='phase'``), ``W_in`` and ``T_in`` are required, and
      JAX's guards raise (no mesh, a ``W_mat``, a plan of another mesh, a
      contradicting ``sparse``, another ``dtype``, callbacks, an
      objective without the ``'mxu'`` plan's COO companion). The
      objective calculator of such a fit pickles without X, and its
      loaded copy raises the ``mesh-sharded`` ``ValueError`` (JAX
      gathers X when it pickles; here that would be a collective only
      the pickling rank enters).
    - **Callbacks** (``diagnostics``, a callable ``early_stop``) receive
      ``(X, W, T)``: W and T as tensors on the fit's device, a sparse X
      (and any X of a sparse-mask fit) as the user passed it, a dense X
      as a tensor on the fit's device (on a mesh: the whole W and
      T).

    Returns the dict of the JAX ``nmf()``, with ``'W'`` (n, k) and ``'T'`` (k, d)
    as tensors on the fit's device; ``'obj_history'`` and
    ``'obj_calculator'`` with ``compute_obj_each_iter``, ``'diagnostics'``
    when given, ``'numer_W'``/``'denom_W'`` with ``store_gradients``,
    ``'iter_cputime'``, ``'random_state'`` and ``'n_resets_remaining'``.

    Under a profiler the call is an ``rri.nmf`` span whose stages follow
    one another (:mod:`rri_nmf_tpu_torch.utils.profiling`).
    """
    stage('rri.nmf.input')
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
    if mesh is not None:
        if not isinstance(mesh, Mesh):
            raise TypeError('mesh must be a rri_nmf_tpu_torch.parallel.Mesh '
                            '(parallel.make_mesh), got %r' % (mesh,))
        mesh.member()
    # ---- a rank's own slab (parallel/multihost.py, reference
    # nmf.py:751-841, 1044-1066): a RankBlock X, or a pre-built plan
    premade = plan_kind(X)
    X_block = isinstance(X, RankBlock)
    if premade is not None:
        _check_premade(X, mesh, W_mat, W_in, T_in, diagnostics, early_stop)
    if X_block:
        _check_rank_block(X, mesh, W_mat, w_row, sparse)
    if isinstance(W_in, RankBlock) and _size(T_in) == 0:
        raise ValueError('W_in as a rank block (parallel.distribute_factors) '
                         'needs T_in: a fresh T would come with a whole W')
    masked = W_mat is not None or premade in ('masked_coo', 'masked_gram')
    # ---- sparse-mask WRRI mode (reference nmf.py:843-882): the observed
    # set as COO end to end, O(nnz) memory
    masked_sparse = premade in ('masked_coo', 'masked_gram') or (
        masked and is_sparse(W_mat))
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
        # the mesh forms' limits (reference nmf.py:869-882)
        if mesh is not None and mesh.shape[1] != 1:
            raise ValueError(
                'sparse-mask mode shards observations by row blocks; use '
                'an (n_devices, 1) mesh (the T-phase d-vectors are '
                'replicated)')
        if mesh is not None and reset_topic_method == 'random':
            raise ValueError(
                "sparse-mask mesh sweeps support reset_topic_method=None "
                "only (a 'random' reset draws a global (n,) column "
                'stream); run single-device for the transform preset')
        if mesh is not None and w_row_sum is not None \
                and np.ndim(w_row_sum) > 0:
            raise ValueError('sparse-mask mesh sweeps do not support a '
                             'per-row w_row_sum vector')
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
    if premade in ('coo', 'mxu'):
        # the plan's type picks the sweep; the sparse kwarg must not
        # contradict it (reference nmf.py:972-986)
        if sparse is False:
            raise ValueError('X is a pre-built sparse mesh plan; '
                             'sparse=False conflicts with it')
        if sparse == 'dma':
            raise ValueError("sparse='dma' is single-device; pre-built "
                             'plans are mesh paths')
        if sparse == 'mxu' and premade == 'coo':
            raise ValueError("sparse='mxu' with a COO block plan: rebuild "
                             "it with distribute_sparse_coo(backend='mxu')")
        sparse = 'mxu' if premade == 'mxu' else True
    X_is_sparse = is_sparse(X) or premade in ('coo', 'mxu')
    _viable = (W_mat is None and w_row is None and not store_gradients
               and not (eps_gauss_t and delta_gauss_t))
    # a sparse mesh (parallel/sparse_mesh.py): a T-row sum constraint
    # projects a whole T row, so it needs the columns unsplit (tp == 1)
    _mesh_sp_ok = (mesh is None or mesh.shape[1] == 1
                   or not (project_T_each_iter and t_row_sum))
    sparse_mode = False
    backend = None
    if sparse in ('mxu', 'dma'):
        if not X_is_sparse:
            raise ValueError('sparse=%r requires a scipy-sparse or torch '
                             'sparse X' % (sparse,))
        if sparse == 'dma' and mesh is not None:
            raise ValueError("sparse='dma' is single-device; use "
                             "sparse='mxu' with a mesh")
        # JAX's B5 and B6 plans are one layout plan here
        backend = 'mxu'
    if sparse is True or backend is not None:
        if not _viable:
            raise ValueError(
                'sparse=True requires: no W_mat, no w_row, no '
                'store_gradients, no DP noise')
        if not _mesh_sp_ok:
            raise ValueError(
                'sparse=True with a column-sharded mesh (tp > 1) does not '
                'support project_T_each_iter with t_row_sum (the T-row '
                'simplex projection needs the row device-local); use a '
                '(n_devices, 1) mesh')
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
        sparse_mode = (_viable and _mesh_sp_ok and update_order == 'phase'
                       and reset_topic_method is None and x_dtype is None)

    # ---- X and its dtypes -------------------------------------------------
    # callbacks receive a sparse X as the user passed it
    X_user = X
    x_quant_in = isinstance(X, QuantizedX)
    x_store = _parse_dtype(x_dtype)
    host = not isinstance(X, torch.Tensor) and not x_quant_in
    split_in = None
    if premade is not None:
        # the plan lies where it was built
        device = _premade_device(X, device)
        host = False
    elif X_block:
        # this rank's block as X from here on; the whole shape in split_in
        split_in, host = X.split, X.host
        X = X.block if device is None else X.block.to(device)
        device = X.device
    elif x_quant_in:
        X = X if device is None else X.to(device)
        device = X.device
    else:
        device = fit_device(X, device)
    if premade is not None:
        pass
    elif masked_sparse:
        # X stays where it is: the plan reads its values at the observed
        # coordinates on the host
        if host and not hasattr(X, 'tocsr'):
            X = np.asarray(X)
    elif X_is_sparse and not sparse_mode:
        # densified on its device (a scipy matrix on the host)
        X = X.to_dense() if isinstance(X, torch.Tensor) else X.toarray()
    if not masked_sparse and (not X_is_sparse or not sparse_mode) \
            and not x_quant_in and premade is None:
        X = as_tensor(X)            # host data: a CPU tensor, for now
    n, d = ((X_user.split.n, X_user.split.d) if premade is not None
            else (split_in.n, split_in.d) if X_block else X.shape)
    if dtype is None and premade is not None:
        dtype = plan_values(X).dtype
    elif dtype is None:
        dtype = X.dtype if isinstance(X, (torch.Tensor, QuantizedX)) \
            else torch.from_numpy(np.zeros(0, X.dtype)).dtype
        # host data takes the card's default float there (the JAX rule:
        # float64 only where x64 is on)
        if not dtype.is_floating_point or (host and device.type != 'cpu'):
            dtype = default_float(device)
    dtype = _parse_dtype(dtype)
    if premade is not None and dtype != plan_values(X).dtype:
        raise ValueError(
            'the plan holds %s values but the fit runs %s; rebuild the plan '
            'with dtype=%s (or pass dtype=%s)'
            % (plan_values(X).dtype, dtype, dtype, plan_values(X).dtype))

    # ---- X storage (reference nmf.py:1089-1116) ---------------------------
    x_quant = x_quant_in or x_store == torch.int16
    if x_quant:
        x_store = None              # the dequantized dtype is the factors'
        if dtype not in (torch.float32, torch.float64):
            raise ValueError("x_dtype='int16' requires float32/float64 "
                             'factors (the dequantized compute dtype)')
        if sparse_mode or masked_sparse or W_mat is not None:
            raise ValueError(
                "x_dtype='int16' (quantized X storage) covers the dense "
                'unmasked paths only; sparse/masked workloads already '
                'store O(nnz)')
        if w_row is not None and x_quant_in:
            raise ValueError(
                'w_row pre-scales X on the host; apply sqrt(w_row) row '
                'scaling before quantize_x, or pass the dense X')
    elif x_store is not None and x_store != dtype and sparse_mode:
        raise ValueError('x_dtype (mixed X storage) is not supported with '
                         'sparse modes: sparse X is stored as nonzeros and '
                         'the contractions key off that dtype directly')
    elif x_store is not None and x_store != dtype and masked:
        # the masked sweeps stream a residual built from X once a sweep,
        # so narrowing X alone saves no memory traffic there
        logger.info('x_dtype ignored on the masked path (the streamed '
                    'residual, not X, carries the traffic)')
        x_store = None
    if x_store == dtype:
        x_store = None
    # host data stored narrower than it came (the int16 code, a bfloat16
    # X, 16-bit factors) is converted on the host: the init reads the host
    # X, as the JAX package's does, and only the stored form crosses to
    # the card
    staged = host and (x_quant or x_store is not None or dtype in NARROW)
    if isinstance(X, torch.Tensor) and not staged:
        X = X.to(device)
    if sparse_mode and backend is None:
        backend = 'torch'
        if sparse == 'auto' and device.type == 'cuda' and mesh is None:
            # the JAX package's policy (reference nmf.py:1343-1374):
            # densify on the card when the dense form fits, else the
            # layout plan's contractions (JAX's B5); a mesh keeps the
            # nonzeros, each rank its block
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
                            'the card\'s budget; gather-kernel '
                            'contractions', dense_bytes / 1e9)
                backend = 'mxu'
    X_dev = None    # masked_sparse: planned below, after the initialization
    if premade is not None:
        X_dev = X
    elif sparse_mode and mesh is not None:
        # this rank's block of nonzeros, in local indices
        X_dev = (partition_mxu(X, mesh, dtype, device) if backend == 'mxu'
                 else partition_coo(X, mesh, dtype, device))
    elif sparse_mode and backend == 'mxu':
        with span('rri.sparse.plan', device):
            X_dev = plan_sparse_matrix(X, dtype, device=device)
    elif sparse_mode:
        X_dev = TorchSparseX(to_torch_sparse(X, dtype, device))
    elif not masked_sparse and not staged and not x_quant \
            and x_store is None:
        X = X.to(dtype).contiguous()
        X_dev = X
    Wm = None
    Wm_block = isinstance(W_mat, RankBlock)
    if premade is not None:
        pass
    elif Wm_block:
        # this rank's block of the mask (parallel.distribute_dense)
        if not X_block and (_size(W_in) == 0 or _size(T_in) == 0):
            raise ValueError('a fresh init reads W_mat * X: a W_mat block '
                             'needs X as a block too (or W_in and T_in)')
        if W_mat.shape != (n, d) or (
                mesh is not None and W_mat.split != mesh.split(n, d)):
            raise ValueError('the W_mat block is the %r of a %s mask; this '
                             'mesh gives this rank %r of %s: rebuild it '
                             'over this mesh' % (W_mat.split, W_mat.shape,
                                                 mesh and mesh.split(n, d),
                                                 (n, d)))
        Wm = W_mat.block.to(device=device, dtype=dtype).contiguous()
    elif masked_sparse:
        if tuple(W_mat.shape) != (n, d):
            raise ValueError('W_mat must have the shape of X, %s; got %s'
                             % ((n, d), tuple(W_mat.shape)))
    elif masked:
        # the mask on the fit's device in the fit's dtype
        Wm = as_tensor(W_mat, device=device, dtype=dtype).contiguous()
        if tuple(Wm.shape) != (n, d):
            raise ValueError('W_mat must have the shape of X, %s; got %s'
                             % ((n, d), tuple(Wm.shape)))

    # ---- row weighting: X pre-scaled by sqrt(w_row) where it lies
    # (reference nmf.py:335-344); the unscaled X serves the W refit
    X_orig = wr = None
    if w_row is not None:
        X_orig = X
        wr = as_tensor(w_row, device=device, dtype=dtype).reshape(n, 1)
        # (promoted: X's storage may be narrower than the factors)
        X = torch.sqrt(wr.to(X.device)) * X
        X_dev = X
    # the stored form: the int16 code or the 16-bit X, on the card
    if x_quant:
        # (a rank's block: each column's scale from its maximum over dp)
        X_dev = (X if x_quant_in else
                 quantize_x(X, dtype, mesh=mesh if X_block else None)
                 .to(device))
    elif x_store is not None:
        X_dev = X.to(x_store).to(device).contiguous()
    elif staged and not (sparse_mode or masked_sparse):
        X_dev = X.to(dtype).to(device).contiguous()

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
    # resets, and Γ/Θ within the Gram budget in full or in k-panels; on a
    # mesh Θ holds each rank's n / dp rows
    gram_panel = None
    masked_gram = False
    if masked_sparse:
        dp = 1 if mesh is None else mesh.shape[0]
        gram_panel = auto_panel(k, n / dp, d, dtype.itemsize)
        gram_fits = gram_panel is None or gram_panel >= 1
        gram_mesh_ok = mesh is None or (mesh.shape[1] == 1
                                        and not w_row_sum_is_vector)
        masked_gram = (update_order == 'phase' and reset_topic_method is None
                       and gram_mesh_ok and gram_fits)
        if premade == 'masked_gram':
            # the plan's type, not the heuristics, picks the sweep
            # (reference nmf.py:920-937)
            if update_order != 'phase':
                raise ValueError(
                    "this plan was built for the Gram-phase sweep "
                    "(backend=%r); pass update_order='phase'" % (X.backend,))
            if reset_topic_method is not None:
                raise ValueError('the Gram-phase sweep supports '
                                 'reset_topic_method=None only')
            if not gram_fits:
                raise ValueError(
                    'even single-row Γ/Θ panels exceed the Gram budget '
                    '(k=%d, shape %s); rebuild the plan with '
                    'distribute_masked_coo(backend=None)' % (k, (n, d)))
            masked_gram = True
        elif premade == 'masked_coo':
            if update_order == 'phase':
                warnings.warn(
                    "update_order='phase' needs a Gram plan; this "
                    'interleaved COO plan runs the reference order (rebuild '
                    "it with distribute_masked_coo(backend='segsum' or "
                    "'mxu') for the Gram-phase sweep)", RuntimeWarning,
                    stacklevel=2)
                update_order = 'interleaved'
            masked_gram = False
        elif update_order == 'phase' and not masked_gram:
            why = ('reset_topic_method=%r is set (a mid-phase reset would '
                   'rewrite the frozen factor)' % (reset_topic_method,)
                   if reset_topic_method is not None else
                   'even single-row Γ/Θ panels exceed the Gram budget '
                   '(sweep_masked_gram.GRAM_BUDGET_BYTES; k=%d, shape %s)'
                   % (k, (n, d)) if not gram_fits else
                   'the mesh is not (n_devices, 1) or a per-row w_row_sum '
                   'vector is set')
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
        if mesh is not None:
            # every rank of a mesh draws from the first rank's seed
            random_state = int(mesh.from_first(torch.tensor(
                [random_state], dtype=torch.int64,
                device=mesh.control_device(device)))[0])

    t_global_start = time.time()
    max_time = max_time - 10  # reserve time for the final W projection

    if w_row_sum_is_vector:
        w_row_sum = as_tensor(w_row_sum, device=device).reshape(-1, 1)
        if w_row is not None:
            # rows of X are scaled by sqrt(w_row), so rows of W must sum
            # to the sqrt as well (reference nmf.py:340-344)
            w_row_sum = w_row_sum.sqrt()
        w_row_sum = w_row_sum.to(dtype)
    elif w_row_sum is not None:
        w_row_sum = float(w_row_sum)

    if n <= k:
        init = 'random'

    stage('rri.nmf.init', device)
    start_time = time.perf_counter()
    X_init, Wm_init = X, Wm
    fresh = _size(W_in) == 0 or _size(T_in) == 0
    first = mesh is None or mesh.member() == (0, 0)
    if masked_sparse:
        X_init, Wm_init = None, None
        if fresh and first:
            X_init = _masked_init_matrix(X, W_mat)
    elif X_block:
        # every rank initializes from its own block, through the mesh
        if Wm is not None and not Wm_block:
            Wm = mesh.block(Wm, mesh.split(n, d))
            Wm_block = True
        X_init = (RankBlock(X if Wm is None else Wm * X, split_in, host)
                  if fresh else None)
        Wm_init = None
    if not first and fresh and not X_block:
        # a fresh init runs on the first rank and is shared with the rest
        W = torch.zeros(n, k, dtype=dtype, device=device)
        T = torch.zeros(k, d, dtype=dtype, device=device)
    else:
        W, T = _initialize_and_validate(
            W_in=W_in, T_in=T_in, W_mat=Wm_init, X=X_init, k=k, init=init,
            random_state=random_state,
            project_T_each_iter=project_T_each_iter,
            project_W_each_iter=project_W_each_iter, w_row_sum=w_row_sum,
            t_row_sum=t_row_sum, fix_W=fix_W, fix_T=fix_T, n=n, d=d,
            device=device, dtype=dtype, mesh=mesh)
    stage('rri.nmf.plan', device)

    # ---- the mesh: this rank's blocks (parallel/mesh.py); the whole
    # factors come back at the end of the fit
    split = whole = None
    w_row_sum_all = w_row_sum
    if mesh is not None:
        # what the caller gave every rank whole, for the objective's
        # pickle (no rank holds a sparse X or a sparse mask whole)
        whole = dict(X=None if (sparse_mode or masked_sparse or X_block
                                or Wm_block) else X_dev,
                     Wm=None if Wm_block else Wm, wr=wr)
        if fresh and not X_block:
            W, T = mesh.from_first(W), mesh.from_first(T)
        split = mesh.split(n, d)
        if n % mesh.shape[0] or d % mesh.shape[1]:
            logger.warning(
                'X shape (%d, %d) does not sit on the (%d, %d) mesh quanta; '
                'splitting it in uneven blocks (the first n %% dp rows and '
                'd %% tp columns one longer): the numbers of an aligned '
                'split', n, d, *mesh.shape)
        if not (sparse_mode or masked_sparse or X_block):
            # (a sparse X_dev is the block already; a sparse-mask plan is
            # made of the rank's rows below; a rank's block is its own)
            X_dev = mesh.block(X_dev, split)
        if Wm is not None and not Wm_block:
            Wm = mesh.block(Wm, split)
        if not isinstance(W_in, RankBlock):
            W = mesh.block(W, split, cols=False)
        T = mesh.block(T, split, rows=False)
        if w_row_sum_is_vector:
            w_row_sum = mesh.block(w_row_sum, split, cols=False)
        if wr is not None:
            wr = mesh.block(wr, split, cols=False)

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
        update_order=update_order, mesh=mesh,
        matmul_precision=matmul_precision, inner_reps=inner_reps)
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
    if x_quant:
        # the int16 code is read only by the dense kernel sweep's
        # scale-folded products (reference nmf.py:1504-1519)
        if not supports_dense_kernels(cfg, d, dtype, device):
            raise ValueError(
                "x_dtype='int16' runs on the fused dense phase kernels: "
                "it requires update_order='phase', "
                'reset_topic_method=None, no store_gradients, no DP '
                'noise, and the projected (k, d) T panel within the '
                "kernels' shared memory; got update_order=%r, "
                'reset_topic_method=%r' % (update_order, reset_topic_method))
        use_pallas = True
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
    # B3/B4 cover a dense mask by their gate: on a mesh the sharded one
    masked_ok = (supports_masked_kernels(cfg) if mesh is None
                 else supports_sharded_masked(cfg))
    if use_pallas is True and not sparse_mode and not dense_ok and \
            not masked_ok:
        logger.warning('use_pallas requested but config unsupported by the '
                       'kernels; falling back to the plain sweep.')
    if masked_sparse:
        # the observed set, planned on the host once for this call (on a
        # mesh this rank's row block)
        if masked_gram:
            X_dev = (X if premade is not None else
                     plan_masked_gram(X, W_mat, dtype, backend=gram_backend,
                                      device=device) if mesh is None else
                     partition_masked_gram(X, W_mat, mesh, dtype,
                                           backend=gram_backend,
                                           device=device))
            if gram_panel is not None:
                logger.info('Gram-phase masked sweep: k=%d exceeds the '
                            'full-tensor budget; tiling Γ/Θ in %d-panel '
                            'tiles', k, gram_panel)
            masked_sweep = (make_masked_gram_sweep(cfg, X_dev.backend,
                                                   gram_panel)
                            if mesh is None else
                            make_sharded_masked_gram_sweep(
                                cfg, mesh, X_dev.backend, gram_panel))
        else:
            X_dev = (X if premade is not None else
                     plan_masked_coo(X, W_mat, dtype, device=device)
                     if mesh is None else
                     partition_masked_coo(X, W_mat, mesh, dtype, device))
            masked_sweep = (make_masked_sparse_sweep(cfg) if mesh is None
                            else make_sharded_masked_sparse_sweep(cfg, mesh))

        def sweep_fn(X, W, T):
            nonlocal resets_left
            W, T, resets_left = masked_sweep(X, W, T, draws, resets_left,
                                             *extras)
            return W, T
    elif sparse_mode:
        sparse_sweep = (make_sparse_sweep(cfg, backend) if mesh is None
                        else make_sharded_mxu_sweep(cfg, mesh)
                        if backend == 'mxu'
                        else make_sharded_sparse_sweep(cfg, mesh))

        def sweep_fn(X, W, T):
            return sparse_sweep(X, W, T, wrs)
    elif (masked_ok and use_pallas is not False
          and not (use_pallas is None and dtype in NARROW)):
        # B3/B4 (each rank's block on a mesh). 16-bit factors take the
        # plain masked sweep unless use_pallas asks for the kernels (the
        # JAX rule, reference nmf.py:1489-1499)
        masked_sweep = (make_masked_sweep(cfg) if mesh is None
                        else make_sharded_masked_sweep(cfg, mesh))

        def sweep_fn(X, W, T):
            nonlocal resets_left
            W, T, resets_left = masked_sweep(X, W, T, Wm, draws, resets_left,
                                             wrs)
            return W, T
    elif dense_ok and reset_topic_method is None:
        dense_sweep = (make_sharded_dense_sweep(cfg, mesh)
                       if mesh is not None else make_dense_phase_sweep(cfg))

        def sweep_fn(X, W, T):
            return dense_sweep(X, W, T, wrs)
    else:
        plain = DenseResetSweep(cfg) if dense_ok else make_sweep(cfg)

        def sweep_fn(X, W, T):
            nonlocal resets_left, stored
            W, T, resets_left, *stored = plain(X, W, T, draws, resets_left,
                                               *extras)
            return W, T

    # ---- extrapolation (accel='her', reference nmf.py:1598-1656): momentum
    # and objective-checked restarts around the sweep picked above --------
    her_state = None
    # the objectives' dtype: float32 beside 16-bit factors (reference
    # nmf.py:1614)
    acc_dt = work_dtype(dtype)
    if accel is None and accel_opts:
        raise ValueError("accel_opts requires accel='her'")
    if accel is not None:
        if accel != 'her':
            raise ValueError("accel must be None or 'her'")
        if not supports_her(cfg) or sparse_mode or fix_W or fix_T:
            raise ValueError(
                "accel='her' requires a non-sparse-mode config with "
                'reset_topic_method=None, no store_gradients, no DP '
                'noise, and both factors free')
        her_opts = dict(gamma=1.05, beta0=0.5, beta_max=0.9999)
        if accel_opts:
            unknown = set(accel_opts) - set(her_opts)
            if unknown:
                raise ValueError('accel_opts: unknown keys %s (valid: %s)'
                                 % (sorted(unknown), sorted(her_opts)))
            her_opts.update({k: float(v) for k, v in accel_opts.items()})
        her_extras = (Wm,) if masked else ()
        her_step = make_her_step(sweep_fn, make_residual_obj(cfg),
                                 gamma=her_opts['gamma'],
                                 beta_max=her_opts['beta_max'])
        her_state = {}

        def sweep_fn(X, W, T):
            if not her_state:
                inf = torch.tensor(float('inf'), dtype=acc_dt, device=device)
                her_state.update(
                    Wy=W, Ty=T, Wb=W, Tb=T, eb=inf,
                    beta=torch.tensor(her_opts['beta0'], dtype=torch.float32,
                                      device=device),
                    e=inf)
            W1, T1, Wy, Ty, Wb, Tb, eb, b, e = her_step(
                X, W, T, her_state['Wy'], her_state['Ty'], her_state['Wb'],
                her_state['Tb'], her_state['eb'], her_state['beta'],
                her_state['e'], *her_extras)
            her_state.update(Wy=Wy, Ty=Ty, Wb=Wb, Tb=Tb, eb=eb, beta=b, e=e)
            return W1, T1

    def _her_ckpt_state():
        """The momentum state for a checkpoint (None when accel is off)."""
        if her_state:
            return {k: her_state[k]
                    for k in ('Wy', 'Ty', 'beta', 'e', 'Wb', 'Tb', 'eb')}
        return None

    # factors between the whole and this rank's blocks on a mesh (the
    # identity without one): checkpoints and callbacks see whole factors
    def _block_w(A):
        return A if mesh is None else mesh.block(A, split, cols=False)

    def _block_t(A):
        return A if mesh is None else mesh.block(A, split, rows=False)

    def _whole_w(A):
        return A if mesh is None else mesh.gather_rows(A, split)

    def _whole_t(A):
        return A if mesh is None else mesh.gather_cols(A, split)

    # ---- checkpoint/resume (reference nmf.py:1662-1726) --------------------
    ckpt = None
    start_iter = 0
    resumed = None
    if checkpoint is not None:
        ckpt_owned = not isinstance(checkpoint, NMFCheckpointer)
        ckpt = NMFCheckpointer(checkpoint) if ckpt_owned else checkpoint
        # on a mesh the first rank reads, and every rank takes what it
        # found: ranks that see other directories take the same branch
        resumed = (ckpt.restore(device=device) if mesh is None
                   else restore_shared(ckpt, mesh, device))
        if resumed is not None:
            logger.info('Resuming from checkpoint step %d',
                        resumed.iteration)
            W = _block_w(resumed.W.to(device=device, dtype=dtype))
            T = _block_t(resumed.T.to(device=device, dtype=dtype))
            _restore_draws(draws, resumed, device, random_state)
            resets_left = int(resumed.resets_left)
            start_iter = resumed.iteration
            if her_state is not None:
                her = resumed.her
                if her is not None:
                    # continue the momentum sequence exactly: resumed HER
                    # fit ≡ straight HER fit
                    her_state.update(
                        Wy=_block_w(her['Wy'].to(dtype)),
                        Ty=_block_t(her['Ty'].to(dtype)),
                        beta=her['beta'].to(torch.float32),
                        e=her['e'].to(acc_dt))
                    if 'Wb' in her:
                        her_state.update(Wb=_block_w(her['Wb'].to(dtype)),
                                         Tb=_block_t(her['Tb'].to(dtype)),
                                         eb=her['eb'].to(acc_dt))
                    else:
                        # written before best-iterate tracking: the
                        # checkpointed factors are the last accepted
                        # iterate, whose objective is her['e']
                        her_state.update(Wb=W, Tb=T,
                                         eb=her['e'].to(acc_dt))
                elif resumed.iteration > 0:
                    logger.warning(
                        'Checkpoint at step %d carries no extrapolation '
                        'state (written without accel=\'her\'); the '
                        'momentum sequence restarts from this point.',
                        resumed.iteration)

    # ---- early stopping state (reference nmf.py:360-363, 1733-1756) -------
    _es_active = bool(early_stop) and (callable(early_stop)
                                       or compute_obj_each_iter)
    _es_rolled_back = False
    if early_stop and not _es_active:
        logger.warning(
            'early_stop=%r scores from the tracked objective, but '
            'compute_obj_each_iter=False — no score is ever computed, so '
            'early stopping will never trigger. Pass '
            'compute_obj_each_iter=True (or a callable early_stop).',
            early_stop)
    if _es_active:
        last_score = np.inf
        if resumed is not None and resumed.es_score is not None:
            # the straight fit's comparison state: without it a resumed
            # fit misses the stop it makes at the first score increase
            last_score = float(resumed.es_score)
        W_prev, T_prev = W, T

    obj_history = []
    iter_cputime = []
    if logger.getEffectiveLevel() <= logging.DEBUG:
        compute_obj_each_iter = True
    OBJ = None
    if compute_obj_each_iter:
        # the plan modes' X is a layout plan: the sparse objective's cross
        # term wants the plain coordinate list (reference nmf.py:1762-1790)
        X_obj = X_dev
        if premade == 'mxu':
            X_obj = X.obj_coo
            if X_obj is None:
                raise ValueError(
                    'compute_obj_each_iter with a pre-built MXU plan needs '
                    "its COO companion; build the plan with distribute_"
                    "sparse_coo(backend='mxu', with_obj_coo=True), or pass "
                    'compute_obj_each_iter=False')
        elif sparse_mode:
            X_obj = (X_dev.coo if backend == 'torch'
                     else to_torch_sparse(X, dtype, device) if mesh is None
                     else partition_coo(X, mesh, dtype, device).coo)
        OBJ = TrueObjComputer(X_obj, W, T, reg_w_l1=reg_w_l1,
                              reg_t_l2=reg_t_l2, reg_w_l2=reg_w_l2,
                              reg_t_l1=reg_t_l1, Wm=Wm,
                              matmul_precision=matmul_precision,
                              sparse=sparse_mode,
                              masked_sparse=masked_sparse, wr=wr, mesh=mesh,
                              whole=whole)

    # (a QuantizedX given as X reaches the callbacks dequantized)
    X_cb = (_Gathered(mesh, X, split) if X_block else
            X_user if X_is_sparse or masked_sparse else
            _Dequantized(X) if x_quant_in else X)
    for func in diagnostics:
        rtv['diagnostics'][func.__name__].append(
            func(_x(X_cb), _whole_w(W), _whole_t(T)))
    if store_gradients:
        rtv['numer_W'] = {}
        rtv['denom_W'] = {}

    if resumed is not None:
        # a restored fit: its history, so the stopping rule sees it
        # (reference nmf.py:1818-1840)
        obj_history = list(resumed.obj_history)
        if compute_obj_each_iter and not resumed.obj_tracked and \
                resumed.iteration > 0:
            logger.warning(
                'Checkpoint at step %d was written without objective '
                'tracking (grouped dispatch); obj_history restarts empty, '
                'so the universal stopping condition behaves as from a '
                'fresh start.', resumed.iteration)
        if compute_obj_each_iter and universal_stopping_condition(
                obj_history, eps_stop=eps_stop):
            # the straight fit stopped at the end of this iteration; one
            # more sweep could hop between tied solutions
            logger.info('STOPPING on restore: the restored obj_history '
                        'already meets the stopping condition')
            start_iter = max_iter

    def _save(step, tracked, history):
        # on a mesh the first rank writes the whole factors, gathered from
        # every rank, and the others wait until it has
        her = _her_ckpt_state()
        if her is not None and mesh is not None:
            her = dict(her, Wy=_whole_w(her['Wy']), Ty=_whole_t(her['Ty']),
                       Wb=_whole_w(her['Wb']), Tb=_whole_t(her['Tb']))
        state = NMFState(
            W=_whole_w(W), T=_whole_t(T), iteration=step,
            obj_history=history, generator_state=draws.get_state(),
            resets_left=resets_left, random_state=random_state,
            obj_tracked=tracked, her=her,
            es_score=(float(last_score) if (_es_active
                                            and np.isfinite(last_score))
                      else None),
            generator_device=device.type)
        if mesh is None or mesh.member() == (0, 0):
            ckpt.save(step, state)
        if mesh is not None:
            mesh.barrier(device)

    # grouped sweeps (reference nmf.py:1842-1916): with no per-sweep host
    # work asked for, the device is synced, the clock stamped and max_time
    # checked only at the end of each group of sweeps; a group also ends
    # at each checkpoint step
    group = int(sweeps_per_dispatch)
    grouped = group > 1 and not (_es_active or compute_obj_each_iter
                                 or diagnostics or store_gradients
                                 or debug_checks)

    # ---- outer iteration loop (reference nmf.py:377-514) ------------------
    stage(None, device)
    for iter_no in range(start_iter, max_iter):
        logger.info('Iteration %d', iter_no)

        if _es_active:
            with span('rri.nmf.score'):
                if callable(early_stop):
                    this_score = float(early_stop(_x(X_cb), _whole_w(W),
                                                  _whole_t(T)))
                elif compute_obj_each_iter and len(obj_history) > 0:
                    this_score = obj_history[-1]
                else:
                    this_score = np.inf
            logger.info('Iter %d stopping score %.3f', iter_no, this_score)
            if this_score > last_score:  # STOP EARLY (nmf.py:391-403)
                logger.info('Stopping early at iter %d', iter_no)
                _es_rolled_back = True
                W, T = W_prev, T_prev
                obj_history = obj_history[:-1]
                iter_cputime = iter_cputime[:-1]
                for func in diagnostics:
                    rtv['diagnostics'][func.__name__] = \
                        rtv['diagnostics'][func.__name__][:-1]
                break
            last_score = this_score
            W_prev, T_prev = W, T

        stage('rri.nmf.sweep')
        it_start_time = time.time()
        _md = None
        if OBJ is not None and logger.getEffectiveLevel() <= logging.DEBUG:
            from rri_nmf_tpu_torch.utils.debug import MeasureDelta
            OBJ.W, OBJ.T = W, T
            _md = MeasureDelta(OBJ.true_objective,
                               'iter %d sweep' % iter_no, log=logger)
            _md.__enter__()

        W, T = sweep_fn(X_dev, W, T)
        if store_gradients:
            rtv['numer_W'][iter_no], rtv['denom_W'][iter_no] = stored

        if _md is not None:
            OBJ.W, OBJ.T = W, T
            _md.__exit__(None, None, None)

        if debug_checks:
            from rri_nmf_tpu_torch.utils.debug import validate_factors
            validate_factors(_whole_w(W), _whole_t(T), w_row_sum=w_row_sum_all,
                             t_row_sum=t_row_sum,
                             project_W_each_iter=project_W_each_iter,
                             project_T_each_iter=project_T_each_iter)

        save_now = ckpt is not None and checkpoint_every > 0 and \
            (iter_no + 1) % checkpoint_every == 0
        if grouped:
            pending = iter_no + 1 - start_iter - len(iter_cputime)
            if pending < group and iter_no + 1 < max_iter and not save_now:
                continue
            _sync(device)
            iter_cputime.extend([time.perf_counter()] * pending)
        elif compute_obj_each_iter:
            OBJ.W, OBJ.T = W, T
            with span('rri.nmf.score'):
                obj_history.append(OBJ.true_objective())
            logger.info('\tObj: %3.3e', obj_history[-1])
            iter_cputime.append(time.perf_counter())
        else:
            _sync(device)   # keep the host clock honest
            iter_cputime.append(time.perf_counter())
        stage()

        for func in diagnostics:
            dval = func(_x(X_cb), _whole_w(W), _whole_t(T))
            rtv['diagnostics'][func.__name__].append(dval)
            logger.info('\t%s: %s', func.__name__, dval)

        logger.info('\tTime: %.3fsec', time.time() - it_start_time)

        if save_now:
            _save(iter_no + 1, bool(compute_obj_each_iter),
                  list(obj_history))

        out_of_time = time.time() - t_global_start >= max_time
        if mesh is not None and mesh.size > 1:
            # the ranks stop together
            out_of_time = bool(mesh.any_all(torch.tensor(
                out_of_time, device=mesh.control_device(device))))
        if out_of_time:
            logger.info('STOPPING because max_time after iter %d', iter_no)
            break
        if compute_obj_each_iter and universal_stopping_condition(
                obj_history, eps_stop=eps_stop):
            logger.info('STOPPING because obj_history after iter %d', iter_no)
            break

    stage('rri.nmf.finish')
    iter_cputime = [x - start_time for x in iter_cputime]

    # ---- HER: the lowest-objective accepted iterate (reference
    # nmf.py:2038-2050); an early-stop rollback keeps its own iterate ------
    if her_state and not _es_rolled_back:
        if bool(her_state['eb'] < her_state['e']):
            logger.info('HER: returning the best accepted iterate '
                        '(objective %.6g < final %.6g)',
                        float(her_state['eb']), float(her_state['e']))
            W, T = her_state['Wb'], her_state['Tb']

    # ---- final W projection (reference nmf.py:519-529) --------------------
    if (not project_W_each_iter and w_row_sum is not None and not fix_W
            and do_final_project_W):
        logger.info('Post completion W row projection')
        W = proj_mat_to_simplex(W, w_row_sum if not w_row_sum_is_vector
                                else w_row_sum.reshape(-1))

    # the whole factors, the same on every rank of a mesh
    W, T = _whole_w(W), _whole_t(T)

    # ---- row-weighted post-solve: W refit on the unscaled X (reference
    # nmf.py:531-539, with the run's settings threaded through as the JAX
    # package does, nmf.py:2063-2078) ------------------------------------
    if w_row is not None:
        sub = nmf(X_orig, k, T_in=T, fix_T=True, max_iter=10,
                  w_row_sum=w_row_sum_all, project_W_each_iter=True,
                  compute_obj_each_iter=compute_obj_each_iter,
                  random_state=random_state, dtype=dtype, mesh=mesh,
                  matmul_precision=matmul_precision, device=device)
        obj_history.extend(sub.get('obj_history', []))
        iter_cputime.extend(sub['iter_cputime'])
        W = sub['W']

    rtv['W'] = W.contiguous()
    rtv['T'] = T.contiguous()
    rtv['n_resets_remaining'] = resets_left
    if compute_obj_each_iter:
        rtv['obj_history'] = obj_history
        OBJ.W, OBJ.T = _block_w(rtv['W']), _block_t(rtv['T'])
        if whole is not None:
            whole.update(W=rtv['W'], T=rtv['T'])
        rtv['obj_calculator'] = OBJ
    rtv['iter_cputime'] = iter_cputime
    rtv['random_state'] = random_state
    if ckpt is not None and ckpt_owned:
        ckpt.close()
    stage(None, device)
    return rtv


class _Dequantized(object):
    """A QuantizedX for the callbacks, dequantized at its first use."""

    def __init__(self, qx):
        self.qx = qx
        self.X = None


class _Gathered(object):
    """A rank's block of X for the callbacks, gathered whole over the mesh
    at its first use (the JAX package's ``_to_host`` of a process-spanning
    X; every rank calls the callbacks together)."""

    def __init__(self, mesh, block, split):
        self.mesh = mesh
        self.block = block
        self.split = split
        self.X = None


def _x(X_cb):
    """The X a callback receives (see :class:`_Dequantized` and
    :class:`_Gathered`)."""
    if isinstance(X_cb, _Dequantized):
        if X_cb.X is None:
            X_cb.X = dequantize_x(X_cb.qx)
        return X_cb.X
    if isinstance(X_cb, _Gathered):
        if X_cb.X is None:
            m, s = X_cb.mesh, X_cb.split
            X_cb.X = m.gather_cols(m.gather_rows(X_cb.block, s), s)
        return X_cb.X
    return X_cb


def _restore_draws(draws, state, device, random_state):
    """Set the restored generator state on ``draws`` (seeded with
    ``random_state``). A state written on another device type, or none at
    all, cannot be set: the generator keeps its seed, and that is
    logged."""
    if state.generator_state is None:
        logger.info('checkpoint at step %d carries no generator state; the '
                    'generator is seeded from random_state=%d',
                    state.iteration, random_state)
    elif state.generator_device != device.type:
        logger.warning(
            'checkpoint at step %d holds a %s generator state, which a %s '
            'fit cannot set; the generator re-seeds from random_state=%d '
            '(the factors, history and reset budget resume)',
            state.iteration, state.generator_device, device.type,
            random_state)
    else:
        draws.set_state(state.generator_state)


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
                             dtype, mesh=None):
    """Initialize W, T or validate warm starts (reference
    ``_initialize_and_validate``, ``nmf.py:819-880``): a fresh init runs
    on the masked matrix ``W_mat * X`` when masked, fresh factors get
    their row sums scaled to ``t_row_sum``/``w_row_sum``, warm starts are
    shape-checked, negatives clipped, and the initial simplex projections
    applied when per-iteration projection is on. A sparse X (scipy or a
    torch sparse tensor) initializes as it is, never densified. Returns
    tensors on ``device`` in ``dtype``. A rank's block of X (a
    :class:`~rri_nmf_tpu_torch.parallel.multihost.RankBlock`) initializes
    through ``mesh`` on every rank, the SVD family on the device backend,
    as JAX's does for a process-spanning X; a RankBlock ``W_in`` stays
    this rank's rows."""
    W = T = None
    if _size(W_in) == 0 or _size(T_in) == 0:
        # scikit-learn's SVD in float64 (on the host for a CPU X, the
        # reference's goldens; on the card for a CUDA X); the device
        # backend for a QuantizedX or a rank's block (reference
        # nmf.py:2145-2166)
        backend = ('torch' if isinstance(X, (QuantizedX, RankBlock))
                   else 'sklearn')
        if isinstance(X, RankBlock) and init == 'coherence_pmi':
            raise ValueError(
                "init='coherence_pmi' walks X on the host; with a "
                'rank-block X initialize explicitly and pass W_in/T_in')
        W, T = initialize_nmf(X if W_mat is None else W_mat * X, k, init,
                              random_state=random_state,
                              row_normalize=False, svd_backend=backend,
                              device=device,
                              mesh=mesh if isinstance(X, RankBlock) else None)
        if t_row_sum is not None:
            T = normalize(T) * t_row_sum
        if w_row_sum is not None:
            W = normalize(W) * w_row_sum
    rows = None
    if isinstance(W_in, RankBlock):
        # this rank's rows of W (parallel.distribute_factors)
        if W_in.shape != (n, k) or mesh is None or (
                W_in.split.r0, W_in.split.r1) != mesh.split(n, d)[2:4]:
            raise ValueError('W_in has wrong dimensions, must be n*k, its '
                             'block the rows of this rank')
        W = W_in.block
        rows = slice(W_in.split.r0, W_in.split.r1)
    elif _size(W_in) > 0:
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
                                else w_row_sum.reshape(-1)[rows or
                                                           slice(None)])
    if project_T_each_iter and not fix_T and t_row_sum is not None:
        logger.debug('Projecting T rows after initialization')
        T = proj_mat_to_simplex(T, t_row_sum)
    return W, T

