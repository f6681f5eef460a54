"""The plain sweep: the interleaved order, topic resets, DP noise and the
Gram-blocked phase form.

Counterpart of :mod:`rri_nmf_tpu.ops.sweep_xla`: :class:`SweepConfig`
(copied field for field, without JAX), :func:`resolve_mixed_dtypes`,
:func:`make_objective` (plain, masked or row-weighted, with the
row-blocked option),
:func:`make_reset_rowcol` (``'max_resid_document'``, blockwise or
whole, and ``'random'``) and :func:`make_sweep`, the sweep the JAX
package runs when no fused kernel covers a config: the reference's
interleaved order (the ``nmf()`` default), unmasked or masked, the
Gram-blocked phase form (``use_pallas=False``, and the fixed-T transform
when a reset fires), gradient stores and DP noise. The kernel sweeps live
in :mod:`rri_nmf_tpu_torch.ops.dense_kernels` (phase order) and
:mod:`rri_nmf_tpu_torch.ops.masked_kernels` (masked WRRI).

**Resets without a host sync per topic.** JAX decides each reset on the
device (``lax.cond``). Here a sweep first runs *speculatively*: no reset
fires, and a dead topic is left as the no-reset branch leaves it. One
read after the sweep asks whether any topic came out dead while budget
was left (:func:`_dead_topics`). If none did, the speculative result is
the sweep's result. If one did, the sweep runs again from its inputs
(which it never writes) with each check read on the host, resetting as
JAX does; resets are rare. A topic that dies with no budget left changes
nothing, so with no budget nothing is checked. On the card the
speculative sweep is one CUDA graph.

**Storage dtypes** follow :func:`resolve_mixed_dtypes`, as in the JAX
package: a sweep works its factors in the accumulator dtype (float32 for
16-bit factors) and rounds each stored T row, W column and masked
residual update to the factors' dtype, and a narrower X (``x_dtype=
'bfloat16'``, 16-bit factors) enters its products through
:func:`~rri_nmf_tpu_torch.ops.quantized.xmm`, a block of rows at a time.
The objectives evaluate in the accumulator dtype, over a
:class:`~rri_nmf_tpu_torch.ops.quantized.QuantizedX`'s dequantized blocks
where X is quantized.

**X's nonzeros.** Where X is mostly zeros, the interleaved W side's
per-topic ``X @ T[t]`` reads X's nonzeros through the SpMV kernel
(:mod:`rri_nmf_tpu_torch.ops.spmv`, :meth:`Sweep.rows`) in place of a
GEMV over the dense X; every other product reads the dense X.

Random numbers (the ``'random'`` reset, the DP noise) come from a
``draws`` object (:class:`GeneratorDraws`: a ``torch.Generator``); the
tests pass one that draws what ``jax.random`` draws, so a reset that
fires is held against JAX value for value.

**On a mesh** (``cfg.mesh``, a :class:`rri_nmf_tpu_torch.parallel.mesh.
Mesh`) the sweep runs on this rank's blocks of X, W and T and all-reduces
where JAX's GSPMD sweep does: the sums over rows (``WᵀX``, ``WᵀW``,
``||W[:, t]||²``, a W column's sum) over ``dp``, the sums over columns
(``X @ T[t]``, ``TTᵀ``, ``||T[t]||²``, a T row's sum) over ``tp``; a T row
that is projected onto the simplex is gathered whole over ``tp`` first.
Every rank draws from one seed, so the random draws agree; each takes its
block of a drawn row or column. The dead-topic check is agreed over the
mesh before any rank picks the speculative result or the eager re-run.
The speculative sweep is one CUDA graph only where the mesh's collectives
can be captured (:attr:`~rri_nmf_tpu_torch.parallel.mesh.Mesh.graphable`:
NCCL, or a one-rank mesh).
"""

import contextlib
import dataclasses
import itertools
import logging
import weakref
from typing import Any, Optional, Tuple

import torch

from rri_nmf_tpu_torch.matrixops import (_proj_simplex_core,
                                         reproject_row_if_drifted)
from rri_nmf_tpu_torch.ops import spmv
from rri_nmf_tpu_torch.ops.quantized import (QuantizedX, dequantize_x,
                                             qx_row_block, work_dtype, xmm)
from rri_nmf_tpu_torch.optimization import (qf_min_scalar_c,
                                            qf_min_scalar_free,
                                            qf_min_vector_c,
                                            qf_min_vector_c_sharded)
from rri_nmf_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)

# a topic is alive while its row (column) sums above this (reference
# nmf.py:757,790)
ALIVE = 1e-10


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """Static configuration of one sweep; field names mirror the
    reference ``nmf()`` kwargs. A per-row ``w_row_sum`` vector is passed
    to the sweep as a tensor instead (``w_row_sum_is_vector``). See
    :class:`rri_nmf_tpu.ops.sweep_xla.SweepConfig` for every field."""
    k: int
    fix_W: bool = False
    fix_T: bool = False
    masked: bool = False
    masked_sparse: bool = False
    project_T_each_iter: bool = False
    project_W_each_iter: bool = False
    t_row_sum: Optional[float] = None
    w_row_sum: Optional[float] = None
    w_row_sum_is_vector: bool = False
    reg_w_l2: float = 0.0
    reg_t_l2: float = 0.0
    reg_w_l1: float = 0.0
    reg_t_l1: float = 0.0
    reset_topic_method: Optional[str] = 'max_resid_document'
    fix_reset_seed: bool = False
    dp_sigma: Optional[float] = None
    store_gradients: bool = False
    store_rows: Optional[Tuple[int, ...]] = None
    update_order: str = 'interleaved'
    reset_blockwise: bool = True
    mesh: Optional[Any] = None
    matmul_precision: Optional[str] = None
    inner_reps: int = 1

    @property
    def scale_transfer(self) -> bool:
        """The reference's scale-invariance transfer (``nmf.py:449-452``):
        off in phase order, else on when all four regularizers are 0."""
        if self.update_order == 'phase':
            return False
        return (abs(self.reg_w_l1) + abs(self.reg_w_l2) +
                abs(self.reg_t_l1) + abs(self.reg_t_l2)) == 0

    @property
    def t_update_s(self):
        """Sum constraint of the T-row subproblem (reference
        ``nmf.py:442-445``)."""
        return self.t_row_sum if self.project_T_each_iter else None


def resolve_mixed_dtypes(x_dtype, w_dtype, matmul_precision=None):
    """``(dtype, acc, x_narrow)``: the factor dtype (follows W), the
    accumulator dtype (float32 for a 16-bit promoted pair, else the
    promotion) and whether the X products should cast their factor
    operand down to a bfloat16 X (only under default precision). The
    rules of :func:`rri_nmf_tpu.ops.sweep_xla.resolve_mixed_dtypes`."""
    wide = torch.promote_types(x_dtype, w_dtype)
    acc = work_dtype(wide)
    x_narrow = x_dtype == torch.bfloat16 and matmul_precision is None
    return w_dtype, acc, x_narrow


# jax.default_matmul_precision names -> torch float32 matmul precision.
# None keeps exact float32 products: on the card a float32 matmul is
# exact by default, while a TPU's default f32 dot is one bf16 pass.
_PRECISION = {None: 'highest', 'highest': 'highest', 'float32': 'highest',
              'high': 'high', 'tensorfloat32': 'high',
              'default': 'medium', 'fastest': 'medium', 'bfloat16': 'medium'}


@contextlib.contextmanager
def precision_scope(name):
    """Run the enclosed float32 products at the precision a JAX
    ``matmul_precision`` name asks for, and restore the previous
    setting after."""
    if name not in _PRECISION:
        raise ValueError('matmul_precision must be one of %s, got %r'
                         % (sorted(k for k in _PRECISION if k), name))
    prev = torch.get_float32_matmul_precision()
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision(_PRECISION[name])
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32


def mesh_sums(mesh, total, w_terms=(), t_terms=()):
    """``(total, w_terms, t_terms)`` of this rank's 0-d partial sums
    summed over ``mesh``: ``total`` (a sum over this rank's block of X)
    over the whole mesh, ``w_terms`` (sums over its W rows) over ``dp``
    and ``t_terms`` (sums over its T columns) over ``tp``, in one
    all-reduce per axis: a W term counts only on the first ``tp`` rank
    and a T term on the first ``dp`` rank, the others adding zeros. A
    None term stays None. With no mesh, or one rank, the sums come back
    as they are."""
    w_terms, t_terms = list(w_terms), list(t_terms)
    if mesh is None or mesh.size == 1:
        return total, w_terms, t_terms
    i, j = mesh.member()
    zero = total.new_zeros(())
    parts = ([total]
             + [w if w is None or j == 0 else zero for w in w_terms]
             + [t if t is None or i == 0 else zero for t in t_terms])
    live = [p is not None for p in parts]
    v = iter(mesh.sum_all(torch.stack([p for p in parts if p is not None])))
    out = [next(v) if ok else None for ok in live]
    nw = len(w_terms)
    return out[0], out[1:1 + nw], out[1 + nw:]


def make_objective(masked=False, row_weighted=False, reg_w_l2=0.0,
                   reg_t_l2=0.0, reg_w_l1=0.0, reg_t_l1=0.0,
                   block_rows=None, matmul_precision=None, mesh=None):
    """Build ``objective(X, W, T, M=None, wr=None) -> 0-d tensor``:
    ``0.5 Σ wr ⊙ M ⊙ (X - WT)²`` plus the four regularizers (reference
    ``nmf.py:71-94``), accumulated in the accumulator dtype. The mask
    ``M`` (n, d) is passed only when ``masked`` and the row weights ``wr``
    (n, 1) only when ``row_weighted``; each weights the squared entries,
    as :func:`rri_nmf_tpu.ops.sweep_xla.make_objective` does.

    ``block_rows`` sums the residual over row blocks of that size instead
    of materializing the whole ``W @ T`` product (for X near the device
    memory budget). X may be a :class:`~rri_nmf_tpu_torch.ops.quantized.
    QuantizedX`: dequantized a row block at a time (whole without
    ``block_rows``).

    With ``mesh`` X, W, T, ``M`` and ``wr`` are this rank's blocks, and
    the sums are taken over the mesh (:func:`mesh_sums`); every rank of
    the mesh calls the objective and gets the same value."""

    def _res_sq(acc, X, W, T, M, wr):
        R = (X.to(acc) - W.to(acc) @ T.to(acc)) ** 2
        if masked:
            R = M.to(acc) * R
        if row_weighted:
            R = wr.to(acc) * R
        return R.sum()

    def objective(X, W, T, M=None, wr=None):
        if masked and M is None:
            raise ValueError('the masked objective needs the mask M')
        if row_weighted and wr is None:
            raise ValueError('the row-weighted objective needs the weights')
        _, acc, _ = resolve_mixed_dtypes(X.dtype, W.dtype)
        qx = isinstance(X, QuantizedX)
        with precision_scope(matmul_precision):
            if block_rows is None:
                base = _res_sq(acc, dequantize_x(X) if qx else X, W, T, M,
                               wr)
            else:
                B = int(block_rows)
                base = sum(_res_sq(acc, qx_row_block(X, i, B, acc) if qx
                                   else X[i:i + B], W[i:i + B], T,
                                   M[i:i + B] if masked else None,
                                   wr[i:i + B] if row_weighted else None)
                           for i in range(0, X.shape[0], B))
        Wa = W.to(acc)
        Ta = T.to(acc)
        base, (w2, w1), (t2, t1) = mesh_sums(
            mesh, base, ((Wa ** 2).sum(), Wa.abs().sum()),
            ((Ta ** 2).sum(), Ta.abs().sum()))
        obj = 0.5 * base
        obj = obj + 0.5 * reg_w_l2 * w2
        obj = obj + 0.5 * reg_t_l2 * t2
        obj = obj + reg_t_l1 * t1
        obj = obj + reg_w_l1 * w1
        return obj

    return objective


# ---------------------------------------------------------------------------
# random numbers and topic resets
# ---------------------------------------------------------------------------

class GeneratorDraws(object):
    """The random numbers of a fit, from the ``torch.Generator`` ``gen``
    on the fit's device: uniform draws for the ``'random'`` reset and
    normal draws for the DP noise. torch draws other numbers than
    ``jax.random`` from the same seed (ROADMAP §C check 2); a test passes
    an object with the same four methods that draws JAX's."""

    def __init__(self, gen):
        self.gen = gen

    def reset(self, t, t_row, n, d, seeded):
        """Uniform ``(row (d,), column (n,))`` for resetting topic ``t``,
        whose T row is ``t_row``. ``seeded`` draws instead from a fresh
        generator seeded with ``initial_seed + t + argmax(t_row)``, the
        analog of the reference's ``np.random.seed(t + argmax(T[t]))``:
        the same on every run."""
        gen = self.gen
        if seeded:
            gen = torch.Generator(device=t_row.device).manual_seed(
                self.gen.initial_seed() + t + int(torch.argmax(t_row)))
        kw = dict(generator=gen, dtype=t_row.dtype, device=t_row.device)
        return torch.rand(d, **kw), torch.rand(n, **kw)

    def normal(self, like, shape):
        """Standard normal draws shaped as ``like`` and as ``shape``."""
        kw = dict(generator=self.gen, dtype=like.dtype, device=like.device)
        return torch.randn(like.shape, **kw), torch.randn(shape, **kw)

    def get_state(self):
        return self.gen.get_state()

    def set_state(self, state):
        self.gen.set_state(state)


def make_draws(random_state, device):
    """The draws of a fit seeded with ``random_state`` on ``device``."""
    return GeneratorDraws(torch.Generator(device=device).manual_seed(
        int(random_state)))


def make_reset_rowcol(cfg):
    """The topic reset for ``cfg``: ``reset(X, W, T, t, draws, split=None)
    -> (t_row, w_col)``, the new T row (d,) and W column (n,) for the dead
    topic ``t`` (reference ``nmf.py:770-783, 804-816``;
    :func:`rri_nmf_tpu.ops.sweep_xla.make_reset_rowcol`).

    - ``'max_resid_document'``: the document whose positive residual
      ``max(X[i] - W[i]·T, 0)`` has the largest squared norm becomes the
      row, and the column is one-hot on it. With ``cfg.reset_blockwise``
      the norms are taken over blocks of 4096 rows (the last block
      clamped to end at n), keeping the first maximum (strict ``>``, as
      ``argmax``), without an (n, d) temporary; else from the whole
      residual. The same document as JAX.
    - ``'random'``: a uniform row normalized to sum 1 and a uniform
      column, from ``draws.reset`` (seeded per topic with
      ``cfg.fix_reset_seed``).

    On a mesh (``cfg.mesh``) X, W and T are this rank's blocks, ``split``
    their :class:`~rri_nmf_tpu_torch.parallel.mesh.Split`, and the row and
    column come back as this rank's blocks, the same on every rank. The
    residual norms are taken blockwise over each rank's rows, summed over
    ``tp``, and the first maximum is kept over ``dp`` (JAX's mesh form,
    ``sweep_xla.py:323-386``); the owner of the document builds the row.
    A random reset draws the whole row and column on every rank (one
    seed) and each keeps its block."""
    method = cfg.reset_topic_method
    mesh = cfg.mesh
    if method not in ('max_resid_document', 'random'):
        raise ValueError('unknown reset_topic_method %r' % (method,))

    def scan(X, W, T, rts_of):
        """The first maximum of the residual norms over blocks of 4096
        rows: ``(value, row)``."""
        n = X.shape[0]
        B = min(n, 4096)
        best_val, best = float('-inf'), 0
        for i in range(-(-n // B)):
            start = min(i * B, n - B)
            R = (X[start:start + B] - W[start:start + B] @ T).clamp_min(0.0)
            rts = rts_of((R * R).sum(1))
            j = int(torch.argmax(rts))
            v = float(rts[j])
            if v > best_val:
                best_val, best = v, start + j
        return best_val, best

    def max_resid(X, W, T):
        if not cfg.reset_blockwise:
            R = (X - W @ T).clamp_min(0.0)
            return int(torch.argmax((R * R).sum(1)))
        return scan(X, W, T, lambda rts: rts)[1]

    def max_resid_mesh(X, W, T, split):
        """The reset's row and column blocks on a mesh."""
        val, li = scan(X, W, T, mesh.sum_tp)
        i = mesh.member()[0]
        # every dp rank's (value, global row), combined in rank order
        cand = torch.zeros(mesh.shape[0], 2, dtype=torch.float64,
                           device=X.device)
        cand[i, 0] = val
        cand[i, 1] = split.r0 + li
        best_val, mi = float('-inf'), 0
        for v, r in mesh.sum_dp(cand).tolist():
            if v > best_val:
                best_val, mi = v, int(r)
        mine = split.r0 <= mi < split.r1
        row = torch.zeros(X.shape[1], dtype=T.dtype, device=T.device)
        col = torch.zeros(X.shape[0], dtype=W.dtype, device=W.device)
        if mine:
            lmi = mi - split.r0
            row += (X[lmi] - W[lmi] @ T).clamp_min(0.0).to(T.dtype)
            col[lmi] = 1.0
        return mi, mesh.sum_dp(row), col

    def reset(X, W, T, t, draws, split=None):
        n, d = X.shape
        if method == 'random':
            if mesh is None:
                row, col = draws.reset(t, T[t], n, d, cfg.fix_reset_seed)
                return row / row.sum(), col
            row, col = draws.reset(t, mesh.gather_cols(T[t], split),
                                   split.n, split.d, cfg.fix_reset_seed)
            return (mesh.own_cols(row / row.sum(), split),
                    col[split.r0:split.r1])
        if mesh is not None:
            mi, row, col = max_resid_mesh(X, W, T, split)
            logger.info('topic %d reset to document %d', t, mi)
            return row, col
        mi = max_resid(X, W, T)
        logger.info('topic %d reset to document %d', t, mi)
        row = (X[mi] - W[mi] @ T).clamp_min(0.0).to(T.dtype)
        col = torch.zeros(n, dtype=W.dtype, device=W.device)
        col[mi] = 1.0
        return row, col

    return reset


def make_reset_factors(cfg):
    """The whole-matrix form of :func:`make_reset_rowcol`: ``reset(X, W,
    T, t, draws, split=None) -> (W, T)``, copies of W and T with column
    ``t`` of W and row ``t`` of T replaced by the reset's
    (:func:`rri_nmf_tpu.ops.sweep_xla.make_reset_factors`, with the
    port's ``draws`` in place of JAX's keys). The sweeps use the row and
    column form."""
    rowcol = make_reset_rowcol(cfg)

    def reset_factors(X, W, T, t, draws, split=None):
        row, col = rowcol(X, W, T, t, draws, split)
        W = W.clone()
        T = T.clone()
        W[:, t] = col
        T[t] = row
        return W, T

    return reset_factors


class _Resets(object):
    """A sweep's reset decisions. ``eager``: each check is read on the
    host, and a dead topic resets while ``budget`` is left. Otherwise
    (the speculative sweep) no reset fires and no check is made: the
    factors are checked once after the sweep (:func:`_dead_topics`)."""

    def __init__(self, budget, eager):
        self.budget = int(budget)
        self.eager = eager

    def __call__(self, alive):
        """Whether to reset a topic; ``alive()`` gives its 0-d aliveness
        (asked only in an eager sweep with budget left)."""
        if not self.eager or self.budget <= 0 or bool(alive()):
            return False
        self.budget -= 1
        return True


def _dead_topics(Wt, T, do_t, do_w, mesh=None):
    """A 0-d tensor: whether a reset check of the sweep just run found a
    dead topic. A T row is final once its topic's T-phase is done, a W
    column once its W-phase is, and neither changes after its check when
    no reset fires (a re-projected row sums to ``t_row_sum``), so the
    checks can all be made on the sweep's result: the T rows if the
    T-phase ran, the W columns (rows of ``Wt``, before the W row
    projection) if the W-phase did; None if neither phase ran. On a
    ``mesh`` the sums are taken over the mesh and the answer agreed by
    every rank."""
    dead = []
    if do_t:
        s = T.sum(1)
        dead.append(~((mesh.sum_tp(s) if mesh is not None else s) > ALIVE))
    if do_w:
        s = Wt.sum(1)
        dead.append(~((mesh.sum_dp(s) if mesh is not None else s) > ALIVE))
    if not dead:
        return None
    dead = torch.cat(dead).any()
    return mesh.any_all(dead) if mesh is not None else dead


def _gram_block_size(k):
    """Topic-block size of the Gram-blocked phase sweep: the largest
    divisor of k that is <= 16 (``sweep_xla._gram_block_size``)."""
    for b in range(min(16, k), 0, -1):
        if k % b == 0:
            return b
    return 1


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

class Sweep(object):
    """One sweep over all k topics for a static config (the counterpart
    of :func:`rri_nmf_tpu.ops.sweep_xla.make_sweep`)::

        sweep(X, W, T, draws, resets_left, *extras)
            -> (W, T, resets_left [, numer_store, denom_store])

    ``extras`` is ``(W_mat,)`` if ``cfg.masked`` and then
    ``(w_row_sum_vec,)`` if ``cfg.w_row_sum_is_vector``. ``resets_left``
    (an int) is the fit's remaining reset budget. ``X``, the extras, ``W``
    (n, k) and ``T`` (k, d) are tensors of one dtype on one device and
    are not modified. Which body runs:

    - phase order, unmasked, no gradient stores, no DP noise: the
      Gram-blocked phase form (topics in blocks of
      :func:`_gram_block_size`; a reset patches the Gram and the block's
      cache);
    - phase order otherwise: the per-topic body, T rows then W columns,
      the W-phase contractions as one ``X @ Tᵀ``;
    - else the interleaved per-topic body: T row, then W column, per
      topic; unmasked, the T side takes one ``WᵀX`` for the sweep and the
      W side a GEMV ``X @ T[t]`` per topic (an SpMV on X's nonzeros where
      :meth:`rows` finds X sparse enough); masked, the residual
      ``R = M ⊙ (X − WT)`` is carried with rank-2 and rank-1 updates.

    :meth:`speculate` runs the sweep as if no reset fired (no host
    sync); calling the sweep reads its checks once and runs :meth:`eager`
    only when a topic died with budget left. On the card the speculative
    sweep replays as one CUDA graph (:meth:`replay`).

    On a mesh (``cfg.mesh``) the arrays are this rank's blocks (the mask
    split like X, the ``w_row_sum`` vector as W's rows); every rank of the
    mesh calls the sweep with the same ``draws`` and budget. The masked
    sums over rows (``wᵀR``, ``(w²)ᵀM``) all-reduce over ``dp`` and those
    over columns (``R·t``, ``M·t²``) over ``tp``, each pair in one
    all-reduce. Gradient stores come back whole on every rank: the
    numerators (and a masked fit's denominators) gathered over ``tp``; a
    selected row belongs to one ``dp`` rank, and its sums are summed over
    ``dp``."""

    # X's nonzeros for the W side's SpMV (:meth:`rows`), kept for one X
    _rows = None
    spmv_route = False
    _generations = itertools.count()

    def __init__(self, cfg):
        method = cfg.reset_topic_method
        if cfg.inner_reps > 1 and (
                cfg.update_order != 'phase' or cfg.masked
                or method is not None or cfg.store_gradients
                or cfg.dp_sigma is not None):
            raise ValueError(
                "inner_reps > 1 requires update_order='phase', unmasked, "
                'reset_topic_method=None, no store_gradients, no DP noise')
        self.cfg = cfg
        self.reset_rowcol = (make_reset_rowcol(cfg) if method is not None
                             else None)
        self.random = method == 'random' or cfg.dp_sigma is not None
        # a speculative sweep that draws nothing, copies nothing to the
        # device and makes no collective a graph cannot capture replays as
        # one CUDA graph
        self.graphable = (cfg.dp_sigma is None and not cfg.store_gradients
                          and (cfg.mesh is None or cfg.mesh.graphable))
        # the unmasked interleaved body's W side, on one device
        self.spmv_route = (cfg.mesh is None and not cfg.masked
                           and cfg.update_order != 'phase' and not cfg.fix_W)
        self._graph = self._seen = self._where = None

    def split(self, X):
        """Where this rank's block ``X`` lies on the mesh (None without
        one), found once per X (:meth:`~rri_nmf_tpu_torch.parallel.mesh.
        Mesh.locate`)."""
        mesh = self.cfg.mesh
        if mesh is None:
            return None
        key = (X.data_ptr(), tuple(X.shape))
        if self._where is None or self._where[0] != key:
            self._where = (key, mesh.locate(*X.shape, X.device))
        return self._where[1]

    def rows(self, X, W, find=True):
        """X's nonzeros (:class:`~rri_nmf_tpu_torch.ops.spmv.Rows`) where
        the W side's ``X @ T[t]`` reads them through
        :func:`~rri_nmf_tpu_torch.ops.spmv.spmv`, else None: the unmasked
        interleaved body without a mesh (:attr:`spmv_route`), X float32
        or float64 and the accumulator dtype, its density at most
        :func:`~rri_nmf_tpu_torch.ops.spmv.max_density`. Decided and
        built once per X object (a later X at the same address is
        another), with a host read: by the sweep's call and by
        :meth:`eager`, before any capture. ``find=False`` only looks
        them up, as :meth:`speculate` does, which reads nothing on the
        host: an X not seen before takes the GEMV."""
        if (not self.spmv_route or not spmv.takes(X)
                or resolve_mixed_dtypes(X.dtype, W.dtype)[1] != X.dtype):
            return None
        key = (X.data_ptr(), tuple(X.shape), X.dtype)
        if (self._rows is None or self._rows[0]() is not X
                or self._rows[1] != key):
            if not find:
                return None
            self._rows = (weakref.ref(X), key, spmv.sparse_rows(X),
                          next(self._generations))
        return self._rows[2]

    def __call__(self, X, W, T, draws, resets_left, *extras):
        state = draws.get_state() if self.random else None
        self.rows(X, W)
        if X.is_cuda and self.graphable:
            out, dead = self.replay(X, W, T, draws, resets_left, *extras)
        else:
            out, dead = self.speculate(X, W, T, draws, resets_left, *extras)
        if dead is None or not bool(dead):
            return out
        if self.random:
            draws.set_state(state)
        return self.eager(X, W, T, draws, resets_left, *extras)

    def replay(self, X, W, T, draws, resets_left, *extras):
        """:meth:`speculate` as one CUDA graph: its thousands of small
        launches cost one host call. The first sweep on a set of operands
        runs launch by launch, which also warms up what a capture needs
        (so a fit of one sweep captures nothing); the second captures the
        graph, which it and every later sweep replay from static copies
        of W and T, the results copied out of the graph's memory. X's
        nonzeros (:meth:`rows`) are found before any capture, and a graph
        is kept for them as for X; each replay adds the SpMV launches its
        capture recorded to ``spmv.LAUNCHES``."""
        self.rows(X, W)
        key = (X.data_ptr(), tuple(X.shape), tuple(W.shape), W.dtype,
               resets_left > 0, tuple(e.data_ptr() for e in extras),
               self._rows[3] if self._rows is not None else None)
        if self._graph is None or self._graph[0] != key:
            self._graph = None
            if self._seen != key:
                self._seen = key
                return self.speculate(X, W, T, draws, resets_left, *extras)
            with span('rri.sweep.capture'):
                W_in = W.clone(memory_format=torch.contiguous_format)
                T_in = T.clone(memory_format=torch.contiguous_format)
                graph = torch.cuda.CUDAGraph()
                before = spmv.LAUNCHES['spmv']
                with torch.cuda.graph(graph):
                    out, dead = self.speculate(X, W_in, T_in, draws,
                                               resets_left, *extras)
                # recorded, not run: counted at each replay
                launches = spmv.LAUNCHES['spmv'] - before
                spmv.LAUNCHES['spmv'] = before
            self._graph = (key, graph, W_in, T_in, out[0], out[1], dead,
                           launches)
        _, graph, W_in, T_in, W_out, T_out, dead, launches = self._graph
        W_in.copy_(W)
        T_in.copy_(T)
        graph.replay()
        spmv.LAUNCHES['spmv'] += launches
        return (W_out.clone(), T_out.clone(), int(resets_left)), dead

    def speculate(self, X, W, T, draws, resets_left, *extras):
        """The sweep with no reset firing, and nothing read on the host:
        ``(out, dead)``, ``dead`` a 0-d tensor (whether a topic died while
        budget was left) or None when no check was made."""
        return self._body(X, W, T, draws, _Resets(resets_left, eager=False),
                          extras)

    def eager(self, X, W, T, draws, resets_left, *extras):
        """The sweep with each reset check read on the host."""
        return self._body(X, W, T, draws, _Resets(resets_left, eager=True),
                          extras)[0]

    def _body(self, X, W, T, draws, resets, extras):
        cfg = self.cfg
        split = self.split(X)
        Xs = self.rows(X, W, find=resets.eager)
        with precision_scope(cfg.matmul_precision):
            W, T, dead, stores = _sweep_body(cfg, self.reset_rowcol, X, W, T,
                                             draws, resets, extras, split, Xs)
        return (W, T, resets.budget) + stores, dead


def make_sweep(cfg):
    """The :class:`Sweep` for ``cfg``."""
    return Sweep(cfg)


def _same(x):
    return x


def _sweep_body(cfg, reset_rowcol, X, W, T, draws, resets, extras,
                split=None, Xs=None):
    """One sweep (see :class:`Sweep`): ``(W, T, dead, stores)``; ``dead``
    is :func:`_dead_topics` for a speculative sweep with budget left,
    else None, and ``stores`` is empty or ``(numer_store,
    denom_store)``. On a mesh ``split`` locates this rank's blocks.
    ``Xs``: X's nonzeros (:meth:`Sweep.rows`), which the interleaved W
    side's ``X @ T[t]`` then reads through the SpMV in place of X."""
    k = cfg.k
    mesh = cfg.mesh
    # the collectives of a mesh sweep (module docstring); without a mesh
    # they are the identity
    if mesh is None:
        sum_dp = sum_tp = whole = own = _same
    else:
        sum_dp, sum_tp = mesh.sum_dp, mesh.sum_tp

        def whole(x):
            return mesh.gather_cols(x, split)

        def own(x):
            return mesh.own_cols(x, split)
    method = cfg.reset_topic_method
    proj_t = bool(cfg.t_row_sum and cfg.project_T_each_iter)
    i = 0
    W_mat = wrs = None
    if cfg.masked:
        W_mat = extras[i]
        i += 1
    if cfg.w_row_sum_is_vector:
        wrs = extras[i].reshape(-1)
    ub_w = wrs if cfg.w_row_sum_is_vector else cfg.w_row_sum
    l1t, l2t, l1w, l2w = (cfg.reg_t_l1, cfg.reg_t_l2, cfg.reg_w_l1,
                          cfg.reg_w_l2)
    n, d = X.shape
    dev = X.device
    # the factors are copied, never written: row t of Wt is W[:, t]. The
    # copies are in the accumulator dtype; a 16-bit factor's stored rows
    # are rounded to it (rnd)
    out_dtype, dtype, _ = resolve_mixed_dtypes(X.dtype, W.dtype)
    Wt = W.T.to(dtype, memory_format=torch.contiguous_format, copy=True)
    T = T.to(dtype, memory_format=torch.contiguous_format, copy=True)
    if out_dtype != dtype:
        def rnd(v):
            return v.to(out_dtype).to(dtype)
    else:
        def rnd(v):
            return v
    if cfg.masked:
        W_mat = W_mat.to(dtype)

    R = WX = Wcoln = zeros_n = zeros_d = None
    if not cfg.masked:
        # the concave branch's zeros (qf_min_scalar_free)
        zeros_n = torch.zeros(n, dtype=dtype, device=dev)
        zeros_d = torch.zeros(d, dtype=dtype, device=dev)
    if cfg.masked:
        # the masked residual carry, fresh every sweep
        R = rnd(W_mat * (X - Wt.T @ T))
    elif not cfg.fix_T:
        # one GEMM for the sweep: column t of W is untouched until its own
        # topic, so row t of WᵀX is still current there
        WX = sum_dp(xmm(Wt, X, dtype))                     # (k, d)
        Wcoln = sum_dp((Wt * Wt).sum(1))                   # (k,)

    stores = ()
    if cfg.store_gradients:
        numer_store = torch.zeros(k, d, dtype=dtype, device=dev)
        denom_store = torch.zeros(k, d if cfg.masked else 1, dtype=dtype,
                                  device=dev)
        stores = (numer_store, denom_store)
        rows = None
        if cfg.store_rows is not None:
            rows = torch.as_tensor(list(cfg.store_rows), dtype=torch.long,
                                   device=dev)
            if mesh is not None:
                # the selected rows this rank owns, in its local indices
                rows = rows[(rows >= split.r0) & (rows < split.r1)] - split.r0
            X_rows = X[rows].to(dtype)
            M_rows = W_mat[rows] if cfg.masked else None

    def fire(t):
        """Reset topic t; the masked residual is rebuilt after it."""
        nonlocal R
        row, col = reset_rowcol(X, Wt.T, T, t, draws, split)
        Wt[t] = rnd(col)
        T[t] = rnd(row)
        if cfg.masked:
            R = rnd(W_mat * (X - Wt.T @ T))

    def check_t(t):
        """Reference ``nmf.py:750-783``: an alive row drifted off the
        simplex is re-projected (unmasked: the masked body re-projects
        before its residual update); a dead one resets or stays as it is.
        Returns whether a reset fired."""
        if method is not None and resets(lambda: sum_tp(T[t].sum()) > ALIVE):
            fire(t)
            return True
        if proj_t and not cfg.masked:
            row = whole(T[t])
            T[t] = rnd(own(reproject_row_if_drifted(
                row, cfg.t_row_sum,
                extra_pred=row.sum() > ALIVE if method is not None else None)))
        return False

    def check_w(t):
        """Reference ``nmf.py:786-816``."""
        if method is None or not resets(lambda: sum_dp(Wt[t].sum()) > ALIVE):
            return False
        fire(t)
        return True

    def store(t, w, wR, nw):
        if rows is None:
            numer_store[t] = wR
            denom_store[t] = nw
            return
        ws = w[rows]
        if cfg.masked:
            Rt_rows = R[rows] + M_rows * torch.outer(ws, T[t])
            wR_s = ws @ Rt_rows
            nw_s = (ws * ws) @ M_rows
            if mesh is not None:
                wR_s, nw_s = sum_dp(torch.stack([wR_s, nw_s])).unbind(0)
        else:
            wWs = sum_dp(Wt[:, rows] @ ws)
            wWs[t].zero_()
            wR_s = sum_dp(ws @ X_rows) - wWs @ T
            nw_s = sum_dp((ws * ws).sum())
        numer_store[t] = wR_s
        denom_store[t] = nw_s

    def topic(t, do_t, do_w, XTt=None):
        """One Gauss-Seidel topic step, restricted to the requested
        phase(s) (``sweep_xla.make_sweep``'s ``topic_body``). ``XTt``
        (k, n) supplies the W-phase contraction when the T rows are final
        for the sweep (phase order)."""
        nonlocal R
        if do_t:
            if cfg.masked:
                w = Wt[t].clone()
                nw = (w * w) @ W_mat                               # (d,)
                wR = w @ R
                if mesh is not None:
                    nw, wR = sum_dp(torch.stack([nw, wR])).unbind(0)
                wR = wR + T[t] * nw
            else:
                w = Wt[t]
                wW = sum_dp(Wt @ w)                                # (k,)
                wW[t].zero_()
                wR = torch.addmv(WX[t], T.T, wW, alpha=-1.0)
                nw = Wcoln[t]
            if cfg.store_gradients:
                store(t, w, wR, nw)
            if cfg.dp_sigma is not None:
                # Gaussian-mechanism noise (reference nmf.py:422-435), the
                # whole row's draws on a mesh (a masked nw is a row too)
                z1, z2 = draws.normal(whole(wR), nw.shape if nw.dim() == 0
                                      or mesh is None else (split.d,))
                wR = wR + cfg.dp_sigma * own(z1)
                nw = (nw + cfg.dp_sigma * (own(z2) if nw.dim() else z2)
                      ).clamp_min(0.0)
            numer = wR - l1t if l1t else wR
            denom = nw + l2t if l2t else nw
            if cfg.masked:
                # the l1 norm of the whole row (JAX's _qf_min_vector_psum)
                t_new, nt1 = qf_min_vector_c_sharded(
                    -numer, denom, s=cfg.t_update_s, ub=cfg.t_row_sum,
                    total=None if mesh is None else sum_tp)
            elif cfg.t_update_s is not None:
                # the simplex projection takes the whole row
                t_new, nt1 = qf_min_scalar_c(-whole(numer), denom,
                                             s=cfg.t_update_s,
                                             ub=cfg.t_row_sum)
                t_new = own(t_new)
            elif mesh is None:
                t_new, nt1 = qf_min_scalar_free(numer, denom, cfg.t_row_sum,
                                                zeros_d)
            else:
                t_new = qf_min_scalar_free(numer, denom, cfg.t_row_sum,
                                           zeros_d, norm=False)
                # the norm of the whole row (the scale transfer's)
                nt1 = (torch.where(denom > 0, sum_tp(t_new.sum()), 1.0)
                       if cfg.scale_transfer else None)
            t_old = T[t].clone() if cfg.masked else None
            w_eff = w
            if cfg.scale_transfer:
                # diagonal scale-invariance transfer (nmf.py:450-452)
                Wt[t] = rnd(Wt[t] * rnd(nt1))
                if cfg.masked:
                    w_eff = rnd(w * rnd(nt1))
            if cfg.masked and proj_t:
                # the drift re-projection hoisted before the rank-2
                # residual update, so R tracks T exactly (on the whole row)
                row = whole(t_new)
                t_new = own(reproject_row_if_drifted(
                    row, cfg.t_row_sum,
                    extra_pred=(row.sum() > ALIVE
                                if method is not None else None)))
            T[t] = rnd(t_new)
            if cfg.masked:
                # R += M ⊙ (w t_oldᵀ − w_eff t_newᵀ) as one (n,2)×(2,d)
                U2 = torch.stack([w, -w_eff], 1)
                V2 = torch.stack([t_old, T[t]], 0)
                R = rnd(R + rnd(W_mat * (U2 @ V2)))
            check_t(t)
        if do_w:
            trow = T[t]
            if cfg.masked:
                w_old = Wt[t].clone()
                mt2 = W_mat @ (trow * trow)                        # (n,)
                Rt = R @ trow
                if mesh is not None:
                    mt2, Rt = sum_tp(torch.stack([mt2, Rt])).unbind(0)
                Rt = Rt + w_old * mt2
                nt = mt2
            else:
                if XTt is not None:
                    Xt = XTt[t]
                elif Xs is not None:
                    Xt = spmv.spmv(Xs, trow)                       # (n,)
                else:
                    Xt = sum_tp(xmm(X, trow[:, None], dtype)[:, 0])
                Tt = sum_tp(T @ trow)
                Tt[t].zero_()
                Rt = torch.addmv(Xt, Wt.T, Tt, alpha=-1.0)
                nt = sum_tp(torch.dot(trow, trow))
            numer = Rt - l1w if l1w else Rt
            denom = nt + l2w if l2w else nt
            if cfg.masked:
                w_new = qf_min_vector_c(-numer, denom, s=None, ub=ub_w)[0]
            else:
                w_new = qf_min_scalar_free(numer, denom, ub_w, zeros_n,
                                           norm=False)
            Wt[t] = rnd(w_new)
            if cfg.masked:
                R = rnd(R + rnd(W_mat * torch.outer(w_old - Wt[t], trow)))
            check_w(t)

    def t_phase_blocked():
        """All T rows, Gauss-Seidel, in topic blocks of B: one (B, k)×(k, d)
        GEMM against the block-start T, then per topic a correction by
        the (B, d) in-block delta (``sweep_xla``'s ``t_phase_blocked``)."""
        B = _gram_block_size(k)
        G = sum_dp(Wt @ Wt.T)                                  # (k, k)
        for bi in range(cfg.inner_reps * (k // B)):
            bs = (bi % (k // B)) * B
            C = G[bs:bs + B] @ T                               # (B, d)
            T0 = T[bs:bs + B].clone()
            D = torch.zeros(B, d, dtype=dtype, device=dev)
            for i in range(B):
                t = bs + i
                g = G[t, bs:bs + B]
                wR = WX[t] - (C[i] + g @ D - g[i] * T0[i])
                numer = wR - l1t if l1t else wR
                if cfg.t_update_s is None:
                    T[t] = rnd(qf_min_scalar_free(numer, g[i] + l2t,
                                                  cfg.t_row_sum, zeros_d,
                                                  norm=False))
                else:
                    T[t] = rnd(own(qf_min_scalar_c(-whole(numer), g[i] + l2t,
                                                   s=cfg.t_update_s,
                                                   ub=cfg.t_row_sum)[0]))
                if check_t(t):
                    # the reset rewrote W[:, t]: patch G's row and column
                    # and the block cache
                    g_new = sum_dp(Wt @ Wt[t])
                    C += torch.outer(g_new[bs:bs + B] - G[bs:bs + B, t],
                                     T0[i])
                    G[:, t] = g_new
                    G[t, :] = g_new
                D[i] = T[t] - T0[i]

    def w_phase_blocked():
        """All W columns the same way (``sweep_xla``'s
        ``w_phase_blocked``), on Wᵀ's rows."""
        B = _gram_block_size(k)
        G = sum_tp(T @ T.T)                                    # (k, k)
        XTt = sum_tp(xmm(T, X.T, dtype))                       # (k, n)
        for bi in range(cfg.inner_reps * (k // B)):
            bs = (bi % (k // B)) * B
            C = G[:, bs:bs + B].T @ Wt                         # (B, n)
            W0 = Wt[bs:bs + B].clone()
            D = torch.zeros(B, n, dtype=dtype, device=dev)
            for i in range(B):
                t = bs + i
                g = G[bs:bs + B, t]
                Rt = XTt[t] - (C[i] + g @ D - W0[i] * g[i])
                numer = Rt - l1w if l1w else Rt
                Wt[t] = rnd(qf_min_scalar_free(numer, g[i] + l2w, ub_w,
                                               zeros_n, norm=False))
                if check_w(t):
                    # the reset rewrote T[t]
                    g_new = sum_tp(T @ T[t])
                    C += torch.outer(g_new[bs:bs + B] - G[bs:bs + B, t],
                                     W0[i])
                    G[:, t] = g_new
                    G[t, :] = g_new
                D[i] = Wt[t] - W0[i]

    phase = cfg.update_order == 'phase' and not cfg.masked
    if phase and not cfg.store_gradients and cfg.dp_sigma is None:
        if not cfg.fix_T:
            t_phase_blocked()
        if not cfg.fix_W:
            w_phase_blocked()
    elif phase:
        # gradient stores / DP noise: the per-topic body, the W-phase
        # contractions still one GEMM
        if not cfg.fix_T:
            for t in range(k):
                topic(t, True, False)
        if not cfg.fix_W:
            XTt = sum_tp(xmm(T, X.T, dtype))
            for t in range(k):
                topic(t, False, True, XTt)
    else:
        for t in range(k):
            topic(t, not cfg.fix_T, not cfg.fix_W)

    dead = None
    if method is not None and not resets.eager and resets.budget > 0:
        dead = _dead_topics(Wt, T, not cfg.fix_T, not cfg.fix_W, mesh)
    if stores and mesh is not None:
        # the whole stores on every rank
        stores = (whole(numer_store),
                  whole(denom_store) if cfg.masked else denom_store)
    W = Wt.T.to(out_dtype, memory_format=torch.contiguous_format)
    T = T.to(out_dtype)
    # per-iteration W row projection (reference nmf.py:481-484)
    if (cfg.project_W_each_iter and not cfg.fix_W
            and (cfg.w_row_sum is not None or cfg.w_row_sum_is_vector)):
        W = _proj_simplex_core(W, wrs.to(W.dtype) if cfg.w_row_sum_is_vector
                               else float(cfg.w_row_sum))
    return W, T, dead, stores
