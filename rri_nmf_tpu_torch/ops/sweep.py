"""Sweep configuration, dtype resolution and the full objective.

Counterpart of the parts of :mod:`rri_nmf_tpu.ops.sweep_xla` that the
ported sweeps need: :class:`SweepConfig` (copied field for field, without
JAX), :func:`resolve_mixed_dtypes`, :func:`make_objective` (plain or
masked, with the row-blocked option) and :func:`make_reset_rowcol` (the
``'random'`` reset). The XLA sweep itself (``make_sweep``: interleaved
order, ``'max_resid_document'`` resets, DP noise) is not ported yet; the
sweeps live in :mod:`rri_nmf_tpu_torch.ops.dense_kernels` (phase order)
and :mod:`rri_nmf_tpu_torch.ops.masked_kernels` (masked WRRI).
"""

import contextlib
import dataclasses
from typing import Any, Optional, Tuple

import torch


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


_NARROW = (torch.bfloat16, torch.float16)


def resolve_mixed_dtypes(x_dtype, w_dtype, matmul_precision=None):
    """``(dtype, acc, x_narrow)``: the factor dtype (follows W), the
    accumulator dtype (float32 for a 16-bit promoted pair, else the
    promotion) and whether the X products should cast their factor
    operand down to a bfloat16 X (only under default precision). The
    rules of :func:`rri_nmf_tpu.ops.sweep_xla.resolve_mixed_dtypes`."""
    wide = torch.promote_types(x_dtype, w_dtype)
    acc = torch.float32 if wide in _NARROW else wide
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


def make_objective(masked=False, row_weighted=False, reg_w_l2=0.0,
                   reg_t_l2=0.0, reg_w_l1=0.0, reg_t_l1=0.0,
                   block_rows=None, matmul_precision=None):
    """Build ``objective(X, W, T[, M]) -> 0-d tensor``:
    ``0.5 Σ M ⊙ (X - WT)²`` plus the four regularizers (reference
    ``nmf.py:71-94``), accumulated in the accumulator dtype. The mask
    ``M`` (n, d) is passed only when ``masked``; it weights each squared
    entry, as :func:`rri_nmf_tpu.ops.sweep_xla.make_objective` does.

    ``block_rows`` sums the residual over row blocks of that size instead
    of materializing the whole ``W @ T`` product (for X near the device
    memory budget). The row-weighted form waits for the ``w_row`` refit
    (ROADMAP A.4)."""
    if row_weighted:
        raise NotImplementedError(
            'the row-weighted objective arrives with the w_row refit '
            '(ROADMAP A.4)')

    def _res_sq(acc, X, W, T, M):
        R = (X.to(acc) - W.to(acc) @ T.to(acc)) ** 2
        if masked:
            R = M.to(acc) * R
        return R.sum()

    def objective(X, W, T, M=None):
        if masked and M is None:
            raise ValueError('the masked objective needs the mask M')
        _, acc, _ = resolve_mixed_dtypes(X.dtype, W.dtype)
        with precision_scope(matmul_precision):
            if block_rows is None:
                base = _res_sq(acc, X, W, T, M)
            else:
                B = int(block_rows)
                base = sum(_res_sq(acc, X[i:i + B], W[i:i + B], T,
                                   M[i:i + B] if masked else None)
                           for i in range(0, X.shape[0], B))
        Wa = W.to(acc)
        Ta = T.to(acc)
        obj = 0.5 * base
        obj = obj + 0.5 * reg_w_l2 * (Wa ** 2).sum()
        obj = obj + 0.5 * reg_t_l2 * (Ta ** 2).sum()
        obj = obj + reg_t_l1 * Ta.abs().sum()
        obj = obj + reg_w_l1 * Wa.abs().sum()
        return obj

    return objective


def make_reset_rowcol(cfg):
    """Topic-reset builder: ``reset(X, t_row, t, gen) -> (t_row, w_col)``,
    the new T row (d,) and W column (n,) for the dead topic ``t`` whose
    current T row is ``t_row`` under ``cfg.reset_topic_method``
    (reference ``nmf.py:770-783, 804-816``).

    Only ``'random'`` is ported: a uniform row normalized to sum 1 and a
    uniform column, drawn from the ``torch.Generator`` ``gen`` on the fit's
    device. With ``cfg.fix_reset_seed`` the draw comes instead from a
    fresh generator seeded with ``gen.initial_seed() + t + argmax(t_row)``,
    the analog of the reference's ``np.random.seed(t + argmax(T[t]))``:
    the same on every run. torch draws other numbers than ``jax.random``
    from the same seed (ROADMAP §C.2), so values differ from the JAX
    package while the reset budget is spent alike."""
    method = cfg.reset_topic_method
    if method != 'random':
        raise NotImplementedError(
            'reset_topic_method=%r is not ported to rri_nmf_tpu_torch yet; '
            'it arrives with ROADMAP A.2' % (method,))

    def reset(X, t_row, t, gen):
        n, d = X.shape
        dtype, device = t_row.dtype, t_row.device
        if cfg.fix_reset_seed:
            gen = torch.Generator(device=device).manual_seed(
                gen.initial_seed() + t + int(torch.argmax(t_row)))
        row = torch.rand(d, generator=gen, dtype=dtype, device=device)
        col = torch.rand(n, generator=gen, dtype=dtype, device=device)
        return row / row.sum(), col

    return reset
