"""Extrapolated sweeps: HER (heuristic extrapolation with restarts).

Counterpart of :mod:`rri_nmf_tpu.ops.accel`. HER (Ang & Gillis,
"Accelerating nonnegative matrix factorization algorithms using
extrapolation", Neural Computation 2019) wraps any alternating update
with momentum on the iterate sequence:

- sweep from the *extrapolated* point ``(Wy, Ty)`` to get ``(W1, T1)``;
- check the true objective; if it did not increase, extrapolate
  ``Wy = [W1 + beta (W1 - W)]_+`` (same for T) and grow ``beta``
  geometrically; on an increase, restart — drop the momentum
  (``Wy = W1``) and halve ``beta``.

The accepted iterates ``(W1, T1)`` are ordinary sweep outputs, so the
accepted sequence stays feasible. A sweep from an extrapolated point can
land in a worse basin, so the step also carries the best accepted
iterate ``(Wb, Tb, eb)``; ``nmf()`` returns it when it beats the final
one.

The objective check sums the explicit residual blockwise
(:func:`make_residual_obj`), never the Gram identity
``||X||² - 2<WᵀX,T> + <G,G²>``, whose ``||X||²``-sized terms cancel below
float32 noise near a 1e-4 relative error.

The step is free of host reads: the objective, the test and ``beta`` are
0-d tensors and every choice a ``torch.where``, so a group of HER sweeps
(``sweeps_per_dispatch``) runs without a sync, as one jitted program does
in the JAX package. ``beta`` is a float32 scalar whatever the factors'
dtype (grown, capped and halved in float32, then cast to W's dtype), and
the objectives live in the accumulator dtype: the JAX rules, which f64
parity needs.

The residual blocks are widened to the accumulator dtype one block at a
time: a bfloat16 X (``x_dtype='bfloat16'``) and a
:class:`~rri_nmf_tpu_torch.ops.quantized.QuantizedX` (dequantized
blocks) never become an n x d float copy. On a mesh the objective sums
each rank's block and all-reduces (``make_residual_obj(cfg,
distributed=True)``), so every rank takes the same restart decisions; the
extrapolation is elementwise on each rank's blocks.
"""

import torch

from rri_nmf_tpu_torch.ops.quantized import (QuantizedX, qx_col_block,
                                             qx_row_block)
from rri_nmf_tpu_torch.ops.sweep import (mesh_sums, precision_scope,
                                         resolve_mixed_dtypes)


def supports_her(cfg):
    """HER wraps a sweep whose per-sweep state is just (W, T): no resets,
    gradient stores or DP noise, and a dense residual (not the
    sparse-mask fit's observed set). Masked (WRRI) configs with a dense
    ``W_mat`` qualify: their sweeps rebuild the residual from (X, W, T)
    each sweep, so sweeping from an extrapolated point is exact."""
    return (cfg.reset_topic_method is None
            and not cfg.masked_sparse
            and not cfg.store_gradients
            and cfg.dp_sigma is None)


def make_residual_obj(cfg, block_rows=4096, distributed=None):
    """``obj(X, W, T, M=None) -> 0-d tensor``: ``0.5 Σ M ⊙ (X - WT)²`` (M
    only when ``cfg.masked``) plus the four regularizers, the residual
    summed blockwise in the accumulator dtype (the single-device forms of
    :func:`rri_nmf_tpu.ops.accel.make_residual_obj`):

    - unmasked in phase order, over column blocks of
      ``min(d, max(128, 2**27 // n // 128 * 128))`` columns;
    - otherwise over blocks of ``block_rows`` rows.

    The last block ends at the matrix's edge and skips what the block
    before it covered.

    ``distributed`` (default: whether ``cfg.mesh`` is set) is the mesh
    form: X, W, T (and M, split like X) are this rank's blocks, each
    summed blockwise as above, and the sums are all-reduced over the mesh
    (:func:`~rri_nmf_tpu_torch.ops.sweep.mesh_sums`), so every rank gets
    the same value; nothing larger than a block is formed."""
    if distributed is None:
        distributed = cfg.mesh is not None
    if distributed and cfg.mesh is None:
        raise ValueError('the distributed objective needs cfg.mesh')
    mesh = cfg.mesh if distributed else None

    def obj(X, W, T, M=None):
        n, d = X.shape
        acc = resolve_mixed_dtypes(X.dtype, W.dtype)[1]
        qx = isinstance(X, QuantizedX)
        s = torch.zeros((), dtype=acc, device=X.device)
        with precision_scope(cfg.matmul_precision):
            if cfg.update_order == 'phase' and not cfg.masked:
                B = min(d, max(128, (1 << 27) // max(n, 1) // 128 * 128))
                Wa = W.to(acc)
                for j in range(-(-d // B)):
                    off = min(j * B, d - B)
                    Xb = qx_col_block(X, off, B, acc) if qx \
                        else X[:, off:off + B].to(acc)
                    Rb = Xb - Wa @ T[:, off:off + B].to(acc)
                    cols = (Rb * Rb).sum(0)[j * B - off:]
                    s = s + cols.sum()
            else:
                B = min(block_rows, n)
                for i in range(-(-n // B)):
                    off = min(i * B, n - B)
                    Xb = qx_row_block(X, off, B, acc) if qx \
                        else X[off:off + B].to(acc)
                    Rb = Xb - W[off:off + B].to(acc) @ T.to(acc)
                    Rb = Rb * Rb
                    if cfg.masked:
                        Rb = M[off:off + B].to(acc) * Rb
                    rows = Rb.sum(1)[i * B - off:]
                    s = s + rows.sum()
        Wa = W.to(acc)
        Ta = T.to(acc)
        s, (w2, w1), (t2, t1) = mesh_sums(
            mesh, s, ((Wa * Wa).sum() if cfg.reg_w_l2 else None,
                      Wa.abs().sum() if cfg.reg_w_l1 else None),
            ((Ta * Ta).sum() if cfg.reg_t_l2 else None,
             Ta.abs().sum() if cfg.reg_t_l1 else None))
        o = 0.5 * s
        if cfg.reg_w_l2:
            o = o + 0.5 * cfg.reg_w_l2 * w2
        if cfg.reg_t_l2:
            o = o + 0.5 * cfg.reg_t_l2 * t2
        if cfg.reg_w_l1:
            o = o + cfg.reg_w_l1 * w1
        if cfg.reg_t_l1:
            o = o + cfg.reg_t_l1 * t1
        return o

    return obj


def _her_body(sweep_fn, obj_fn, gamma, beta_max):
    """One HER step: sweep from the extrapolated point, objective check,
    extrapolate or restart, track the best accepted iterate.

    ``step(X, W, T, Wy, Ty, Wb, Tb, eb, beta, e_prev, *extras)`` ->
    ``(W1, T1, Wy, Ty, Wb, Tb, eb, beta, e)``. ``sweep_fn(X, W, T) -> (W,
    T)`` must leave its inputs unwritten: ``W`` (the last accepted
    iterate) and ``Wy`` are both read after it. ``extras`` go to
    ``obj_fn`` (the mask of a masked fit)."""

    def step(X, W, T, Wy, Ty, Wb, Tb, eb, beta, e_prev, *extras):
        W1, T1 = sweep_fn(X, Wy, Ty)
        e = obj_fn(X, W1, T1, *extras)
        # the lowest-objective accepted iterate (module docstring)
        better = e < eb
        Wb = torch.where(better, W1, Wb)
        Tb = torch.where(better, T1, Tb)
        eb = torch.where(better, e, eb).to(eb.dtype)
        ok = e <= e_prev
        b = torch.where(ok, torch.clamp_max(beta * gamma, beta_max),
                        beta * 0.5).to(beta.dtype)
        bcast = b.to(W1.dtype)
        # extrapolate from the step's input W, the last accepted iterate
        Wy = torch.where(ok, (W1 + bcast * (W1 - W)).clamp_min(0), W1)
        Ty = torch.where(ok, (T1 + bcast * (T1 - T)).clamp_min(0), T1)
        return W1, T1, Wy, Ty, Wb, Tb, eb, b, e.to(e_prev.dtype)

    return step


def make_her_step(sweep_fn, obj_fn, gamma=1.05, beta_max=0.9999):
    """A single HER step (the per-sweep driver loop); see
    :func:`_her_body`."""
    return _her_body(sweep_fn, obj_fn, float(gamma), float(beta_max))


def make_her_multi(sweep_fn, obj_fn, nsweeps, gamma=1.05, beta_max=0.9999):
    """``nsweeps`` HER steps in one call (grouped dispatch), with the same
    signature as the step: extrapolation and the objective-checked
    restart run per sweep, with no host read between them."""
    step = _her_body(sweep_fn, obj_fn, float(gamma), float(beta_max))

    def multi(X, W, T, Wy, Ty, Wb, Tb, eb, beta, e_prev, *extras):
        for _ in range(int(nsweeps)):
            W, T, Wy, Ty, Wb, Tb, eb, beta, e_prev = step(
                X, W, T, Wy, Ty, Wb, Tb, eb, beta, e_prev, *extras)
        return W, T, Wy, Ty, Wb, Tb, eb, beta, e_prev

    return multi
