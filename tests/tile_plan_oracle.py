"""The output-column layouts unpacked from the JAX package's TPU tile
plans: the oracle the port's layouts (``rri_nmf_tpu_torch.ops.
sparse_plan``) are held against.

JAX's B5 plan (``sparse_mxu.plan_sparse_matrix``: 128-slot chunks of
128×128 tiles, grouped G per output tile) and B6 plan
(``sparse_dma.plan_sparse_matrix_dma``: the same chunks with CSR offsets
over the used output tiles and trailing pad chunks) hold X's nonzeros
output-tile-major. Each slot unpacks to (gathered row, output column,
value); the slots of value 0 (the padding, and explicit zeros) are
dropped and the rest sorted stably by output column: the layout the
gather kernel reads. JAX is imported at the first call, so a test file
that imports this module still runs where JAX is not installed.
"""

import types

import numpy as np

TILE = 128


def plan_slots(direction):
    """``(g, s, v)`` of every slot of one direction of a JAX B5 or B6
    plan, in plan order: the row of Fᵀ it gathers, its output column and
    its value (numpy). B6's trailing pad chunks are left out."""
    vals = np.asarray(direction.vals)
    ftile = np.asarray(direction.ftile).astype(np.int64)
    C = vals.shape[1] // ftile.shape[0]
    if hasattr(direction, 'gloc'):                  # B5
        otile = np.asarray(direction.otile).astype(np.int64)
        otile = np.repeat(otile, ftile.shape[0] // otile.shape[0])
        gl = np.asarray(direction.gloc)[0]
        sl = np.asarray(direction.sloc)[0]
        v = vals[0]
    else:                                           # B6
        ostart = np.asarray(direction.ostart).astype(np.int64)
        nch = int(ostart[-1])
        ftile = ftile[:nch]
        otile = np.repeat(np.asarray(direction.uotile).astype(np.int64),
                          np.diff(ostart))
        idx = np.asarray(direction.idx)
        gl, sl, v = idx[0, :nch * C], idx[1, :nch * C], vals[0, :nch * C]
    g = np.repeat(ftile * TILE, C) + gl.astype(np.int64)
    s = np.repeat(otile * TILE, C) + sl.astype(np.int64)
    return g, s, v


def unpack(direction, extra=None):
    """``(colptr, gidx, vals)``: the output-column layout of one JAX plan
    direction as numpy arrays, ``colptr`` over the plan's padded width
    (its ``mask``): nonzero slots, stably sorted by output column.
    ``extra``: a second value set in the plan's slots (shaped like its
    ``vals``, as JAX's Gram plan carries M⊙X), returned fourth in the
    layout's order."""
    g, s, v = plan_slots(direction)
    keep = v != 0
    order = np.argsort(s[keep], kind='stable')
    n_cols = np.asarray(direction.mask).shape[1]
    colptr = np.searchsorted(s[keep][order], np.arange(n_cols + 1))
    out = (colptr, g[keep][order], v[keep][order])
    if extra is None:
        return out
    return out + (np.asarray(extra).reshape(-1)[:len(keep)][keep][order],)


def jax_plans(X, dtype=np.float64):
    """JAX's three tile plans of the scipy matrix ``X``: B5 with group 8
    and 1, and B6."""
    from rri_nmf_tpu.ops import sparse_dma, sparse_mxu
    return {'b5 group 8': sparse_mxu.plan_sparse_matrix(X, dtype, group=8),
            'b5 group 1': sparse_mxu.plan_sparse_matrix(X, dtype, group=1),
            'b6': sparse_dma.plan_sparse_matrix_dma(X, dtype)}


def tile_plan_order(g, s, n_g, n_s, group):
    """``(colptr, ids)``: the entries (indices into ``g``/``s``) of each
    output column in the order JAX's B5 tile plan of the direction lays
    them out (``sparse_mxu._plan_direction_np`` with ``group``), over the
    plan's padded width. The plan carries each entry's index + 1 as its
    value, so any number of value sets can follow it."""
    from rri_nmf_tpu.ops import sparse_mxu
    ids = np.arange(1, len(g) + 1, dtype=np.float64)
    v, gl, sl, ft, ot, mask = sparse_mxu._plan_direction_np(
        g, s, ids, -(-n_g // TILE), -(-n_s // TILE), TILE, group,
        np.float64)
    plan = types.SimpleNamespace(vals=v, gloc=gl, sloc=sl, ftile=ft,
                                 otile=ot, mask=mask)
    colptr, _, slot_ids = unpack(plan)
    return colptr, slot_ids.astype(np.int64) - 1
