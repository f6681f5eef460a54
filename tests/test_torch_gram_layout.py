"""The Gram-phase plan's output-column layouts (``ops/sweep_masked_gram.
_layouts``, through :func:`~rri_nmf_tpu_torch.ops.sparse_plan.
coo_layouts`), built from the observed COO, against the B5 route they
replace: each direction's tile plan of the mask, as the JAX package
builds it (``tests/tile_plan_oracle.py``), unpacked into a layout.
``tests/test_torch_masked_gram.py`` holds the same layouts against the
plans of JAX's own Gram plan.

On the CPU, on uniform and skewed masks, ``n``/``d`` off whole 128-wide
tiles, a mask under one tile, an empty mask and mask values that round
to 0 in float32, in float64 and float32, with both groupings of the
tile plan:

- ``colptr``, ``n_rows`` and the widths equal the oracle's; each column
  holds the same (row gathered, mask value, M⊙X value) entries, observed
  zero ratings included, bit for bit; the gathered rows ascend inside
  each column of both directions; a mask value that rounds to 0 stays
  an entry of value 0 (the oracle drops it, as it drops its padding);
- the gather and Gram contractions (A, C, Γ/Θ whole and in a panel)
  through the new layouts equal those through the oracle's to 1e-12 in
  float64;
- the route: the Gram plan counts two layouts in
  ``PLAN_BUILDS['layout']``, the segsum plan none, and the sparse X plan
  two, from the one layout function.

On the card (``cuda``): the card's layouts equal the CPU's bit for bit
on a skewed mask of ~3M observations. JAX is imported only by the
oracle, so ``python -m pytest --noconftest -m cuda
tests/test_torch_gram_layout.py`` runs the file on the card's machine.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from rri_nmf_tpu_torch.ops import sparse_kernels as sk
from rri_nmf_tpu_torch.ops import sparse_plan as spl
from rri_nmf_tpu_torch.ops import sweep_masked_gram as mg
from rri_nmf_tpu_torch.ops.sweep_masked_sparse import masked_coo_host_arrays
from tile_plan_oracle import tile_plan_order

TOL = 1e-12


def _skewed(seed, n, d, mean, zipf=1.2):
    """``(X, M)`` scipy CSR: users of log-normal activity rating items of
    Zipf popularity (repeats summed, so some mask weights are 2 or 3),
    half-star ratings with observed zeros among them."""
    rng = np.random.RandomState(seed)
    counts = np.clip(rng.lognormal(np.log(mean), 1.0, n).astype(int), 1, d)
    users = np.repeat(np.arange(n), counts)
    p = (np.arange(d) + 5.0) ** -zipf
    items = rng.permutation(d)[rng.choice(d, users.size, p=p / p.sum())]
    ones = np.ones(users.size)
    M = sp.csr_matrix((ones, (users, items)), shape=(n, d))
    X = sp.csr_matrix((rng.randint(0, 11, users.size) / 2.0,
                       (users, items)), shape=(n, d))
    return X, M


def _uniform(seed, n, d, density):
    rng = np.random.RandomState(seed)
    M = (rng.rand(n, d) < density) * rng.uniform(0.5, 2.0, (n, d))
    X = rng.rand(n, d) * (rng.rand(n, d) > 0.2)     # observed zeros
    return X, sp.csr_matrix(M)


def _underflow(seed):
    """Mask weights of 1e-50 among ordinary ones: 0 in float32, and
    observed all the same."""
    X, M = _uniform(seed, 150, 140, 0.3)
    M = M.tocoo()
    M.data[::7] = 1e-50
    return X, M.tocsr()


MASKS = {
    'uniform': lambda: _uniform(0, 300, 200, 0.2),
    'skewed': lambda: _skewed(1, 517, 389, 12),
    'under a tile': lambda: _uniform(2, 37, 5, 0.5),
    'empty': lambda: (np.zeros((130, 257)), sp.csr_matrix((130, 257))),
    'underflow': lambda: _underflow(3),
}


def oracle(X, M, dtype, group):
    """``{'t': (layout, M⊙X), 'w': ...}``: each direction's layout as
    unpacked from the B5 tile plan of the mask (JAX's, with ``group``),
    the mask's values in it, and M⊙X carried to the same entries. The
    mask values that are 0 in ``dtype`` are dropped, as the unpacking
    drops the plan's zero slots."""
    dt = spl.numpy_dtype(dtype)
    rows, cols, x, m, (n, d), nz = masked_coo_host_arrays(X, M, dt)
    rows, cols, m = rows[:nz], cols[:nz], m[:nz]
    mx = (m * x[:nz]).astype(dt, copy=False)
    out = {}
    for side, g, s, n_g, n_s in (('t', rows, cols, n, d),
                                 ('w', cols, rows, d, n)):
        colptr, ids = tile_plan_order(g, s, n_g, n_s, group)
        live = m[ids] != 0
        # the column offsets of the entries left
        col = np.repeat(np.arange(len(colptr) - 1), np.diff(colptr))[live]
        colptr = np.searchsorted(col, np.arange(len(colptr)))
        ids = ids[live]
        gidx = torch.as_tensor(g[ids].astype(np.int32))
        lay = spl.ColumnLayout(torch.as_tensor(colptr.astype(np.int32)),
                               gidx, torch.as_tensor(m[ids]),
                               int(gidx.max()) + 1 if len(ids) else 0)
        out[side] = (lay, torch.as_tensor(mx[ids]))
    return out


def entries(layout, mx):
    """The layout's (output column, gathered row, mask value, M⊙X value)
    as numpy arrays ordered by column, then row: the same arrays for two
    layouts that hold the same entries in each column."""
    col = torch.arange(layout.n_cols).repeat_interleave(
        torch.diff(layout.colptr.long())).numpy()
    row = layout.gidx.long().numpy()
    o = np.lexsort((row, col))
    return col[o], row[o], layout.vals.numpy()[o], mx.numpy()[o]


def _plan(X, M, dtype, device='cpu'):
    return mg.plan_masked_gram(X, M, dtype, backend='mxu', device=device)


@pytest.mark.parametrize('group', [1, 8])
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('mask', sorted(MASKS))
def test_layouts_hold_the_tile_plans_entries(mask, dtype, group):
    X, M = MASKS[mask]()
    plan = _plan(X, M, dtype, 'cpu')
    want = oracle(X, M, dtype, group)
    for side in ('t', 'w'):
        lay = plan.m_t if side == 't' else plan.m_w
        mx = plan.mx_layout_values(side)
        wlay, wmx = want[side]
        assert isinstance(lay, spl.ColumnLayout)
        assert lay.colptr.dtype == lay.gidx.dtype == torch.int32
        assert lay.vals.dtype == mx.dtype == dtype
        assert lay.gidx.shape == lay.vals.shape == mx.shape == (plan.nnz,)
        assert lay.n_cols == wlay.n_cols, side
        ours = entries(lay, mx)
        kept = ours[2] != 0
        if kept.all():
            assert torch.equal(lay.colptr, wlay.colptr), side
            assert lay.n_rows == wlay.n_rows, side
        for a, b in zip(ours, entries(wlay, wmx)):
            assert np.array_equal(a[kept], b), side
        # rows ascend inside each column: the order the kernel sums in
        col, row = entries(lay, mx)[:2]
        same = col[1:] == col[:-1]
        assert np.array_equal(row[1:][same] > row[:-1][same],
                              np.ones(int(same.sum()), bool)), side
        assert np.array_equal(row, lay.gidx.long().numpy()), side
    if mask in ('uniform', 'skewed'):
        # observed zero ratings stay in: M⊙X is 0 on a nonzero of M
        assert int((plan.mx_t_vals == 0).sum()) > 0
    if mask == 'underflow':
        zeros = int((plan.m_t.vals == 0).sum())
        assert zeros == (-(-plan.nnz // 7) if dtype == torch.float32
                         else 0)


@pytest.mark.parametrize('mask', ['uniform', 'skewed', 'under a tile'])
def test_contractions_through_both_layouts_agree(mask):
    """A, C (M⊙X), WᵀM, and Γ/Θ whole and in a panel, through the new
    layouts and through the tile plans' (float64)."""
    X, M = MASKS[mask]()
    plan = _plan(X, M, torch.float64)
    want = oracle(X, M, torch.float64, 8)
    n, d = plan.shape
    k = 5
    g = torch.Generator().manual_seed(7)
    F = {'t': torch.rand(n, k, generator=g, dtype=torch.float64),
         'w': torch.rand(d, k, generator=g, dtype=torch.float64)}
    for side, ncols in (('t', d), ('w', n)):
        lay = plan.m_t if side == 't' else plan.m_w
        wlay, wmx = want[side]
        Ft = F[side]
        pairs = [(sk.gather_contract(lay, Ft, k, ncols,
                                     plan.mx_layout_values(side)),
                  sk.gather_contract(wlay, Ft, k, ncols, wmx)),
                 (sk.gather_contract(lay, Ft, k, ncols),
                  sk.gather_contract(wlay, Ft, k, ncols))]
        for panel in (None, (1, 3)):
            pairs.append((sk.gram_contract(lay, Ft, k, panel, ncols),
                          sk.gram_contract(wlay, Ft, k, panel, ncols)))
        for got, ref in pairs:
            assert got.shape == ref.shape
            assert float((got - ref).abs().max()) <= TOL * max(
                1.0, float(ref.abs().max()))


def test_gram_route_plans_no_tiles():
    """The Gram plan builds its two layouts from the COO with the one
    layout function (the segsum plan builds none), and so does the sparse X
    plan; the package holds no tile planner."""
    X, M = MASKS['skewed']()
    before = spl.PLAN_BUILDS['layout']
    plan = _plan(X, M, torch.float64)
    assert plan.backend == 'mxu'
    assert spl.PLAN_BUILDS['layout'] - before == 2
    mg.plan_masked_gram(X, M, torch.float64, backend='segsum', device='cpu')
    assert spl.PLAN_BUILDS['layout'] - before == 2
    spl.plan_sparse_matrix(sp.csr_matrix(X), device='cpu')
    assert spl.PLAN_BUILDS['layout'] - before == 4
    assert not [name for name in dir(spl) if 'plan_direction' in name]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the layouts are built there')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_cuda_layouts_equal_the_cpu_ones(cuda_device, dtype):
    """One stable sort on the card gives the CPU's layouts bit for bit
    (~3M observations, a popular item's column ~5% of them)."""
    X, M = _skewed(4, 60000, 20000, 50)
    before = spl.PLAN_BUILDS['layout']
    card = _plan(X, M, dtype, cuda_device)
    host = _plan(X, M, dtype, 'cpu')
    assert spl.PLAN_BUILDS['layout'] - before == 4
    assert card.nnz == host.nnz > 2_000_000
    for side in ('t', 'w'):
        a, b = ((p.m_t if side == 't' else p.m_w) for p in (card, host))
        assert a.colptr.is_cuda and (a.n_rows, a.n_cols) == (b.n_rows,
                                                             b.n_cols)
        for f in spl.ColumnLayout._fields:
            assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), (side, f)
        assert torch.equal(card.mx_layout_values(side).cpu(),
                           host.mx_layout_values(side)), side
