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

The Gram kernel's work list of a layout (``sparse_plan.gram_work``,
kept by ``ColumnLayout.gram_work``), on the CPU: every nonzero of every
column lies in exactly one item, no item holds more than the chunk
length L, a cut column's chunks are contiguous, ascending and first,
the other columns follow whole in ascending id, and with no column over
L the list is the columns in order; empty columns, one column holding
every nonzero, padded widths and an empty layout; L's rule
(``sparse_kernels.chunk_length``) from the nonzeros and the resident
teams; the chunks' sums, added chunk by chunk, give the twin's Γ/Θ; the
launch's arguments (scratch, counters, items of the first ``ncols``
columns).

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


# ---------------------------------------------------------------------------
# the Gram kernel's work list
# ---------------------------------------------------------------------------

def _colptr(counts, pad=0):
    """An int32 colptr of columns holding ``counts`` nonzeros, ``pad``
    empty columns after them (a layout's padded width)."""
    c = np.concatenate([[0], np.cumsum(list(counts) + [0] * pad)])
    return torch.as_tensor(c.astype(np.int32))


COLPTRS = {
    'uniform': lambda: _colptr(np.random.RandomState(0).randint(0, 9, 50)),
    'skewed': lambda: _colptr([3, 0, 41, 7, 0, 0, 100, 9, 17, 2], pad=6),
    'one column holds all': lambda: _colptr([0, 0, 250, 0], pad=124),
    'empty columns only': lambda: _colptr([0] * 5),
    'exact multiples': lambda: _colptr([16, 8, 32, 9, 24]),
    'layout': lambda: _plan(*MASKS['skewed'](), torch.float64).m_t.colptr,
}


def check_work(colptr, length, work):
    """The work list's invariants (the module docstring's list)."""
    ptr = colptr.long().numpy()
    nnz = np.diff(ptr)
    items = work.items.long().numpy()
    assert work.items.dtype == work.split_ptr.dtype == torch.int32
    assert work.items.shape == (work.n_chunks + len(nnz) - work.n_split, 4)
    col, start, end, split = items.T
    sizes = end - start
    assert (sizes >= 0).all() and (sizes <= length).all()
    # every nonzero in exactly one item, each inside its own column
    hits = np.zeros(ptr[-1], np.int64)
    for c, a, b in zip(col, start, end):
        assert ptr[c] <= a <= b <= ptr[c + 1]
        hits[a:b] += 1
    assert (hits == 1).all()
    long_cols = np.flatnonzero(nnz > length)
    q = -(-nnz[long_cols] // length)
    assert work.n_split == len(long_cols)
    assert work.n_chunks == int(q.sum())
    assert work.length == length
    assert work.last_split == (long_cols[-1] if len(long_cols) else -1)
    # chunks first: ascending column, each column's chunks contiguous,
    # ascending, near-equal; then the whole columns, ascending
    nc = work.n_chunks
    assert (split[:nc] >= 0).all() and (split[nc:] == -1).all()
    assert np.array_equal(col[:nc], np.repeat(long_cols, q))
    assert np.array_equal(split[:nc], np.repeat(np.arange(len(q)), q))
    assert np.array_equal(work.split_ptr.long().numpy(),
                          np.concatenate([[0], np.cumsum(q)]))
    for s_, c in enumerate(long_cols):
        a, b = work.split_ptr[s_:s_ + 2].tolist()
        assert start[a] == ptr[c] and end[b - 1] == ptr[c + 1]
        assert np.array_equal(start[a + 1:b], end[a:b - 1])
        assert sizes[a:b].max() - sizes[a:b].min() <= 1
    assert np.array_equal(col[nc:], np.setdiff1d(np.arange(len(nnz)),
                                                 long_cols))
    assert np.array_equal(sizes[nc:], nnz[col[nc:]])
    assert work.longest == (sizes.max() if len(sizes) else 0)


@pytest.mark.parametrize('length', [1, 4, 8, 16, 40, 10 ** 6])
@pytest.mark.parametrize('case', sorted(COLPTRS))
def test_gram_work_covers_each_nonzero_once(case, length):
    colptr = COLPTRS[case]()
    work = spl.gram_work(colptr, length)
    check_work(colptr, length, work)
    if not (torch.diff(colptr.long()) > length).any():
        # no column over L: the columns in order, no list for the launch
        n = colptr.shape[0] - 1
        assert work.n_split == work.n_chunks == 0
        assert torch.equal(work.items[:, 0], torch.arange(n,
                                                          dtype=torch.int32))
        assert torch.equal(work.items[:, 1], colptr[:-1])
        assert torch.equal(work.items[:, 2], colptr[1:])


@pytest.mark.parametrize('mask', sorted(MASKS))
def test_gram_work_of_a_plans_layouts(mask):
    """Both directions of a Gram plan, at a chunk length that cuts the
    longest columns and at one past them; kept on the layout, one list a
    length."""
    plan = _plan(*MASKS[mask](), torch.float32)
    for lay in (plan.m_t, plan.m_w):
        longest = max(1, int(torch.diff(lay.colptr.long()).max()))
        for length in (max(1, longest // 3), longest):
            work = lay.gram_work(length)
            assert lay.gram_work(length) is work
            check_work(lay.colptr, length, work)
            assert work.n_items(lay.n_cols) == work.items.shape[0]
        assert (lay.gram_work(longest).n_split == 0) and (
            longest < 3 or lay.gram_work(max(1, longest // 3)).n_split > 0)


@pytest.mark.parametrize('nnz,teams,want', [
    (25_000_095, 792, 3946),             # ML-25M, an 80-tile panel
    (25_000_095, 528, 5919),             # a 96-tile panel
    (25_000_095, 1320, 2368),            # a 48-tile panel
    (24_937_479, 6600, sk.CHUNK_FLOOR),  # the uniform record at k=32
    (0, 792, sk.CHUNK_FLOOR),
    (10 ** 9, 1, 125_000_000),
    (100, 0, sk.CHUNK_FLOOR),
])
def test_chunk_length_rule(nnz, teams, want):
    """L = max(CHUNK_FLOOR, ceil(nnz / (teams · CHUNK_SHARE)))."""
    assert sk.CHUNK_SHARE == 8
    assert sk.chunk_length(nnz, teams) == want
    assert want == max(sk.CHUNK_FLOOR,
                       -(-nnz // (max(teams, 1) * sk.CHUNK_SHARE)))


@pytest.mark.parametrize('side', ['t', 'w'])
@pytest.mark.parametrize('panel', [None, (1, 3)])
def test_chunk_sums_give_the_twins_gram(side, panel):
    """Each item's sums (the twin on its nonzeros alone), a cut column's
    chunks added in chunk order, equal the twin's Γ/Θ at 1e-12
    (float64): the kernel's order of sums covers each column once."""
    X, M = MASKS['skewed']()
    plan = _plan(X, M, torch.float64)
    lay = plan.m_t if side == 't' else plan.m_w
    ncols = plan.shape[1] if side == 't' else plan.shape[0]
    k = 5
    Ft = torch.rand(lay.n_rows, k, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(11))
    want = sk.gram_contract_ref(lay, Ft, k, panel, ncols)
    work = lay.gram_work(7)
    assert work.n_split > 0
    got = torch.zeros_like(want)
    for c, a, b, split in work.items.tolist()[:work.n_items(ncols)]:
        one = spl.ColumnLayout(torch.tensor([0, b - a], dtype=torch.int32),
                               lay.gidx[a:b], lay.vals[a:b], lay.n_rows)
        got[:, c] += sk.gram_contract_ref(one, Ft, k, panel, 1)[:, 0]
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())


def test_gram_tiles_cover_the_rows():
    """gram_tiles: the kernel's tiles of a column, covering every row of
    gram_pairs (TI 8 float32, 4 float64)."""
    assert sk.gram_tiles(128, 0, 0, 8) == 136
    assert [sk.gram_tiles(128, t0, p, 8) for t0, p in
            ((0, 35), (35, 35), (70, 35), (105, 23))] == [80, 80, 96, 48]
    for k, panel, ti in ((5, None, 4), (32, (5, 12), 8), (16, (0, 16), 4),
                         (40, None, 8)):
        t0, p = panel or (0, 0)
        rows = sk.gram_pairs(k, panel)[0].shape[0]
        assert sk.gram_tiles(k, t0, p, ti) * ti * ti >= rows


def test_gram_args_of_a_split_list():
    """The launch's arguments: the items of the first ncols columns
    always; where a column is cut, chunk scratch of chunks × tiles × TI²
    (returned, for the caller to hold past the launch) and counters kept
    at zero on the list, else neither; a cut column past ncols raises."""
    lay = spl.ColumnLayout(_colptr([3, 0, 41, 7, 0, 0], pad=2),
                           torch.zeros(51, dtype=torch.int32),
                           torch.ones(51), 1)
    Fr = torch.ones(1, 8)
    whole = lay.gram_work(100)
    out, args, part = sk.gram_args(lay, whole, Fr, 5, 0, 0, 6)
    assert out.shape == (15, 6) and part is None
    assert args[4:6] == (whole.items.data_ptr(),
                         whole.split_ptr.data_ptr()) and args[6:8] == (0, 0)
    assert args[8:] == (5, 8, 0, 0, 6, 6)
    work = lay.gram_work(10)
    out, args, part = sk.gram_args(lay, work, Fr, 5, 0, 0, 6)
    assert work.n_split == 1 and work.n_chunks == 5
    assert args[4] == work.items.data_ptr() and all(args[4:8])
    assert args[6] == part.data_ptr()
    assert part.shape == (work.n_chunks * sk.gram_tiles(5, 0, 0, 8) * 64,)
    assert args[-1] == work.n_items(6) == 5 + 6 - 1
    counters = work.arrivals(1)
    assert counters.shape[0] >= 1 and int(counters.abs().sum()) == 0
    assert work.arrivals(1) is counters
    assert work.arrivals(50).shape[0] == 50
    with pytest.raises(ValueError, match='column 2 has nonzeros'):
        sk.gram_args(lay, work, Fr, 5, 0, 0, 2)


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
