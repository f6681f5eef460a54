"""The output-column layout of the sparse plans and the gather kernel's
plain twin, against the plan-walking twins of B5 and B6.

- ``sparse_plan.column_layout`` from the B5 plan (group 8 and 1) and from
  the B6 plan of one matrix give equal arrays; each column keeps its
  nonzeros in plan order; the plans' zero-valued slots are dropped; empty
  columns and the empty plan.
- ``sparse_kernels.gather_contract_ref`` (the kernel's twin) against
  ``mxu_contract_ref`` / ``dma_contract_ref`` and the dense product at
  1e-12, at k = 16, 50 (in float32 a 200-byte row, which the kernel pads
  to 16 bytes) and 128, ragged shapes, duplicates, an empty 128-column
  band and a Zipf corpus (a few long columns).
- A NumPy mirror of ``csrc/sparse.cu``'s decomposition (blocks of
  ``SG_NC`` columns, ``SG_WARPS`` equal runs of nonzeros, pieces of cut
  columns added in warp order, 32/L interleaved partial sums), read
  from the source's constants, against the twin: the kernel's index
  logic, which only the card can run.
- ``_rows`` (W itself when its rows are 16-byte multiples).

float64 on the CPU.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from rri_nmf_tpu_torch.ops import sparse_kernels as sk
from rri_nmf_tpu_torch.ops import sparse_plan as spl

torch.set_num_threads(2)
# float64, relative to the largest entry of the wanted product (the Zipf
# columns sum hundreds of terms into entries ~1e3): the two sides differ
# only in summation order
RTOL = 1e-12
SOURCE = Path(sk.__file__).resolve().parent.parent / 'csrc' / 'sparse.cu'


def _matrix(n, d, dens, seed, dup=False, empty_band=None):
    """A scipy COO (n, d) matrix, optionally with duplicate coordinates
    (kept as separate entries) and an all-zero 128-column band."""
    rng = np.random.RandomState(seed)
    nnz = int(n * d * dens)
    rows = rng.randint(0, n, nnz)
    cols = rng.randint(0, d, nnz)
    if dup:
        rows = np.concatenate([rows, rows[:nnz // 5]])
        cols = np.concatenate([cols, cols[:nnz // 5]])
    if empty_band is not None:
        keep = cols // 128 != empty_band
        rows, cols = rows[keep], cols[keep]
    vals = rng.rand(len(rows)) + 0.1
    return sp.coo_matrix((vals, (rows, cols)), shape=(n, d))


def _zipf(n_docs, n_words, seed, doc_len=40):
    """Documents of ``doc_len`` word draws from a Zipf law over a permuted
    vocabulary, summed per (document, word): a few word columns hold most
    documents, most hold a few."""
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, n_words + 1)
    p = p[rng.permutation(n_words)] / p.sum()
    rows = np.repeat(np.arange(n_docs), doc_len)
    cols = rng.choice(n_words, size=n_docs * doc_len, p=p)
    X = sp.coo_matrix((np.ones(len(rows)), (rows, cols)),
                      shape=(n_docs, n_words)).tocsr()
    X.sum_duplicates()
    return X.tocoo()


MATRICES = {
    'ragged': lambda: _matrix(300, 260, 0.02, 0),
    'duplicates and empty band': lambda: _matrix(413, 530, 0.01, 1, dup=True,
                                                 empty_band=2),
    'dense tiles': lambda: _matrix(200, 150, 0.3, 2),
    'zipf': lambda: _zipf(400, 700, 3),
    'empty': lambda: sp.coo_matrix((50, 70)),
}


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    return got.shape == want.shape and bool(
        np.all(np.abs(got - want) <= RTOL * scale))


def _plans(X):
    return {'mxu': spl.plan_sparse_matrix(X, np.float64, device='cpu'),
            'mxu group 1': spl.plan_sparse_matrix(X, np.float64, group=1,
                                                  device='cpu'),
            'dma': spl.plan_sparse_matrix_dma(X, np.float64, device='cpu')}


def _directions(plan):
    return (('WtX', plan.t_phase), ('TXt', plan.w_phase))


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('case', sorted(MATRICES))
def test_layouts_of_the_b5_and_b6_plans_are_equal(case):
    plans = _plans(MATRICES[case]())
    for dirn in (0, 1):
        layouts = [spl.column_layout(_directions(p)[dirn][1])
                   for p in plans.values()]
        first = layouts[0]
        assert first.colptr.dtype == first.gidx.dtype == torch.int32
        assert first.vals.dtype == torch.float64
        for other in layouts[1:]:
            for field in spl.ColumnLayout._fields:
                assert torch.equal(getattr(other, field),
                                   getattr(first, field)), field
            assert other.n_rows == first.n_rows


def _plan_order_columns(direction):
    """Each output column's (gather row, value) pairs in plan order, from
    the plan arrays in NumPy: slots with v = 0 left out."""
    if isinstance(direction, spl.ContractPlan):
        ft = direction.ftile.numpy()
        C = direction.vals.shape[1] // len(ft)
        ot = np.repeat(direction.otile.numpy(), direction.group)
        gl, sl = direction.gloc[0].numpy(), direction.sloc[0].numpy()
    else:
        nch = int(direction.ostart[-1])
        ft = direction.ftile.numpy()[:nch]
        C = direction.vals.shape[1] // direction.ftile.shape[0]
        ot = np.repeat(direction.uotile.numpy(),
                       np.diff(direction.ostart.numpy()))
        gl, sl = direction.idx[0].numpy(), direction.idx[1].numpy()
    v = direction.vals[0].numpy()
    cols = {}
    for i in range(len(ft) * C):
        if v[i] != 0:
            c = 128 * int(ot[i // C]) + int(sl[i])
            cols.setdefault(c, []).append((128 * int(ft[i // C])
                                           + int(gl[i]), v[i]))
    return cols


@pytest.mark.parametrize('kind', ['mxu', 'dma'])
@pytest.mark.parametrize('case', sorted(MATRICES))
def test_layout_keeps_plan_order_and_drops_zero_slots(case, kind):
    X = MATRICES[case]()
    plan = _plans(X)[kind]
    for _, direction in _directions(plan):
        lay = spl.column_layout(direction)
        assert spl.column_layout(direction) is lay      # cached on the plan
        colptr = lay.colptr.numpy()
        gidx, vals = lay.gidx.numpy(), lay.vals.numpy()
        assert len(gidx) == X.nnz and np.all(vals != 0)
        assert lay.n_cols == direction.mask.shape[1]
        want = _plan_order_columns(direction)
        for c in range(lay.n_cols):
            got = list(zip(gidx[colptr[c]:colptr[c + 1]],
                           vals[colptr[c]:colptr[c + 1]]))
            assert got == want.get(c, []), c
        assert lay.n_rows == (int(gidx.max()) + 1 if len(gidx) else 0)


def test_empty_columns_and_the_empty_plan():
    X = MATRICES['duplicates and empty band']()
    lay = spl.column_layout(_plans(X)['mxu'].t_phase)
    counts = np.diff(lay.colptr.numpy())
    assert np.all(counts[256:384] == 0) and counts[:256].sum() > 0
    assert np.all(counts[X.shape[1]:] == 0)            # the padded columns

    empty = sp.coo_matrix((50, 70))
    W = torch.rand(50, 4, dtype=torch.float64)
    T = torch.rand(4, 70, dtype=torch.float64)
    for plan in _plans(empty).values():
        for _, direction in _directions(plan):
            lay = spl.column_layout(direction)
            assert lay.gidx.numel() == 0 and lay.n_rows == 0
            assert lay.n_cols == 128
            assert torch.equal(lay.colptr, torch.zeros(129, dtype=torch.int32))
        assert torch.equal(sk.contract_wtx(plan, W), torch.zeros(4, 70,
                                                              dtype=W.dtype))
        assert torch.equal(sk.contract_xtt(plan, T), torch.zeros(4, 50,
                                                              dtype=T.dtype))
    out = sk.gather_contract_ref(spl.column_layout(
        _plans(empty)['dma'].w_phase), T.T, 4, 128)
    assert out.shape == (4, 128) and not out.any()


def test_layout_is_rebuilt_for_a_moved_plan():
    plan = _plans(MATRICES['ragged']())['mxu'].t_phase
    lay = spl.column_layout(plan)
    moved = plan.to('cpu')
    assert moved.columns is None
    again = spl.column_layout(moved)
    assert again is not lay and torch.equal(again.gidx, lay.gidx)


# ---------------------------------------------------------------------------
# the gather twin against the plan twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('k', [16, 50, 128])
@pytest.mark.parametrize('case', sorted(set(MATRICES) - {'empty'}))
def test_gather_twin_matches_plan_twins(case, k):
    X = MATRICES[case]()
    n, d = X.shape
    Xd = X.toarray()
    rng = np.random.RandomState(k)
    W = torch.as_tensor(rng.rand(n, k))
    T = torch.as_tensor(rng.rand(k, d))
    plans = _plans(X)
    for dirn, Ft, m, dense in (('WtX', W, n, W.numpy().T @ Xd),
                               ('TXt', T.T, d, T.numpy() @ Xd.T)):
        F = Ft.T
        wants = [sk.mxu_contract_ref(plans['mxu'].t_phase if dirn == 'WtX'
                                     else plans['mxu'].w_phase,
                                     sk._padded(F, m)),
                 sk.dma_contract_ref(plans['dma'].t_phase if dirn == 'WtX'
                                     else plans['dma'].w_phase,
                                     sk._tile_cols(F, m))]
        for kind, plan in plans.items():
            direction = plan.t_phase if dirn == 'WtX' else plan.w_phase
            lay = spl.column_layout(direction)
            got = sk.gather_contract_ref(lay, Ft, k, lay.n_cols)
            for want in wants:
                assert _close(got, want), (kind, dirn)
            assert _close(got[:, :dense.shape[1]], dense)
        # the wrappers of both interfaces give the same product
        mp = plans['mxu'].t_phase if dirn == 'WtX' else plans['mxu'].w_phase
        dp = plans['dma'].t_phase if dirn == 'WtX' else plans['dma'].w_phase
        assert torch.equal(sk.mxu_contract(mp, sk._padded(F, m)),
                           sk.dma_contract(dp, sk._tile_cols(F, m)))


def test_zipf_columns_are_skewed():
    """The Zipf case holds the skew the kernel balances: its longest word
    column has many times the mean column's nonzeros."""
    lay = spl.column_layout(_plans(MATRICES['zipf']())['dma'].t_phase)
    counts = np.diff(lay.colptr.numpy())[:700]
    assert counts.max() > 20 * counts.mean()


# ---------------------------------------------------------------------------
# the kernel's decomposition, mirrored in NumPy
# ---------------------------------------------------------------------------

def _kernel_constants():
    text = SOURCE.read_text()
    return {name: int(re.search(r'#define %s (\d+)' % name, text).group(1))
            for name in ('SG_NC', 'SG_WARPS')}


def _xor_tree(acc):
    """The groups' partial sums combined as the kernel's shuffle tree:
    at each level, group g adds the partial of group g ^ off."""
    acc = acc.copy()
    off = 1
    while off < acc.shape[0]:
        acc = acc + acc[np.arange(acc.shape[0]) ^ off]
        off <<= 1
    return acc[0]


def kernel_mirror(lay, Ft, k, ncols, nc, nw, groups):
    """``csrc/sparse.cu`` ``gather_kernel``'s arithmetic in NumPy: blocks
    of ``nc`` columns, ``nw`` equal runs of nonzeros per block, ``groups``
    (32 / L) interleaved partial sums per run piece, pieces of a cut
    column added in warp order, empty columns 0. Unwritten outputs stay
    NaN."""
    colptr, gidx = lay.colptr.numpy(), lay.gidx.numpy()
    vals, F = lay.vals.numpy(), Ft.numpy()[:, :k]
    out = np.full((k, ncols), np.nan)
    for c0 in range(0, ncols, nc):
        cn = min(nc, ncols - c0)
        cp = colptr[c0:c0 + cn + 1]
        lo, hi = int(cp[0]), int(cp[cn])
        q = -(-(hi - lo) // nw)
        tile = np.full((cn, k), np.nan)
        piece = np.full((nw, 2, k), np.nan)
        for w in range(nw):
            a = min(hi, lo + w * q)
            b = min(hi, a + q)
            if a >= b:
                continue
            c = 0
            while cp[c + 1] <= a:
                c += 1
            s = a
            while s < b:
                e = min(b, int(cp[c + 1]))
                acc = np.zeros((groups, k))
                for base in range(s, e, 32):
                    for j in range(min(32, e - base)):
                        i = base + j
                        acc[j % groups] += vals[i] * F[gidx[i]]
                total = _xor_tree(acc)
                if cp[c] >= a and cp[c + 1] <= b:
                    tile[c] = total
                else:
                    piece[w, 0 if cp[c] <= a else 1] = total
                s = e
                c += 1
                while c < cn and cp[c + 1] <= s:
                    c += 1
        for c in range(cn):
            s0, s1 = int(cp[c]), int(cp[c + 1])
            if s0 == s1:
                tile[c] = 0.0
                continue
            w0, w1 = (s0 - lo) // q, (s1 - 1 - lo) // q
            if w0 == w1:
                continue
            total = piece[w0, 0 if lo + w0 * q == s0 else 1].copy()
            for w in range(w0 + 1, w1 + 1):
                total += piece[w, 0]
            tile[c] = total
        out[:, c0:c0 + cn] = tile.T
    return out


@pytest.mark.parametrize('groups', [1, 2, 8])
@pytest.mark.parametrize('blocks', ['source', (4, 3), (5, 8)])
@pytest.mark.parametrize('case', ['duplicates and empty band', 'zipf',
                                  'dense tiles'])
def test_kernel_decomposition_matches_twin(case, blocks, groups):
    nc, nw = ((_kernel_constants()['SG_NC'], _kernel_constants()['SG_WARPS'])
              if blocks == 'source' else blocks)
    X = MATRICES[case]()
    k = 6
    W = torch.as_tensor(np.random.RandomState(4).rand(X.shape[0], k))
    plan = _plans(X)['dma']
    lay = spl.column_layout(plan.t_phase)
    for ncols in (lay.n_cols, X.shape[1]):
        got = kernel_mirror(lay, W, k, ncols, nc, nw, groups)
        want = sk.gather_contract_ref(lay, W, k, ncols).numpy()
        assert np.all(np.isfinite(got))
        assert _close(got, want)


# ---------------------------------------------------------------------------
# the factor rows
# ---------------------------------------------------------------------------

def test_factor_rows_are_w_itself_or_a_padded_copy():
    W = torch.rand(300, 128)
    assert sk._rows(W, 128) is W
    for F, k, kp in ((torch.rand(300, 50), 50, 52),
                     (torch.rand(50, 300).T, 50, 52),
                     (torch.rand(300, 50, dtype=torch.float64), 50, 50),
                     (torch.rand(300, 5, dtype=torch.float64), 5, 6)):
        rows = sk._rows(F, k)
        assert rows.shape == (300, kp) and rows.is_contiguous()
        assert torch.equal(rows[:, :k], F[:, :k])
        assert not rows[:, k:].any()
