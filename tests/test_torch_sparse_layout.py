"""The output-column layouts of a sparse X and the gather kernel's plain
twin.

- ``sparse_plan.plan_sparse_matrix``'s two layouts are X's CSC (for
  ``WᵀX``) and CSR (for ``T Xᵀ``): each column holds its nonzeros in
  ascending gather index, duplicate coordinates as separate entries in
  input order, explicit zeros dropped; empty columns and the empty plan;
  ``nmf(sparse='mxu')`` and ``nmf(sparse='dma')`` give the same bits.
- ``sparse_kernels.gather_contract_ref`` (the kernel's twin) on the
  layouts against JAX's Pallas kernels B5 (``mxu_contract``) and B6
  (``dma_contract``) in interpret mode, each on its own tile plan, and
  against the dense product at 1e-12, at k = 16, 50 (in float32 a
  200-byte row, which the kernel pads to 16 bytes) and 128, ragged
  shapes, duplicates, an empty 128-column band and a Zipf corpus (a few
  long columns).
- The NumPy mirror of ``csrc/sparse.cu``'s decomposition
  (``ops/sparse_mirror``: blocks of ``SG_NC`` columns, ``SG_WARPS`` equal
  runs of nonzeros, pieces of cut columns added in warp order, 32/L
  interleaved partial sums), read from the source's constants, against
  the twin: the kernel's index logic, which only the card can run; also
  the 16-bit builds' in float32 on 16-bit rows, and a wrong piece rule
  caught.
- ``_rows`` (W itself when its rows are 16-byte multiples).

float64 on the CPU but for the 16-bit mirror.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from rri_nmf_tpu_torch.nmf import nmf
from rri_nmf_tpu_torch.ops import sparse_kernels as sk
from rri_nmf_tpu_torch.ops import sparse_plan as spl
from rri_nmf_tpu_torch.ops.sparse_mirror import (kernel_constants,
                                                 kernel_mirror, slice_groups)

torch.set_num_threads(2)
# float64, relative to the largest entry of the wanted product (the Zipf
# columns sum hundreds of terms into entries ~1e3): the two sides differ
# only in summation order
RTOL = 1e-12


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


def _plan(X, dtype=np.float64):
    return spl.plan_sparse_matrix(X, dtype, device='cpu')


def _with_explicit_zeros(X):
    """``X`` with every fifth entry's value set to 0, kept as an entry."""
    X = X.copy()
    X.data[::5] = 0.0
    return X


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('direction', ['WtX', 'TXt'])
@pytest.mark.parametrize('case', sorted(MATRICES))
def test_layout_is_the_csc_or_csr_with_zeros_dropped(case, direction):
    """``t_phase`` is X's CSC and ``w_phase`` its CSR: per output column
    the nonzero entries in ascending gather index, a duplicate coordinate
    twice in input order, an explicit zero left out; columns padded to
    whole 128-column tiles; int32 indices."""
    X = _with_explicit_zeros(MATRICES[case]())
    plan = _plan(X)
    lay = plan.t_phase if direction == 'WtX' else plan.w_phase
    assert lay.colptr.dtype == lay.gidx.dtype == torch.int32
    assert lay.vals.dtype == torch.float64
    out, gather = (X.col, X.row) if direction == 'WtX' else (X.row, X.col)
    width = X.shape[1] if direction == 'WtX' else X.shape[0]
    assert lay.n_cols == -(-width // 128) * 128
    keep = X.data != 0
    # a stable sort on (output column, gather index): the order wanted
    order = np.lexsort((gather[keep], out[keep]))
    want_g = gather[keep][order]
    want_v = X.data[keep][order]
    colptr = np.searchsorted(out[keep][order], np.arange(lay.n_cols + 1))
    assert np.array_equal(lay.colptr.numpy(), colptr)
    assert np.array_equal(lay.gidx.numpy(), want_g)
    assert np.array_equal(lay.vals.numpy(), want_v)
    assert np.all(lay.vals.numpy() != 0)
    assert lay.n_rows == (int(want_g.max()) + 1 if len(want_g) else 0)


@pytest.mark.parametrize('case', sorted(MATRICES))
def test_nmf_mxu_and_dma_fit_the_same_bits(case):
    """``sparse='mxu'`` and ``sparse='dma'`` build one plan, so their fits
    are equal bit for bit."""
    X = MATRICES[case]()
    fits = [nmf(X, 4, max_iter=3, update_order='phase',
                reset_topic_method=None, sparse=mode, random_state=0,
                init='random', device='cpu')
            for mode in ('mxu', 'dma')]
    for name in ('W', 'T'):
        assert torch.equal(torch.as_tensor(fits[0][name]),
                           torch.as_tensor(fits[1][name])), name


def test_empty_columns_and_the_empty_plan():
    X = MATRICES['duplicates and empty band']()
    lay = _plan(X).t_phase
    counts = np.diff(lay.colptr.numpy())
    assert np.all(counts[256:384] == 0) and counts[:256].sum() > 0
    assert np.all(counts[X.shape[1]:] == 0)            # the padded columns

    empty = sp.coo_matrix((50, 70))
    W = torch.rand(50, 4, dtype=torch.float64)
    T = torch.rand(4, 70, dtype=torch.float64)
    plan = _plan(empty)
    for lay in (plan.t_phase, plan.w_phase):
        assert lay.gidx.numel() == 0 and lay.n_rows == 0
        assert lay.n_cols == 128
        assert torch.equal(lay.colptr, torch.zeros(129, dtype=torch.int32))
    assert torch.equal(sk.contract_wtx(plan, W), torch.zeros(4, 70,
                                                          dtype=W.dtype))
    assert torch.equal(sk.contract_xtt(plan, T), torch.zeros(4, 50,
                                                          dtype=T.dtype))
    out = sk.gather_contract_ref(plan.w_phase, T.T, 4, 128)
    assert out.shape == (4, 128) and not out.any()


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16])
def test_16_bit_values_are_rounded_once_and_zeros_dropped(dtype):
    """A 16-bit plan's values are X's float64 values rounded once to the
    dtype, and the entries that round to 0 leave the layout."""
    X = MATRICES['ragged']().tocsr()
    X.data[::3] = 1e-50                     # 0 in either 16-bit dtype
    lay = _plan(X, dtype).w_phase
    rounded = torch.as_tensor(X.data).to(dtype)
    keep = (rounded != 0).numpy()
    assert lay.vals.dtype == dtype and not keep.all()
    assert torch.equal(lay.vals, rounded[torch.as_tensor(keep)])
    assert np.array_equal(lay.gidx.numpy(), X.indices[keep])


# ---------------------------------------------------------------------------
# the gather twin against JAX's kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('k', [16, 50, 128])
@pytest.mark.parametrize('case', sorted(set(MATRICES) - {'empty'}))
def test_gather_twin_matches_plan_twins(case, k):
    """The twin on each layout against B5 and B6 in interpret mode (each
    on JAX's own tile plan of X, over the padded width) and against the
    dense product."""
    import jax.numpy as jnp
    from rri_nmf_tpu.ops import sparse_dma as jdma
    from rri_nmf_tpu.ops import sparse_mxu as jmxu
    from tile_plan_oracle import jax_plans
    X = MATRICES[case]()
    n, d = X.shape
    Xd = X.toarray()
    rng = np.random.RandomState(k)
    W = torch.as_tensor(rng.rand(n, k))
    T = torch.as_tensor(rng.rand(k, d))
    plan = _plan(X)
    jp = jax_plans(X)
    for dirn, Ft, m, dense in (('WtX', W, n, W.numpy().T @ Xd),
                               ('TXt', T.T, d, T.numpy() @ Xd.T)):
        lay = plan.t_phase if dirn == 'WtX' else plan.w_phase
        F = np.zeros((k, -(-m // 128) * 128))
        F[:, :m] = Ft.numpy().T
        b5 = getattr(jp['b5 group 8'], 't_phase' if dirn == 'WtX'
                     else 'w_phase')
        b6 = getattr(jp['b6'], 't_phase' if dirn == 'WtX' else 'w_phase')
        wants = [jmxu.mxu_contract(b5, jnp.asarray(F), interpret=True,
                                   group=8),
                 jdma.dma_contract(b6, jdma._tile_cols(jnp.asarray(F[:, :m]),
                                                       m), interpret=True)]
        got = sk.gather_contract_ref(lay, Ft, k, lay.n_cols)
        for want in wants:
            assert _close(got, np.asarray(want)), dirn
        assert _close(got[:, :dense.shape[1]], dense)


def test_zipf_columns_are_skewed():
    """The Zipf case holds the skew the kernel balances: its longest word
    column has many times the mean column's nonzeros."""
    lay = _plan(MATRICES['zipf']()).t_phase
    counts = np.diff(lay.colptr.numpy())[:700]
    assert counts.max() > 20 * counts.mean()


# ---------------------------------------------------------------------------
# the kernel's decomposition, mirrored in NumPy
# ---------------------------------------------------------------------------

# the decompositions held (the ids pytest gave the float64 cases before
# the 16-bit ones joined): float64 rows at k=6 in the source's blocks and
# in others, with 1, 2 or 8 groups; the 16-bit builds' (the source's
# blocks, 8 values a lane: ``slice_groups(k, 2)`` groups) at k = 24, 50,
# 128 and 200
DECOMPOSITIONS = {
    '%s-%d' % (name, groups): (torch.float64, 6, blocks, groups)
    for name, blocks in (('source', 'source'), ('blocks1', (4, 3)),
                         ('blocks2', (5, 8)))
    for groups in (1, 2, 8)}
DECOMPOSITIONS.update({
    '%s-k%d' % (str(dt)[6:], k): (dt, k, 'source', None)
    for dt in (torch.bfloat16, torch.float16) for k in (24, 50, 128, 200)})


def _gamma_bound(lay, exact, ncols):
    """Per entry, the float32 error bound of summing its column's m
    nonnegative terms in any order: γ_m·(their sum), γ_m = m·u/(1 - m·u),
    u = 2⁻²⁴ (the products of 16-bit values are exact in float32)."""
    m = np.diff(lay.colptr.numpy())[:ncols].astype(np.float64)
    u = 2.0 ** -24
    return (m * u / (1 - m * u))[None, :] * np.abs(exact)


@pytest.mark.parametrize('setup', list(DECOMPOSITIONS.values()),
                         ids=list(DECOMPOSITIONS))
@pytest.mark.parametrize('case', ['duplicates and empty band', 'zipf',
                                  'dense tiles'])
def test_kernel_decomposition_matches_twin(case, setup):
    """The mirror against the twin: in float64 within 1e-12 of it; in 16
    bits (16-bit factor rows and values, float32 arithmetic) the mirror
    and the twin each within the float32 bound of the exact product, and
    within twice that of each other."""
    dt, k, blocks, groups = setup
    c = kernel_constants()
    nc, nw = (c['SG_NC'], c['SG_WARPS']) if blocks == 'source' else blocks
    X = MATRICES[case]()
    W = torch.as_tensor(np.random.RandomState(4).rand(X.shape[0], k)).to(dt)
    lay = _plan(X, dt).t_phase
    if dt != torch.float64:
        groups = slice_groups(k, W.element_size())
    for ncols in (lay.n_cols, X.shape[1]):
        got = kernel_mirror(lay, W, k, ncols, nc, nw, groups,
                            np.float64 if dt == torch.float64 else np.float32)
        want = sk.gather_contract_ref(lay, W, k, ncols)
        assert np.all(np.isfinite(got))
        if dt == torch.float64:
            assert _close(got, want.numpy())
            continue
        assert got.dtype == np.float32 and want.dtype == torch.float32
        exact = sk.gather_contract_ref(lay, W.double(), k, ncols,
                                       vals=lay.vals.double()).numpy()
        tol = _gamma_bound(lay, exact, ncols)
        assert np.all(np.abs(got - exact) <= tol)
        assert np.all(np.abs(want.numpy() - exact) <= tol)
        assert np.all(np.abs(got - want.numpy()) <= 2 * tol)


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
def test_kernel_mirror_fails_on_a_wrong_piece_rule(dtype):
    """The Zipf columns are cut between warps, so a mirror whose cut
    columns start from the wrong piece does not match the twin."""
    c = kernel_constants()
    X = MATRICES['zipf']()
    tdt = torch.float64 if dtype == np.float64 else torch.bfloat16
    W = torch.as_tensor(np.random.RandomState(4).rand(X.shape[0], 6)).to(tdt)
    lay = _plan(X, tdt).t_phase
    groups = slice_groups(6, W.element_size())
    want = sk.gather_contract_ref(lay, W, 6, lay.n_cols).double().numpy()
    right = kernel_mirror(lay, W, 6, lay.n_cols, c['SG_NC'], c['SG_WARPS'],
                          groups, dtype)
    wrong = kernel_mirror(lay, W, 6, lay.n_cols, c['SG_NC'], c['SG_WARPS'],
                          groups, dtype, wrong_pieces=True)
    assert np.allclose(right, want, rtol=1e-5, atol=0)
    assert not np.allclose(wrong, want, rtol=1e-5, atol=0)


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
