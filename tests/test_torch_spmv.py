"""The SpMV of the interleaved sweep's W side (``ops/spmv.py``,
``csrc/spmv.cu``) and its routing in ``ops/sweep.Sweep``. No JAX: the
JAX parity of the sweep on a sparse X is in ``tests/test_torch_sweep.py``.

On the CPU (float64 unless marked):

- the plain twin against the dense ``X @ t``: empty rows, a row longer
  than a block's share, ragged n, an all-zero X, one entry;
- the CSR: X's own values in row order, the same built a few rows at a
  time, and the blocks' cut of the rows (whole rows, about ``CHUNK``
  nonzeros a block, a long row starting its block);
- the density rule, the CPU's crossover (a ~0.3%-dense X takes the
  twin's route, a 2%-dense one the GEMV), and what bypasses the route: a
  dense X, a mesh, a masked fit, phase order, ``fix_W``, a bfloat16 X, a
  ``QuantizedX``, a float32 X under float64 factors;
- under the card's rule (:func:`_route_on`) a ~1%-dense X engages it: k
  products a sweep, in ``Sweep`` and in ``nmf()``; the sweep and the fit
  through it equal the GEMV route's at 1e-12;
- the CSR is found once per X object, a view of X at the same address
  being another X, by the sweep's call or the eager sweep, never by the
  speculative sweep, which reads nothing on the host.

On the card (``cuda``): the kernel against its twin and the dense product
in float32 and float64 on the same cases, two launches bit for bit, a
captured launch replayed equal to an eager one, and the plain sweep's
CUDA graph counting k launches a replayed sweep. The file imports no
JAX, so ``python -m pytest --noconftest -m cuda tests/test_torch_spmv.py``
runs those on the card's machine.
"""

import numpy as np
import pytest
import torch

from rri_nmf_tpu_torch.nmf import nmf
from rri_nmf_tpu_torch.ops import spmv as sp
from rri_nmf_tpu_torch.ops.quantized import quantize_x
from rri_nmf_tpu_torch.ops.sweep import (SweepConfig, Sweep, make_draws,
                                         make_sweep)


def _sparse(n, d, density, seed=0, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    X = torch.rand(n, d, generator=g, dtype=dtype)
    return X * (torch.rand(n, d, generator=g, dtype=dtype) < density)


def _cases(dtype=torch.float64):
    """(name, X): the shapes the kernel's cut of the nonzeros has to
    handle."""
    X = _sparse(300, 500, 0.03, seed=1, dtype=dtype)
    X[[0, 7, 8, 9, 299]] = 0.0                      # empty rows, first, last
    long = _sparse(50, 9000, 0.002, seed=2, dtype=dtype)
    long[11] = torch.rand(9000, generator=torch.Generator().manual_seed(3),
                          dtype=dtype)               # 9000 nonzeros a row
    long[12, :3] = 1.0
    long[40, :2500] = 0.5
    return [('scattered', X), ('long rows', long),
            ('ragged', _sparse(1001, 77, 0.2, seed=4, dtype=dtype)),
            ('zero', torch.zeros(33, 20, dtype=dtype)),
            ('one entry', torch.full((1, 1), 2.5, dtype=dtype))]


CASES = [name for name, _ in _cases()]


def _case(name, dtype=torch.float64, device='cpu'):
    return dict(_cases(dtype))[name].to(device)


@pytest.mark.parametrize('name', CASES)
def test_twin_equals_the_dense_product(name):
    X = _case(name)
    t = torch.rand(X.shape[1], generator=torch.Generator().manual_seed(5),
                   dtype=X.dtype)
    rows = sp.rows_of(X)
    got = sp.spmv(rows, t)
    assert got.shape == (X.shape[0],) and got.dtype == X.dtype
    assert torch.allclose(got, X @ t, rtol=1e-13, atol=1e-13)
    # an empty row is exactly 0
    empty = (X == 0).all(1)
    assert torch.equal(got[empty], torch.zeros_like(got[empty]))


@pytest.mark.parametrize('name', CASES)
def test_rows_hold_x_in_row_order_and_blocks_cut_whole_rows(name):
    X = _case(name)
    rows = sp.rows_of(X)
    n, d = X.shape
    assert rows.shape == (n, d)
    for a in (rows.rowptr, rows.cols, rows.blocks):
        assert a.dtype == torch.int32 and a.is_contiguous()
    nz = X.nonzero()
    assert torch.equal(rows.cols.long(), nz[:, 1])
    assert torch.equal(rows.vals, X[nz[:, 0], nz[:, 1]])
    assert torch.equal(torch.diff(rows.rowptr.long()), (X != 0).sum(1))
    b = rows.blocks.long()
    assert b[0] == 0 and b[-1] == n and bool((torch.diff(b) > 0).all())
    # a block starts at the row holding nonzero c·CHUNK, so it holds
    # fewer than CHUNK nonzeros past its first row
    ptr = rows.rowptr.long()
    first_len = ptr[b[:-1] + 1] - ptr[b[:-1]]
    assert bool((ptr[b[1:]] - ptr[b[:-1]] - first_len < sp.CHUNK).all())


@pytest.mark.parametrize('name', CASES)
def test_rows_built_in_steps_equal_one_step(name, monkeypatch):
    X = _case(name)
    whole = sp.rows_of(X)
    monkeypatch.setattr(sp, 'BUILD_ELEMS', 3 * X.shape[1] - 1)
    steps = sp.rows_of(X)
    for a, b in zip(whole[:4], steps[:4]):
        assert torch.equal(a, b)


def test_a_long_row_starts_its_block():
    # rows 11 (9000 nonzeros) and 40 (2500) each hold a multiple of CHUNK
    blocks = sp.rows_of(_case('long rows')).blocks.tolist()
    assert 11 in blocks and 40 in blocks and len(blocks) < 8


def _route_on(monkeypatch):
    """The card's rule on the CPU: a ~1%-dense X takes the twin's route,
    which the CPU's own crossover leaves to the GEMV."""
    monkeypatch.setattr(sp, 'CPU_MAX_DENSITY', sp.MAX_DENSITY)


def _route_off(monkeypatch):
    monkeypatch.setattr(sp, 'MAX_DENSITY', -1.0)
    monkeypatch.setattr(sp, 'CPU_MAX_DENSITY', -1.0)


def test_density_rule(monkeypatch):
    X = _sparse(200, 100, 0.01)
    # on the CPU a 1%-dense X lies above the twin's crossover
    assert sp.max_density(X) == sp.CPU_MAX_DENSITY < 0.01
    assert sp.sparse_rows(X) is None
    _route_on(monkeypatch)
    assert isinstance(sp.sparse_rows(X), sp.Rows)
    assert sp.sparse_rows(torch.rand(200, 100, dtype=torch.float64)) is None
    # at the crossover itself the rows are built, above it not
    nnz = int((X != 0).sum())
    monkeypatch.setattr(sp, 'CPU_MAX_DENSITY', nnz / X.numel())
    assert sp.sparse_rows(X) is not None
    monkeypatch.setattr(sp, 'CPU_MAX_DENSITY', (nnz - 1) / X.numel())
    assert sp.sparse_rows(X) is None
    assert sp.sparse_rows(X.to(torch.bfloat16)) is None
    assert sp.sparse_rows(X.to_sparse()) is None


def _counting(monkeypatch):
    """Count the sweep's calls of ``spmv.spmv`` (the twin launches
    nothing, so LAUNCHES stays 0 on the CPU)."""
    calls = []
    real = sp.spmv

    def spmv(rows, t):
        calls.append(rows.shape)
        return real(rows, t)
    monkeypatch.setattr(sp, 'spmv', spmv)
    return calls


def _corpus(n, d, k, density, seed=0, dtype=torch.float64):
    """A ~``density``-dense X of k blocks (row i and column j share block
    ``i % k``, ``j % k``) over a tenth of it spread evenly."""
    g = torch.Generator().manual_seed(seed)
    same = (torch.arange(n)[:, None] % k) == (torch.arange(d)[None, :] % k)
    keep = torch.rand(n, d, generator=g, dtype=dtype) < 0.9 * density * k
    spread = torch.rand(n, d, generator=g, dtype=dtype) < 0.1 * density
    return torch.rand(n, d, generator=g, dtype=dtype) * ((same & keep)
                                                          | spread)


def _factors(n, d, k, seed=6, dtype=torch.float64):
    """W and T near :func:`_corpus`'s blocks: no topic dies."""
    g = torch.Generator().manual_seed(seed)
    W = (torch.arange(n)[:, None] % k == torch.arange(k)).to(dtype)
    T = 0.05 * (torch.arange(k)[:, None] == torch.arange(d) % k).to(dtype)
    return (W + 0.1 * torch.rand(n, k, generator=g, dtype=dtype),
            T + 0.01 * torch.rand(k, d, generator=g, dtype=dtype))


@pytest.mark.parametrize('kw', [dict(), dict(reset_topic_method=None),
                                dict(project_T_each_iter=True, t_row_sum=1.0,
                                     w_row_sum=1.0),
                                dict(fix_T=True)])
def test_a_sparse_x_takes_k_products_a_sweep(kw, monkeypatch):
    _route_on(monkeypatch)
    calls = _counting(monkeypatch)
    n, d, k = 150, 1200, 6
    X = _corpus(n, d, k, 0.01, seed=7)
    W, T = _factors(n, d, k)
    sweep = make_sweep(SweepConfig(k=k, **kw))
    draws = make_draws(0, 'cpu')
    for s in range(3):
        W, T, left = sweep(X, W, T, draws, 3)
        assert len(calls) == k * (s + 1) and left == 3
    assert set(calls) == {(n, d)}


@pytest.mark.parametrize('density,routed', [(0.003, True), (0.02, False)])
def test_the_cpu_crossover(density, routed, monkeypatch):
    """With the constants as they stand, a CPU X below
    :data:`~rri_nmf_tpu_torch.ops.spmv.CPU_MAX_DENSITY` takes the twin's
    route, k products a sweep; one above it, though under the card's
    rule, takes the GEMV."""
    calls = _counting(monkeypatch)
    n, d, k = 150, 1200, 6
    X = _corpus(n, d, k, density, seed=19)
    nnz = int((X != 0).sum())
    assert (nnz <= sp.CPU_MAX_DENSITY * X.numel()) == routed
    assert nnz <= sp.MAX_DENSITY * X.numel()
    W, T = _factors(n, d, k)
    sweep = make_sweep(SweepConfig(k=k))
    assert (sweep.rows(X, W) is not None) == routed
    for s in range(2):
        W, T, _ = sweep(X, W, T, make_draws(0, 'cpu'), 3)
        assert len(calls) == (k * (s + 1) if routed else 0)


@pytest.mark.parametrize('case', ['dense X', 'masked', 'phase', 'fix_W',
                                  'bfloat16 X', 'QuantizedX',
                                  'float64 factors', 'mesh'])
def test_what_bypasses_the_route(case, monkeypatch):
    _route_on(monkeypatch)          # only the case sends X to the GEMV
    calls = _counting(monkeypatch)
    n, d, k = 80, 60, 4
    X = _sparse(n, d, 0.02, seed=9) + 0.01 * torch.eye(n, d,
                                                       dtype=torch.float64)
    W, T = _factors(n, d, k)
    kw, extras = dict(k=k), ()
    if case == 'dense X':
        X = X + 0.5
    elif case == 'masked':
        kw['masked'] = True
        extras = ((X != 0).double(),)
    elif case == 'phase':
        kw['update_order'] = 'phase'
    elif case == 'fix_W':
        kw['fix_W'] = True
    elif case == 'bfloat16 X':
        X = X.to(torch.bfloat16)
        W, T = W.float(), T.float()
    elif case == 'float64 factors':
        X = X.float()
    if case == 'mesh':
        class OneRank(object):
            graphable = True
        sweep = Sweep(SweepConfig(mesh=OneRank(), **kw))
        assert sweep.rows(X, W) is None
        return
    sweep = make_sweep(SweepConfig(**kw))
    if case == 'QuantizedX':
        qx = quantize_x(X, device='cpu')
        assert sweep.rows(qx, W) is None
        return
    assert sweep.rows(X, W) is None
    sweep(X, W, T, make_draws(0, 'cpu'), 2, *extras)
    assert calls == []


@pytest.mark.parametrize('case', ['plain', 'simplex', 'a reset'])
def test_the_route_equals_the_gemv_route(case, monkeypatch):
    n, d, k = 120, 1500, 5
    X = _corpus(n, d, k, 0.01, seed=10)
    W0, T0 = _factors(n, d, k, seed=12)
    kw = dict(k=k)
    if case == 'simplex':
        kw.update(project_T_each_iter=True, t_row_sum=1.0, w_row_sum=1.0)
    if case == 'a reset':
        W0[:, 3] = 0.0
    outs = []
    _route_on(monkeypatch)
    for on in (True, False):
        if not on:
            _route_off(monkeypatch)
        calls = _counting(monkeypatch)
        sweep = make_sweep(SweepConfig(**kw))
        W, T, left = W0, T0, 4
        for _ in range(4):
            W, T, left = sweep(X, W, T, make_draws(0, 'cpu'), left)
        assert bool(calls) == on
        outs.append((W, T, left))
    (Wa, Ta, la), (Wb, Tb, lb) = outs
    assert la == lb == (3 if case == 'a reset' else 4)
    assert torch.allclose(Wa, Wb, rtol=0, atol=1e-12)
    assert torch.allclose(Ta, Tb, rtol=0, atol=1e-12)


def test_nmf_defaults_on_a_sparse_x(monkeypatch):
    """``nmf()``'s defaults (interleaved, ``'max_resid_document'``) on a
    ~1%-dense X: k products a sweep through the route, and the fit of
    the GEMV route at 1e-12."""
    n, d, k, sweeps = 150, 1200, 8, 6
    X = _corpus(n, d, k, 0.012, seed=13)
    fits = []
    _route_on(monkeypatch)
    for on in (True, False):
        if not on:
            _route_off(monkeypatch)
        calls = _counting(monkeypatch)
        out = nmf(X, k, max_iter=sweeps, random_state=0, device='cpu',
                  compute_obj_each_iter=True)
        assert len(out['obj_history']) == sweeps
        resets = 23 - out['n_resets_remaining']
        if on:
            # a sweep whose topic dies with budget left runs again, eagerly
            assert k * sweeps <= len(calls) <= k * (sweeps + resets)
        else:
            assert calls == []
        fits.append(out)
    a, b = fits
    assert a['n_resets_remaining'] == b['n_resets_remaining']
    assert torch.allclose(a['W'], b['W'], rtol=0, atol=1e-12)
    assert torch.allclose(a['T'], b['T'], rtol=0, atol=1e-12)
    assert np.allclose(a['obj_history'], b['obj_history'], rtol=1e-12)


def test_rows_are_found_once_per_x_object(monkeypatch):
    _route_on(monkeypatch)
    built = []
    real = sp.sparse_rows

    def sparse_rows(X):
        built.append(X)
        return real(X)
    monkeypatch.setattr(sp, 'sparse_rows', sparse_rows)
    n, d, k = 60, 50, 3
    X = _sparse(n, d, 0.02, seed=15)
    W, _ = _factors(n, d, k)
    sweep = make_sweep(SweepConfig(k=k))
    a = sweep.rows(X, W)
    assert sweep.rows(X, W) is a and len(built) == 1
    # the same address, another X: found again
    view = X.view(n, d)
    assert view.data_ptr() == X.data_ptr() and view is not X
    b = sweep.rows(view, W)
    assert len(built) == 2 and b is not a
    assert torch.equal(b.vals, a.vals)


def test_the_speculative_sweep_reads_nothing_on_the_host(monkeypatch):
    """The speculative sweep only looks X's nonzeros up: an X not seen
    before takes the GEMV; the sweep's call and the eager sweep find
    them (one host read), after which the speculative sweep reads them."""
    _route_on(monkeypatch)
    found = []
    real = sp.sparse_rows
    monkeypatch.setattr(sp, 'sparse_rows',
                        lambda X: found.append(X) or real(X))
    calls = _counting(monkeypatch)
    n, d, k = 120, 1500, 5
    X = _corpus(n, d, k, 0.01, seed=18)
    W, T = _factors(n, d, k)
    sweep = make_sweep(SweepConfig(k=k))
    sweep.speculate(X, W, T, make_draws(0, 'cpu'), 3)
    assert found == [] and calls == []
    sweep(X, W, T, make_draws(0, 'cpu'), 3)
    assert len(found) == 1 and len(calls) == k
    sweep.speculate(X, W, T, make_draws(0, 'cpu'), 3)
    assert len(found) == 1 and len(calls) == 2 * k
    other = X.clone()
    sweep.eager(other, W, T, make_draws(0, 'cpu'), 3)
    assert len(found) == 2 and len(calls) == 3 * k


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float64, 1e-13),
                                       (torch.float32, 2e-6)])
@pytest.mark.parametrize('name', CASES)
def test_cuda_kernel_matches_twin_and_dense(cuda_device, name, dtype, tol):
    X = _case(name, dtype, cuda_device)
    t = torch.rand(X.shape[1], dtype=dtype, device=cuda_device)
    rows = sp.rows_of(X)
    before = sp.LAUNCHES['spmv']
    got = sp.spmv(rows, t)
    again = sp.spmv(rows, t)
    torch.cuda.synchronize()
    assert sp.LAUNCHES['spmv'] == before + 2
    assert torch.equal(got, again)
    scale = float((X.abs() @ t.abs()).max().clamp_min(1e-30))
    for want in (sp.spmv_ref(rows, t), X @ t):
        assert float((got - want).abs().max()) <= tol * scale
    empty = (X == 0).all(1)
    assert bool((got[empty] == 0).all())


@pytest.mark.cuda
def test_cuda_kernel_in_a_graph_equals_an_eager_launch(cuda_device):
    X = _case('scattered', torch.float32, cuda_device)
    rows = sp.rows_of(X)
    t = torch.rand(X.shape[1], device=cuda_device)
    eager = sp.spmv(rows, t)
    t_in = t.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        sp.spmv(rows, t_in)                            # warm up off-graph
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = sp.spmv(rows, t_in)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    t_in.copy_(2.0 * t)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, sp.spmv(rows, 2.0 * t))


@pytest.mark.cuda
def test_cuda_sweep_graph_counts_k_launches_a_sweep(cuda_device):
    n, d, k = 400, 3000, 6
    X = _corpus(n, d, k, 0.01, seed=16, dtype=torch.float32).to(cuda_device)
    W, T = (a.to(cuda_device) for a in _factors(n, d, k,
                                                 dtype=torch.float32))
    assert sp.max_density(X) == sp.MAX_DENSITY        # the card's rule
    sweep = make_sweep(SweepConfig(k=k))
    draws = make_draws(0, cuda_device)
    before = sp.LAUNCHES['spmv']
    outs = []
    for s in range(4):          # launches, capture, then two replays
        outs.append(sweep(X, W, T, draws, 3))
        torch.cuda.synchronize()
        assert sp.LAUNCHES['spmv'] == before + k * (s + 1)
    for W_s, T_s, _ in outs[1:]:
        assert torch.equal(W_s, outs[0][0]) and torch.equal(T_s, outs[0][1])
