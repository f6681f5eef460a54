"""The port's sparse X layouts, the gather kernel's twin and the sparse
sweep against the JAX package.

- The output-column layouts (``ops/sparse_plan.py``) against those
  unpacked from JAX's tile plans (``tests/tile_plan_oracle.py``: B5 with
  group 1 and 8, and B6), with duplicate coordinates, an empty tile band
  and the empty matrix: on a row-major X with sorted columns (a CSR) bit
  for bit, order included; on an unsorted COO each column's entries as a
  multiset, the column offsets exactly. A torch COO or CSR X gives the
  scipy matrix's plan.
- The gather kernel's plain twin on the layouts against JAX's Pallas
  kernels B5 and B6 in interpret mode and against the dense ``F @ X``,
  at 1e-12.
- ``make_sparse_sweep`` with each backend (``torch.sparse``, the layout
  plan) against JAX's ``make_sparse_sweep(cfg, gs_kernels=True,
  interpret=True, mxu=True)`` on its B5 and its B6 plan, at 1e-9, and
  ``make_sparse_objective`` at 1e-10 relative.
- The wrappers' routing, and on a CUDA machine the kernel against its
  twin (marked ``cuda``, skipped without a card).

float64 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from rri_nmf_tpu.ops import sparse_dma as jdma
from rri_nmf_tpu.ops import sparse_mxu as jmxu
from rri_nmf_tpu.ops.sweep_sparse import (
    make_sparse_objective as jax_sparse_objective)
from rri_nmf_tpu.ops.sweep_sparse import make_sparse_sweep as jax_sparse_sweep
from rri_nmf_tpu.ops.sweep_sparse import to_bcoo
from rri_nmf_tpu.ops.sweep_xla import SweepConfig as JaxSweepConfig
from rri_nmf_tpu_torch.ops import sparse_kernels as sk
from rri_nmf_tpu_torch.ops import sparse_plan as spl
from rri_nmf_tpu_torch.ops import sweep_sparse as ss
from rri_nmf_tpu_torch.ops.sweep import SweepConfig
from tile_plan_oracle import jax_plans, unpack

torch.set_num_threads(2)
ATOL_TWIN = 1e-12
ATOL_SWEEP = 1e-9


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


MATRICES = {
    'ragged': lambda: _matrix(300, 260, 0.02, 0),
    'duplicates and empty band': lambda: _matrix(413, 530, 0.01, 1, dup=True,
                                                 empty_band=2),
    'dense tiles': lambda: _matrix(200, 150, 0.3, 2),
    'empty': lambda: sp.coo_matrix((50, 70)),
}


# ---------------------------------------------------------------------------
# the layouts against JAX's tile plans
# ---------------------------------------------------------------------------

def _layout_arrays(layout):
    return tuple(getattr(layout, f).numpy() for f in spl.ColumnLayout._fields)


def _column_entries(colptr, gidx, vals):
    """Each column's (gathered row, value) entries, sorted."""
    return [sorted(zip(gidx[colptr[c]:colptr[c + 1]].tolist(),
                       vals[colptr[c]:colptr[c + 1]].tolist()))
            for c in range(len(colptr) - 1)]


@pytest.mark.parametrize('source', ['csr', 'coo'])
@pytest.mark.parametrize('tile_plan', ['b5 group 8', 'b5 group 1', 'b6'])
@pytest.mark.parametrize('case', sorted(MATRICES))
def test_layouts_match_jax_tile_plans(case, tile_plan, source):
    """The plan's two layouts against those unpacked from JAX's tile plan
    of the same matrix: a CSR (row-major, columns sorted) bit for bit,
    the raw COO (unsorted, duplicates kept) column by column as
    multisets, its column offsets exactly."""
    X = MATRICES[case]()
    if source == 'csr':
        X = X.tocsr()
    got = spl.plan_sparse_matrix(X, np.float64, device='cpu')
    want = jax_plans(X)[tile_plan]
    assert (got.n, got.d) == (want.n, want.d) == X.shape
    for lay, direction in ((got.t_phase, want.t_phase),
                           (got.w_phase, want.w_phase)):
        assert lay.colptr.dtype == lay.gidx.dtype == torch.int32
        assert lay.vals.dtype == torch.float64
        colptr, gidx, vals = unpack(direction)
        ours = _layout_arrays(lay)
        assert np.array_equal(ours[0], colptr)
        assert lay.n_rows == (int(gidx.max()) + 1 if len(gidx) else 0)
        if source == 'csr':
            assert np.array_equal(ours[1], gidx)
            assert np.array_equal(ours[2], vals)
        else:
            assert (_column_entries(*ours)
                    == _column_entries(colptr, gidx, vals))


@pytest.mark.parametrize('case', sorted(MATRICES))
def test_torch_sparse_inputs_plan_like_scipy(case):
    """A torch COO tensor holding the scipy COO's entries in the same
    order (unsorted, duplicates kept) and a torch CSR tensor of its CSR
    give the scipy matrices' plans, bit for bit."""
    coo = MATRICES[case]()
    csr = coo.tocsr()
    Xc = torch.sparse_coo_tensor(np.stack([coo.row, coo.col]), coo.data,
                                 coo.shape)
    Xr = torch.sparse_csr_tensor(csr.indptr, csr.indices, csr.data,
                                 csr.shape)
    for Xt, Xs in ((Xc, coo), (Xr, csr)):
        for dt in (None, torch.float32):
            got = spl.plan_sparse_matrix(Xt, dt)
            want = spl.plan_sparse_matrix(Xs, dt, device='cpu')
            assert got.shape == want.shape == Xs.shape
            for g, w in ((got.t_phase, want.t_phase),
                         (got.w_phase, want.w_phase)):
                assert g.n_rows == w.n_rows
                for field in spl.ColumnLayout._fields:
                    assert torch.equal(getattr(g, field),
                                       getattr(w, field)), field


# ---------------------------------------------------------------------------
# the twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('case', sorted(MATRICES))
def test_twins_match_pallas_interpret_and_dense(case):
    """The gather twin on the layouts against JAX's B5 (``mxu_contract``)
    and B6 (``dma_contract``) in interpret mode, each on its own tile
    plan, and against the dense products."""
    X = MATRICES[case]()
    n, d = X.shape
    Xd = X.toarray()
    rng = np.random.RandomState(3)
    k = 5
    W, T = rng.rand(n, k), rng.rand(k, d)
    jp = jax_plans(X)
    plan = spl.plan_sparse_matrix(X, np.float64, device='cpu')
    lay_t, lay_w = plan.t_phase, plan.w_phase
    # the raw contractions over the padded widths, against the Pallas
    # kernels in interpret mode
    Wt = np.zeros((k, -(-n // 128) * 128))
    Wt[:, :n] = W.T
    want = np.asarray(jmxu.mxu_contract(
        jp['b5 group 8'].t_phase, jnp.asarray(Wt), interpret=True,
        group=8))
    got = sk.gather_contract_ref(lay_t, torch.as_tensor(W), k, lay_t.n_cols)
    assert np.allclose(got.numpy(), want, rtol=0, atol=ATOL_TWIN)
    want = np.asarray(jdma.dma_contract(
        jp['b6'].w_phase, jdma._tile_cols(jnp.asarray(T), d),
        interpret=True))
    got = sk.gather_contract_ref(lay_w, torch.as_tensor(T.T), k,
                                 lay_w.n_cols)
    assert np.allclose(got.numpy(), want, rtol=0, atol=ATOL_TWIN)
    # both directions against dense F @ X
    wtx = sk.contract_wtx(plan, torch.as_tensor(W)).numpy()
    xtt = sk.contract_xtt(plan, torch.as_tensor(T)).numpy()
    assert wtx.shape == (k, d) and xtt.shape == (k, n)
    assert np.allclose(wtx, W.T @ Xd, rtol=0, atol=ATOL_TWIN)
    assert np.allclose(xtt, T @ Xd.T, rtol=0, atol=ATOL_TWIN)


def test_twins_duplicates_sum_and_unvisited_tiles_are_zero():
    X = sp.coo_matrix((np.array([1.0, 2.0, 3.0]),
                       (np.array([5, 5, 9]), np.array([7, 7, 130]))),
                      shape=(200, 400))
    W = torch.as_tensor(np.random.RandomState(0).rand(200, 3))
    plan = spl.plan_sparse_matrix(X, device='cpu')
    out = sk.contract_wtx(plan, W).numpy()
    assert np.allclose(out, W.numpy().T @ X.toarray(), rtol=0,
                       atol=ATOL_TWIN)
    assert np.all(out[:, 256:] == 0.0)
    # the duplicate coordinates are two entries of column 7
    assert plan.t_phase.gidx.tolist() == [5, 5, 9]


def test_twins_chunk_their_gather(monkeypatch):
    """A gather budget below one slice still covers every nonzero."""
    X = MATRICES['dense tiles']()
    W = torch.as_tensor(np.random.RandomState(1).rand(X.shape[0], 4))
    want = W.numpy().T @ X.toarray()
    monkeypatch.setattr(sk, 'GATHER_BUDGET', 1)
    plan = spl.plan_sparse_matrix(X, device='cpu')
    assert np.allclose(sk.contract_wtx(plan, W).numpy(), want, rtol=0,
                       atol=ATOL_TWIN)


# ---------------------------------------------------------------------------
# the sweep and the objective
# ---------------------------------------------------------------------------

SWEEP_CASES = {
    'plain': dict(),
    'tm preset': dict(project_T_each_iter=True, t_row_sum=1.0,
                      w_row_sum=1.0),
    'inner_reps=2': dict(inner_reps=2),
    'negative l1 bounded': dict(reg_t_l1=-0.02, reg_t_l2=0.5, reg_w_l2=0.1,
                                t_row_sum=1.0),
    'fix_T': dict(fix_T=True, w_row_sum=1.0, project_W_each_iter=True),
}


@pytest.mark.parametrize('backend', ['torch', 'mxu', 'dma'])
@pytest.mark.parametrize('case', sorted(SWEEP_CASES))
def test_sparse_sweep_matches_jax(case, backend):
    """The port's sweep on its layout plan (``torch.sparse`` for
    ``'torch'``) against JAX's on its B5 plan (``'torch'``, ``'mxu'``)
    and its B6 plan (``'dma'``)."""
    X = _matrix(301, 267, 0.04, 4).tocsr()
    n, d = X.shape
    k = 4
    rng = np.random.RandomState(5)
    W0, T0 = rng.rand(n, k), rng.rand(k, d)
    kw = dict(k=k, reset_topic_method=None, update_order='phase',
              **SWEEP_CASES[case])
    if kw.get('project_T_each_iter'):
        T0 = T0 / T0.sum(1, keepdims=True)
    jsweep = jax_sparse_sweep(JaxSweepConfig(**kw), gs_kernels=True,
                              interpret=True, mxu=True)
    plan = (jdma.plan_sparse_matrix_dma(X, np.float64) if backend == 'dma'
            else jmxu.plan_sparse_matrix(X, np.float64))
    key = jax.random.PRNGKey(0)
    W, T = jnp.asarray(W0), jnp.asarray(T0)
    for _ in range(3):
        W, T, key, _ = jsweep(plan, W, T, key, jnp.asarray(0), key)
    if backend == 'torch':
        sweep = ss.make_sparse_sweep(SweepConfig(**kw), 'torch')
        Xp = ss.TorchSparseX(ss.to_torch_sparse(X))
    else:
        sweep = ss.make_sparse_sweep(SweepConfig(**kw), 'mxu')
        Xp = spl.plan_sparse_matrix(X, np.float64, device='cpu')
    Wt, Tt = torch.as_tensor(W0), torch.as_tensor(T0)
    for _ in range(3):
        Wt, Tt = sweep(Xp, Wt, Tt)
    assert np.allclose(Wt.numpy(), np.asarray(W), rtol=0, atol=ATOL_SWEEP)
    assert np.allclose(Tt.numpy(), np.asarray(T), rtol=0, atol=ATOL_SWEEP)


def test_sparse_sweep_rejects_wrong_inputs():
    cfg = SweepConfig(k=3, reset_topic_method=None, update_order='phase')
    with pytest.raises(ValueError):
        ss.make_sparse_sweep(SweepConfig(k=3), 'torch')
    for backend in ('bogus', 'dma'):
        with pytest.raises(ValueError):
            ss.make_sparse_sweep(cfg, backend)
    X = _matrix(40, 30, 0.1, 6)
    sweep = ss.make_sparse_sweep(cfg, 'mxu')
    W, T = torch.rand(40, 3, dtype=torch.float64), torch.rand(
        3, 30, dtype=torch.float64)
    with pytest.raises(TypeError):
        sweep(ss.TorchSparseX(ss.to_torch_sparse(X)), W, T)
    assert not ss.supports_sparse(SweepConfig(k=3, masked=True,
                                              update_order='phase',
                                              reset_topic_method=None))


@pytest.mark.parametrize('budget', [2 << 30, 1])
def test_sparse_objective_matches_jax(budget):
    X = _matrix(210, 190, 0.05, 7, dup=True)
    rng = np.random.RandomState(8)
    W, T = rng.rand(210, 6), rng.rand(6, 190)
    regs = dict(reg_w_l2=0.1, reg_t_l2=0.2, reg_w_l1=0.01, reg_t_l1=0.03)
    want = float(jax_sparse_objective(**regs)(to_bcoo(X), jnp.asarray(W),
                                              jnp.asarray(T)))
    fn = ss.make_sparse_objective(chunk=97, gather_budget=budget, **regs)
    got = float(fn(ss.to_torch_sparse(X), torch.as_tensor(W),
                   torch.as_tensor(T)))
    assert got == pytest.approx(want, rel=1e-10)
    dense = 0.5 * ((X.toarray() - W @ T) ** 2).sum() + 0.05 * (W ** 2).sum() \
        + 0.1 * (T ** 2).sum() + 0.03 * T.sum() + 0.01 * W.sum()
    assert got == pytest.approx(dense, rel=1e-10)


def test_to_torch_sparse_sums_duplicates():
    X = sp.coo_matrix((np.array([1.0, 2.0, 4.0]),
                       (np.array([1, 1, 0]), np.array([2, 2, 0]))),
                      shape=(3, 4))
    for src in (X, X.tocsr(), X.toarray(),
                torch.sparse_coo_tensor(np.stack([X.row, X.col]), X.data,
                                        X.shape)):
        t = ss.to_torch_sparse(src)
        assert t.is_coalesced() and t.layout == torch.sparse_coo
        assert np.array_equal(t.to_dense().numpy(), X.toarray())
    assert ss.to_torch_sparse(X.astype(np.int64)).dtype == torch.float64
    assert ss.to_torch_sparse(X, dtype=torch.float32).dtype == torch.float32


# ---------------------------------------------------------------------------
# wrapper routing and checks
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_twins_and_launch_nothing():
    X = MATRICES['ragged']()
    W = torch.as_tensor(np.random.RandomState(9).rand(X.shape[0], 3))
    before = dict(sk.LAUNCHES)
    lay = spl.plan_sparse_matrix(X, device='cpu').t_phase
    assert torch.equal(sk.gather_contract(lay, W, 3, lay.n_cols),
                       sk.gather_contract_ref(lay, W, 3, lay.n_cols))
    assert sk.LAUNCHES == before


def test_non_cuda_devices_raise_and_16_bit_factors_wait_for_A8():
    """Non-CUDA devices raise; 16-bit factors (ROADMAP A.8, ported) meet
    values of their dtype, their exact products summed in float32, as
    JAX's narrow kernels take them (interpret mode, B5 for ``WᵀX`` and B6
    for ``T Xᵀ``): the same float32 output up to summation order."""
    X = MATRICES['ragged']()
    cpu = spl.plan_sparse_matrix(X, device='cpu')
    pm = spl.SparsePlan(*(spl.ColumnLayout(
        *(getattr(lay, f).to('meta') for f in spl.ColumnLayout._fields),
        lay.n_rows) for lay in (cpu.t_phase, cpu.w_phase)), *cpu.shape)
    F = torch.empty(384, 3, dtype=torch.float64, device='meta')
    with pytest.raises(ValueError, match='CUDA'):
        sk.gather_contract(pm.t_phase, F, 3, 128)
    with pytest.raises(ValueError, match='CUDA'):
        sk.contract_xtt(pm, F.T)
    # duplicate coordinates summed first: JAX rounds the sum of a
    # chunk's duplicates to 16 bits inside its one-hot tile, a rounding
    # that depends on its chunking
    X = X.tocsr().tocoo()
    rng = np.random.RandomState(9)
    W, T = rng.rand(X.shape[0], 3), rng.rand(3, X.shape[1])
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float16, jnp.float16)):
        W16, T16 = torch.as_tensor(W).to(dt), torch.as_tensor(T).to(dt)
        Xq = sp.coo_matrix((torch.as_tensor(X.data).to(dt).double().numpy(),
                            (X.row, X.col)), shape=X.shape).tocsr()
        wtx = (Xq.T @ W16.double().numpy()).T
        xtt = T16.double().numpy() @ Xq.T
        plan = spl.plan_sparse_matrix(X, dt, device='cpu')
        got = (sk.contract_wtx(plan, W16), sk.contract_xtt(plan, T16))
        want = (jmxu.contract_wtx(jmxu.plan_sparse_matrix(X, np.dtype(jdt)),
                                  jnp.asarray(W16.float().numpy(), jdt),
                                  interpret=True),
                jdma.contract_xtt(jdma.plan_sparse_matrix_dma(
                    X, np.dtype(jdt)), jnp.asarray(T16.float().numpy(), jdt),
                    interpret=True))
        for g, w, exact in zip(got, want, (wtx, xtt)):
            assert g.dtype == torch.float32 and w.dtype == jnp.float32
            scale = np.abs(exact).max()
            np.testing.assert_allclose(g.numpy(), exact, rtol=0,
                                       atol=1e-6 * scale)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-6 * scale)


def test_shared_memory_gate_and_launch_counter_reset():
    # the gather kernel has no shared-memory gate (it runs k in slices, in
    # ~17 KB a block), and neither does the twin: any k, here 512
    X = MATRICES['ragged']()
    W = torch.as_tensor(np.random.RandomState(9).rand(X.shape[0], 512))
    got = sk.contract_wtx(spl.plan_sparse_matrix(X, device='cpu'), W)
    np.testing.assert_allclose(got.numpy(), (X.T @ W.numpy()).T,
                               atol=ATOL_TWIN)
    sk.LAUNCHES['gather'] += 2
    sk.reset_launches()
    assert sk.LAUNCHES == {'gather': 0, 'gram': 0, 'gram_split': 0}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('k', [16, 50, 200])
@pytest.mark.parametrize('dtype,tol', [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
def test_cuda_kernels_match_twins(cuda_device, dtype, tol, k):
    """The gather kernel through the sweep's products and on a layout's
    whole padded width, against the CPU twin on the CPU's plan, whose
    layouts equal the card's; a repeated launch gives the same bits, and
    so does the plan of a torch CSR X built on the card."""
    X = _matrix(1000, 700, 0.02, 10, dup=True, empty_band=3)
    rng = np.random.RandomState(11)
    W = torch.as_tensor(rng.rand(1000, k), dtype=dtype, device=cuda_device)
    T = torch.as_tensor(rng.rand(k, 700), dtype=dtype, device=cuda_device)

    def close(got, want):
        scale = want.abs().amax(1, keepdim=True).clamp_min(1e-300)
        return float(((got.cpu() - want).abs() / scale).max()) <= tol

    before = dict(sk.LAUNCHES)
    csr = X.tocsr()
    Xr = torch.sparse_csr_tensor(csr.indptr, csr.indices, csr.data,
                                 csr.shape, device=cuda_device)
    outs = {}
    for plan in (spl.plan_sparse_matrix(csr, dtype, device=cuda_device),
                 spl.plan_sparse_matrix(Xr, dtype)):
        assert plan.t_phase.gidx.is_cuda
        cpu = spl.plan_sparse_matrix(csr, dtype, device='cpu')
        for a, b in ((plan.t_phase, cpu.t_phase), (plan.w_phase, cpu.w_phase)):
            assert a.n_rows == b.n_rows
            for f in spl.ColumnLayout._fields:
                assert torch.equal(getattr(a, f).cpu(), getattr(b, f))
        for fn, F in ((sk.contract_wtx, W), (sk.contract_xtt, T)):
            got = fn(plan, F)
            again = fn(plan, F)
            want = fn(cpu, F.cpu())
            torch.cuda.synchronize()
            assert close(got, want) and torch.equal(got, again)
            outs.setdefault(fn.__name__, []).append(got)
        lay = plan.t_phase
        whole = sk.gather_contract(lay, W, k, lay.n_cols)
        ref = sk.gather_contract_ref(cpu.t_phase, W.cpu(), k, lay.n_cols)
        torch.cuda.synchronize()
        assert close(whole, ref)
        assert torch.equal(whole[:, :X.shape[1]], outs['contract_wtx'][-1])
    for got in outs.values():
        assert torch.equal(got[0], got[1])          # the two plans' launches
    assert sk.LAUNCHES['gather'] == before['gather'] + 10
