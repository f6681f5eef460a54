"""The port's sparse plans, contraction kernels and sparse sweep against
the JAX package.

- The host plans (``ops/sparse_plan.py``) against JAX's
  ``_plan_direction_np``, ``plan_sparse_matrix`` (group 1 and 8) and
  ``plan_sparse_matrix_dma``, bit for bit on every array, with duplicate
  coordinates, an empty tile band and the empty matrix. JAX's native
  counting sort is switched off for the comparison, so both packages run
  the same NumPy argsort form.
- The plain twins of B5 and B6 (``mxu_contract_ref``,
  ``dma_contract_ref``) against the Pallas kernels in interpret mode and
  against the dense ``F @ X``, at 1e-12.
- ``make_sparse_sweep`` with each backend (``torch.sparse``, the B5
  plan, the B6 plan) against JAX's ``make_sparse_sweep(cfg,
  gs_kernels=True, interpret=True, mxu=True)``, at 1e-9, and
  ``make_sparse_objective`` at 1e-10 relative.
- The wrappers' routing, and on a CUDA machine each kernel against its
  twin (marked ``cuda``, skipped without a card).

float64 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rri_nmf_tpu.native as jax_native
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

torch.set_num_threads(2)
ATOL_TWIN = 1e-12
ATOL_SWEEP = 1e-9


@pytest.fixture
def argsort_plans(monkeypatch):
    """JAX's plan functions on their NumPy argsort path (the port's)."""
    monkeypatch.setattr(jax_native, 'plan_hist', lambda *a, **k: None)


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
# host plans, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('G', [1, 8])
@pytest.mark.parametrize('case', sorted(MATRICES))
def test_plan_direction_matches_jax(case, G, argsort_plans):
    X = MATRICES[case]()
    n, d = X.shape
    args = (X.col, X.row, X.data, -(-d // 128), -(-n // 128), 128, G,
            np.float64)
    for got, want in zip(spl._plan_direction_np(*args),
                         jmxu._plan_direction_np(*args)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def _arrays_equal(got, want):
    got = got.cpu().numpy()
    want = np.asarray(want)
    return got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize('group', [1, 8])
@pytest.mark.parametrize('case', sorted(MATRICES))
def test_plan_sparse_matrix_matches_jax(case, group, argsort_plans):
    X = MATRICES[case]()
    got = spl.plan_sparse_matrix(X, np.float64, group=group, device='cpu')
    want = jmxu.plan_sparse_matrix(X, np.float64, group=group)
    assert (got.n, got.d, got.group) == (want.n, want.d, want.group)
    for g, w in ((got.t_phase, want.t_phase), (got.w_phase, want.w_phase)):
        for field in ('vals', 'gloc', 'sloc', 'ftile', 'otile', 'mask'):
            assert _arrays_equal(getattr(g, field), getattr(w, field)), field
        assert g.gloc.dtype == g.sloc.dtype == torch.uint8


@pytest.mark.parametrize('case', sorted(MATRICES))
def test_plan_sparse_matrix_dma_matches_jax(case, argsort_plans):
    X = MATRICES[case]()
    got = spl.plan_sparse_matrix_dma(X, np.float64, device='cpu')
    want = jdma.plan_sparse_matrix_dma(X, np.float64)
    for g, w in ((got.t_phase, want.t_phase), (got.w_phase, want.w_phase)):
        for field in ('vals', 'idx', 'ftile', 'uotile', 'ostart', 'mask'):
            assert _arrays_equal(getattr(g, field), getattr(w, field)), field
        assert g.ftile.shape[0] == int(g.ostart[-1]) + spl.MBLK_MAX


def test_torch_sparse_inputs_plan_like_scipy():
    """A torch COO or CSR tensor holding the scipy matrix's entries in the
    same order gives the same plan."""
    X = MATRICES['duplicates and empty band']().tocsr()
    X.sum_duplicates()
    want = spl.plan_sparse_matrix(X, np.float64, device='cpu')
    coo = X.tocoo()
    Xc = torch.sparse_coo_tensor(np.stack([coo.row, coo.col]), coo.data,
                                 X.shape)
    Xr = torch.sparse_csr_tensor(X.indptr, X.indices, X.data, X.shape)
    for Xt in (Xc, Xr):
        got = spl.plan_sparse_matrix(Xt)
        for field in spl.ContractPlan._fields:
            assert torch.equal(getattr(got.t_phase, field),
                               getattr(want.t_phase, field))
            assert torch.equal(getattr(got.w_phase, field),
                               getattr(want.w_phase, field))


# ---------------------------------------------------------------------------
# the twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('case', sorted(MATRICES))
def test_twins_match_pallas_interpret_and_dense(case, argsort_plans):
    X = MATRICES[case]()
    n, d = X.shape
    Xd = X.toarray()
    rng = np.random.RandomState(3)
    k = 5
    W, T = rng.rand(n, k), rng.rand(k, d)
    jm = jmxu.plan_sparse_matrix(X, np.float64)
    jd = jdma.plan_sparse_matrix_dma(X, np.float64)
    pm = spl.plan_sparse_matrix(X, np.float64, device='cpu')
    pd = spl.plan_sparse_matrix_dma(X, np.float64, device='cpu')
    Wt = sk._padded(torch.as_tensor(W.T.copy()), n)
    # the raw contraction, against the Pallas kernel in interpret mode
    want = np.asarray(jmxu.mxu_contract(jm.t_phase, jnp.asarray(Wt.numpy()),
                                        interpret=True, group=jm.group))
    got = sk.mxu_contract_ref(pm.t_phase, Wt).numpy()
    assert np.allclose(got, want, rtol=0, atol=ATOL_TWIN)
    want = np.asarray(jdma.dma_contract(
        jd.w_phase, jdma._tile_cols(jnp.asarray(T), d), interpret=True))
    got = sk.dma_contract_ref(pd.w_phase, sk._tile_cols(
        torch.as_tensor(T), d)).numpy()
    assert np.allclose(got, want, rtol=0, atol=ATOL_TWIN)
    # both directions, both plan types, against dense F @ X
    for plan in (pm, pd, spl.plan_sparse_matrix(X, np.float64, group=1,
                                                device='cpu')):
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
    for plan in (spl.plan_sparse_matrix(X, device='cpu'),
                 spl.plan_sparse_matrix_dma(X, device='cpu')):
        out = sk.contract_wtx(plan, W).numpy()
        assert np.allclose(out, W.numpy().T @ X.toarray(), rtol=0,
                           atol=ATOL_TWIN)
        assert np.all(out[:, 256:] == 0.0)


def test_twins_chunk_their_gather(monkeypatch):
    """A gather budget below one slice still covers every chunk."""
    X = MATRICES['dense tiles']()
    W = torch.as_tensor(np.random.RandomState(1).rand(X.shape[0], 4))
    want = W.numpy().T @ X.toarray()
    monkeypatch.setattr(sk, 'GATHER_BUDGET', 1)
    for plan in (spl.plan_sparse_matrix(X, device='cpu'),
                 spl.plan_sparse_matrix_dma(X, device='cpu')):
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


def _port_x(X, backend):
    if backend == 'torch':
        return ss.TorchSparseX(ss.to_torch_sparse(X))
    if backend == 'mxu':
        return spl.plan_sparse_matrix(X, np.float64, device='cpu')
    return spl.plan_sparse_matrix_dma(X, np.float64, device='cpu')


@pytest.mark.parametrize('backend', ['torch', 'mxu', 'dma'])
@pytest.mark.parametrize('case', sorted(SWEEP_CASES))
def test_sparse_sweep_matches_jax(case, backend, argsort_plans):
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
    plan = jmxu.plan_sparse_matrix(X, np.float64)
    key = jax.random.PRNGKey(0)
    W, T = jnp.asarray(W0), jnp.asarray(T0)
    for _ in range(3):
        W, T, key, _ = jsweep(plan, W, T, key, jnp.asarray(0), key)
    sweep = ss.make_sparse_sweep(SweepConfig(**kw), backend)
    Xp = _port_x(X, backend)
    Wt, Tt = torch.as_tensor(W0), torch.as_tensor(T0)
    for _ in range(3):
        Wt, Tt = sweep(Xp, Wt, Tt)
    assert np.allclose(Wt.numpy(), np.asarray(W), rtol=0, atol=ATOL_SWEEP)
    assert np.allclose(Tt.numpy(), np.asarray(T), rtol=0, atol=ATOL_SWEEP)


def test_sparse_sweep_rejects_wrong_inputs():
    cfg = SweepConfig(k=3, reset_topic_method=None, update_order='phase')
    with pytest.raises(ValueError):
        ss.make_sparse_sweep(SweepConfig(k=3), 'torch')
    with pytest.raises(ValueError):
        ss.make_sparse_sweep(cfg, 'bogus')
    X = _matrix(40, 30, 0.1, 6)
    sweep = ss.make_sparse_sweep(cfg, 'mxu')
    W, T = torch.rand(40, 3, dtype=torch.float64), torch.rand(
        3, 30, dtype=torch.float64)
    with pytest.raises(TypeError):
        sweep(spl.plan_sparse_matrix_dma(X, device='cpu'), W, T)
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
    pm = spl.plan_sparse_matrix(X, device='cpu')
    pd = spl.plan_sparse_matrix_dma(X, device='cpu')
    Wt = sk._padded(W.T, X.shape[0])
    assert torch.equal(sk.mxu_contract(pm.t_phase, Wt),
                       sk.mxu_contract_ref(pm.t_phase, Wt))
    F3 = sk._tile_cols(W.T, X.shape[0])
    assert torch.equal(sk.dma_contract(pd.t_phase, F3),
                       sk.dma_contract_ref(pd.t_phase, F3))
    assert sk.LAUNCHES == before


def test_non_cuda_devices_raise_and_16_bit_factors_wait_for_A8(
        argsort_plans):
    """Non-CUDA devices raise; 16-bit factors (ROADMAP A.8, ported) meet
    values of their dtype, their exact products summed in float32, as
    JAX's narrow kernels take them (interpret mode): the same float32
    output up to summation order."""
    X = MATRICES['ragged']()
    pm = spl.plan_sparse_matrix(X, device='cpu').to('meta')
    pd = spl.plan_sparse_matrix_dma(X, device='cpu').to('meta')
    F = torch.empty(3, 384, dtype=torch.float64, device='meta')
    with pytest.raises(ValueError, match='CUDA'):
        sk.mxu_contract(pm.t_phase, F)
    with pytest.raises(ValueError, match='CUDA'):
        sk.dma_contract(pd.t_phase, F.reshape(3, 3, 128).permute(1, 0, 2))
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
        got = (sk.contract_wtx(spl.plan_sparse_matrix(X, dt, device='cpu'),
                               W16),
               sk.contract_xtt(spl.plan_sparse_matrix_dma(X, dt,
                                                          device='cpu'),
                               T16))
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
    # ~17 KB a block), and neither do the twins: any k, here 512
    X = MATRICES['ragged']()
    W = torch.as_tensor(np.random.RandomState(9).rand(X.shape[0], 512))
    got = sk.contract_wtx(spl.plan_sparse_matrix_dma(X, device='cpu'), W)
    np.testing.assert_allclose(got.numpy(), (X.T @ W.numpy()).T,
                               atol=ATOL_TWIN)
    sk.LAUNCHES['mxu'] += 2
    sk.reset_launches()
    assert sk.LAUNCHES == {'mxu': 0, 'dma': 0, 'gram': 0}


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
    """The gather kernel through the sweep's products and through B5's
    and B6's interfaces, against the CPU twins (the layout's and the
    plans'); a repeated launch gives the same bits, and so do the two
    plans' launches."""
    X = _matrix(1000, 700, 0.02, 10, dup=True, empty_band=3)
    rng = np.random.RandomState(11)
    W = torch.as_tensor(rng.rand(1000, k), dtype=dtype, device=cuda_device)
    T = torch.as_tensor(rng.rand(k, 700), dtype=dtype, device=cuda_device)

    def close(got, want):
        scale = want.abs().amax(1, keepdim=True).clamp_min(1e-300)
        return float(((got.cpu() - want).abs() / scale).max()) <= tol

    before = dict(sk.LAUNCHES)
    outs = {}
    for kind, plan in (
            ('mxu', spl.plan_sparse_matrix(X, dtype, device=cuda_device)),
            ('dma', spl.plan_sparse_matrix_dma(X, dtype, device=cuda_device))):
        cpu = plan.to('cpu')
        for fn, F in ((sk.contract_wtx, W), (sk.contract_xtt, T)):
            got = fn(plan, F)
            again = fn(plan, F)
            want = fn(cpu, F.cpu())
            torch.cuda.synchronize()
            assert close(got, want) and torch.equal(got, again)
            outs.setdefault(fn.__name__, []).append(got)
        m = X.shape[0]
        if kind == 'mxu':
            direct = sk.mxu_contract(plan.t_phase, sk._padded(W.T, m))
            ref = sk.mxu_contract_ref(cpu.t_phase, sk._padded(W.T.cpu(), m))
        else:
            direct = sk.dma_contract(plan.t_phase, sk._tile_cols(W.T, m))
            ref = sk.dma_contract_ref(cpu.t_phase, sk._tile_cols(W.T.cpu(), m))
        torch.cuda.synchronize()
        assert close(direct, ref)
        assert torch.equal(direct[:, :X.shape[1]], outs['contract_wtx'][-1])
    for got in outs.values():
        assert torch.equal(got[0], got[1])          # the two plans' launches
    assert sk.LAUNCHES['mxu'] == before['mxu'] + 5
    assert sk.LAUNCHES['dma'] == before['dma'] + 5
