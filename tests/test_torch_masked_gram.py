"""The port's Gram-phase sweep of the sparse-mask path
(``ops/sweep_masked_gram.py``) against the JAX package, on the CPU in
float64.

- The plan: the COO arrays and ``Σ m x²`` equal JAX's bit for bit; the
  port's output-column layouts, built from the COO, hold the entries of
  the layouts unpacked from JAX's B5 plans of the mask
  (``tests/tile_plan_oracle.py``), M⊙X included.
- ``make_masked_gram_sweep`` against JAX's at 1e-9, both backends
  (JAX's ``'mxu'`` in interpret mode, the port's through the gather and
  Gram kernels' plain twins): the oracle configurations of
  ``tests/test_masked_gram.py``, random ones, a vector ``w_row_sum`` and
  DP noise (JAX's draws injected); the panel form against the full form
  at 1e-13; the objective; ``auto_panel``.
- ``nmf()`` routing as JAX's: phase order to the Gram sweep (the
  ``sparse='mxu'`` hint included), the fallback warning, ``inner_reps``
  with grouped dispatch, k-panels past the budget, the objective's pickle.
- On a card (marked ``cuda``): the gather kernel with the M⊙X values (A,
  C) and the Gram kernel (the k(k+1)/2 and p·k Khatri-Rao rows, Γ/Θ)
  against their twins, and the Gram kernel against the gather kernel on
  the materialized rows.
"""

import pickle
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rri_nmf_tpu.ops.sweep_masked_gram as jmg
from rri_nmf_tpu.nmf import nmf as jax_nmf
from rri_nmf_tpu.ops.sweep_xla import SweepConfig as JaxSweepConfig
from rri_nmf_tpu_torch import nmf as tnmf
from rri_nmf_tpu_torch.ops import sparse_kernels as sk
from rri_nmf_tpu_torch.ops import sparse_plan as spl
from rri_nmf_tpu_torch.ops import sweep_masked_gram as mg
from rri_nmf_tpu_torch.ops.sweep import SweepConfig
from test_torch_gram_layout import entries
from test_torch_sweep import jax_draws
from tile_plan_oracle import unpack

torch.set_num_threads(2)
ATOL_SWEEP = 1e-9
TOL = 1e-8


def _problem(seed, n=30, d=24, k=4, density=0.35):
    rng = np.random.RandomState(seed)
    M = (rng.rand(n, d) < density).astype(float)
    X = rng.rand(n, d) * M
    W0 = np.abs(rng.rand(n, k))
    T0 = np.abs(rng.rand(k, d))
    return X, M, W0, T0


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(a, b, tol=TOL):
    return np.allclose(_np(a), _np(b), rtol=0, atol=tol)


def _cfg(k, **kw):
    return dict(dict(k=k, masked=True, masked_sparse=True,
                     update_order='phase', reset_topic_method=None), **kw)


def _run_jax(X, M, W0, T0, sweeps, backend='segsum', panel=None, extras=(),
             **kw):
    plan = jmg.plan_masked_gram(X, sp.csr_matrix(M), np.float64,
                                backend=backend)
    sweep = jmg.make_masked_gram_sweep(JaxSweepConfig(**_cfg(W0.shape[1],
                                                             **kw)),
                                       backend=backend, panel=panel)
    draws = jax_draws(3)
    key, r = draws.key, jnp.asarray(0, jnp.int32)
    W, T = jnp.asarray(W0), jnp.asarray(T0)
    out = []
    for _ in range(sweeps):
        W, T, key, r = sweep(plan, W, T, key, r, draws.reset_key,
                             *[jnp.asarray(e) for e in extras])
        out.append((np.array(W), np.array(T)))
    return out


def _run_port(X, M, W0, T0, sweeps, backend='segsum', panel=None, extras=(),
              **kw):
    plan = mg.plan_masked_gram(X, sp.csr_matrix(M), torch.float64,
                               backend=backend, device='cpu')
    sweep = mg.make_masked_gram_sweep(SweepConfig(**_cfg(W0.shape[1], **kw)),
                                      backend=backend, panel=panel)
    draws = jax_draws(3)
    W, T = torch.as_tensor(W0), torch.as_tensor(T0)
    out = []
    for _ in range(sweeps):
        W, T, left = sweep(plan, W, T, draws, 0,
                           *[torch.as_tensor(e) for e in extras])
        assert left == 0
        out.append((W.numpy(), T.numpy()))
    return out


def _same(want, got, tol=ATOL_SWEEP):
    assert len(want) == len(got)
    for (Wj, Tj), (Wp, Tp) in zip(want, got):
        assert np.allclose(Wp, Wj, rtol=0, atol=tol), np.abs(Wp - Wj).max()
        assert np.allclose(Tp, Tj, rtol=0, atol=tol), np.abs(Tp - Tj).max()


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('group', [1, 8])
def test_plan_equals_jax(group):
    """Observed zeros included (x = 0 where m = 1): the COO and ``Σ m x²``
    bit for bit JAX's; each direction's layout, built from the COO, holds
    the entries of the layout derived from JAX's B5 plan of the mask (the
    route it replaces), M⊙X carried over from JAX's second value set,
    with equal column offsets and rows ascending inside each column."""
    X, M, _, _ = _problem(11, n=300, d=200, density=0.3)
    X[M != 0] *= (np.random.RandomState(1).rand(int(M.sum())) > 0.2)
    want = jmg.plan_masked_gram(X, sp.csr_matrix(M), np.float64,
                                backend='mxu', group=group)
    got = mg.plan_masked_gram(X, sp.csr_matrix(M), torch.float64,
                              backend='mxu', device='cpu')
    assert got.backend == 'mxu' and got.shape == want.shape
    assert got.nnz == want.nnz == int(M.sum())
    for f in ('rows', 'cols', 'x_vals', 'm_vals'):
        assert np.array_equal(_np(getattr(got.coo, f)),
                              np.array(getattr(want.coo, f))), f
    assert float(got.sum_mx2) == float(want.sum_mx2)
    for side, jp, jmx, lay in (
            ('t', want.m_t, want.mx_t_vals, got.m_t),
            ('w', want.m_w, want.mx_w_vals, got.m_w)):
        assert len(jp) == len(jmx) == 1
        colptr, gidx, m, mx = unpack(jp[0], jmx[0])
        jlay = spl.ColumnLayout(torch.as_tensor(colptr.astype(np.int32)),
                                torch.as_tensor(gidx), torch.as_tensor(m),
                                int(gidx.max()) + 1)
        jv = torch.as_tensor(mx)
        assert torch.equal(lay.colptr, jlay.colptr), side
        assert lay.n_rows == jlay.n_rows, side
        v = got.mx_layout_values(side)
        ours, theirs = entries(lay, v), entries(jlay, jv)
        for a, b in zip(ours, theirs):
            assert np.array_equal(a, b), side
        assert np.array_equal(ours[1], lay.gidx.long().numpy()), side
        # every observation is a nonzero of the layout, zero ratings too
        assert lay.gidx.shape[0] == got.nnz
        assert v.shape == lay.vals.shape and int((v == 0).sum()) > 0


def test_layout_values_contract_to_the_dense_products():
    """The gather twin with the M⊙X values gives Wᵀ(M⊙X) and (M⊙X)Tᵀ;
    with the mask's own values WᵀM and M Tᵀ."""
    X, M, W, T = _problem(12, n=260, d=140, density=0.2)
    plan = mg.plan_masked_gram(X, sp.csr_matrix(M), torch.float64,
                               backend='mxu', device='cpu')
    Wt, Tt = torch.as_tensor(W), torch.as_tensor(T)
    A = sk.gather_contract(plan.m_t, Wt, 4, 140,
                           plan.mx_layout_values('t'))
    C = sk.gather_contract(plan.m_w, Tt.T, 4, 260,
                           plan.mx_layout_values('w'))
    assert np.allclose(A.numpy(), W.T @ (M * X), rtol=0, atol=1e-12)
    assert np.allclose(C.numpy(), T @ (M * X).T, rtol=0, atol=1e-12)
    G = sk.gather_contract(plan.m_t, Wt, 4, 140)
    assert np.allclose(G.numpy(), W.T @ M, rtol=0, atol=1e-12)


def test_segsum_plan_and_backend_choice():
    X, M, _, _ = _problem(13, n=21, d=13)
    plan = mg.plan_masked_gram(X, sp.csr_matrix(M), torch.float64,
                               device='cpu')
    assert plan.backend == 'segsum' and plan.m_t is None
    assert float(plan.sum_mx2) == pytest.approx(np.sum(M * X ** 2),
                                                rel=1e-14)
    M2, _ = plan.to_scipy()
    assert np.array_equal(M2.toarray(), M)
    with pytest.raises(ValueError, match='backend'):
        mg.plan_masked_gram(X, sp.csr_matrix(M), torch.float64,
                            backend='dma', device='cpu')


# ---------------------------------------------------------------------------
# the sweep against JAX's
# ---------------------------------------------------------------------------

ORACLE_CONFIGS = {
    'plain': dict(),
    'projected T': dict(project_T_each_iter=True, t_row_sum=1.0),
    'l2': dict(reg_t_l2=0.1, reg_w_l2=0.05),
    'l1': dict(reg_t_l1=0.02, reg_w_l1=0.01),
    'projected both': dict(project_T_each_iter=True, t_row_sum=1.0,
                           w_row_sum=1.0, project_W_each_iter=True),
    'w_row_sum': dict(w_row_sum=2.0),
    'inner_reps 3': dict(inner_reps=3, project_T_each_iter=True,
                         t_row_sum=1.0),
    'fix_T': dict(fix_T=True),
    'fix_W': dict(fix_W=True, project_T_each_iter=True, t_row_sum=1.0),
}


@pytest.mark.parametrize('backend', ['segsum', 'mxu'])
@pytest.mark.parametrize('case', sorted(ORACLE_CONFIGS))
def test_gram_sweep_matches_jax(case, backend):
    X, M, W0, T0 = _problem(0)
    kw = ORACLE_CONFIGS[case]
    _same(_run_jax(X, M, W0, T0, 3, backend, **kw),
          _run_port(X, M, W0, T0, 3, backend, **kw))


@pytest.mark.parametrize('seed', range(4))
def test_gram_sweep_randomized(seed):
    rng = np.random.RandomState(200 + seed)
    n, d, k = (int(rng.randint(15, 45)), int(rng.randint(12, 40)),
               int(rng.randint(2, 6)))
    X, M, W0, T0 = _problem(300 + seed, n=n, d=d, k=k,
                            density=float(rng.uniform(0.2, 0.6)))
    kw = {}
    if rng.rand() < 0.6:
        kw['project_T_each_iter'] = True
        kw['t_row_sum'] = float(rng.choice([1.0, 2.0]))
    if rng.rand() < 0.4:
        kw['w_row_sum'] = float(rng.choice([1.0, 3.0]))
        kw['project_W_each_iter'] = bool(rng.rand() < 0.5)
    for r in ('reg_w_l1', 'reg_w_l2', 'reg_t_l1', 'reg_t_l2'):
        if rng.rand() < 0.4:
            kw[r] = float(rng.choice([0.01, 0.1]))
    kw['inner_reps'] = int(rng.choice([1, 1, 2]))
    backend = ('segsum', 'mxu')[seed % 2]
    _same(_run_jax(X, M, W0, T0, 2, backend, **kw),
          _run_port(X, M, W0, T0, 2, backend, **kw))


@pytest.mark.parametrize('case', ['vector w_row_sum', 'dp noise'])
def test_gram_sweep_vector_bound_and_dp_noise(case):
    X, M, W0, T0 = _problem(5)
    if case == 'vector w_row_sum':
        wrs = 0.5 + np.random.RandomState(5).rand(X.shape[0])
        kw = dict(w_row_sum_is_vector=True, project_W_each_iter=True,
                  extras=(wrs,))
    else:
        kw = dict(dp_sigma=0.05, project_T_each_iter=True, t_row_sum=1.0)
    _same(_run_jax(X, M, W0, T0, 2, **kw), _run_port(X, M, W0, T0, 2, **kw))


def test_mxu_backend_matches_segsum():
    X, M, W0, T0 = _problem(7, n=40, d=33, k=5)
    kw = dict(project_T_each_iter=True, t_row_sum=1.0, w_row_sum=1.0,
              project_W_each_iter=True)
    _same(_run_port(X, M, W0, T0, 2, 'segsum', **kw),
          _run_port(X, M, W0, T0, 2, 'mxu', **kw), tol=1e-12)
    before = dict(sk.LAUNCHES)
    _run_port(X, M, W0, T0, 1, 'mxu')
    assert sk.LAUNCHES == before         # the twin on the CPU launches none


@pytest.mark.parametrize('panel', [1, 2, 3])
@pytest.mark.parametrize('case', ['plain', 'projected both', 'l1 l2',
                                  'inner_reps 2', 'fix_T'])
def test_panel_sweep_equals_full(panel, case):
    """Panels run the same Gauss-Seidel sequence (k=4, p=3 is ragged)."""
    kw = {'plain': dict(), 'projected both': ORACLE_CONFIGS['projected both'],
          'l1 l2': dict(reg_t_l1=0.02, reg_w_l2=0.05),
          'inner_reps 2': dict(inner_reps=2), 'fix_T': dict(fix_T=True)}[case]
    X, M, W0, T0 = _problem(21, k=4)
    _same(_run_port(X, M, W0, T0, 3, **kw),
          _run_port(X, M, W0, T0, 3, panel=panel, **kw), tol=1e-13)


def test_panel_sweep_mxu_matches_jax():
    X, M, W0, T0 = _problem(22, n=40, d=33, k=5)
    _same(_run_jax(X, M, W0, T0, 2, 'mxu', panel=2),
          _run_port(X, M, W0, T0, 2, 'mxu', panel=2))


@pytest.mark.parametrize('backend', ['segsum', 'mxu'])
def test_objective_matches_jax(backend):
    X, M, W0, T0 = _problem(9)
    regs = dict(reg_w_l2=0.02, reg_t_l2=0.01, reg_w_l1=0.005,
                reg_t_l1=0.003)
    direct = 0.5 * np.sum(M * (X - W0 @ T0) ** 2) \
        + 0.5 * 0.02 * np.sum(W0 ** 2) + 0.5 * 0.01 * np.sum(T0 ** 2) \
        + 0.005 * np.sum(W0) + 0.003 * np.sum(T0)
    jp = jmg.plan_masked_gram(X, sp.csr_matrix(M), np.float64,
                              backend=backend)
    want = float(jmg.make_masked_gram_objective(backend=backend, **regs)(
        jp, jnp.asarray(W0), jnp.asarray(T0)))
    plan = mg.plan_masked_gram(X, sp.csr_matrix(M), torch.float64,
                               backend=backend, device='cpu')
    W, T = torch.as_tensor(W0), torch.as_tensor(T0)
    got = float(mg.make_masked_gram_objective(backend, **regs)(plan, W, T))
    tiled = float(mg.make_masked_gram_objective(backend, panel=2, **regs)(
        plan, W, T))
    assert got == pytest.approx(want, rel=1e-12)
    assert got == pytest.approx(direct, rel=1e-10)
    assert tiled == pytest.approx(got, rel=1e-13)


def test_auto_panel_policy_as_jax_off_tpu():
    for args in ((8, 100, 80, 8), (128, 100_000, 50_000, 4),
                 (64, 10_000, 5_000, 4), (32, 100_000, 50_000, 4),
                 (10_000_000, 1_000_000, 1_000_000, 8)):
        assert mg.auto_panel(*args) == jmg.auto_panel(*args, mxu=False)
    assert mg.auto_panel(32, 100_000, 50_000, 4) is None
    p = mg.auto_panel(128, 100_000, 50_000, 4)
    assert 1 <= p < 128 and p * 128 * 150_000 * 4 <= 4e9
    assert mg.auto_panel(10_000_000, 1_000_000, 1_000_000, 8) == 0


def test_sweep_guards():
    with pytest.raises(ValueError, match='not supported'):
        mg.make_masked_gram_sweep(SweepConfig(**_cfg(
            4, reset_topic_method='random')))
    with pytest.raises(ValueError, match='panel'):
        mg.make_masked_gram_sweep(SweepConfig(**_cfg(4)), panel=4)
    X, M, W0, T0 = _problem(3)
    plan = mg.plan_masked_gram(X, sp.csr_matrix(M), torch.float64,
                               device='cpu')
    with pytest.raises(ValueError, match="'segsum' plan"):
        mg.make_masked_gram_sweep(SweepConfig(**_cfg(4)), 'mxu')(
            plan, torch.as_tensor(W0), torch.as_tensor(T0), None, 0)


# ---------------------------------------------------------------------------
# nmf() routing against JAX's
# ---------------------------------------------------------------------------

def _driver_kw(**extra):
    kw = dict(max_iter=10, compute_obj_each_iter=True, random_state=0,
              reset_topic_method=None, reg_t_l1=0.01, reg_w_l1=0.01)
    kw.update(extra)
    return kw


def _same_fit(X, M, k, jax_kw=None, **kw):
    a = jax_nmf(X, k, W_mat=sp.csr_matrix(M), **dict(kw, **(jax_kw or {})))
    b = tnmf.nmf(X, k, W_mat=sp.csr_matrix(M), device='cpu', **kw)
    assert _close(b['W'], a['W']), np.abs(_np(b['W']) - a['W']).max()
    assert _close(b['T'], a['T']), np.abs(_np(b['T']) - a['T']).max()
    if 'obj_history' in a:
        assert np.allclose(b['obj_history'], a['obj_history'], rtol=TOL,
                           atol=0)
    return a, b


@pytest.mark.parametrize('hint', [None, 'mxu'])
def test_nmf_phase_routes_to_gram_as_jax(hint):
    X, M, _, _ = _problem(1)
    kw = _driver_kw(max_iter=12, update_order='phase')
    if hint:
        kw['sparse'] = hint
    a, b = _same_fit(X, M, 4, **kw)
    og = np.asarray(b['obj_history'])
    assert np.all(np.diff(og) <= 1e-12)
    oc = b['obj_calculator']
    assert isinstance(oc.X, mg.MaskedGramPlan)
    assert oc.X.backend == ('mxu' if hint else 'segsum')
    assert abs(oc.true_objective() - og[-1]) < 1e-10
    oc2 = pickle.loads(pickle.dumps(oc))
    assert abs(oc2.true_objective() - og[-1]) < 1e-10


def test_nmf_gram_projected_and_dp_noise(monkeypatch):
    monkeypatch.setattr(tnmf, 'make_draws', jax_draws)
    X, M, _, _ = _problem(6)
    _same_fit(X, M, 4, max_iter=8, compute_obj_each_iter=True,
              random_state=0, reset_topic_method=None, w_row_sum=1.0,
              t_row_sum=1.0, project_T_each_iter=True, update_order='phase')
    _same_fit(X, M, 4, **_driver_kw(eps_gauss_t=1e4, delta_gauss_t=0.1,
                                    max_iter=4, update_order='phase'))


def test_nmf_gram_inner_reps_grouped_equals_stepped():
    X, M, _, _ = _problem(2)
    Ms = sp.csr_matrix(M)
    kw = _driver_kw(inner_reps=2, update_order='phase', device='cpu')
    r1 = tnmf.nmf(X, 4, W_mat=Ms, **kw)
    r2 = tnmf.nmf(X, 4, W_mat=Ms, sweeps_per_dispatch=5, **kw)
    assert torch.equal(r1['W'], r2['W']) and torch.equal(r1['T'], r2['T'])
    assert np.all(np.diff(r1['obj_history']) <= 1e-12)
    a = jax_nmf(X, 4, W_mat=Ms, **_driver_kw(inner_reps=2,
                                             update_order='phase'))
    assert _close(r1['W'], a['W']) and _close(r1['T'], a['T'])


def test_nmf_fallback_to_interleaved_warns():
    """Phase order with resets cannot take the Gram sweep: a
    RuntimeWarning, then the interleaved sweep, bit for bit."""
    X, M, _, _ = _problem(3)
    Ms = sp.csr_matrix(M)
    kw = _driver_kw(reset_topic_method='random', n_resets=2, device='cpu')
    with pytest.warns(RuntimeWarning, match='falling back to the '
                      'interleaved'):
        rp = tnmf.nmf(X, 4, W_mat=Ms, update_order='phase', **kw)
    ri = tnmf.nmf(X, 4, W_mat=Ms, update_order='interleaved', **kw)
    assert torch.equal(rp['W'], ri['W']) and torch.equal(rp['T'], ri['T'])
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        tnmf.nmf(X, 4, W_mat=Ms, **_driver_kw(max_iter=2, device='cpu'))


def test_nmf_large_k_takes_panels_as_jax(monkeypatch):
    X, M, _, _ = _problem(24, n=40, d=30, k=4)
    kw = _driver_kw(max_iter=6, update_order='phase')
    full = tnmf.nmf(X, 4, W_mat=sp.csr_matrix(M), device='cpu', **kw)
    unit = 4 * (40 + 30) * 8
    monkeypatch.setattr(jmg, 'GRAM_BUDGET_BYTES', 2 * unit)
    monkeypatch.setattr(mg, 'GRAM_BUDGET_BYTES', 2 * unit)
    assert mg.auto_panel(4, 40, 30, 8) == 2
    a, tiled = _same_fit(X, M, 4, **kw)
    assert _close(tiled['W'], full['W'], 1e-13)
    assert _close(tiled['T'], full['T'], 1e-13)
    assert np.all(np.diff(tiled['obj_history']) <= 1e-12)


def test_nmf_gram_on_a_sparse_X_and_a_torch_mask():
    X, M, _, _ = _problem(8)
    kw = _driver_kw(max_iter=5, update_order='phase')
    a = jax_nmf(sp.csr_matrix(X), 4, W_mat=sp.csr_matrix(M), **kw)
    b = tnmf.nmf(torch.as_tensor(X).to_sparse_csr(), 4,
                 W_mat=torch.as_tensor(M).to_sparse(), device='cpu', **kw)
    assert _close(b['W'], a['W']) and _close(b['T'], a['T'])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
def test_cuda_gram_contractions_match_twins(cuda_device, dtype, tol):
    """A, C (M⊙X values) through the gather kernel, Γ/Θ (k(k+1)/2 rows)
    and p·k panels through the Gram kernel, against the twins and (Γ/Θ)
    the gather kernel on the materialized Khatri-Rao rows; repeats give
    the same bits; one launch each, counted under ``'gather'`` and
    ``'gram'``."""
    X, M, W0, T0 = _problem(30, n=700, d=500, k=12, density=0.05)
    plan = mg.plan_masked_gram(X, sp.csr_matrix(M), dtype, backend='mxu',
                               device=cuda_device)
    cpu = mg.plan_masked_gram(X, sp.csr_matrix(M), dtype, backend='mxu',
                              device='cpu')
    W = torch.as_tensor(W0, dtype=dtype)
    T = torch.as_tensor(T0, dtype=dtype)
    before = dict(sk.LAUNCHES)
    for fn, args in ((mg._mxu_gram_t, ()), (mg._mxu_gram_w, ()),
                     (mg._mxu_gram_t_panel, (0, 5)),
                     (mg._mxu_gram_w_panel, (5, 7))):
        F = W if fn in (mg._mxu_gram_t, mg._mxu_gram_t_panel) else T
        got = fn(plan, F.to(cuda_device), *args, dtype)
        again = fn(plan, F.to(cuda_device), *args, dtype)
        want = fn(cpu, F, *args, dtype)
        torch.cuda.synchronize()
        for g, a, w in zip(*(x if isinstance(x, tuple) else (x,)
                             for x in (got, again, want))):
            assert torch.equal(g, a)
            scale = w.abs().max().clamp_min(1e-300)
            assert float((g.cpu() - w).abs().max() / scale) <= tol
    assert sk.LAUNCHES['gather'] - before['gather'] == 2 * (1 + 1)
    assert sk.LAUNCHES['gram'] - before['gram'] == 2 * (1 + 1 + 1 + 1)
    # the Gram kernel against the gather kernel on the materialized rows
    k = W.shape[1]
    for side, F, ncols in (('t', W, X.shape[1]), ('w', T.T, X.shape[0])):
        pl = plan.m_t if side == 't' else plan.m_w
        F = F.to(cuda_device)
        for panel in (None, (0, 5), (5, 7)):
            a, b = (x.to(cuda_device) for x in sk.gram_pairs(k, panel))
            want = sk.gather_contract(pl, F[:, a] * F[:, b], a.shape[0],
                                      ncols)
            got = sk.gram_contract(pl, F, k, panel, ncols)
            scale = want.abs().max().clamp_min(1e-300)
            assert float((got - want).abs().max() / scale) <= tol
