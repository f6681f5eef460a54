"""The port's dense phase sweep and its two kernels against the JAX
package.

- The plain twins (``gs_update_ref``, ``tm_proj_update_ref``) against the
  Pallas kernels run in interpret mode on the CPU, as the JAX suite runs
  them (``_gs_call`` / ``_tm_proj_call`` with ``interpret=True``).
- The whole port sweep against ``make_dense_phase_sweep_pallas(cfg,
  interpret=True)`` and against the XLA ``make_sweep(cfg)`` in phase
  order.
- The wrappers' routing: a CPU tensor takes the twin and launches
  nothing; any other non-CUDA tensor raises.
- On a CUDA machine, each kernel against its twin (marked ``cuda``,
  skipped without a card).

float64 on the CPU; ``atol=1e-9`` as in ``tests/test_dense_pallas.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rri_nmf_tpu.ops.dense_pallas import (
    _gs_call, _tm_proj_call, make_dense_phase_sweep_pallas)
from rri_nmf_tpu.ops.sweep_xla import SweepConfig as JaxSweepConfig
from rri_nmf_tpu.ops.sweep_xla import make_sweep
from rri_nmf_tpu_torch.ops import dense_kernels as dk
from rri_nmf_tpu_torch.ops.sweep import SweepConfig

torch.set_num_threads(2)
ATOL = 1e-9
INF = float('inf')


def _problem(n, d, k, seed=0):
    rng = np.random.RandomState(seed)
    X = np.abs(rng.rand(n, k) @ rng.rand(k, d) + 0.01 * rng.rand(n, d))
    W0 = np.abs(rng.rand(n, k))
    T0 = np.abs(rng.rand(k, d))
    return X, W0, T0


def _gs_inputs(k, m, seed, dead=None):
    rng = np.random.RandomState(seed)
    W = rng.rand(3 * k + 7, k)
    if dead is not None:
        W[:, dead] = 0.0
    G = W.T @ W
    N = W.T @ rng.rand(W.shape[0], m)
    F = rng.rand(k, m)
    return G, N, F


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


GS_VARIANTS = {
    'plain': dict(l1=0.0, l2=0.0, bound=INF),
    'regularized': dict(l1=0.05, l2=0.3, bound=INF),
    'negative l1': dict(l1=-0.05, l2=0.0, bound=1.0),
    'reps=3': dict(l1=0.0, l2=0.0, bound=INF, reps=3),
}


@pytest.mark.parametrize('k,m', [(3, 40), (5, 1100), (16, 130)])
@pytest.mark.parametrize('variant', sorted(GS_VARIANTS))
def test_gs_twin_matches_pallas_interpret(k, m, variant):
    kw = GS_VARIANTS[variant]
    G, N, F = _gs_inputs(k, m, seed=k + m)
    want = np.asarray(_gs_call(
        k, m, 1, kw['l1'], kw['l2'], kw['bound'], jnp.float64, jnp.float64,
        jnp.asarray(G), jnp.asarray(np.diag(G).reshape(k, 1)),
        jnp.asarray(N), jnp.asarray(F), interpret=True,
        reps=kw.get('reps', 1)))
    got = dk.gs_update_ref(*_t(G, N, F), **kw).numpy()
    assert np.allclose(got, want, rtol=0, atol=ATOL), np.abs(got - want).max()


@pytest.mark.parametrize('vector_ub', [False, True])
def test_gs_twin_dead_topic_matches_pallas(vector_ub):
    """A dead topic (G[t,t] = 0) takes the concave branch: the bound
    (scalar or per column) wherever -l1 > 0."""
    k, m = 4, 50
    G, N, F = _gs_inputs(k, m, seed=3, dead=2)
    ub = np.random.RandomState(4).rand(m) + 0.5
    want = np.asarray(_gs_call(
        k, m, 1, -0.02, 0.0, 1.0, jnp.float64, jnp.float64,
        jnp.asarray(G), jnp.asarray(np.diag(G).reshape(k, 1)),
        jnp.asarray(N), jnp.asarray(F),
        ub=jnp.asarray(ub.reshape(1, m)) if vector_ub else None,
        interpret=True))
    got = dk.gs_update_ref(*_t(G, N, F), -0.02, 0.0, 1.0,
                           ub=torch.as_tensor(ub) if vector_ub else None)
    assert np.allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert np.array_equal(got[2].numpy(), ub if vector_ub else np.ones(m))


def _tm_inputs(k, d, seed, dead=None):
    rng = np.random.RandomState(seed)
    W = rng.rand(3 * k + 11, k)
    if dead is not None:
        W[:, dead] = 0.0
    G = W.T @ W
    N = W.T @ (rng.rand(W.shape[0], d) ** 6)
    F = rng.rand(k, d)
    return G, N, F / F.sum(1, keepdims=True)


@pytest.mark.parametrize('k,d', [(8, 60), (5, 1100), (5, 37)])
@pytest.mark.parametrize('variant', ['plain', 'dead topic', 'reps=3 l2'])
def test_tm_proj_twin_matches_pallas_interpret(k, d, variant):
    G, N, F = _tm_inputs(k, d, seed=k * d,
                         dead=1 if variant == 'dead topic' else None)
    l2 = 0.4 if variant.endswith('l2') else 0.0
    reps = 3 if variant.startswith('reps') else 1
    want = np.asarray(_tm_proj_call(
        k, d, d, 0.0, l2, 1.0, jnp.float64, jnp.float64,
        jnp.asarray(G), jnp.asarray(np.diag(G).reshape(k, 1)),
        jnp.asarray(N), jnp.asarray(F), interpret=True, reps=reps))
    got = dk.tm_proj_update_ref(*_t(G, N, F), 0.0, l2, 1.0,
                                reps=reps).numpy()
    assert np.allclose(got, want, rtol=0, atol=ATOL), np.abs(got - want).max()
    assert np.allclose(got.sum(1), 1.0, atol=1e-12) and got.min() >= 0


def test_tm_proj_twin_vertex_first_index():
    """Concave branch with tied numerators: all mass on the first index."""
    k, d = 3, 20
    G = np.zeros((k, k))
    N = np.zeros((k, d))
    F = np.full((k, d), 1.0 / d)
    got = dk.tm_proj_update_ref(*_t(G, N, F), 0.0, 0.0, 1.0).numpy()
    want = np.zeros((k, d))
    want[:, 0] = 1.0
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# the whole sweep
# ---------------------------------------------------------------------------

def _run_jax(sweep, X, W, T, iters, extras=()):
    key = jax.random.PRNGKey(0)
    resets = jnp.asarray(0, jnp.int32)
    W, T = jnp.asarray(W), jnp.asarray(T)
    for _ in range(iters):
        W, T, key, resets = sweep(jnp.asarray(X), W, T, key, resets, key,
                                  *extras)
    return np.array(W), np.array(T)


def _run_port(cfg, X, W, T, iters, wrs=None):
    sweep = dk.make_dense_phase_sweep(cfg)
    X, W, T = _t(X, W, T)
    wrs = torch.as_tensor(wrs) if wrs is not None else None
    for _ in range(iters):
        W, T = sweep(X, W, T, wrs)
    return W.numpy(), T.numpy()


SWEEP_CASES = {
    'plain': dict(),
    'negative l1': dict(reg_t_l1=-0.05, reg_w_l2=0.1, t_row_sum=1.0),
    'fix_T project_W': dict(fix_T=True, project_W_each_iter=True,
                            w_row_sum=1.0),
    'inner_reps=3': dict(inner_reps=3),
    'tm preset': dict(project_T_each_iter=True, t_row_sum=1.0,
                      w_row_sum=1.0),
}


@pytest.mark.parametrize('shape', [(40, 30, 3), (300, 1100, 5),
                                   (600, 130, 16)])
@pytest.mark.parametrize('case', sorted(SWEEP_CASES))
def test_sweep_matches_pallas_and_xla(shape, case):
    n, d, k = shape
    X, W0, T0 = _problem(n, d, k)
    kw = dict(k=k, reset_topic_method=None, update_order='phase',
              **SWEEP_CASES[case])
    if kw.get('project_T_each_iter'):
        T0 = T0 / T0.sum(1, keepdims=True)
    iters = 3
    Wx, Tx = _run_jax(make_sweep(JaxSweepConfig(**kw)), X, W0, T0, iters)
    Wp, Tp = _run_jax(make_dense_phase_sweep_pallas(
        JaxSweepConfig(**kw), interpret=True), X, W0, T0, iters)
    Wt, Tt = _run_port(SweepConfig(**kw), X, W0, T0, iters)
    for got, want in ((Wt, Wp), (Tt, Tp), (Wt, Wx), (Tt, Tx)):
        assert np.allclose(got, want, rtol=0, atol=ATOL), \
            np.abs(got - want).max()


def test_sweep_dead_topic_matches_pallas_and_xla():
    n, d, k = 50, 40, 4
    X, W0, T0 = _problem(n, d, k, seed=3)
    W0[:, 2] = 0.0
    T0[2] = 0.0
    kw = dict(k=k, reset_topic_method=None, update_order='phase',
              t_row_sum=1.0, w_row_sum=1.0)
    Wx, Tx = _run_jax(make_sweep(JaxSweepConfig(**kw)), X, W0, T0, 2)
    Wp, Tp = _run_jax(make_dense_phase_sweep_pallas(
        JaxSweepConfig(**kw), interpret=True), X, W0, T0, 2)
    Wt, Tt = _run_port(SweepConfig(**kw), X, W0, T0, 2)
    for got, want in ((Wt, Wp), (Tt, Tp), (Wt, Wx), (Tt, Tx)):
        assert np.allclose(got, want, rtol=0, atol=ATOL)


def test_sweep_vector_w_row_sum_matches_pallas_and_xla():
    n, d, k = 45, 35, 3
    X, W0, T0 = _problem(n, d, k, seed=5)
    wrs = np.abs(np.random.RandomState(6).rand(n)) + 0.5
    kw = dict(k=k, reset_topic_method=None, update_order='phase',
              w_row_sum_is_vector=True, project_W_each_iter=True)
    extras = (jnp.asarray(wrs),)
    Wx, Tx = _run_jax(make_sweep(JaxSweepConfig(**kw)), X, W0, T0, 3,
                      extras)
    Wp, Tp = _run_jax(make_dense_phase_sweep_pallas(
        JaxSweepConfig(**kw), interpret=True), X, W0, T0, 3, extras)
    Wt, Tt = _run_port(SweepConfig(**kw), X, W0, T0, 3, wrs=wrs)
    for got, want in ((Wt, Wp), (Tt, Tp), (Wt, Wx), (Tt, Tx)):
        assert np.allclose(got, want, rtol=0, atol=ATOL)
    assert np.allclose(Wt.sum(1), wrs, atol=1e-12)


def test_sweep_rejects_unsupported_configs():
    for kw in (dict(update_order='interleaved', reset_topic_method=None),
               dict(update_order='phase'),
               dict(update_order='phase', reset_topic_method=None,
                    masked=True)):
        cfg = SweepConfig(k=3, **kw)
        assert not dk.supports_dense_kernels(cfg, 10, torch.float32)
        with pytest.raises(ValueError):
            dk.make_dense_phase_sweep(cfg)


def test_shared_memory_gates():
    assert dk.gs_fits(128, torch.float64)
    assert not dk.gs_fits(1024, torch.float64)
    assert dk.tm_proj_fits(50, 26214, torch.float64)
    assert dk.tm_proj_fits(128, 55000, torch.float32)
    assert not dk.tm_proj_fits(50, 60000, torch.float32)
    cfg = SweepConfig(k=8, reset_topic_method=None, update_order='phase',
                      project_T_each_iter=True, t_row_sum=1.0)
    assert dk.supports_dense_kernels(cfg, 20000, torch.float64)
    assert not dk.supports_dense_kernels(cfg, 40000, torch.float64)


# ---------------------------------------------------------------------------
# wrapper routing and checks
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_twin_and_launch_nothing():
    G, N, F = _t(*_gs_inputs(4, 30, seed=7))
    before = dict(dk.LAUNCHES)
    a = dk.gs_update(G, N, F, 0.0, 0.0, INF)
    b = dk.gs_update_ref(G, N, F, 0.0, 0.0, INF)
    assert torch.equal(a, b)
    G, N, F = _t(*_tm_inputs(4, 30, seed=8))
    a = dk.tm_proj_update(G, N, F, 0.0, 0.0, 1.0)
    assert torch.equal(a, dk.tm_proj_update_ref(G, N, F, 0.0, 0.0, 1.0))
    assert dk.LAUNCHES == before


def test_non_cuda_devices_raise_instead_of_falling_back():
    """Only a CPU tensor may take the twin: any other device must reach
    the kernel's checks and be refused there."""
    G, N, F = (a.to('meta') for a in _t(*_gs_inputs(3, 8, seed=9)))
    with pytest.raises(ValueError, match='CUDA'):
        dk.gs_update(G, N, F, 0.0, 0.0, INF)
    with pytest.raises(ValueError, match='CUDA'):
        dk.tm_proj_update(G, N, F, 0.0, 0.0, 1.0)


def test_launch_counter_reset():
    dk.LAUNCHES['gs'] += 3
    dk.reset_launches()
    assert dk.LAUNCHES == {'gs': 0, 'tm_proj': 0}


def test_build_library_path_tracks_sources(tmp_path, monkeypatch):
    from rri_nmf_tpu_torch.ops import _build
    assert [p.name for p in _build.sources()] == ['gs.cu', 'masked.cu',
                                                  'sparse.cu', 'tm_proj.cu']
    p1 = _build.library_path()
    monkeypatch.setattr(_build, 'NVCC_FLAGS', _build.NVCC_FLAGS + ['-G'])
    assert _build.library_path() != p1
    assert p1.parent == _build.BUILD_DIR


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
def test_cuda_kernels_match_twins(cuda_device, dtype, tol):
    def on(*arrays):
        return [torch.as_tensor(a, dtype=dtype, device=cuda_device)
                for a in arrays]
    before = dict(dk.LAUNCHES)
    G, N, F = on(*_gs_inputs(16, 1000, seed=10, dead=3))
    ub = on(np.random.RandomState(11).rand(1000) + 0.5)[0]
    for kw in (dict(l1=0.0, l2=0.0, bound=INF),
               dict(l1=-0.05, l2=0.1, bound=1.0, ub=ub),
               dict(l1=0.0, l2=0.0, bound=1.0, reps=3)):
        a = dk.gs_update(G, N, F, **kw)
        b = dk.gs_update_ref(G, N, F, **kw)
        assert float((a - b).abs().max() / b.abs().max()) <= tol
    G, N, F = on(*_tm_inputs(8, 3000, seed=12, dead=2))
    a = dk.tm_proj_update(G, N, F, 0.0, 0.0, 1.0, reps=2)
    b = dk.tm_proj_update_ref(G, N, F, 0.0, 0.0, 1.0, reps=2)
    torch.cuda.synchronize()
    assert float((a - b).abs().max() / b.abs().max()) <= tol
    assert dk.LAUNCHES['gs'] == before['gs'] + 3
    assert dk.LAUNCHES['tm_proj'] == before['tm_proj'] + 1
