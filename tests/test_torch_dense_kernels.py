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
        assert not dk.supports_dense_kernels(cfg, 10, torch.float32, 'cpu')
        with pytest.raises(ValueError):
            dk.make_dense_phase_sweep(cfg)


def test_shared_memory_gates(monkeypatch):
    """The gates are the launchers' own (csrc/gs.cu ``rri_gs_fits``,
    csrc/tm_proj.cu ``rri_tm_proj_fits``): on the CPU the twins run and
    have no limit; a CUDA device asks the library with the device's index
    and raises on a CUDA error."""
    from rri_nmf_tpu_torch.ops import _build
    cpu = torch.device('cpu')
    for dtype in (torch.float32, torch.float64):
        assert dk.gs_fits(4096, dtype, cpu)
        assert dk.tm_proj_fits(40000, 2 ** 24 + 1, dtype, cpu)
    cfg = SweepConfig(k=8, reset_topic_method=None, update_order='phase',
                      project_T_each_iter=True, t_row_sum=1.0)
    assert dk.supports_dense_kernels(cfg, 2 ** 24 + 1, torch.float64, cpu)

    calls = []

    class Library:
        def rri_gs_fits_f32(self, k, index):
            calls.append(('gs', k, index))
            return int(k <= 1200)

        def rri_gs_fits_f64(self, k, index):
            calls.append(('gs', k, index))
            return -3 if k == 7 else int(k <= 600)   # k=7: a CUDA error

        def rri_gs_fits_bf16(self, k, index):
            calls.append(('gs16', k, index))
            return int(k <= 1200)

        def rri_tm_proj_fits_f64(self, k, d, index):
            calls.append(('tm_proj', k, d, index))
            return int(d <= 2 ** 24)

    monkeypatch.setattr(_build, 'load', Library)
    card = torch.device('cuda', 1)
    assert dk.gs_fits(128, torch.float32, card)
    assert not dk.gs_fits(4096, torch.float32, card)
    assert dk.tm_proj_fits(50, 26214, torch.float64, card)
    assert not dk.tm_proj_fits(50, 2 ** 24 + 1, torch.float64, card)
    assert dk.supports_dense_kernels(cfg, 20000, torch.float64, card)
    assert not dk.supports_dense_kernels(cfg, 2 ** 24 + 1, torch.float64,
                                         card)
    assert calls == [('gs', 128, 1), ('gs', 4096, 1),
                     ('tm_proj', 50, 26214, 1),
                     ('tm_proj', 50, 2 ** 24 + 1, 1),
                     ('gs', 8, 1), ('tm_proj', 8, 20000, 1),
                     ('gs', 8, 1), ('tm_proj', 8, 2 ** 24 + 1, 1)]
    with pytest.raises(RuntimeError, match='CUDA error 3'):
        dk.gs_fits(7, torch.float64, card)
    # 16-bit factors ask their own launcher (its strip is worked in
    # float32: the float32 layout)
    calls.clear()
    assert dk.gs_fits(128, torch.bfloat16, card)
    assert not dk.gs_fits(4096, torch.bfloat16, card)
    assert calls == [('gs16', 128, 1), ('gs16', 4096, 1)]
    assert not dk.gs_fits(128, torch.int16, card)


# ---------------------------------------------------------------------------
# the kernels' decompositions, mirrored in plain PyTorch
# ---------------------------------------------------------------------------

EPS = float(np.spacing(10))


def _gs_blocked(G, N, F, l1, l2, bound, ub=None, reps=1, b=16):
    """B1's order (csrc/gs.cu): topics in blocks of ``b``. Each block
    first takes every topic's correction G[t, :] F against the factor at
    the block's start, then runs the chain inside the block, folding each
    finished topic's change D into the corrections of the topics after
    it."""
    F = F.clone()
    k = F.shape[0]
    ubv = ub if ub is not None else torch.tensor(bound, dtype=F.dtype)
    for _ in range(reps):
        for t0 in range(0, k, b):
            bb = min(b, k - t0)
            F0 = F[t0:t0 + bb].clone()
            C = G[t0:t0 + bb] @ F
            D = []
            for i in range(bb):
                t = t0 + i
                corr = C[i]
                for j in range(i):
                    corr = corr + G[t, t0 + j] * D[j]
                numer = N[t] - corr + G[t, t] * F0[i] - l1
                denom = G[t, t] + l2
                pos = numer.clamp_min(0.0) / (denom + EPS)
                neg = torch.where(denom - numer < 0, ubv, 0.0)
                v = torch.where(denom > 0, pos, neg)
                D.append(v - F0[i])
                F[t] = v
    return F


def _tm_proj_sliced(G, N, F, l1, l2, s, reps=1, nblk=7):
    """B2's split (csrc/tm_proj.cu): the columns in ``nblk`` contiguous
    slices; every row-wide reduction is the slices' partials, (sum,
    min), (sum, count, shifted sum) or (max, first index), combined in
    slice order; the drift check reads the last Michelot round's shifted
    sum when the threshold did not move in it."""
    F = F.clone()
    k, d = F.shape
    cols = -(-d // nblk)
    parts = [slice(j, min(j + cols, d)) for j in range(0, d, cols)]

    def total(values):
        acc = values[0]
        for v in values[1:]:
            acc = acc + v
        return acc

    def project(v, sv):
        tau = (sv - s) / d
        tau_prev, shifted, m_prev, changed, it = tau, None, d + 1, True, 0
        while changed and it < d + 2:
            act = [v[p] > tau for p in parts]
            a = total([torch.where(m, v[p], 0.0).sum()
                       for m, p in zip(act, parts)])
            m = int(total([int(m.sum()) for m in act]))
            c = total([torch.where(m, v[p] - tau, 0.0).sum()
                       for m, p in zip(act, parts)])
            tau_prev, shifted = tau, c
            tau = (a - s) / max(m, 1)
            changed, m_prev, it = m != m_prev, m, it + 1
        x = torch.where(v > tau, v - tau, 0.0)
        if bool(tau == tau_prev):
            return x, shifted
        return x, total([x[p].sum() for p in parts])

    for _ in range(reps):
        for t in range(k):
            gtt = G[t, t]
            numer = N[t] - G[t] @ F + gtt * F[t] - l1
            denom = gtt + l2
            if bool(denom > 0):
                v = numer.clamp_min(0.0) / (denom + EPS)
                sv = total([v[p].sum() for p in parts])
                mn = min(float(v[p].min()) for p in parts)
                row, rs = v, sv
                if not (bool(sv == s) and mn >= 0):
                    row, rs = project(v, sv)
                if bool((rs - s).abs() > 1e-15):
                    row, _ = project(row, rs)
            else:
                best, idx = None, None
                for p in parts:
                    val = numer[p].max()
                    j = p.start + int(torch.nonzero(numer[p] == val)[0, 0])
                    if best is None or bool(val > best):
                        best, idx = val, j
                row = torch.zeros_like(F[t])
                row[idx] = s
            F[t] = row
    return F


def _gs_pallas(G, N, F, l1, l2, bound, ub=None, reps=1):
    k, m = F.shape
    return np.asarray(_gs_call(
        k, m, 1, l1, l2, bound, jnp.float64, jnp.float64, jnp.asarray(G),
        jnp.asarray(np.diag(G).reshape(k, 1)), jnp.asarray(N),
        jnp.asarray(F), ub=None if ub is None else jnp.asarray(
            ub.reshape(1, m)), interpret=True, reps=reps))


GS_MIRROR_VARIANTS = {
    'plain': dict(l1=0.0, l2=0.0, bound=INF),
    'negative l1, dead topic': dict(l1=-0.05, l2=0.0, bound=1.0, dead=1),
    'vector ub, dead topic': dict(l1=-0.02, l2=0.1, bound=1.0, dead=3,
                                  ub=True),
    'reps=2': dict(l1=0.01, l2=0.2, bound=INF, reps=2),
}


@pytest.mark.parametrize('k,m,b', [(5, 41, 2), (20, 130, 16), (16, 99, 16),
                                   (7, 33, 16)])
@pytest.mark.parametrize('variant', sorted(GS_MIRROR_VARIANTS))
def test_gs_topic_blocked_order_matches_twin_and_pallas(k, m, b, variant):
    """B1's topic-blocked order is the Gauss-Seidel loop: against the
    serial twin and the Pallas kernel (interpret mode), float64, 1e-12;
    k not a multiple of the block, ragged m."""
    kw = dict(GS_MIRROR_VARIANTS[variant])
    G, N, F = _gs_inputs(k, m, seed=k * m + b,
                         dead=kw.pop('dead', None) if k > 3 else None)
    ub = np.random.RandomState(m).rand(m) + 0.5 if kw.pop('ub', False) \
        else None
    got = _gs_blocked(*_t(G, N, F), b=b, ub=None if ub is None
                      else torch.as_tensor(ub), **kw).numpy()
    twin = dk.gs_update_ref(*_t(G, N, F), ub=None if ub is None
                            else torch.as_tensor(ub), **kw).numpy()
    want = _gs_pallas(G, N, F, ub=ub, **kw)
    assert np.isfinite(got).all()
    assert np.allclose(got, twin, rtol=0, atol=1e-12), \
        np.abs(got - twin).max()
    assert np.allclose(got, want, rtol=0, atol=1e-12), \
        np.abs(got - want).max()


def _tm_feasible(k, d):
    """Rows whose [numer]+ / (denom + eps) lies on the simplex exactly
    (G = I, F = 0; the even rows powers of two summing to 1) and random
    rows between them."""
    G, F = np.eye(k), np.zeros((k, d))
    N = np.random.RandomState(d).rand(k, d) - 0.5
    pat = np.full(d, -1.0)
    pat[[0, d // 3, 2 * d // 3, d - 1]] = [0.5, 0.25, 0.125, 0.125]
    N[::2] = pat * (1 + EPS)
    return G, N, F, pat


@pytest.mark.parametrize('k,d,nblk', [(8, 60, 7), (5, 37, 4), (6, 301, 9)])
@pytest.mark.parametrize('variant', ['plain', 'dead topic', 'reps=2 l2',
                                     'negative l1', 'feasible'])
def test_tm_proj_column_sliced_reductions_match_twin_and_pallas(k, d, nblk,
                                                                variant):
    """B2's column-sliced reductions, combined in the kernel's order:
    against the serial twin and the Pallas kernel (interpret mode),
    float64, 1e-12; ragged d, the concave branch (a dead topic), the
    feasible shortcut, negative l1, reps=2."""
    l1, l2, reps = 0.0, 0.0, 1
    if variant == 'feasible':
        G, N, F, pat = _tm_feasible(k, d)
    else:
        G, N, F = _tm_inputs(k, d, seed=k * d + nblk,
                             dead=1 if variant == 'dead topic' else None)
        l2, reps = (0.4, 2) if variant == 'reps=2 l2' else (0.0, 1)
        l1 = -0.02 if variant == 'negative l1' else 0.0
    got = _tm_proj_sliced(*_t(G, N, F), l1, l2, 1.0, reps=reps,
                          nblk=nblk).numpy()
    twin = dk.tm_proj_update_ref(*_t(G, N, F), l1, l2, 1.0,
                                 reps=reps).numpy()
    want = np.asarray(_tm_proj_call(
        k, d, d, l1, l2, 1.0, jnp.float64, jnp.float64, jnp.asarray(G),
        jnp.asarray(np.diag(G).reshape(k, 1)), jnp.asarray(N),
        jnp.asarray(F), interpret=True, reps=reps))
    assert np.allclose(got, twin, rtol=0, atol=1e-12), \
        np.abs(got - twin).max()
    assert np.allclose(got, want, rtol=0, atol=1e-12), \
        np.abs(got - want).max()
    assert np.allclose(got.sum(1), 1.0, atol=1e-12) and got.min() >= 0
    if variant == 'feasible':
        # the shortcut returns those rows as they are
        assert np.array_equal(got[::2], np.tile(pat.clip(0), (len(got[::2]),
                                                              1)))
    if variant == 'dead topic':
        assert np.count_nonzero(got[1]) == 1


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
    assert [p.name for p in _build.sources()] == ['gram.cu', 'gs.cu',
                                                  'masked.cu', 'sparse.cu',
                                                  'spmv.cu', 'tm_proj.cu']
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
    # k=256: B1 stages 16 Gram rows per topic block
    G, N, F = on(*_gs_inputs(256, 3000, seed=13, dead=5))
    a = dk.gs_update(G, N, F, -0.02, 0.0, 1.0)
    assert torch.equal(a, dk.gs_update(G, N, F, -0.02, 0.0, 1.0))
    b = dk.gs_update_ref(G, N, F, -0.02, 0.0, 1.0)
    assert float((a - b).abs().max() / b.abs().max()) <= tol
    # k=256: B2 loads a Gram row per topic (in float64 its slice is
    # worked in place in the output)
    for k, d, reps in ((8, 3000, 2), (256, 4000, 1)):
        G, N, F = on(*_tm_inputs(k, d, seed=12 + k, dead=2))
        a = dk.tm_proj_update(G, N, F, 0.0, 0.0, 1.0, reps=reps)
        assert torch.equal(a, dk.tm_proj_update(G, N, F, 0.0, 0.0, 1.0,
                                                reps=reps))
        b = dk.tm_proj_update_ref(G, N, F, 0.0, 0.0, 1.0, reps=reps)
        assert float((a - b).abs().max() / b.abs().max()) <= tol
    assert dk.LAUNCHES['gs'] == before['gs'] + 5
    assert dk.LAUNCHES['tm_proj'] == before['tm_proj'] + 4

