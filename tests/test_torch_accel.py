"""The port's HER extrapolation (``nmf(accel='her')``,
``rri_nmf_tpu_torch.ops.accel``) against the JAX package, on the CPU in
float64.

- ``nmf(accel='her')`` against the JAX ``nmf()`` at 1e-8 (W, T) and
  1e-10 relative (``obj_history``) at up to 30 sweeps: over the dense
  phase sweep (B1's twin), the TM constraint set with regularizers (B2's
  twin), the interleaved plain sweep, the masked dense sweep (B3/B4's
  twins; the JAX side in interpret mode), ``accel_opts``, and a problem
  whose best accepted iterate is returned.
- Grouped dispatch (``sweeps_per_dispatch``) ≡ the per-sweep loop at
  1e-12; the JAX package's ``ValueError``\\ s; the acceleration as a
  property (at equal sweeps HER's error is below plain's) on the dense
  and the masked class; the wrapped sweeps leave their inputs unwritten;
  the residual objective against JAX's; ``NMF_RS_Estimator`` with
  ``nmf_kwargs=dict(accel='her')`` against JAX's estimator.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from rri_nmf_tpu.nmf import nmf as jax_nmf
from rri_nmf_tpu.ops.accel import make_residual_obj as jax_residual_obj
from rri_nmf_tpu.ops.sweep_xla import SweepConfig as JaxSweepConfig
from rri_nmf_tpu.sklearn_interface import NMF_RS_Estimator as JaxRS
from rri_nmf_tpu_torch import sklearn_interface as tsk
from rri_nmf_tpu_torch.nmf import nmf as torch_nmf
from rri_nmf_tpu_torch.ops import accel
from rri_nmf_tpu_torch.ops.dense_kernels import make_dense_phase_sweep
from rri_nmf_tpu_torch.ops.masked_kernels import make_masked_sweep
from rri_nmf_tpu_torch.ops.sweep import SweepConfig, make_sweep

torch.set_num_threads(2)
TOL = 1e-8
OBJ_RTOL = 1e-10
GROUP_TOL = 1e-12


def _uniform_factor_problem(n=96, d=64, k=6, seed=0):
    """The U[0,1]-factor class of tests/test_accel.py, smaller."""
    rng = np.random.RandomState(seed)
    return rng.rand(n, k) @ rng.rand(k, d)


def _mask(X, seed, density=0.7):
    return (np.random.RandomState(seed).rand(*X.shape) < density).astype(
        float)


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(X, s, M=1.0):
    return (np.linalg.norm(M * (X - _np(s['W']) @ _np(s['T'])))
            / np.linalg.norm(M * X))


KW = dict(random_state=0, early_stop=False, reset_topic_method=None,
          eps_stop=0.0, accel='her')


def _seed26():
    """tests/test_accel.py's seed-26 problem: an extrapolated sweep lands
    in a worse basin, and the best accepted iterate is returned."""
    rng = np.random.RandomState(26)
    n, d, k = int(rng.randint(20, 60)), int(rng.randint(15, 50)), 7
    X = np.abs(rng.rand(n, k) @ rng.rand(k, d) + 0.01 * rng.rand(n, d))
    return X, k, dict(max_iter=6, random_state=26, early_stop=False,
                      eps_stop=0, reset_topic_method=None,
                      project_T_each_iter=True, t_row_sum=1.0,
                      project_W_each_iter=True, w_row_sum=1.0,
                      reg_w_l2=0.01, reg_t_l2=0.01, init='smart_random',
                      accel='her')


def _case(name):
    X = _uniform_factor_problem(seed=3)
    if name == 'dense phase (B1)':
        return X, 6, dict(KW, max_iter=30, update_order='phase')
    if name == 'constraints and regularizers (B2)':
        return X, 6, dict(KW, max_iter=20, update_order='phase',
                          project_T_each_iter=True, t_row_sum=1.0,
                          w_row_sum=1.0, project_W_each_iter=True,
                          reg_w_l2=0.01, reg_t_l2=0.02)
    if name == 'interleaved plain sweep':
        return X, 6, dict(KW, max_iter=20)
    if name == 'masked dense (B3/B4)':
        return X, 6, dict(KW, max_iter=20, W_mat=_mask(X, 7), t_row_sum=1.0)
    if name == 'accel_opts':
        return X, 6, dict(KW, max_iter=15, update_order='phase',
                          accel_opts=dict(gamma=1.5, beta0=0.9,
                                          beta_max=0.95))
    if name == 'best accepted iterate':
        return _seed26()
    raise KeyError(name)


CASES = ('dense phase (B1)', 'constraints and regularizers (B2)',
         'interleaved plain sweep', 'masked dense (B3/B4)', 'accel_opts',
         'best accepted iterate')


@pytest.fixture(scope='module')
def jax_fits():
    """The JAX fits of every case, with the objective tracked (each JAX
    configuration compiles once for the module)."""
    out = {}
    for name in CASES:
        X, k, kw = _case(name)
        out[name] = jax_nmf(X, k, use_pallas='interpret',
                            compute_obj_each_iter=True, **kw)
    return out


@pytest.mark.parametrize('case', CASES)
def test_her_matches_jax(case, jax_fits):
    X, k, kw = _case(case)
    a = jax_fits[case]
    b = torch_nmf(X, k, device='cpu', compute_obj_each_iter=True, **kw)
    assert np.allclose(_np(b['W']), a['W'], rtol=0, atol=TOL), \
        np.abs(_np(b['W']) - a['W']).max()
    assert np.allclose(_np(b['T']), a['T'], rtol=0, atol=TOL)
    oa, ob = np.asarray(a['obj_history']), np.asarray(b['obj_history'])
    assert oa.shape == ob.shape
    assert np.allclose(ob, oa, rtol=OBJ_RTOL, atol=0)
    if case == 'best accepted iterate':
        # the returned factors are the best accepted iterate, below the
        # last tracked objective (tests/test_accel.py:195-225)
        final = b['obj_calculator'].true_objective()
        assert final <= ob.min() + 1e-10 * abs(ob[0]) < ob[-1]


@pytest.mark.parametrize('case', ('dense phase (B1)', 'masked dense (B3/B4)',
                                  'best accepted iterate'))
def test_her_grouped_matches_per_sweep(case):
    X, k, kw = _case(case)
    kw = dict(kw, max_iter=min(kw['max_iter'], 12))
    a = torch_nmf(X, k, device='cpu', **kw)
    b = torch_nmf(X, k, device='cpu', sweeps_per_dispatch=5, **kw)
    assert np.allclose(_np(b['W']), _np(a['W']), rtol=0, atol=GROUP_TOL)
    assert np.allclose(_np(b['T']), _np(a['T']), rtol=0, atol=GROUP_TOL)
    assert len(b['iter_cputime']) == len(a['iter_cputime'])


def test_her_multi_matches_steps():
    """``make_her_multi(..., n)`` ≡ n calls of ``make_her_step``: every
    output of the last step, bit for bit."""
    X = torch.as_tensor(_uniform_factor_problem(seed=5))
    rng = np.random.RandomState(6)
    W, T = torch.as_tensor(rng.rand(96, 6)), torch.as_tensor(rng.rand(6, 64))
    cfg = SweepConfig(k=6, reset_topic_method=None, update_order='phase')
    sweep, obj = make_dense_phase_sweep(cfg), accel.make_residual_obj(cfg)
    inf = torch.tensor(float('inf'), dtype=X.dtype)
    state = (W, T, W, T, W, T, inf, torch.tensor(0.5), inf)
    step = accel.make_her_step(sweep, obj, gamma=1.2)
    want = state
    for _ in range(7):
        want = step(X, *want)
    got = accel.make_her_multi(sweep, obj, 7, gamma=1.2)(X, *state)
    assert len(got) == len(want)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


VALIDATION = {
    'unknown accel': dict(accel='nope', reset_topic_method=None),
    'resets on (default)': dict(accel='her'),
    'masked with resets': dict(accel='her', W_mat='ones'),
    'fixed factor': dict(accel='her', fix_T=True, reset_topic_method=None,
                         T_in='random'),
    'sparse mode': dict(accel='her', sparse=True),
    'DP noise': dict(accel='her', reset_topic_method=None, eps_gauss_t=1.0,
                     delta_gauss_t=1e-5),
    'accel_opts without accel': dict(accel_opts=dict(gamma=1.1),
                                     reset_topic_method=None),
    'unknown accel_opts key': dict(accel='her', reset_topic_method=None,
                                   accel_opts=dict(nope=1.0)),
}


@pytest.mark.parametrize('case', sorted(VALIDATION))
def test_her_validation_matches_jax(case):
    X = _uniform_factor_problem(n=20, d=15, k=3)
    kw = dict(VALIDATION[case])
    if kw.get('W_mat') == 'ones':
        kw['W_mat'] = np.ones_like(X)
    if kw.get('T_in') == 'random':
        kw['T_in'] = np.random.RandomState(0).rand(3, 15)
    for fit in (jax_nmf, lambda *a, **k: torch_nmf(*a, device='cpu', **k)):
        with pytest.raises(ValueError):
            fit(X, 3, max_iter=2, **kw)


@pytest.mark.parametrize('masked', (False, True), ids=('dense', 'masked'))
def test_her_accelerates(masked):
    """At equal sweeps HER reaches a lower error than plain sweeps on the
    mean-dominated U[0,1]-factor class (tests/test_accel.py:32-46,
    122-143), stays non-negative, and ends below its first sweep."""
    X = _uniform_factor_problem(n=128, d=96, k=8, seed=7)
    M = _mask(X, 7) if masked else 1.0
    kw = dict(KW, compute_obj_each_iter=True, max_iter=60 if masked else 80)
    kw.pop('accel')
    if masked:
        kw['W_mat'] = M
    else:
        kw['update_order'] = 'phase'
    plain = torch_nmf(X, 8, device='cpu', **kw)
    her = torch_nmf(X, 8, device='cpu', accel='her', **kw)
    r_plain, r_her = _rel(X, plain, M), _rel(X, her, M)
    assert np.isfinite(r_her)
    assert bool((her['W'] >= 0).all()) and bool((her['T'] >= 0).all())
    assert r_her < r_plain * (0.9 if masked else 0.65), (r_her, r_plain)
    assert her['obj_history'][-1] <= plain['obj_history'][-1]
    assert her['obj_history'][-1] < her['obj_history'][0]


def _wrapped_sweeps(X, M, k):
    phase = SweepConfig(k=k, reset_topic_method=None, update_order='phase')
    dense = make_dense_phase_sweep(phase)
    plain = make_sweep(SweepConfig(k=k, reset_topic_method=None))
    masked = make_masked_sweep(SweepConfig(k=k, masked=True,
                                           reset_topic_method=None))
    return {
        'kernel phase sweep': lambda W, T: dense(X, W, T),
        'plain sweep': lambda W, T: plain(X, W, T, None, 0)[:2],
        'masked kernel sweep': lambda W, T: masked(X, W, T, M, None, 0)[:2],
    }


@pytest.mark.parametrize('name', ('kernel phase sweep', 'plain sweep',
                                  'masked kernel sweep'))
def test_wrapped_sweeps_leave_inputs_unwritten(name):
    """HER reads its step's input W (the last accepted iterate) and the
    extrapolated point after the sweep: every sweep it wraps must return
    new tensors and leave its inputs as they were."""
    rng = np.random.RandomState(2)
    X = torch.as_tensor(_uniform_factor_problem(n=40, d=30, k=4, seed=2))
    M = torch.as_tensor(_mask(X.numpy(), 3))
    W = torch.as_tensor(rng.rand(40, 4))
    T = torch.as_tensor(rng.rand(4, 30))
    W0, T0 = W.clone(), T.clone()
    W1, T1 = _wrapped_sweeps(X, M, 4)[name](W, T)
    assert torch.equal(W, W0) and torch.equal(T, T0)
    assert not torch.equal(W1, W0) and not torch.equal(T1, T0)


OBJ_FORMS = {
    'phase, column blocks': dict(update_order='phase'),
    'interleaved, row blocks': dict(),
    'masked, row blocks': dict(masked=True),
    'regularized': dict(update_order='phase', reg_w_l2=0.1, reg_t_l2=0.2,
                        reg_w_l1=0.01, reg_t_l1=0.02),
}


@pytest.mark.parametrize('form', sorted(OBJ_FORMS))
def test_residual_objective_matches_jax(form):
    """The objective check against JAX's: the column form (one block at
    these sizes) and the row form over 4096-row blocks of 4500 rows, the
    last block ragged."""
    kw = OBJ_FORMS[form]
    rows = 4500 if 'column' not in form else 300
    cols = 1000 if 'column' in form else 20
    if form == 'regularized':
        rows, cols = 60, 50
    rng = np.random.RandomState(4)
    X = rng.rand(rows, cols)
    W, T, M = rng.rand(rows, 3), rng.rand(3, cols), _mask(X, 5)
    extras = (M,) if kw.get('masked') else ()
    want = float(jax_residual_obj(JaxSweepConfig(
        k=3, reset_topic_method=None, **kw))(
            jnp.asarray(X), jnp.asarray(W), jnp.asarray(T),
            *(jnp.asarray(e) for e in extras)))
    got = accel.make_residual_obj(SweepConfig(
        k=3, reset_topic_method=None, **kw))(
            *(torch.as_tensor(a) for a in (X, W, T) + extras))
    assert got.dim() == 0
    assert float(got) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize('validation', (False, True),
                         ids=('fixed sweeps', 'validation early stop'))
def test_rs_estimator_her_matches_jax(recsys_train, validation):
    """``NMF_RS_Estimator(nmf_kwargs=dict(accel='her'))`` (the
    recommender record's ``fit_30_her``, at fewer sweeps) against the JAX
    estimator, with and without its validation early stop and rollback.
    Four fixed sweeps: on these fixtures the extrapolated steps grow the
    two fits' ~1e-11 difference after the first sweep past 1e-8 by the
    sixth."""
    n, d = recsys_train.shape
    kw = dict(random_state=0, max_iter=8 if validation else 4,
              use_validation_early_stopping=validation,
              nmf_kwargs=dict(accel='her'))
    J = JaxRS(n, d, 4, **kw).fit_from_Xtr(recsys_train)
    P = tsk.NMF_RS_Estimator(n, d, 4, device='cpu', **kw).fit_from_Xtr(
        recsys_train)
    assert np.allclose(_np(P.W), J.W, rtol=0, atol=TOL)
    assert np.allclose(_np(P.T), J.T, rtol=0, atol=TOL)
    assert np.allclose(P.nmf_outputs['obj_history'],
                       J.nmf_outputs['obj_history'], rtol=OBJ_RTOL, atol=0)
