"""The port's plain sweep (``ops/sweep.py``, ``make_sweep``) against the
JAX package's (:func:`rri_nmf_tpu.ops.sweep_xla.make_sweep`), on the CPU
in float64 at 1e-9 (``tests/test_dense_oracle.py`` pins JAX's own sweep
at 1e-10/1e-11).

- Every branch: unmasked interleaved with and without the scale
  transfer, ``project_T_each_iter``, ``fix_W``/``fix_T``, a vector
  ``w_row_sum``, masked interleaved, the Gram-blocked phase form
  (``inner_reps`` too), for one and several sweeps.
- Resets that fire: ``'max_resid_document'`` in the T phase (a dead W
  column) and in the W phase (a dead T row with T fixed), blockwise
  (with a clamped last block past 4096 rows) and whole, unmasked and
  masked, interleaved and Gram-blocked (mid-block): the same documents,
  the same factors and the same budget left. ``'random'`` with the draws
  injected (:class:`JaxDraws` draws what ``jax.random`` draws), seeded
  per topic or not.
- DP noise and ``store_gradients``, with the draws injected.
- The speculative sweep: with no reset it equals the eager sweep; when a
  topic dies with budget left its re-run equals the eager sweep bit for
  bit.
- A ~1%-dense X, whose W side reads X's nonzeros through the SpMV's twin
  (``ops/spmv.py``): the sweep at 1e-9 and the speculative re-run.
- The kernels' phase sweep with resets (``DenseResetSweep``): the twins
  with no reset, the Gram-blocked re-run when one fires.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rri_nmf_tpu.ops.sweep_xla import SweepConfig as JaxSweepConfig
from rri_nmf_tpu.ops.sweep_xla import make_reset_factors as \
    make_reset_factors_jax
from rri_nmf_tpu.ops.sweep_xla import make_reset_rowcol as \
    make_reset_rowcol_jax
from rri_nmf_tpu.ops.sweep_xla import make_sweep as jax_make_sweep
from rri_nmf_tpu_torch.ops import dense_kernels as dk
from rri_nmf_tpu_torch.ops import spmv
from rri_nmf_tpu_torch.ops.sweep import (SweepConfig, _gram_block_size,
                                         make_reset_factors,
                                         make_reset_rowcol, make_sweep)
from test_torch_spmv import _corpus, _factors

torch.set_num_threads(2)
ATOL = 1e-9


class JaxDraws(object):
    """The port's draws interface (``GeneratorDraws``) drawing what the
    JAX sweep draws: ``key`` is split at each unseeded reset and at each
    DP draw, a seeded reset folds ``t + argmax(T[t])`` into
    ``reset_key`` (``sweep_xla.make_reset_rowcol``, ``_dp_noise``)."""

    def __init__(self, key, reset_key):
        self.key, self.reset_key = key, reset_key

    def reset(self, t, t_row, n, d, seeded):
        if seeded:
            rk = jax.random.fold_in(self.reset_key,
                                    t + int(np.argmax(t_row.numpy())))
        else:
            self.key, rk = jax.random.split(self.key)
        k1, k2 = jax.random.split(rk)
        return (_torch(jax.random.uniform(k1, (d,), dtype=jnp.float64)),
                _torch(jax.random.uniform(k2, (n,), dtype=jnp.float64)))

    def normal(self, like, shape):
        self.key, k1, k2 = jax.random.split(self.key, 3)
        return (_torch(jax.random.normal(k1, tuple(like.shape), jnp.float64)),
                _torch(jax.random.normal(k2, tuple(shape), jnp.float64)))

    def get_state(self):
        return self.key

    def set_state(self, key):
        self.key = key


def jax_draws(random_state, device=None):
    """The draws of a JAX ``nmf()`` fit seeded with ``random_state``: its
    sweep key and its reset key (``rri_nmf_tpu/nmf.py:1658-1659``)."""
    return JaxDraws(jax.random.fold_in(jax.random.PRNGKey(random_state), 0),
                    jax.random.PRNGKey(random_state))


def _torch(a):
    return torch.as_tensor(np.array(a))


def _problem(n, d, k, seed=0, density=0.6):
    rng = np.random.RandomState(seed)
    X = np.abs(rng.rand(n, k) @ rng.rand(k, d) + 0.01 * rng.rand(n, d))
    M = (rng.rand(n, d) < density).astype(float)
    return X, M, np.abs(rng.rand(n, k)), np.abs(rng.rand(k, d))


def _sparse_problem(n, d, k, seed=0):
    """A ~1%-dense X of k blocks and factors near them (no topic dies),
    as numpy."""
    X = _corpus(n, d, k, 0.01, seed=seed)
    W, T = _factors(n, d, k, seed=seed + 1)
    return X.numpy(), W.numpy(), T.numpy()


def _spmv_calls(monkeypatch):
    """The sweep's calls of ``spmv.spmv`` (its twin on the CPU), under
    the card's density rule, which takes a ~1%-dense X."""
    monkeypatch.setattr(spmv, 'CPU_MAX_DENSITY', spmv.MAX_DENSITY)
    calls = []
    real = spmv.spmv

    def counted(rows, t):
        calls.append(t.shape)
        return real(rows, t)
    monkeypatch.setattr(spmv, 'spmv', counted)
    return calls


def _extras(kw, M, wrs):
    out = []
    if kw.get('masked'):
        out.append(M)
    if kw.get('w_row_sum_is_vector'):
        out.append(wrs)
    return out


def _run_jax(kw, X, W, T, iters, extras=(), resets=0, seed=3):
    sweep = jax_make_sweep(JaxSweepConfig(**kw))
    draws = jax_draws(seed)
    key, reset_key = draws.key, draws.reset_key
    left = jnp.asarray(resets, jnp.int32)
    W, T = jnp.asarray(W), jnp.asarray(T)
    extras = [jnp.asarray(e) for e in extras]
    stores = []
    for _ in range(iters):
        out = sweep(jnp.asarray(X), W, T, key, left, reset_key, *extras)
        W, T, key, left = out[:4]
        stores.append([np.array(s) for s in out[4:]])
    return np.array(W), np.array(T), int(left), stores


def _run_port(kw, X, W, T, iters, extras=(), resets=0, seed=3, eager=False):
    sweep = make_sweep(SweepConfig(**kw))
    draws = jax_draws(seed)
    W, T = _torch(W), _torch(T)
    extras = [_torch(e) for e in extras]
    stores = []
    run = sweep.eager if eager else sweep
    for _ in range(iters):
        W, T, resets, *st = run(_torch(X), W, T, draws, resets, *extras)
        stores.append([s.numpy() for s in st])
    return W.numpy(), T.numpy(), resets, stores


def _assert_close(got, want, tol=ATOL):
    assert np.allclose(got, want, rtol=0, atol=tol), np.abs(got - want).max()


def _same(kw, X, W0, T0, iters, extras=(), resets=0, **run):
    """Both sweeps from the same inputs: W, T, the budget and any stores
    agree."""
    Wj, Tj, lj, sj = _run_jax(kw, X, W0, T0, iters, extras, resets, **run)
    Wt, Tt, lt, st = _run_port(kw, X, W0, T0, iters, extras, resets, **run)
    _assert_close(Wt, Wj)
    _assert_close(Tt, Tj)
    assert lt == lj
    for a, b in zip(st, sj):
        for x, y in zip(a, b):
            assert x.shape == y.shape
            _assert_close(x, y)
    return Wt, Tt, lt


SWEEP_CASES = {
    'interleaved': dict(),
    'interleaved regularized': dict(reg_w_l2=0.1, reg_t_l2=0.05,
                                    reg_w_l1=0.01, reg_t_l1=0.02),
    'interleaved no resets': dict(reset_topic_method=None),
    'project_T': dict(project_T_each_iter=True, t_row_sum=1.0,
                      w_row_sum=1.0),
    'project_T project_W': dict(project_T_each_iter=True, t_row_sum=1.0,
                                w_row_sum=1.0, project_W_each_iter=True),
    'vector w_row_sum': dict(w_row_sum_is_vector=True,
                             project_W_each_iter=True),
    'fix_W': dict(fix_W=True),
    'fix_T': dict(fix_T=True, w_row_sum=1.0),
    'masked': dict(masked=True, t_row_sum=1.0),
    'masked project_T': dict(masked=True, project_T_each_iter=True,
                             t_row_sum=1.0),
    'masked regularized': dict(masked=True, t_row_sum=1.0, reg_w_l1=0.05,
                               reg_t_l1=0.02, reg_w_l2=0.1, reg_t_l2=0.05),
    'masked fix_W': dict(masked=True, fix_W=True),
    # neither phase runs: the inputs come back unchanged
    'fix_W fix_T': dict(fix_W=True, fix_T=True),
    'masked fix_W fix_T': dict(masked=True, fix_W=True, fix_T=True),
    'phase gram': dict(update_order='phase'),
    'phase gram project_T': dict(update_order='phase',
                                 project_T_each_iter=True, t_row_sum=1.0),
    'phase gram negative l1': dict(update_order='phase', reg_t_l1=-0.05,
                                   reg_w_l2=0.1, t_row_sum=1.0),
    'phase gram inner_reps': dict(update_order='phase', inner_reps=3,
                                  reset_topic_method=None),
    'phase gram fix_T': dict(update_order='phase', fix_T=True,
                             w_row_sum=1.0),
    # ~1%-dense X: the W side's X @ T[t] through the SpMV
    'interleaved sparse X': dict(),
    'project_T sparse X': dict(project_T_each_iter=True, t_row_sum=1.0,
                               w_row_sum=1.0),
    'fix_T sparse X': dict(fix_T=True, w_row_sum=1.0),
}


@pytest.mark.parametrize('case', sorted(SWEEP_CASES))
def test_sweep_matches_jax(case, monkeypatch):
    n, d, k = 40, 30, 6
    X, M, W0, T0 = _problem(n, d, k, seed=len(case))
    sparse = case.endswith('sparse X')
    if sparse:
        n, d = 60, 800
        X, W0, T0 = _sparse_problem(n, d, k, seed=len(case))
        calls = _spmv_calls(monkeypatch)
    kw = dict(k=k, **SWEEP_CASES[case])
    if kw.get('project_T_each_iter'):
        T0 = T0 / T0.sum(1, keepdims=True)
    wrs = np.random.RandomState(4).rand(n) + 0.5
    extras = _extras(kw, M, wrs)
    _same(kw, X, W0, T0, 1, extras, resets=5)
    Wt, Tt, left = _same(kw, X, W0, T0, 3, extras, resets=5)
    if kw.get('fix_T'):
        assert np.array_equal(Tt, T0)
    if kw.get('fix_T') and kw.get('fix_W'):
        assert np.array_equal(Wt, W0) and left == 5
    if kw.get('project_T_each_iter') and left == 5:
        # (a reset row is a residual row, not projected, in both packages)
        assert np.abs(Tt.sum(1) - 1.0).max() < 1e-12
    if kw.get('w_row_sum_is_vector'):
        assert np.abs(Wt.sum(1) - wrs).max() < 1e-12
    if sparse:
        # k products a sweep: 1 + 3 sweeps, no reset
        assert len(calls) == 4 * k and left == 5


def _max_resid_doc(X, W, T):
    R = np.maximum(X - W @ T, 0.0)
    return int(np.argmax((R * R).sum(1)))


RESET_CASES = {
    # T phase: a dead W column makes its T row 0 on the first sweep
    'T phase blockwise': dict(dead='W'),
    'T phase whole': dict(dead='W', reset_blockwise=False),
    'T phase masked': dict(dead='W', masked=True, t_row_sum=1.0),
    'T phase row bound': dict(dead='W', t_row_sum=1.0),
    # W phase: a dead T row with T fixed leaves its W column 0
    'W phase blockwise': dict(dead='T', fix_T=True, w_row_sum=1.0),
    'W phase whole': dict(dead='T', fix_T=True, reset_blockwise=False),
    'W phase masked': dict(dead='T', fix_T=True, masked=True),
    # the Gram-blocked form, the reset mid-block (topic 3 of a block of 6)
    'gram T phase mid-block': dict(dead='W', update_order='phase'),
    'gram W phase mid-block': dict(dead='T', update_order='phase',
                                   fix_T=True, w_row_sum=1.0),
    'gram both phases': dict(dead='WT', update_order='phase'),
}


@pytest.mark.parametrize('case', sorted(RESET_CASES))
def test_max_resid_reset_matches_jax(case, caplog):
    """'max_resid_document' fires: W, T and the budget match JAX over two
    sweeps, one reset logged per budget unit spent. With T fixed the reset
    column stays one-hot through the sweep, so JAX's W names the document
    the port logged."""
    kw = dict(RESET_CASES[case])
    dead = kw.pop('dead')
    n, d, k = 45, 35, 6
    assert _gram_block_size(k) == 6
    X, M, W0, T0 = _problem(n, d, k, seed=11)
    if 'W' in dead:
        W0[:, 3] = 0.0
    if 'T' in dead:
        T0[3] = 0.0
    kw = dict(k=k, **kw)
    extras = _extras(kw, M, None)
    caplog.set_level(logging.INFO, logger='rri_nmf_tpu_torch.ops.sweep')
    _, _, left = _same(kw, X, W0, T0, 2, extras, resets=4)
    fired = [r.getMessage() for r in caplog.records
             if 'reset to document' in r.getMessage()]
    assert left == 4 - len(fired) and 1 <= len(fired) <= 2, fired
    if kw.get('fix_T'):
        Wj = _run_jax(kw, X, W0, T0, 1, extras, resets=4)[0]
        assert fired[0] == 'topic 3 reset to document %d' % np.argmax(
            Wj[:, 3])


@pytest.mark.parametrize('where', [10, 4099])
@pytest.mark.parametrize('form', ['blockwise', 'whole', 'random',
                                  'random seeded'])
def test_reset_rowcol_matches_jax(form, where):
    """The reset alone against ``sweep_xla.make_reset_rowcol``. n = 4100:
    blocks start at 0 and 4 (the last one clamped to end at n, overlapping
    the first), and the largest residual lies in the first block or only
    in the second; the same document, row and column. 'random' with the
    draws injected."""
    n, d, k = 4100, 6, 2
    rng = np.random.RandomState(5)
    X = rng.rand(n, d)
    X[where] += 3.0
    W0, T0 = rng.rand(n, k), rng.rand(k, d)
    kw = dict(k=k, reset_blockwise=form != 'whole',
              reset_topic_method=('random' if form.startswith('random')
                                  else 'max_resid_document'),
              fix_reset_seed=form == 'random seeded')
    draws = jax_draws(3)
    rj, cj, _ = make_reset_rowcol_jax(JaxSweepConfig(**kw))(
        jnp.asarray(X), jnp.asarray(W0), jnp.asarray(T0), 1, draws.key,
        draws.reset_key)
    rt, ct = make_reset_rowcol(SweepConfig(**kw))(
        _torch(X), _torch(W0), _torch(T0), 1, draws)
    _assert_close(rt.numpy(), np.array(rj), 1e-12)
    _assert_close(ct.numpy(), np.array(cj), 1e-12)
    if not form.startswith('random'):
        assert int(torch.argmax(ct)) == where
    W0[:, 1] = 0.0
    _same(kw, X, W0, T0, 2, resets=3)


@pytest.mark.parametrize('form', ['blockwise', 'whole', 'random',
                                  'random seeded'])
def test_reset_factors_matches_jax(form):
    """``make_reset_factors``, the whole-matrix form: the check of
    ``tests/test_units.py:57-61`` (topic 1 of T and W replaced by the
    reset's row and one-hot column at the largest residual, the other
    columns untouched, the inputs unwritten) against JAX's wrapper at
    1e-12, JAX's draws injected for the 'random' forms."""
    rng = np.random.RandomState(0)
    n, d, k = 12, 9, 3
    X = np.abs(rng.rand(n, d))
    W = np.abs(rng.rand(n, k))
    T = np.abs(rng.rand(k, d))
    X[5] += 10.0                       # row 5 has the largest residual
    kw = dict(k=k, reset_blockwise=form != 'whole',
              reset_topic_method=('random' if form.startswith('random')
                                  else 'max_resid_document'),
              fix_reset_seed=form == 'random seeded')
    draws = jax_draws(3)
    Wj, Tj, _ = make_reset_factors_jax(JaxSweepConfig(**kw))(
        jnp.asarray(X), jnp.asarray(W), jnp.asarray(T), 1, draws.key,
        draws.reset_key)
    Wt, Tt = _torch(W), _torch(T)
    W2, T2 = make_reset_factors(SweepConfig(**kw))(_torch(X), Wt, Tt, 1,
                                                   draws)
    _assert_close(T2.numpy(), np.array(Tj), 1e-12)
    _assert_close(W2.numpy(), np.array(Wj), 1e-12)
    assert np.array_equal(W2.numpy()[:, [0, 2]], W[:, [0, 2]])
    assert np.array_equal(T2.numpy()[[0, 2]], T[[0, 2]])
    assert np.array_equal(Wt.numpy(), W) and np.array_equal(Tt.numpy(), T)
    if not form.startswith('random'):
        expect = np.maximum(X[5] - W[5] @ T, 0.0)
        _assert_close(T2.numpy()[1], expect, 1e-12)
        assert W2[5, 1] == 1.0 and float(W2[:, 1].sum()) == 1.0


@pytest.mark.parametrize('seeded', [False, True])
@pytest.mark.parametrize('masked', [False, True])
def test_random_reset_with_injected_draws_matches_jax(seeded, masked):
    """'random' resets fire in the T phase (a dead W column) and in the W
    phase (a dead T row with T fixed): with the draws JAX draws, the
    values agree."""
    n, d, k = 40, 30, 4
    X, M, W0, T0 = _problem(n, d, k, seed=12)
    W0[:, 1] = 0.0
    kw = dict(k=k, reset_topic_method='random', fix_reset_seed=seeded,
              masked=masked, t_row_sum=1.0)
    _, _, left = _same(kw, X, W0, T0, 2, _extras(kw, M, None), resets=3)
    assert left < 3
    T0[2] = 0.0
    kw['fix_T'] = True
    _, _, left = _same(kw, X, W0, T0, 2, _extras(kw, M, None), resets=3)
    assert left < 3


def test_budget_runs_out_like_jax():
    """Two dead topics and a budget of one: the first resets, the second
    stays as the no-reset branch leaves it; a budget of 0 resets none."""
    n, d, k = 40, 30, 5
    X, _, W0, T0 = _problem(n, d, k, seed=13)
    W0[:, [1, 3]] = 0.0
    for resets in (1, 0):
        _, Tt, left = _same(dict(k=k), X, W0, T0, 1, resets=resets)
        assert left == 0
        assert np.all(Tt[3] == 0.0) and (resets == 1) != np.all(Tt[1] == 0.0)


@pytest.mark.parametrize('case', ['interleaved', 'phase', 'masked'])
def test_dp_noise_with_injected_draws_matches_jax(case):
    n, d, k = 40, 30, 4
    X, M, W0, T0 = _problem(n, d, k, seed=14)
    kw = dict(k=k, dp_sigma=0.05, t_row_sum=1.0,
              masked=case == 'masked',
              update_order='phase' if case == 'phase' else 'interleaved')
    Wt, _, _ = _same(kw, X, W0, T0, 2, _extras(kw, M, None))
    # the noise changes the result
    Wc, _, _, _ = _run_port(dict(kw, dp_sigma=None), X, W0, T0, 2,
                            _extras(kw, M, None))
    assert not np.allclose(Wt, Wc, atol=1e-6)


@pytest.mark.parametrize('rows', [None, (0, 3, 7)])
@pytest.mark.parametrize('case', ['interleaved', 'phase', 'masked'])
def test_store_gradients_match_jax(case, rows):
    n, d, k = 40, 30, 4
    X, M, W0, T0 = _problem(n, d, k, seed=15)
    kw = dict(k=k, store_gradients=True, store_rows=rows,
              masked=case == 'masked',
              update_order='phase' if case == 'phase' else 'interleaved')
    _same(kw, X, W0, T0, 2, _extras(kw, M, None))
    _, _, _, stores = _run_port(kw, X, W0, T0, 1, _extras(kw, M, None))
    numer, denom = stores[0]
    assert numer.shape == (k, d)
    assert denom.shape == (k, d if case == 'masked' else 1)


@pytest.mark.parametrize('case', ['interleaved', 'masked', 'gram', 'random',
                                  'sparse X'])
def test_speculative_rerun_equals_the_eager_sweep(case, monkeypatch):
    """A topic that dies with budget left sends the sweep to its eager
    re-run: bit for bit the eager sweep's result, draws included. With no
    reset the speculative result is the eager one, bit for bit. On a
    ~1%-dense X both runs read X's nonzeros."""
    n, d, k = 40, 30, 6
    X, M, W0, T0 = _problem(n, d, k, seed=16)
    if case == 'sparse X':
        n, d = 60, 800
        X, W0, T0 = _sparse_problem(n, d, k, seed=16)
        calls = _spmv_calls(monkeypatch)
    kw = dict(k=k, masked=case == 'masked',
              update_order='phase' if case == 'gram' else 'interleaved',
              reset_topic_method='random' if case == 'random'
              else 'max_resid_document',
              dp_sigma=0.01 if case == 'random' else None,
              # the noise would revive a dead column's T row; an L1 cost
              # above the noise keeps it dead
              reg_t_l1=1.0 if case == 'random' else 0.0)
    extras = _extras(kw, M, None)
    for dead in (False, True):
        W = W0.copy()
        if dead:
            W[:, 2] = 0.0
        a = _run_port(kw, X, W, T0, 2, extras, resets=3)
        b = _run_port(kw, X, W, T0, 2, extras, resets=3, eager=True)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        assert a[2] == b[2] == (2 if dead else 3)
    sweep = make_sweep(SweepConfig(**kw))
    Xt, Wt = _torch(X), _torch(W)
    if case == 'sparse X':
        sweep.rows(Xt, Wt)      # found before, as the sweep's call does
    out, dead = sweep.speculate(Xt, Wt, _torch(T0),
                                jax_draws(3), 3, *map(_torch, extras))
    assert bool(dead) and out[2] == 3        # no reset fired speculatively
    out, dead = sweep.speculate(Xt, Wt, _torch(T0),
                                jax_draws(3), 0, *map(_torch, extras))
    assert dead is None                      # no budget: no check kept
    if case == 'sparse X':
        # 2 sweeps of k products each way, and the dead topic's sweep
        # again; then the two speculative sweeps above
        assert len(calls) == (4 + 4 + 1) * k + 2 * k


@pytest.mark.parametrize('c', [2.5, 0.0, -1.5, float('inf')])
@pytest.mark.parametrize('ub', [None, 0.7, 'vector'])
def test_lean_qf_matches_jax_qf_min_scalar_c(c, ub):
    """The sweeps' lean form of the unconstrained scalar subproblem
    (``qf_min_scalar_free``, which takes the negated linear term) against
    JAX's ``qf_min_scalar_c``, both branches, with infinities and a NaN
    among the numerators, and without the norm."""
    from rri_nmf_tpu.optimization import qf_min_scalar_c as jax_qf
    from rri_nmf_tpu_torch.optimization import qf_min_scalar_free
    rng = np.random.RandomState(18)
    numer = np.concatenate([rng.randn(40) * 3,
                            [0.0, -0.0, c if np.isfinite(c) else 1.0,
                             np.inf, -np.inf, np.nan]])
    if ub == 'vector':
        ub = rng.rand(numer.size) + 0.5
    x, nx = qf_min_scalar_free(
        _torch(numer), torch.tensor(c, dtype=torch.float64),
        _torch(ub) if isinstance(ub, np.ndarray) else ub)
    xj, nxj = jax_qf(jnp.asarray(-numer), jnp.asarray(c), None,
                     jnp.asarray(ub) if isinstance(ub, np.ndarray) else ub)
    assert np.array_equal(x.numpy(), np.array(xj), equal_nan=True)
    assert np.array_equal(nx.numpy(), np.array(nxj), equal_nan=True)
    alone = qf_min_scalar_free(
        _torch(numer), torch.tensor(c, dtype=torch.float64),
        _torch(ub) if isinstance(ub, np.ndarray) else ub,
        zeros=torch.zeros(numer.size, dtype=torch.float64), norm=False)
    assert torch.equal(alone.nan_to_num(), x.nan_to_num())


def test_sweep_rejects_what_jax_rejects():
    with pytest.raises(ValueError, match='inner_reps'):
        make_sweep(SweepConfig(k=3, inner_reps=2))
    with pytest.raises(ValueError, match='reset_topic_method'):
        make_sweep(SweepConfig(k=3, reset_topic_method='bogus'))


# ---------------------------------------------------------------------------
# the kernels' phase sweep with resets
# ---------------------------------------------------------------------------

RESET_KERNEL_CASES = {
    'both phases': dict(),
    'tm preset': dict(project_T_each_iter=True, t_row_sum=1.0,
                      w_row_sum=1.0),
    'transform': dict(fix_T=True, w_row_sum=1.0, t_row_sum=1.0),
    'project_W': dict(project_W_each_iter=True, w_row_sum=1.0),
}


@pytest.mark.parametrize('dead', [None, 'W', 'T'])
@pytest.mark.parametrize('case', sorted(RESET_KERNEL_CASES))
def test_dense_reset_sweep_matches_jax(case, dead, monkeypatch):
    """With no reset the twins' sweep runs alone; when a topic dies with
    budget left the sweep re-runs through the Gram-blocked form. Both
    against the JAX sweep (its Gram-blocked form), budget included."""
    n, d, k = 45, 35, 6
    X, _, W0, T0 = _problem(n, d, k, seed=17)
    kw = dict(k=k, update_order='phase', **RESET_KERNEL_CASES[case])
    if kw.get('project_T_each_iter'):
        T0 = T0 / T0.sum(1, keepdims=True)
    if dead == 'W':
        W0[:, 2] = 0.0
    if dead == 'T':
        T0[2] = 0.0
    sweep = dk.DenseResetSweep(SweepConfig(**kw))
    calls = []
    eager = sweep.eager
    monkeypatch.setattr(sweep, 'eager',
                        lambda *a: calls.append(1) or eager(*a))
    Wj, Tj, lj, _ = _run_jax(kw, X, W0, T0, 1, resets=3)
    W, T, left = sweep(_torch(X), _torch(W0), _torch(T0), jax_draws(3), 3)
    _assert_close(W.numpy(), Wj)
    _assert_close(T.numpy(), Tj)
    assert left == lj
    assert len(calls) == (lj < 3)
    if dead is None or (dead == 'W' and kw.get('fix_T')):
        assert not calls and left == 3
