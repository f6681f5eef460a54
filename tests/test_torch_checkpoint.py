"""The port's checkpoint/resume (``rri_nmf_tpu_torch.checkpoint``,
``nmf(checkpoint=...)``) on the CPU in float64.

- A state round-trips through ``torch.save``/``torch.load``, the
  directory keeps the last ``keep`` steps, and no temporary file stays.
- A fit checkpointed part way and resumed equals the straight fit at
  1e-12 — a plain fit, a HER fit (its momentum state), an early-stop fit
  (its score) and a ``'random'``-reset fit with DP noise (the generator
  state) — and each straight fit equals the JAX package's at 1e-8 (the
  random draws injected from JAX for the last).
- The JAX package's warnings (a grouped checkpoint's untracked
  objective, HER resumed from a plain checkpoint), stopping on restore,
  grouped saves aligned to ``checkpoint_every``, a generator state of
  another device type, and ``convert.state_from_numpy`` of a checkpoint
  the JAX package wrote.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

from rri_nmf_tpu.checkpoint import NMFCheckpointer as JaxCheckpointer
from rri_nmf_tpu.nmf import nmf as jax_nmf
from rri_nmf_tpu_torch import nmf as tnmf
from rri_nmf_tpu_torch.checkpoint import NMFCheckpointer, NMFState
from rri_nmf_tpu_torch.convert import state_from_numpy
from rri_nmf_tpu_torch.nmf import nmf as torch_nmf
from test_torch_sweep import jax_draws

torch.set_num_threads(2)
TOL = 1e-8
RESUME_TOL = 1e-12


def _problem(n=25, d=18, k=3, seed=0):
    rng = np.random.RandomState(seed)
    return np.abs(rng.rand(n, k) @ rng.rand(k, d) + 0.01 * rng.rand(n, d))


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _fit(X, **kw):
    return torch_nmf(X, device='cpu', **kw)


def _dead_topic_start(X, k=3, seed=1):
    rng = np.random.RandomState(seed)
    W0 = rng.rand(X.shape[0], k)
    W0[:, 1] = 0.0
    return W0, rng.rand(k, X.shape[1])


BASE = dict(k=3, random_state=0, early_stop=False,
            compute_obj_each_iter=True, reset_topic_method=None,
            eps_stop=0.0)


def _resume_case(name):
    """``(X, kwargs of the straight fit, sweeps before the checkpoint,
    checkpoint_every)``."""
    X = _problem()
    if name == 'plain':
        return X, dict(BASE, max_iter=8), 4, 2
    if name == 'her':
        return X, dict(BASE, max_iter=10, accel='her',
                       update_order='phase'), 5, 5
    if name == 'early stop':
        # the tracked objective as the score: a HER restart's rise stops
        # the fit and rolls it back, after the checkpoint
        return X, dict(BASE, max_iter=40, early_stop=True, accel='her',
                       update_order='phase'), 10, 5
    if name == 'random reset, DP noise':
        W0, T0 = _dead_topic_start(X)
        return X, dict(BASE, max_iter=8, reset_topic_method='random',
                       eps_gauss_t=1e5, delta_gauss_t=1e-5, W_in=W0,
                       T_in=T0), 4, 2
    raise KeyError(name)


RESUME_CASES = ('plain', 'her', 'early stop', 'random reset, DP noise')


@pytest.mark.parametrize('case', RESUME_CASES)
def test_resume_equals_straight(case, tmp_path):
    X, kw, first, every = _resume_case(case)
    straight = _fit(X, **kw)
    ck = str(tmp_path / 'run')
    _fit(X, checkpoint=ck, checkpoint_every=every, **dict(kw, max_iter=first))
    resumed = _fit(X, checkpoint=ck, checkpoint_every=100, **kw)
    for key in ('W', 'T'):
        assert np.allclose(_np(resumed[key]), _np(straight[key]), rtol=0,
                           atol=RESUME_TOL)
    assert np.allclose(resumed['obj_history'], straight['obj_history'],
                       rtol=RESUME_TOL, atol=0)
    assert resumed['n_resets_remaining'] == straight['n_resets_remaining']
    if case == 'early stop':
        assert len(straight['obj_history']) < kw['max_iter'] - 1
        # the score the straight fit compared against at the checkpoint
        assert NMFCheckpointer(ck).restore(first).es_score == \
            straight['obj_history'][first - 2]
    if case == 'random reset, DP noise':
        # the dead topic reset before the checkpoint, and the noise of
        # every later sweep came from the restored generator
        assert straight['n_resets_remaining'] < 23


@pytest.mark.parametrize('case', RESUME_CASES)
def test_straight_fit_matches_jax(case, monkeypatch):
    X, kw, _, _ = _resume_case(case)
    if case == 'random reset, DP noise':
        monkeypatch.setattr(tnmf, 'make_draws', jax_draws)
    a = jax_nmf(X, **kw)
    b = _fit(X, **kw)
    assert np.allclose(_np(b['W']), a['W'], rtol=0, atol=TOL)
    assert np.allclose(_np(b['T']), a['T'], rtol=0, atol=TOL)
    assert np.allclose(b['obj_history'], a['obj_history'], rtol=TOL, atol=0)
    assert b['n_resets_remaining'] == a['n_resets_remaining']


def _state(**kw):
    her = dict(Wy=torch.ones(4, 2), Ty=torch.full((2, 3), 0.25),
               beta=torch.tensor(0.7, dtype=torch.float32),
               e=torch.tensor(1.5, dtype=torch.float64),
               Wb=torch.ones(4, 2), Tb=torch.ones(2, 3),
               eb=torch.tensor(1.25, dtype=torch.float64))
    base = dict(W=torch.ones(4, 2, dtype=torch.float64),
                T=torch.full((2, 3), 0.5, dtype=torch.float64), iteration=7,
                obj_history=[3.0, 2.0, 1.5],
                generator_state=torch.Generator().manual_seed(5).get_state(),
                resets_left=11, random_state=42, her=her, es_score=2.5,
                generator_device='cpu')
    base.update(kw)
    return NMFState(**base)


def test_checkpoint_roundtrip(tmp_path):
    ckpt = NMFCheckpointer(tmp_path / 'ck', keep=2)
    state = _state()
    ckpt.save(7, state, wait=True)
    assert ckpt.latest_step() == 7
    back = ckpt.restore()
    assert (back.iteration, back.resets_left, back.random_state) == (7, 11, 42)
    assert back.obj_history == [3.0, 2.0, 1.5]
    assert back.obj_tracked is True and back.es_score == 2.5
    assert back.generator_device == 'cpu'
    assert torch.equal(back.generator_state, state.generator_state)
    assert torch.equal(back.W, state.W) and torch.equal(back.T, state.T)
    assert set(back.her) == set(state.her)
    for key, v in state.her.items():
        assert torch.equal(back.her[key], v) and back.her[key].dtype == v.dtype
    assert NMFCheckpointer(tmp_path / 'empty').restore() is None
    ckpt.close()


def test_checkpointer_keeps_the_last_steps(tmp_path):
    ckpt = NMFCheckpointer(tmp_path / 'ck', keep=2)
    for step in (2, 4, 6, 8):
        ckpt.save(step, _state(iteration=step))
    assert ckpt.steps() == [6, 8]
    assert ckpt.restore(6).iteration == 6
    # the saves left no temporary file behind
    assert sorted(p.name for p in (tmp_path / 'ck').iterdir()) == \
        ['step_6.pt', 'step_8.pt']


def test_grouped_saves_align_to_checkpoint_every(tmp_path):
    """Groups of 3 sweeps end at each checkpoint step (every 5), as in
    the JAX package; the grouped checkpoint carries no objective."""
    X = _problem()
    kw = dict(k=3, random_state=0, reset_topic_method=None,
              update_order='phase', sweeps_per_dispatch=3)
    ck = str(tmp_path / 'grp')
    a = _fit(X, max_iter=10, checkpoint=ck, checkpoint_every=5, **kw)
    ckpt = NMFCheckpointer(ck)
    assert ckpt.steps() == [5, 10]
    state = ckpt.restore(5)
    assert state.obj_tracked is False and state.obj_history == []
    b = _fit(X, max_iter=10, **dict(kw, sweeps_per_dispatch=1))
    assert np.allclose(_np(a['W']), _np(b['W']), rtol=0, atol=RESUME_TOL)
    assert len(a['iter_cputime']) == 10


def test_grouped_checkpoint_warns_of_its_untracked_objective(tmp_path,
                                                             caplog):
    X = _problem()
    ck = str(tmp_path / 'grp')
    _fit(X, k=3, max_iter=4, random_state=0, sweeps_per_dispatch=2,
         reset_topic_method=None, checkpoint=ck, checkpoint_every=2)
    with caplog.at_level(logging.WARNING, logger='rri_nmf_tpu_torch.nmf'):
        resumed = _fit(X, k=3, max_iter=6, random_state=0,
                       compute_obj_each_iter=True, reset_topic_method=None,
                       checkpoint=ck, checkpoint_every=100)
    assert any('without objective tracking' in r.message
               for r in caplog.records)
    assert len(resumed['obj_history']) == 2


def test_her_resumed_from_a_plain_checkpoint_warns(tmp_path, caplog):
    X = _problem()
    kw = dict(k=3, random_state=0, early_stop=False,
              reset_topic_method=None, eps_stop=0.0, update_order='phase')
    ck = str(tmp_path / 'plain')
    _fit(X, max_iter=4, checkpoint=ck, checkpoint_every=2, **kw)
    with caplog.at_level(logging.WARNING, logger='rri_nmf_tpu_torch.nmf'):
        resumed = _fit(X, max_iter=8, accel='her', checkpoint=ck,
                       checkpoint_every=100, **kw)
    assert any('no extrapolation state' in r.message
               for r in caplog.records)
    assert bool(torch.isfinite(resumed['W']).all())


def test_restored_history_that_meets_the_stop_runs_no_sweep(tmp_path):
    """A restored history that already meets the stopping rule ends the
    fit at once, as the straight fit ended there."""
    X = _problem()
    kw = dict(k=3, random_state=0, compute_obj_each_iter=True,
              reset_topic_method=None, eps_stop=0.5)
    straight = _fit(X, max_iter=50, **kw)
    n = len(straight['obj_history'])
    assert n < 50
    ck = str(tmp_path / 'stop')
    _fit(X, max_iter=n, checkpoint=ck, checkpoint_every=1, **kw)
    resumed = _fit(X, max_iter=50, checkpoint=ck, checkpoint_every=100, **kw)
    assert resumed['iter_cputime'] == []
    assert np.allclose(_np(resumed['W']), _np(straight['W']), rtol=0,
                       atol=RESUME_TOL)
    assert resumed['obj_history'] == straight['obj_history']


def test_generator_state_of_another_device_reseeds(tmp_path, caplog):
    """A generator state written on another device type cannot be set:
    the factors, history and budget resume, the generator re-seeds from
    random_state, and a warning says so."""
    X, kw, first, every = _resume_case('random reset, DP noise')
    ck = str(tmp_path / 'dev')
    _fit(X, checkpoint=ck, checkpoint_every=every, **dict(kw, max_iter=first))
    ckpt = NMFCheckpointer(ck)
    state = ckpt.restore()
    ckpt.save(state.iteration, dataclasses.replace(
        state, generator_device='cuda'))
    with caplog.at_level(logging.WARNING, logger='rri_nmf_tpu_torch.nmf'):
        moved = _fit(X, checkpoint=ck, checkpoint_every=100, **kw)
    assert any('cannot set' in r.message for r in caplog.records)
    # the same as resuming the factors with a generator fresh from the seed
    fresh = _fit(X, **dict(kw, max_iter=kw['max_iter'] - first,
                           W_in=state.W, T_in=state.T,
                           n_resets=state.resets_left))
    assert np.allclose(_np(moved['W']), _np(fresh['W']), rtol=0,
                       atol=RESUME_TOL)
    assert moved['obj_history'][:first] == state.obj_history
    straight = _fit(X, **kw)
    assert not np.allclose(_np(moved['W']), _np(straight['W']))


@pytest.mark.parametrize('accel', (None, 'her'), ids=('plain', 'her'))
def test_state_from_a_jax_checkpoint(accel, tmp_path):
    """A checkpoint written by the JAX package's NMFCheckpointer, read
    with the JAX package and converted, resumes in the port to the JAX
    package's own resumed fit."""
    X = _problem(seed=3)
    kw = dict(BASE, max_iter=10, update_order='phase', accel=accel)
    jck = str(tmp_path / 'jax')
    jax_nmf(X, checkpoint=jck, checkpoint_every=5, **dict(kw, max_iter=5))
    want = jax_nmf(X, checkpoint=jck, checkpoint_every=100, **kw)
    js = JaxCheckpointer(jck).restore()
    state = state_from_numpy(
        W=np.asarray(js.W), T=np.asarray(js.T), iteration=js.iteration,
        obj_history=js.obj_history, resets_left=js.resets_left,
        random_state=js.random_state, obj_tracked=js.obj_tracked,
        her=(None if js.her is None
             else {k: np.asarray(v) for k, v in js.her.items()}),
        es_score=js.es_score)
    assert state.generator_state is None
    tck = str(tmp_path / 'torch')
    NMFCheckpointer(tck).save(state.iteration, state)
    got = _fit(X, checkpoint=tck, checkpoint_every=100, **kw)
    assert np.allclose(_np(got['W']), want['W'], rtol=0, atol=TOL)
    assert np.allclose(_np(got['T']), want['T'], rtol=0, atol=TOL)
    assert np.allclose(got['obj_history'], want['obj_history'], rtol=TOL,
                       atol=0)
