"""The port's masked WRRI sweep and its two kernels against the JAX
package.

- The plain twins (``phase_a_ref``, ``phase_b_ref``) against the Pallas
  kernels ``_phase_a``/``_phase_b`` run in interpret mode on the CPU, as
  the JAX suite runs them.
- The whole port sweep (``make_masked_sweep``) against
  ``make_masked_sweep_pallas(cfg, interpret=True)`` on the cases of
  ``tests/test_pallas.py``: ragged shapes, regularizers,
  ``project_W_each_iter``, T drift re-projection, fixed T, a vector
  ``w_row_sum`` and negative L1 on a ragged shape.
- A dead topic in a fixed-T sweep spends the same ``'random'`` reset
  budget as JAX (the values differ by generator).
- B3's launch geometry (``phase_a_layout``, in 2-, 4- and 8-byte
  words), and a NumPy mirror of its summation order (lanes, warps,
  cluster ranks) against the twin.
- A NumPy mirror of B4's row-sum order (each lane's columns in order, in
  the 16-byte form's 8-column groups or the scalar form's lane stride,
  then the shuffle tree) against the twin, with faults it catches, and in
  float32 on 16-bit terms, where the two forms' orders give other bits.
- The wrappers' routing: a CPU tensor takes the twin and launches
  nothing (and writes into ``out=`` when given); any other non-CUDA
  tensor raises.
- On a CUDA machine, each kernel against its twin (marked ``cuda``,
  skipped without a card).

float64 on the CPU; ``atol=1e-9`` as in ``tests/test_pallas.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rri_nmf_tpu.ops.sweep_pallas import (_phase_a, _phase_b,
                                          make_masked_sweep_pallas)
from rri_nmf_tpu.ops.sweep_xla import SweepConfig as JaxSweepConfig
from rri_nmf_tpu_torch.ops import masked_kernels as mk
from rri_nmf_tpu_torch.ops.sweep import (GeneratorDraws, SweepConfig,
                                         make_objective)

torch.set_num_threads(2)
ATOL = 1e-9


def _problem(n, d, k, seed=0, density=0.5):
    """The inputs of tests/test_pallas.py::_problem."""
    rng = np.random.RandomState(seed)
    X = np.abs(rng.rand(n, k) @ rng.rand(k, d) + 0.01 * rng.rand(n, d))
    M = (rng.rand(n, d) < density).astype(float)
    W0 = np.abs(rng.rand(n, k))
    T0 = np.abs(rng.rand(k, d))
    return X, M, W0, T0


def _t(*arrays):
    return [torch.as_tensor(np.array(a)) for a in arrays]


def _pad(a, shape):
    out = np.zeros(shape)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


def _kernel_inputs(n, d, seed):
    rng = np.random.RandomState(seed)
    R = rng.randn(n, d)
    M = (rng.rand(n, d) < 0.3).astype(float)
    return R, M, [rng.rand(n) - 0.5, rng.rand(n), rng.rand(d), rng.rand(d)]


# ---------------------------------------------------------------------------
# the twins against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('n,d', [(30, 20), (517, 130), (64, 1030)])
def test_phase_a_twin_matches_pallas_interpret(n, d):
    R, M, (dw, w, tp, _) = _kernel_inputs(n, d, seed=n + d)
    # the Pallas kernel takes tile-padded operands (pads are zero)
    npad, dpad = -(-n // 512) * 512, -(-d // 1024) * 1024
    Rj, wR0j, nwj = _phase_a(
        jnp.asarray(_pad(R, (npad, dpad))), jnp.asarray(_pad(M, (npad, dpad))),
        jnp.asarray(_pad(dw, (npad,))), jnp.asarray(_pad(tp, (dpad,))),
        jnp.asarray(_pad(w, (npad,))), interpret=True)
    Rt, Mt, dwt, tpt, wt = _t(R, M, dw, tp, w)
    wR0, nw = mk.phase_a_ref(Rt, Mt, dwt, tpt, wt)
    assert np.allclose(Rt.numpy(), np.asarray(Rj)[:n, :d], rtol=0, atol=ATOL)
    assert np.allclose(wR0.numpy(), np.asarray(wR0j)[0, :d], rtol=0,
                       atol=ATOL)
    assert np.allclose(nw.numpy(), np.asarray(nwj)[0, :d], rtol=0, atol=ATOL)


@pytest.mark.parametrize('n,d', [(30, 20), (517, 130), (64, 1030)])
@pytest.mark.parametrize('fixed_t', [False, True])
def test_phase_b_twin_matches_pallas_interpret(n, d, fixed_t):
    R, M, (w, weff, told, tnew) = _kernel_inputs(n, d, seed=n * d)
    if fixed_t:
        weff = np.zeros(n)
    npad, dpad = -(-n // 512) * 512, -(-d // 1024) * 1024
    Rj, Rtj, mt2j = _phase_b(
        jnp.asarray(_pad(R, (npad, dpad))), jnp.asarray(_pad(M, (npad, dpad))),
        jnp.asarray(_pad(w, (npad,))), jnp.asarray(_pad(weff, (npad,))),
        jnp.asarray(_pad(told, (dpad,))), jnp.asarray(_pad(tnew, (dpad,))),
        interpret=True)
    Rt, Mt, wt, et, tot, tnt = _t(R, M, w, weff, told, tnew)
    Rt0, mt2 = mk.phase_b_ref(Rt, Mt, wt, et, tot, tnt)
    assert np.allclose(Rt.numpy(), np.asarray(Rj)[:n, :d], rtol=0, atol=ATOL)
    assert np.allclose(Rt0.numpy(), np.asarray(Rtj)[:n, 0], rtol=0,
                       atol=ATOL)
    assert np.allclose(mt2.numpy(), np.asarray(mt2j)[:n, 0], rtol=0,
                       atol=ATOL)


# ---------------------------------------------------------------------------
# the whole sweep
# ---------------------------------------------------------------------------

def _run_jax(cfg_kw, X, M, W, T, iters, extras=(), resets=0):
    sweep = make_masked_sweep_pallas(JaxSweepConfig(**cfg_kw),
                                     interpret=True)
    key = jax.random.PRNGKey(0)
    left = jnp.asarray(resets, jnp.int32)
    W, T = jnp.asarray(W), jnp.asarray(T)
    for _ in range(iters):
        W, T, key, left = sweep(jnp.asarray(X), W, T, key, left, key,
                                jnp.asarray(M), *extras)
    return np.array(W), np.array(T), int(left)


def _run_port(cfg_kw, X, M, W, T, iters, wrs=None, resets=0):
    sweep = mk.make_masked_sweep(SweepConfig(**cfg_kw))
    X, M, W, T = _t(X, M, W, T)
    wrs = torch.as_tensor(wrs) if wrs is not None else None
    draws = GeneratorDraws(torch.Generator().manual_seed(0))
    for _ in range(iters):
        W, T, resets = sweep(X, W, T, M, draws, resets, wrs)
    return W.numpy(), T.numpy(), resets


SWEEP_CASES = {
    'plain': dict(t_row_sum=1.0),
    'regularized': dict(t_row_sum=1.0, reg_w_l1=0.1, reg_t_l1=0.05),
    'project_W': dict(project_W_each_iter=True, w_row_sum=1.0,
                      t_row_sum=1.0),
    'T drift reprojection': dict(project_T_each_iter=True, t_row_sum=1.0),
    'fix_T': dict(fix_T=True, t_row_sum=1.0),
    'fix_T regs, row bounds': dict(fix_T=True, reg_w_l1=0.05,
                                   reg_w_l2=0.02, w_row_sum=1.0,
                                   project_W_each_iter=True),
    'negative l1': dict(project_T_each_iter=True, t_row_sum=1.0,
                        reg_t_l1=-0.1, reg_t_l2=0.5, reg_w_l1=-0.05,
                        reg_w_l2=0.5),
}


@pytest.mark.parametrize('shape', [(30, 20, 3), (300, 600, 5),
                                   (520, 130, 4)])
@pytest.mark.parametrize('case', sorted(SWEEP_CASES))
def test_sweep_matches_pallas(shape, case):
    n, d, k = shape
    X, M, W0, T0 = _problem(n, d, k, seed=n + k)
    kw = dict(k=k, masked=True, reset_topic_method=None, **SWEEP_CASES[case])
    Wj, Tj, _ = _run_jax(kw, X, M, W0, T0, 3)
    Wt, Tt, _ = _run_port(kw, X, M, W0, T0, 3)
    assert np.allclose(Wt, Wj, rtol=0, atol=ATOL), np.abs(Wt - Wj).max()
    assert np.allclose(Tt, Tj, rtol=0, atol=ATOL), np.abs(Tt - Tj).max()
    if kw.get('fix_T'):
        assert np.array_equal(Tt, T0)
    if kw.get('project_W_each_iter'):
        assert np.abs(Wt.sum(1) - 1.0).max() < 1e-12
    if kw.get('project_T_each_iter'):
        assert np.abs(Tt.sum(1) - 1.0).max() < 1e-12


@pytest.mark.parametrize('fix_T', [False, True])
def test_sweep_vector_w_row_sum_matches_pallas(fix_T):
    n, d, k = 45, 35, 3
    X, M, W0, T0 = _problem(n, d, k, seed=5)
    wrs = np.random.RandomState(6).rand(n) + 0.5
    kw = dict(k=k, masked=True, reset_topic_method=None, fix_T=fix_T,
              t_row_sum=1.0, w_row_sum_is_vector=True,
              project_W_each_iter=True)
    Wj, Tj, _ = _run_jax(kw, X, M, W0, T0, 3, extras=(jnp.asarray(wrs),))
    Wt, Tt, _ = _run_port(kw, X, M, W0, T0, 3, wrs=wrs)
    assert np.allclose(Wt, Wj, rtol=0, atol=ATOL)
    assert np.allclose(Tt, Tj, rtol=0, atol=ATOL)
    assert np.allclose(Wt.sum(1), wrs, atol=1e-12)


def test_negative_l1_ragged_shape_gives_no_phantom_mass():
    """tests/test_pallas.py's heavily padded negative-L1 case: nothing is
    padded here, so every coordinate the solves see is a real one; the
    factors match JAX and stay on their (n, d) support."""
    n, d, k = 6, 5, 3
    X, M, W0, T0 = _problem(n, d, k, seed=3)
    kw = dict(k=k, masked=True, reset_topic_method=None,
              project_T_each_iter=True, t_row_sum=1.0, reg_t_l1=-0.1,
              reg_t_l2=0.5, reg_w_l1=-0.05, reg_w_l2=0.5)
    Wj, Tj, _ = _run_jax(kw, X, M, W0, T0, 2)
    Wt, Tt, _ = _run_port(kw, X, M, W0, T0, 2)
    assert Wt.shape == (n, k) and Tt.shape == (k, d)
    assert np.allclose(Wt, Wj, rtol=0, atol=ATOL)
    assert np.allclose(Tt, Tj, rtol=0, atol=ATOL)
    assert np.abs(Tt.sum(1) - 1.0).max() < 1e-12


def test_sweep_descends_the_masked_objective():
    n, d, k = 80, 60, 4
    X, M, W0, T0 = _problem(n, d, k, seed=8)
    sweep = mk.make_masked_sweep(SweepConfig(
        k=k, masked=True, reset_topic_method=None, t_row_sum=1.0))
    obj = make_objective(masked=True)
    X, M, W, T = _t(X, M, W0, T0)
    hist = [float(obj(X, W, T, M))]
    for _ in range(5):
        W, T, _ = sweep(X, W, T, M, None, 0)
        hist.append(float(obj(X, W, T, M)))
    assert np.all(np.diff(hist) <= 1e-12 * abs(hist[0]))


@pytest.mark.parametrize('fix_reset_seed', [False, True])
def test_fix_T_dead_topic_resets_spend_the_jax_budget(fix_reset_seed):
    """A dead topic (zero T row with T fixed) fires the 'random' reset in
    both packages; the budget left agrees, the drawn values differ by
    generator."""
    n, d, k = 70, 50, 3
    X, M, W0, T0 = _problem(n, d, k, seed=7)
    T0[1] = 0.0
    kw = dict(k=k, masked=True, fix_T=True, reset_topic_method='random',
              t_row_sum=1.0, fix_reset_seed=fix_reset_seed)
    Wj, Tj, left_j = _run_jax(kw, X, M, W0, T0, 2, resets=23)
    Wt, Tt, left_t = _run_port(kw, X, M, W0, T0, 2, resets=23)
    assert left_j < 23 and left_t == left_j
    assert not np.allclose(Tt[1], 0.0)
    assert np.allclose(Tt[1].sum(), 1.0)
    assert np.array_equal(Tt[[0, 2]], T0[[0, 2]])
    Wt2, Tt2, _ = _run_port(kw, X, M, W0, T0, 2, resets=23)
    assert np.array_equal(Wt2, Wt) and np.array_equal(Tt2, Tt)


def test_reset_budget_zero_leaves_dead_topic():
    n, d, k = 30, 20, 3
    X, M, W0, T0 = _problem(n, d, k, seed=9)
    T0[2] = 0.0
    kw = dict(k=k, masked=True, fix_T=True, reset_topic_method='random',
              t_row_sum=1.0)
    Wj, _, _ = _run_jax(kw, X, M, W0, T0, 2, resets=0)
    Wt, Tt, left = _run_port(kw, X, M, W0, T0, 2, resets=0)
    assert left == 0 and np.array_equal(Tt[2], np.zeros(d))
    assert np.allclose(Wt, Wj, rtol=0, atol=ATOL)


def test_supports_masked_kernels_gates():
    ok = SweepConfig(k=3, masked=True, reset_topic_method=None)
    assert mk.supports_masked_kernels(ok)
    assert mk.supports_masked_kernels(SweepConfig(
        k=3, masked=True, fix_T=True, reset_topic_method='random'))
    for kw in (dict(masked=False, reset_topic_method=None),
               dict(masked=True, reset_topic_method='random'),
               dict(masked=True, reset_topic_method=None, fix_W=True),
               dict(masked=True, reset_topic_method=None, dp_sigma=1.0),
               dict(masked=True, reset_topic_method=None,
                    store_gradients=True),
               dict(masked=True, masked_sparse=True,
                    reset_topic_method=None)):
        cfg = SweepConfig(k=3, **kw)
        assert not mk.supports_masked_kernels(cfg)
        with pytest.raises(ValueError):
            mk.make_masked_sweep(cfg)


@pytest.mark.parametrize('n,d,itemsize,want', [
    # the RS shape: 31 stripes of 128 float32 columns, 8 ranks of 24 tiles
    (6040, 3952, 4, (31, 8, 768)),
    (6040, 3952, 8, (62, 5, 1216)),   # 64 float64 columns a stripe
    (6040, 3952, 2, (16, 8, 768)),    # 256 16-bit columns: 128 blocks
    (40, 300, 4, (3, 8, 32)),          # two tiles for eight ranks
    (40, 300, 2, (2, 8, 32)),
    (10 ** 6, 40000, 4, (313, 1, 10 ** 6)),
    (10 ** 6, 40000, 2, (157, 2, 500000)),
])
def test_phase_a_layout(n, d, itemsize, want):
    stripes, cluster, ranges = mk.phase_a_layout(n, d, itemsize)
    assert (stripes, cluster, ranges[0][1]) == want


@pytest.mark.parametrize('n,d,itemsize', [
    (6040, 3952, 4), (6040, 3952, 8), (517, 1030, 4), (40, 300, 4),
    (5, 3, 8), (100, 257, 4), (2 ** 20, 1, 4), (33, 33000, 8),
    (6040, 3952, 2), (517, 1030, 2), (5, 3, 2), (33, 33000, 2)])
def test_phase_a_layout_covers_every_row_once(n, d, itemsize):
    """Stripes cover d; the cluster is 1-8 blocks; the ranks' ranges are
    whole tiles, in order, and cover [0, n) once."""
    stripes, cluster, ranges = mk.phase_a_layout(n, d, itemsize)
    cols = 32 * 16 // itemsize
    assert (stripes - 1) * cols < d <= stripes * cols
    assert 1 <= cluster <= mk.B3_MAX_CLUSTER and len(ranges) == cluster
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    for (a, b), (c, _) in zip(ranges, ranges[1:]):
        assert b == c
    for a, b in ranges:
        assert a <= b
        assert a == n or a % mk.B3_TILE == 0
        assert b == n or b % mk.B3_TILE == 0


def _phase_a_mirror(R, M, dw, tp, w, ranges):
    """NumPy mirror of B3's summation order (``csrc/masked.cu``): cluster
    rank r sums the rows ``ranges[r]`` in tiles of B3_TILE, dealt to
    B3_WARPS warps in turn; each warp adds its rows in order, the block
    adds its warps in order and rank 0 adds the ranks in order. Every
    column is summed alike (a lane only holds it), so the columns run
    side by side. Updates ``R`` in place, as the kernel does."""
    R += dw[:, None] * tp[None, :]
    total = None
    for a, b in ranges:
        starts = list(range(a, b, mk.B3_TILE))
        block = None
        for warp in range(mk.B3_WARPS):
            s_wr, s_nw = np.zeros(R.shape[1]), np.zeros(R.shape[1])
            for i0 in starts[warp::mk.B3_WARPS]:
                for i in range(i0, min(b, i0 + mk.B3_TILE)):
                    s_wr = s_wr + w[i] * (M[i] * R[i])
                    s_nw = s_nw + (w[i] * w[i]) * M[i]
            block = (s_wr, s_nw) if block is None else (
                block[0] + s_wr, block[1] + s_nw)
        total = block if total is None else (total[0] + block[0],
                                             total[1] + block[1])
    return total


def _mirror_against_twin(n, d, ranges, seed):
    R, M, (dw, w, tp, _) = _kernel_inputs(n, d, seed)
    Rm = R.copy()
    got = _phase_a_mirror(Rm, M, dw, tp, w, ranges)
    Rt, Mt, dwt, tpt, wt = _t(R, M, dw, tp, w)
    want = mk.phase_a_ref(Rt, Mt, dwt, tpt, wt)
    assert np.array_equal(Rm, Rt.numpy())
    return [float(np.abs(g - h.numpy()).max() / np.abs(h.numpy()).max())
            for g, h in zip(got, want)]


@pytest.mark.parametrize('itemsize', [2, 4, 8])
@pytest.mark.parametrize('n,d', [(30, 20), (517, 130), (64, 1030),
                                 (100, 257), (5, 3), (300, 700)])
def test_phase_a_summation_order_matches_twin(n, d, itemsize):
    ranges = mk.phase_a_layout(n, d, itemsize)[2]
    assert max(_mirror_against_twin(n, d, ranges, seed=n + d)) <= 1e-12


@pytest.mark.parametrize('fault', ['a row left out', 'a row twice'])
def test_phase_a_mirror_fails_on_a_wrong_row_range(fault):
    n, d = 300, 70
    ranges = list(mk.phase_a_layout(n, d, 8)[2])
    a, b = ranges[1]
    ranges[1] = (a, b - 1) if fault == 'a row left out' else (a - 1, b)
    assert max(_mirror_against_twin(n, d, ranges, seed=3)) > 1e-6


def _phase_b_columns(d, packed):
    """B4's column order (``csrc/masked.cu``): ``cols[l]`` the columns
    lane l of a row's warp adds, in order; -1 past d. The 16-byte form
    (``packed``): columns 256 s + 8 l + v, v = 0..7, of each step s; the
    scalar form: l + 32 s."""
    lane = np.arange(32)[:, None]
    if packed:
        k = np.arange(-(-d // 256) * 8)[None, :]
        cols = 256 * (k // 8) + 8 * lane + k % 8
    else:
        cols = lane + 32 * np.arange(-(-d // 32))[None, :]
    return np.where(cols < d, cols, -1)


def _phase_b_mirror_sums(R, M, t_new, cols, rnd=lambda a: a):
    """NumPy mirror of B4's row sums on the updated residual ``R``: lane l
    adds its terms in the order of ``cols[l]``, then the shuffle tree adds
    lane l + off into lane l for off = 16, 8, 4, 2, 1 and lane 0 holds the
    sum. ``rnd`` rounds to storage where the 16-bit kernels do (M ⊙ R and
    t_new²); the terms ``rnd(M ⊙ R)·t_new`` and ``M·rnd(t_new²)`` are
    then exact in float32, as in the kernels' fused multiply-adds."""
    out = []
    for terms in (rnd(M * R) * t_new[None, :], M * rnd(t_new * t_new)):
        lanes = np.zeros((R.shape[0], 32), dtype=R.dtype)
        padded = np.concatenate([terms, np.zeros_like(terms[:, :1])], 1)
        for k in range(cols.shape[1]):
            lanes = lanes + padded[:, cols[:, k]]   # -1: the zero column
        for off in (16, 8, 4, 2, 1):
            lanes[:, :off] = lanes[:, :off] + lanes[:, off:2 * off]
        out.append(lanes[:, 0])
    return out


def _b4_mirror_against_twin(n, d, cols, seed):
    R, M, (w, weff, told, tnew) = _kernel_inputs(n, d, seed)
    Rt, Mt, wt, et, tot, tnt = _t(R, M, w, weff, told, tnew)
    want = mk.phase_b_ref(Rt, Mt, wt, et, tot, tnt)
    got = _phase_b_mirror_sums(Rt.numpy(), M, tnew, cols)
    return [float(np.abs(g - h.numpy()).max() / np.abs(h.numpy()).max())
            for g, h in zip(got, want)]


@pytest.mark.parametrize('packed', [True, False])
@pytest.mark.parametrize('n,d', [(30, 24), (64, 1032), (40, 264), (5, 8),
                                 (100, 3952)])
def test_phase_b_summation_order_matches_twin(n, d, packed):
    cols = _phase_b_columns(d, packed)
    used = np.sort(cols[cols >= 0])
    assert np.array_equal(used, np.arange(d))      # every column once
    assert max(_b4_mirror_against_twin(n, d, cols, seed=n + d)) <= 1e-12


@pytest.mark.parametrize('fault', ['the tail step left out',
                                   'a lane twice, its neighbour never'])
def test_phase_b_mirror_fails_on_a_wrong_column_split(fault):
    n, d = 40, 1000                    # 3 full steps and a 232-column tail
    cols = _phase_b_columns(d, True)
    if fault == 'the tail step left out':
        cols[:, 24:] = -1
    else:
        cols[1] = cols[0]
    assert max(_b4_mirror_against_twin(n, d, cols, seed=3)) > 1e-6


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16])
def test_phase_b_forms_sum_in_other_orders_in_float32(dtype):
    """In float32 on 16-bit terms (the 16-bit builds' sums) the two forms'
    orders give other bits on some rows, each within float32 rounding of
    the twin: the card's test of B4's 16-byte sums against the packed
    mirror bit for bit tells the orders apart."""
    n, d = 64, 3952
    R, M, (w, weff, told, tnew) = _kernel_inputs(n, d, seed=21)
    Rt, Mt, wt, et, tot, tnt = (a.to(dtype) for a in _t(
        R, M, w, weff, told, tnew))
    want = mk.phase_b_ref(Rt, Mt, wt, et, tot, tnt)

    def rnd(a):
        return torch.from_numpy(a).to(dtype).float().numpy()
    f32 = [a.float().numpy() for a in (Rt, Mt, tnt)]
    sums = {packed: _phase_b_mirror_sums(
        *f32, _phase_b_columns(d, packed), rnd) for packed in (True, False)}
    for got in sums.values():
        for g, h in zip(got, want):
            assert g.dtype == np.float32
            assert np.abs(g - h.numpy()).max() <= 1e-5 * np.abs(
                h.numpy()).max()
    assert not all(np.array_equal(a, b)
                   for a, b in zip(sums[True], sums[False]))


# ---------------------------------------------------------------------------
# wrapper routing
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_twin_and_launch_nothing():
    R, M, (dw, w, tp, tn) = _kernel_inputs(20, 30, seed=11)
    before = dict(mk.LAUNCHES)
    R1, R2, Mt, dwt, wt, tpt, tnt = _t(R, R, M, dw, w, tp, tn)
    a = mk.phase_a(R1, Mt, dwt, tpt, wt)
    b = mk.phase_a_ref(R2, Mt, dwt, tpt, wt)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(R1, R2) and not np.array_equal(R1.numpy(), R)
    a = mk.phase_b(R1, Mt, wt, dwt, tpt, tnt)
    b = mk.phase_b_ref(R2, Mt, wt, dwt, tpt, tnt)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(R1, R2)
    assert mk.LAUNCHES == before


def test_cpu_wrappers_write_into_out():
    R, M, (dw, w, tp, tn) = _kernel_inputs(20, 30, seed=14)
    R1, R2, Mt, dwt, wt, tpt, tnt = _t(R, R, M, dw, w, tp, tn)
    out = (torch.empty(30, dtype=R1.dtype), torch.empty(30, dtype=R1.dtype))
    got = mk.phase_a(R1, Mt, dwt, tpt, wt, out=out)
    want = mk.phase_a_ref(R2, Mt, dwt, tpt, wt)
    assert got is out and all(torch.equal(x, y) for x, y in zip(out, want))
    out = (torch.empty(20, dtype=R1.dtype), torch.empty(20, dtype=R1.dtype))
    got = mk.phase_b(R1, Mt, wt, dwt, tpt, tnt, out=out)
    want = mk.phase_b_ref(R2, Mt, wt, dwt, tpt, tnt)
    assert got is out and all(torch.equal(x, y) for x, y in zip(out, want))
    assert torch.equal(R1, R2)


def test_non_cuda_devices_raise_instead_of_falling_back():
    R, M, (dw, w, tp, tn) = _kernel_inputs(4, 6, seed=12)
    R, M, dw, w, tp, tn = (a.to('meta') for a in _t(R, M, dw, w, tp, tn))
    with pytest.raises(ValueError, match='CUDA'):
        mk.phase_a(R, M, dw, tp, w)
    with pytest.raises(ValueError, match='CUDA'):
        mk.phase_b(R, M, w, dw, tp, tn)


def test_launch_counter_reset():
    mk.LAUNCHES['phase_b'] += 2
    mk.reset_launches()
    assert mk.LAUNCHES == {'phase_a': 0, 'phase_b': 0}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    return torch.device('cuda')


def _within_one_ulp(got, want, got32, want32, dtype):
    """Each 16-bit entry of ``got`` within one ulp of the storage type of
    ``want`` plus the float32 build's own difference from the float32 twin
    at that entry (``got32``, ``want32``: on the same values upcast), as
    ``chip_smoke.py`` phase 26 gates it."""
    g, w = got.double(), want.double()
    mant, tiny = (7, 2.0 ** -126) if dtype == torch.bfloat16 \
        else (10, 2.0 ** -14)
    ulp = torch.pow(2.0, torch.floor(torch.log2(
        torch.maximum(g.abs(), w.abs()).clamp_min(tiny))) - mant)
    return bool(((g - w).abs()
                 <= ulp + (got32.double() - want32.double()).abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4),
                                       (torch.bfloat16, None),
                                       (torch.float16, None)])
@pytest.mark.parametrize('n,d', [(517, 1030), (2000, 3000), (40, 300),
                                 (700, 100), (300, 257), (5, 130),
                                 (300, 3952)])
def test_cuda_kernels_match_twins(cuda_device, dtype, tol, n, d):
    """Each kernel against its twin, and bit for bit on a repeat launch:
    B3 at ragged d (its scalar-load form in float32 at d % 4 != 0, in 16
    bits at d % 8 != 0), d below one stripe, and n below the cluster's row
    split. 16 bits: R within one ulp plus the float32 build's own
    difference, the float32 sums within 1e-4 relative."""
    R, M, vecs = _kernel_inputs(n, d, seed=13)

    def on(*arrays, dt=dtype):
        return [torch.as_tensor(a, device=cuda_device).to(dt)
                for a in arrays]
    R0, Mt = on(R, M)
    dw, w, tp, tn = on(*vecs)
    before = dict(mk.LAUNCHES)
    for kernel, ref, args in ((mk.phase_a, mk.phase_a_ref, (dw, tp, w)),
                              (mk.phase_b, mk.phase_b_ref,
                               (w, dw, tp, tn)),
                              (mk.phase_b, mk.phase_b_ref,
                               (w, torch.zeros_like(w), tp, tn))):
        Ra, Rc, Rb = R0.clone(), R0.clone(), R0.clone()
        got = kernel(Ra, Mt, *args)
        again = kernel(Rc, Mt, *args)
        want = ref(Rb, Mt, *args)
        if tol is None:
            R32, Rb32 = R0.float(), R0.float()
            kernel(R32, Mt.float(), *(a.float() for a in args))
            ref(Rb32, Mt.float(), *(a.float() for a in args))
        torch.cuda.synchronize()
        if tol is None:
            assert _within_one_ulp(Ra, Rb, R32, Rb32, dtype)
        else:
            assert float((Ra - Rb).abs().max() / Rb.abs().max()) <= tol
        for g, h in zip(got, want):
            assert float((g - h).abs().max() / h.abs().max()) <= (tol or
                                                                  1e-4)
        assert torch.equal(Ra, Rc)
        assert all(torch.equal(g, h) for g, h in zip(got, again))
    assert mk.LAUNCHES['phase_a'] == before['phase_a'] + (
        4 if tol is None else 2)
    assert mk.LAUNCHES['phase_b'] == before['phase_b'] + (
        8 if tol is None else 4)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16])
@pytest.mark.parametrize('n,d', [(64, 3952), (40, 1032), (30, 1030)])
def test_cuda_phase_b_16_bit_sums_follow_the_mirror(cuda_device, dtype, n,
                                                    d):
    """B4's 16-bit row sums bit for bit the float32 mirror of its order:
    the 16-byte form's at d % 8 == 0, the scalar form's otherwise."""
    R, M, (w, weff, told, tnew) = _kernel_inputs(n, d, seed=17)
    Rk, Mt, wt, et, tot, tnt = (torch.as_tensor(a, device=cuda_device)
                                .to(dtype) for a in (R, M, w, weff, told,
                                                     tnew))
    got = mk.phase_b(Rk, Mt, wt, et, tot, tnt)
    torch.cuda.synchronize()

    def rnd(a):
        return torch.from_numpy(a).to(dtype).float().numpy()
    want = _phase_b_mirror_sums(
        *(a.float().cpu().numpy() for a in (Rk, Mt, tnt)),
        _phase_b_columns(d, d % 8 == 0), rnd)
    for g, h in zip(got, want):
        assert np.array_equal(g.cpu().numpy(), h)
