"""The MovieLens-25M cell (``rs-ml25m.fit-gram``) on the CPU at a small
size: its generator of half-star ratings, the estimator's Gram-phase fit
against the plain reference ``reference/rs_sparse_phase.py`` (Γ/Θ in
panels), faults planted in the fit coming out not correct against the
cell's limits, the Gram route's spans nesting in the fit's stages, and
the cell's four readers of them."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import rri_nmf_tpu_torch.nmf as nmf_mod
import rri_nmf_tpu_torch.ops.sweep_masked_gram as mg
from portbench.core import check
from portbench.core.harness import Fit, Run, run_cell
from portbench.core.spec import ROOT, Cell, load_module
from portbench.core.trace import Trace
from portbench.readings import reading
from rri_nmf_tpu_torch.sklearn_interface import NMF_RS_Estimator

CELL = 'rs-ml25m.fit-gram'
CPU = torch.device('cpu')
SEED = 3_123_456_789
N, D, Q, K = 400, 300, 8000, 8
# Γ/Θ in float64 at (n, d) = (400, 300): k·(n + d)·8 bytes a panel row, so
# this budget holds 3 of them and not the whole (k², n + d) tensors
BUDGET = 3 * K * (N + D) * 8 + 1
HALF_STARS = np.arange(1, 11) / 2.0


def small(n=N, d=D, q=Q, k=K, **gen):
    """The cell at a small size, fitting in float64 on the CPU through the
    sparse observed set ('auto' keeps a small table dense)."""
    cell = Cell(CELL)
    cell.config.update(n=n, d=d, n_obs=q, k=k)
    cell.config['gen'] = dict(cell.config['gen'], min_per_user=10,
                              max_per_user=80, zipf_q=10.0, **gen)
    cell.traffic['params'] = dict(cell.traffic['params'], sparse_obs=True)
    return cell


@pytest.fixture
def panels(monkeypatch):
    monkeypatch.setattr(mg, 'GRAM_BUDGET_BYTES', BUDGET)
    assert mg.auto_panel(K, N, D, 8) == 3
    torch.set_num_threads(2)


def _run(cell, trace=False):
    return run_cell(cell, SEED, 0.2, trace, CPU, 0.0, log=lambda msg: None)


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------

def _table(block=None, **over):
    cell = small(**over)
    gen = cell.module('gen', cell.config['generator'])
    kw = {} if block is None else dict(block=block)
    return cell, gen.make(cell.config, SEED, CPU, **kw)


def test_generator_table():
    cell, (pairs, r) = _table(n=500, d=400, q=20000)
    assert pairs.dtype == np.int64 and pairs.shape == (20000, 2)
    assert r.dtype == np.float64 and r.shape == (20000,)
    assert len(np.unique(pairs[:, 0] * 400 + pairs[:, 1])) == 20000
    # user-major, each user's items ascending
    assert np.all(np.diff(pairs[:, 0] * 400 + pairs[:, 1]) > 0)
    per_user = np.bincount(pairs[:, 0], minlength=500)
    assert per_user.min() >= 10 and per_user.max() <= 80
    assert pairs[:, 1].min() >= 0 and pairs[:, 1].max() < 400
    assert set(np.unique(r)) <= set(HALF_STARS)
    shares = np.array([(r == s).mean() for s in HALF_STARS])
    want = np.array(cell.config['gen']['star_shares'])
    assert np.all(np.abs(shares - want) <= 0.01 * want)


def test_generator_repeats_from_its_data_seed():
    _, (p1, r1) = _table()
    _, (p2, r2) = _table()
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_array_equal(r1, r2)
    _, (p3, _) = _table(data_seed=26)
    assert p3.shape != p1.shape or not np.array_equal(p3, p1)


@pytest.mark.parametrize('block', [1, 37, 4096])
def test_generator_blocks_give_one_table(block):
    _, (p1, r1) = _table()
    _, (p2, r2) = _table(block=block)
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_array_equal(r1, r2)


def test_generator_refuses_a_user_past_the_items():
    with pytest.raises(ValueError, match='items'):
        _table(n=50, d=60, q=3000)


# ---------------------------------------------------------------------------
# the fit against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('backend', ['auto', 'mxu'])
def test_gram_fit_matches_the_reference(backend, panels, monkeypatch):
    """The estimator's Gram-phase fit in float64, Γ/Θ in panels of 3 (the
    segment-sum contractions, or with ``sparse='mxu'`` the kernels' CPU
    twins), against the reference's residual form. Both are float64 and
    compute the same sums in another order; they agree to ~4e-13 after 30
    sweeps, so 1e-9 leaves room for the order of the sums and none for a
    wrong update."""
    made = []
    real = nmf_mod.make_masked_gram_sweep

    def spy(cfg, backend, panel):
        made.append(panel)
        return real(cfg, backend, panel)
    monkeypatch.setattr(nmf_mod, 'make_masked_gram_sweep', spy)
    cell = small()
    cell.traffic['nmf_kwargs'] = dict(cell.traffic['nmf_kwargs'],
                                      sparse=backend)
    result, rows = _run(cell)
    found = {name: value for name, value, _ in rows}
    assert made and set(made) == {3}
    assert result['correct'] is True, rows
    assert found['sweeps_gap'] == 0
    assert found['WT_gap'] < 1e-9 and found['rmse_gap'] < 1e-9, found


def test_reference_alone():
    """The reference's own stop and its predictions: 30 sweeps on this
    table, a 5% sample of the pairs, predictions inside the range."""
    cell, inputs = _table()
    ref = cell.module('reference', 'rs_sparse_phase')
    out = ref.fit(inputs, cell.config, cell.workload['reference'], 0, CPU)
    assert out['sweeps'] == 30
    assert out['truth'].shape == (int(np.ceil(0.05 * Q)),)
    pred = out['predict'](out['W'], out['T'])
    assert float(pred.min()) >= 0.5 and float(pred.max()) <= 5.0
    assert bool((out['W'] >= 0).all()) and bool((out['T'] <= 1).all())


IMPORTS = '''
import sys
sys.path.insert(0, %r)
from portbench.core.spec import load_module
load_module('reference', 'rs_sparse_phase')
load_module('gen', 'rs_ratings_half')
print(','.join(sorted({m.split('.')[0] for m in sys.modules} & {
    'jax', 'jaxlib', 'flax', 'rri_nmf_tpu', 'rri_nmf_tpu_torch'})))
'''


def test_reference_and_generator_import_nothing_of_the_packages():
    out = subprocess.run([sys.executable, '-c', IMPORTS % str(ROOT)],
                         capture_output=True, text=True, timeout=120,
                         cwd='/')
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ''


def test_lu_normalizer_is_p_times_l():
    A = torch.randn(50, 7, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    P, L, _ = torch.linalg.lu(A)
    ref = load_module('reference', 'rs_sparse_phase')
    torch.testing.assert_close(ref._pl(A), P @ L, rtol=0, atol=1e-15)


def _skip_panel(builder):
    """A Gram sweep whose second Γ panel is skipped: its topics' T rows
    come out as they went in."""
    def make(cfg, backend, panel):
        inner = builder(cfg, backend, panel)

        def sweep(plan, W, T, *rest):
            out = inner(plan, W, T, *rest)
            T2 = out[1].clone()
            T2[panel:2 * panel] = T[panel:2 * panel]
            return (out[0], T2) + tuple(out[2:])
        return sweep
    return make


@pytest.mark.parametrize('fault', ['skipped_gamma_panel', 'stop_off_by_one',
                                   'tf32_control'])
def test_a_fault_is_not_correct(fault, panels, monkeypatch):
    cell = small()
    if fault == 'skipped_gamma_panel':
        monkeypatch.setattr(nmf_mod, 'make_masked_gram_sweep',
                            _skip_panel(nmf_mod.make_masked_gram_sweep))
    elif fault == 'stop_off_by_one':
        # the objective's stop one sweep early
        real = nmf_mod.universal_stopping_condition
        monkeypatch.setattr(
            nmf_mod, 'universal_stopping_condition',
            lambda h, eps_stop=1e-4: real(h, eps_stop) or len(h) >= 29)
    if fault == 'tf32_control':
        found = reading(cell, SEED, CPU, 'reference_tf32')
        ok, rows = check.judge(found, cell.workload['limits'])
    else:
        result, rows = _run(cell)
        ok = result['correct']
    assert ok is False, rows


# ---------------------------------------------------------------------------
# the spans and their readers
# ---------------------------------------------------------------------------

def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize('backend', ['auto', 'mxu'])
def test_gram_spans_nest_in_the_stages(backend, panels):
    _, (pairs, r) = _table()
    est = NMF_RS_Estimator(N, D, K, max_iter=2, device='cpu',
                           use_validation_early_stopping=False,
                           sparse_obs=True,
                           nmf_kwargs=dict(update_order='phase',
                                           sparse=backend))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        est.fit(pairs, r)
    spans = [(e.name(), e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith('rri.')]
    named = {}
    for s in spans:
        named.setdefault(s[0], []).append(s)
    (plan,), (gram_plan,) = named['rri.nmf.plan'], named['rri.gram.plan']
    assert _inside(gram_plan, plan)
    sweeps = named['rri.nmf.sweep']
    assert len(sweeps) == 2
    # per sweep: A, three Γ panels, C, three Θ panels (with the mxu plan
    # C and three Θ panels more for the objective, inside the sweep's
    # score span); one topic loop a panel and phase
    contracts, topics = named['rri.gram.contract'], named['rri.gram.topics']
    per_sweep = 8 + (4 if backend == 'mxu' else 0)
    assert len(contracts) == 2 * per_sweep and len(topics) == 2 * 6
    assert all(any(_inside(s, w) for w in sweeps)
               for s in contracts + topics)


READERS = ('gram_plan_s', 'gram_topics_ms', 'gram_contract_idle_pct',
           'gram_roofline')
# µs: the plan inside the nmf plan stage, then a sweep: a Γ panel's
# contraction and its topic loop, then a Θ panel's
HOST = [('portbench.traced_fit', 0.0, 1000.0), ('rri.nmf.plan', 10.0, 200.0),
        ('rri.gram.plan', 20.0, 180.0), ('rri.nmf.sweep', 200.0, 900.0),
        ('rri.gram.contract', 210.0, 400.0), ('rri.gram.topics', 400.0,
                                              500.0),
        ('rri.gram.contract', 500.0, 700.0), ('rri.gram.topics', 700.0,
                                              880.0)]
GRAM = 'void gram_kernel<float>(float const*, int, int const*)'
DEVICE = [(GRAM, 220.0, 390.0), ('aten::copy', 410.0, 480.0),
          (GRAM, 520.0, 690.0)]


def _reading(metric, host=HOST, device=DEVICE, trace=True, q=25_000_095):
    tr = Trace(device=list(device), host=list(host), start=0.0, end=1000.0,
               sweeps=1) if trace else None
    run = Run(cell=Cell(CELL), setup_s=1.0, fits=[Fit(1.0, [0.2, 0.4])],
              inputs=(np.zeros((q, 2), np.int64), np.ones(q)), trace=tr)
    return load_module('metrics', metric).read(run)


def test_span_readers():
    assert _reading('gram_plan_s') == pytest.approx(160e-6)
    # the two topic loops over the one sweep
    assert _reading('gram_topics_ms') == pytest.approx(0.280)
    # idle in the contractions: 210-220 and 390-400 of the first, 500-520
    # and 690-700 of the second, of 390 µs
    assert _reading('gram_contract_idle_pct') == pytest.approx(
        100 * 50 / 390)


def test_gram_roofline_reader():
    """Four launches are one round of the 4 panels (35, 35, 35 and 23
    topics of 128) at ML-25M's shape: the operations bound each, 2·rows·
    nnz at 67 TFLOP/s, over their 4 × 170 µs."""
    ref = load_module('reference', 'rs_sparse_phase')
    assert ref.gram_panels(128, 162541, 59047) == [4480, 4480, 4480, 2944]
    least = sum(2 * rows * 25_000_095 / 67e12
                for rows in (4480, 4480, 4480, 2944))
    device = [(GRAM, 100.0 + 200 * i, 270.0 + 200 * i) for i in range(4)]
    assert _reading('gram_roofline', device=device) == pytest.approx(
        100 * least / 680e-6)
    # a launch count that is not whole rounds reads nothing
    assert _reading('gram_roofline') is None


@pytest.mark.parametrize('metric', READERS)
def test_no_spans_no_reading(metric):
    """A program without the Gram spans or the kernel (the other cells'
    routes), or a run without a trace, reads ``None``; nothing raises."""
    bare = [h for h in HOST if not h[0].startswith('rri.gram')]
    assert _reading(metric, trace=False) is None
    assert _reading(metric, host=bare, device=DEVICE[1:2]) is None
