"""The NYTimes cell (``tm-nytimes.fit-phase``) and the sparse-observation
recommender cell (``rs-ml1m.fit-sparse-obs``) on the CPU at small sizes:
the block generator of a large corpus, the plain reference of the sparse
topic-model route (``reference/tm_sparse_phase.py``) against the
estimator's fit on the gather kernel's layouts (the kernel's plain
twin), its launches a sweep, the layout build's span inside the input
stage and the two new readers; the recommender's fit on the O(nnz) sweep
against the dense-mask reference. Imports no JAX."""

import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rri_nmf_tpu_torch.nmf as nmf_mod
from portbench.core.harness import Fit, Run, run_cell
from portbench.core.spec import ROOT, Cell, load_module
from portbench.core.trace import Trace
from rri_nmf_tpu_torch.ops import sparse_kernels
from rri_nmf_tpu_torch.sklearn_interface import NMF_TM_Estimator

CELL = 'tm-nytimes.fit-phase'
RS_CELL = 'rs-ml1m.fit-sparse-obs'
CPU = torch.device('cpu')
SEED = 3_123_456_789
N, D, K = 400, 600, 8


def small(n=N, d=D, k=K, sweeps=10, **gen):
    """The cell at a small size, fit in float64 on the CPU through the
    gather kernel's layouts (``'auto'`` takes them on the card only)."""
    cell = Cell(CELL)
    cell.config.update(n=n, d=d, k=k)
    cell.config['gen'] = dict(cell.config['gen'], len_median=40,
                              len_max=400, n_topics=10, **gen)
    cell.workload['reference']['max_iter'] = sweeps
    cell.traffic['params'] = dict(max_iter=sweeps)
    cell.traffic['nmf_kwargs'] = dict(cell.traffic['nmf_kwargs'],
                                      sparse='mxu')
    torch.set_num_threads(2)
    return cell


def _corpus(cell, **kw):
    gen = cell.module('gen', cell.config['generator'])
    return gen.make(cell.config, SEED, CPU, **kw)[0]


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------

def test_generator_corpus():
    cell = small()
    X = _corpus(cell)
    assert sp.isspmatrix_csr(X) and X.shape == (N, D)
    assert X.dtype == np.float64 and X.has_sorted_indices
    assert X.nnz > 10 * N and (X.data > 0).all()
    np.testing.assert_allclose(sp.linalg.norm(X, axis=1), 1.0, rtol=1e-12)
    # no duplicate (document, word) pair
    assert X.copy().tocoo().tocsr().nnz == X.nnz


def test_generator_is_tfidf_of_its_draw():
    """The values are scikit-learn's TfidfTransformer defaults on the
    drawn counts (smooth idf, raw counts, l2 rows), computed here
    densely; the tokens are the documents' lengths."""
    cell = small()
    gen = cell.module('gen', cell.config['generator'])
    rows, cols, counts, tokens = gen.draw(cell.config, CPU)
    assert int(counts.sum()) == tokens
    C = np.zeros((N, D))
    C[rows.numpy(), cols.numpy()] = counts.numpy()
    df = (C > 0).sum(0)
    Y = C * (np.log((1.0 + N) / (1.0 + df)) + 1.0)
    Y /= np.linalg.norm(Y, axis=1, keepdims=True)
    np.testing.assert_allclose(_corpus(cell).toarray(), Y, rtol=1e-13,
                               atol=1e-15)


def test_generator_repeats_from_its_data_seed():
    cell = small()
    X1, X2 = _corpus(cell), _corpus(cell)
    assert (X1 != X2).nnz == 0
    other = small(data_seed=27)
    assert (_corpus(other) != X1).nnz > 0


def test_generator_allocates_no_n_by_d_array(monkeypatch):
    """Blocks of 16 documents: no allocation on the way reaches a quarter
    of an (n, d) float32 array."""
    cell = small()
    gen = cell.module('gen', cell.config['generator'])
    monkeypatch.setattr(gen, 'BLOCK_BYTES', 16 * D * 4)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU], profile_memory=True)
    with prof:
        X = gen.make(cell.config, SEED, CPU)[0]
    sizes = [e.nbytes() for e in prof.profiler.kineto_results.events()
             if e.name() == '[memory]']
    assert sizes and X.shape == (N, D)
    assert max(sizes) < N * D * 4 // 4, max(sizes)


def test_generator_numbers_words_apart_from_their_frequency():
    """Word ids follow no frequency order (the vocabulary file's order):
    the most frequent words lie spread over the ids, not packed at the
    front."""
    X = _corpus(small())
    df = np.bincount(X.indices, minlength=D)
    head = np.argsort(-df, kind='stable')[:10]
    assert head.max() > D // 2 and (np.diff(df) > 0).sum() > D // 4


@pytest.mark.parametrize('burst', [0.3, 0.6])
def test_generator_bursts(burst):
    """A word drawn into a document is counted ``1 + Poisson(burst)``
    times: about ``1 + burst`` tokens a draw, against a draw without
    bursts of that many documents' draws."""
    cell = small(burst=burst)
    gen = cell.module('gen', cell.config['generator'])
    _, _, counts, tokens = gen.draw(cell.config, CPU)
    g = cell.config['gen']
    cell.config['gen'] = dict(g, burst=0.0, len_median=g['len_median']
                              / (1.0 + burst))
    plain = gen.draw(cell.config, CPU)[3]
    assert tokens / plain == pytest.approx(1.0 + burst, rel=0.05)


def test_configuration_is_the_published_corpus():
    cell = Cell(CELL)
    assert cell.shape == (300_000, 102_660, 100)
    assert cell.config['nnz'] == 69_679_427
    assert cell.config['reduced'] == [] and cell.config['dtype'] == 'float32'
    assert cell.config['generator'] == 'tm_corpus_blocks'
    assert cell.traffic['nmf_kwargs'] == dict(update_order='phase',
                                              reset_topic_method=None)


# ---------------------------------------------------------------------------
# the reference and the fit
# ---------------------------------------------------------------------------

def test_sparse_start_is_the_dense_start():
    """The reference's start from the sparse X (randomized SVD through
    ``torch.sparse.mm``) is ``tm_interleaved.init``'s on the densified X."""
    cell = small()
    X = _corpus(cell)
    ref = cell.module('reference', 'tm_sparse_phase')
    dense = cell.module('reference', 'tm_interleaved')
    plain = cell.module('reference', 'plain')
    W, T = ref.init(X, K, 0, plain.Precision('float64'), CPU)
    Wd, Td = dense.init(dense.dense(X, torch.float64, CPU), K, 0)
    torch.testing.assert_close(W, Wd, rtol=0, atol=1e-10)
    torch.testing.assert_close(T, Td, rtol=0, atol=1e-10)


def _run(cell, trace=False):
    return run_cell(cell, SEED, 0.2, trace, CPU, 0.0, log=lambda msg: None)


def test_layout_fit_matches_the_reference():
    """The estimator's phase fit in float64 on the layouts (the gather
    kernel's plain twin) against the reference's ``torch.sparse.mm``
    sweeps: the same updates with sums in another order, ~1e-14 apart
    after 10 sweeps; 1e-8 leaves room for the order and none for a wrong
    update."""
    result, rows = _run(small())
    found = {name: value for name, value, _ in rows}
    assert result['correct'] is True, rows
    assert found['sweeps_gap'] == 0 and found['WT_gap'] < 1e-8, found


def test_gather_launches_two_a_sweep(monkeypatch):
    """Each sweep contracts X twice through ``gather_contract`` (counted
    here as the kernel's wrapper counts its launches on the card): WᵀX
    over the d word columns, then TXᵀ over the n documents."""
    calls = []
    real = sparse_kernels.gather_contract

    def counted(layout, Ft, k, ncols, vals=None):
        calls.append(ncols)
        return real(layout, Ft, k, ncols, vals)
    monkeypatch.setattr(sparse_kernels, 'gather_contract', counted)
    cell = small()
    X = _corpus(cell)
    est = NMF_TM_Estimator(N, D, K, max_iter=3, device='cpu',
                           nmf_kwargs=dict(update_order='phase',
                                           reset_topic_method=None,
                                           sparse='mxu'))
    est.fit(X)
    assert len(est.nmf_outputs['iter_cputime']) == 3
    assert calls == [D, N] * 3


@pytest.mark.cuda
def test_auto_takes_the_layouts_on_the_card(monkeypatch):
    """On the card ``sparse='auto'`` (the estimator's default) takes the
    gather kernel's layouts where the dense form exceeds 45% of the card
    (here a card reported at 1 MB, so the small corpus does): two gather
    launches a sweep and no densified X."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    card = torch.device('cuda', 0)
    real = torch.cuda.mem_get_info
    monkeypatch.setattr(torch.cuda, 'mem_get_info',
                        lambda device=None: (real(device)[0], 1 << 20))
    X = _corpus(small())
    sparse_kernels.reset_launches()
    est = NMF_TM_Estimator(N, D, K, max_iter=3, device=card,
                           nmf_kwargs=dict(update_order='phase',
                                           reset_topic_method=None))
    est.fit(X)
    assert sparse_kernels.LAUNCHES['gather'] == 2 * 3


def test_reference_and_generator_import_nothing_of_the_packages():
    code = '''
import sys
sys.path.insert(0, %r)
from portbench.core.spec import load_module
load_module('reference', 'tm_sparse_phase')
load_module('gen', 'tm_corpus_blocks')
print(','.join(sorted({m.split('.')[0] for m in sys.modules} & {
    'jax', 'jaxlib', 'flax', 'rri_nmf_tpu', 'rri_nmf_tpu_torch'})))
''' % str(ROOT)
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120, cwd='/')
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ''


# ---------------------------------------------------------------------------
# the yardstick
# ---------------------------------------------------------------------------

def test_gather_counts_by_hand():
    ref = load_module('reference', 'tm_sparse_phase')
    # 5 nonzeros of a (3, 4) X, k = 2: WᵀX gathers W's 3 rows into 4
    # columns: 2·5·2 operations; values and indices 5·(4 + 4) bytes, 5
    # column pointers, W (3·2) and the output (2·4) in float32
    assert ref.gather_counts(5, 3, 4, 2) == (20, 40 + 20 + (6 + 8) * 4)
    assert ref.gather_counts(5, 4, 3, 2, 8) == (20, 60 + 16 + (8 + 6) * 8)
    # the NYTimes cell's WᵀX: bytes bind, ~0.215 ms at 3.35 TB/s
    from portbench.core.roofline import bound
    t, by = bound(*ref.gather_counts(69_679_427, 300_000, 102_660, 100))
    assert by == 'bytes' and t * 1e3 == pytest.approx(0.2147, abs=1e-3)


def test_sweep_counts_of_the_sparse_route():
    cell = Cell(CELL)
    ref = cell.module('reference', 'tm_sparse_phase')
    n, d, k = cell.shape
    q = 69_679_427
    ops, nbytes = ref.sweep_counts(cell.config, {}, (sp.csr_matrix(
        (np.ones(3), ([0, 1, 2], [0, 1, 2])), shape=(n, d)),))
    assert ops == 2 * 2 * 3 * k + 4 * k * k * (n + d)
    ops, nbytes = ref.sweep_counts(
        cell.config, {}, (type('X', (), {'nnz': q})(),))
    assert ops == 4 * q * k + 4 * k * k * (n + d)
    assert nbytes == (2 * q * 8 + (d + 1 + n + 1) * 4
                      + 2 * (n + d) * k * 4 + 2 * (n * k + k * d) * 4)


# ---------------------------------------------------------------------------
# the span and the readers
# ---------------------------------------------------------------------------

def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_sparse_plan_span_nests_in_the_input_stage():
    cell = small()
    X = _corpus(cell)
    est = NMF_TM_Estimator(N, D, K, max_iter=2, device='cpu',
                           nmf_kwargs=dict(update_order='phase',
                                           reset_topic_method=None,
                                           sparse='mxu'))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        est.fit(X)
    spans = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith('rri.'):
            spans.setdefault(e.name(), []).append(
                (e.name(), e.start_ns(), e.end_ns()))
    (plan,), (inp,) = spans['rri.sparse.plan'], spans['rri.nmf.input']
    assert _inside(plan, inp)
    # the torch.sparse route builds no layouts
    est.nmf_kwargs = dict(est.nmf_kwargs, sparse=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        est.fit(X)
    assert not any(e.name() == 'rri.sparse.plan'
                   for e in prof.profiler.kineto_results.events())


GATHER = ('void gather_kernel<float, float, 32>(float const*, long, '
          'int const*, int const*, float const*, float*, long, int, int)')
HOST = [('portbench.traced_fit', 0.0, 1000.0), ('rri.nmf.input', 10.0, 300.0),
        ('rri.sparse.plan', 50.0, 250.0), ('rri.nmf.sweep', 300.0, 900.0)]
DEVICE = [(GATHER, 320.0, 420.0), ('void vectorized_gather_kernel<16>()',
                                   430.0, 440.0),
          (GATHER, 450.0, 490.0)]


def _reading(metric, host=HOST, device=DEVICE, trace=True,
             nnz=69_679_427):
    tr = Trace(device=list(device), host=list(host), start=0.0, end=1000.0,
               sweeps=1) if trace else None
    X = type('X', (), {'nnz': nnz})()
    run = Run(cell=Cell(CELL), setup_s=1.0, fits=[Fit(1.0, [0.2, 0.4])],
              inputs=(X,), trace=tr)
    return load_module('metrics', metric).read(run)


def test_sparse_plan_reader():
    assert _reading('sparse_plan_s') == pytest.approx(200e-6)


def test_gather_roofline_reader():
    """One sweep's two launches (140 µs in all; PyTorch's own
    ``vectorized_gather_kernel`` left out): each at its contraction's
    bytes at 3.35 TB/s."""
    ref = load_module('reference', 'tm_sparse_phase')
    q, n, d, k = 69_679_427, 300_000, 102_660, 100
    least = (ref.gather_counts(q, n, d, k)[1]
             + ref.gather_counts(q, d, n, k)[1]) / 3.35e12
    assert _reading('gather_roofline') == pytest.approx(
        100 * least / 140e-6)
    # a launch count that is not whole sweeps reads nothing
    assert _reading('gather_roofline', device=DEVICE[:2]) is None


@pytest.mark.parametrize('metric', ['sparse_plan_s', 'gather_roofline'])
def test_no_span_no_kernel_no_reading(metric):
    """A program without the span (the parent's), a route without the
    kernel, or a run without a trace reads ``None``; nothing raises."""
    bare = [h for h in HOST if h[0] != 'rri.sparse.plan']
    assert _reading(metric, trace=False) is None
    assert _reading(metric, host=bare, device=DEVICE[1:2]) is None


# ---------------------------------------------------------------------------
# rs-ml1m.fit-sparse-obs
# ---------------------------------------------------------------------------

def test_sparse_obs_cell_loads():
    cell = Cell(RS_CELL)
    assert cell.config['name'] == 'rs-ml1m' and cell.chips == 1
    assert cell.traffic['params'] == {'sparse_obs': True}
    assert cell.traffic['nmf_kwargs'] == {}
    assert cell.workload['reference']['path'] == 'rs_masked'
    assert cell.workload['control'] == 'reference_tf32'
    assert [m['name'] for m in cell.end_to_end] == ['fit_s.rs', 'setup_s']
    names = {m['name'] for m in cell.per_layer}
    assert {'sweep_ms.rs', 'device_idle_pct.rs', 'input_s.rs'} <= names
    assert 'b3b4_roofline' not in names


def test_sparse_obs_fit_matches_the_dense_mask_reference(monkeypatch):
    """The estimator with ``sparse_obs=True`` runs the O(nnz) sweep (and
    no dense-mask sweep) and computes the dense-mask reference's updates
    in the same order: float64 on the CPU, the held-out RMSE ~1e-15
    apart, the same sweeps kept."""
    built = []
    for name in ('make_masked_sparse_sweep', 'make_masked_sweep'):
        real = getattr(nmf_mod, name)

        def spy(*args, _name=name, _real=real, **kwargs):
            built.append(_name)
            return _real(*args, **kwargs)
        monkeypatch.setattr(nmf_mod, name, spy)
    cell = Cell(RS_CELL)
    cell.config.update(n=150, d=100, n_obs=4000, k=5)
    cell.config['gen'] = dict(cell.config['gen'], max_per_user=80,
                              zipf_q=10.0)
    torch.set_num_threads(2)
    result, rows = _run(cell)
    found = {name: value for name, value, _ in rows}
    assert set(built) == {'make_masked_sparse_sweep'}
    assert result['correct'] is True, rows
    assert found['sweeps_gap'] == 0 and found['rmse_gap'] < 1e-9, found
