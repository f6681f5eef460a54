"""The benchmark's readers of the program's ``rri.*`` spans
(``portbench/core/spans.py``, ``portbench/metrics/``) on a synthetic
traced fit: each reader's value, ``None`` where the spans are absent (a
program from before them), the recommender's ``.rs`` readers equal to
their base readers, the idle share counted inside sweep spans only, and
the breakdown naming an idle gap by the stage under way."""

from types import SimpleNamespace

import pytest

from portbench.core import spans
from portbench.core.harness import Fit, Run
from portbench.core.spec import Cell, load_module
from portbench.core.trace import Trace

# a fit in µs, each span starting after the one it nests in: prepare,
# input, init, plan, a loop-top score, two sweeps (the first captures its
# graph; each scores its objective), the score that stops the fit, and
# finish
STAGES = [('rri.fit.prepare', 12.0, 100.0), ('rri.nmf.input', 101.0, 150.0),
          ('rri.nmf.init', 150.0, 300.0), ('rri.nmf.plan', 300.0, 350.0),
          ('rri.nmf.score', 350.0, 370.0), ('rri.nmf.sweep', 370.0, 600.0),
          ('rri.nmf.score', 600.0, 620.0), ('rri.nmf.sweep', 620.0, 900.0),
          ('rri.nmf.score', 900.0, 910.0), ('rri.nmf.finish', 910.0, 980.0)]
HOST = [('portbench.traced_fit', 0.0, 1000.0), ('rri.fit', 10.0, 990.0),
        ('rri.nmf', 100.0, 980.0)] + STAGES + [
    ('rri.sweep.capture', 380.0, 450.0), ('rri.nmf.score', 560.0, 600.0),
    ('aten::mm', 700.0, 720.0), ('rri.nmf.score', 880.0, 900.0)]
DEVICE = [('k_init', 160.0, 290.0), ('k_sweep', 450.0, 550.0),
          ('k_sweep', 630.0, 870.0), ('k_finish', 920.0, 970.0)]
READERS = ('input_s', 'init_s', 'sweep_idle_pct', 'capture_s')
RS_READERS = ('input_s.rs', 'init_s.rs', 'sweep_idle_pct.rs', 'score_ms.rs')


def _trace(host=HOST, device=DEVICE):
    return Trace(device=list(device), host=list(host), start=0.0,
                 end=1000.0, sweeps=1)


def _run(cell, trace):
    return Run(cell=Cell(cell), setup_s=1.0, fits=[Fit(1.0, [0.2, 0.4])],
               inputs=(SimpleNamespace(nnz=1000),), trace=trace)


def _read(metric, run):
    return load_module('metrics', metric).read(run)


def test_stage_readers():
    run = _run('tm-20ng.fit', _trace())
    # prepare 88 + input 49 + plan 50 µs
    assert _read('input_s', run) == pytest.approx(187e-6)
    assert _read('init_s', run) == pytest.approx(150e-6)
    assert _read('capture_s', run) == pytest.approx(70e-6)
    # idle inside the sweeps: 370-450 and 550-600 of the first (230 µs),
    # 620-630 and 870-900 of the second (280 µs)
    assert _read('sweep_idle_pct', run) == pytest.approx(
        100 * 170 / 510)


def test_score_reader():
    run = _run('rs-ml1m.fit', _trace())
    # loop-top 20 + 20 + 10, in the sweeps 40 + 20 µs, over 2 sweeps
    assert _read('score_ms.rs', run) == pytest.approx(110e-3 / 2)


@pytest.mark.parametrize('metric', ('input_s', 'init_s', 'sweep_idle_pct'))
def test_rs_readers_equal_their_base(metric):
    run = _run('rs-ml1m.fit', _trace())
    assert _read(metric + '.rs', run) == _read(metric, run)
    assert _read(metric + '.rs', run) is not None


@pytest.mark.parametrize('metric', READERS + RS_READERS)
def test_no_spans_no_reading(metric):
    """A program without the spans, or a run without a trace, reads
    ``None``, and nothing raises."""
    cell = 'rs-ml1m.fit' if metric.endswith('.rs') else 'tm-20ng.fit'
    bare = [h for h in HOST if not h[0].startswith('rri.')]
    assert _read(metric, _run(cell, _trace(host=bare))) is None
    assert _read(metric, _run(cell, None)) is None


def test_sweep_idle_counts_only_gaps_inside_sweeps():
    # a long idle stretch outside every sweep (the init's kernel gone)
    # leaves the sweeps' idle share as it was
    fewer = [d for d in DEVICE if d[0] != 'k_init']
    run = _run('tm-20ng.fit', _trace(device=fewer))
    assert _read('sweep_idle_pct', run) == pytest.approx(100 * 170 / 510)
    # a kernel through the first sweep's idle stretch lowers it
    more = DEVICE + [('k_more', 370.0, 450.0)]
    run = _run('tm-20ng.fit', _trace(device=more))
    assert _read('sweep_idle_pct', run) == pytest.approx(100 * 90 / 510)
    # no device operation at all: nothing to read
    assert _read('sweep_idle_pct', _run('tm-20ng.fit',
                                        _trace(device=[]))) is None


def test_spans_helpers():
    tr = _trace()
    assert spans.intervals(tr, 'rri.nmf.sweep') == [(370.0, 600.0),
                                                     (620.0, 900.0)]
    assert spans.seconds(tr, 'rri.nope') is None
    assert spans.merged([(5, 7), (0, 2), (1, 3)]) == [(0, 3), (5, 7)]
    assert spans.overlap([(0, 10), (20, 30)], [(5, 25)]) == 10
    # spans are cut to the traced window
    cut = Trace(device=[], host=[('rri.nmf.init', -50.0, 50.0)], start=0.0,
                end=100.0)
    assert spans.seconds(cut, 'rri.nmf.init') == pytest.approx(50e-6)


def test_breakdown_names_gaps_by_stage():
    """An idle gap under an ``rri.*`` span with no torch operation under
    way is named by that span, beside the benchmark's own."""
    gaps = dict(_trace().breakdown()['idle_gaps'])
    assert gaps == {
        'portbench.traced_fit/rri.fit.prepare': pytest.approx(160e-6),
        'portbench.traced_fit/rri.nmf.sweep': pytest.approx(160e-6),
        'portbench.traced_fit/rri.nmf.score': pytest.approx(130e-6),
        'portbench.traced_fit/rri.fit': pytest.approx(30e-6)}
    assert 'portbench.traced_fit' not in gaps
