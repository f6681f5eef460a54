"""The benchmark's files, found by name.

``BENCHMARK.json`` at the checkout's root names the cells, their
configurations and their metrics. Everything that belongs to one of them
sits in a file of its own under ``portbench/``:

- ``configs/<config>.json``: the dataset (shapes, dtype, the generator
  and its parameters, the estimator that fits it, ``assumed``);
- ``workloads/<cell>.json``: the plain-reference path and the limits of
  the comparison that decides ``correct``;
- ``traffic/<traffic>.json``: how the fits are issued (the estimator's
  keyword arguments, the warm-up fit);
- ``gen/<generator>.py``: ``make(config, seed, device)``;
- ``reference/<path>.py``: ``fit(inputs, config, preset, random_state,
  device, precision)`` and ``sweep_counts(config, preset, inputs)``;
- ``metrics/<metric>.py``: ``read(run)``.

Adding a cell, a configuration, a traffic mix or a metric adds files and
entries; no file here changes.
"""

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')


def _json(path):
    with open(path) as f:
        return json.load(f)


def _checked(name, what):
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError('bad %s name %r' % (what, name))
    return name


def load_module(kind, name, base=BENCH_DIR):
    """The module ``<base>/<kind>/<name>.py`` (``base``: the
    ``portbench`` folder), loaded by its path: a name may hold dots."""
    path = Path(base) / kind / (_checked(name, kind) + '.py')
    if not path.is_file():
        raise FileNotFoundError('no %s %r (%s)' % (kind, name, path))
    mod_name = 'portbench_%s_%s' % (kind, re.sub(r'\W', '_', name))
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell(object):
    """One entry of ``BENCHMARK.json``'s ``workloads`` with everything its
    files hold: ``config``, ``traffic`` and ``workload`` (dicts),
    ``end_to_end`` and ``per_layer`` (the metric entries that this cell
    reports, in ``BENCHMARK.json``'s order)."""

    def __init__(self, name, root=ROOT):
        root = Path(root)
        bench = _json(root / 'BENCHMARK.json')
        entries = [w for w in bench['workloads'] if w['name'] == name]
        if len(entries) != 1:
            raise KeyError('no cell %r in BENCHMARK.json' % (name,))
        self.entry = entries[0]
        self.name = name
        self.chips = int(self.entry['chips'])
        self.run_seconds = int(bench['run_seconds'])
        self.base = base = root / 'portbench'
        self.config = _json(base / 'configs' / (
            _checked(self.entry['config'], 'config') + '.json'))
        self.traffic = _json(base / 'traffic' / (
            _checked(self.entry['traffic'], 'traffic') + '.json'))
        self.workload = _json(base / 'workloads' / (
            _checked(name, 'cell') + '.json'))
        if self.workload.get('config') != self.entry['config'] or \
                self.workload.get('traffic') != self.entry['traffic']:
            raise ValueError('workloads/%s.json names another config or '
                             'traffic than BENCHMARK.json' % name)

        def mine(m):
            return 'workloads' not in m or name in m['workloads']
        self.end_to_end = [m for m in bench['end_to_end'] if mine(m)]
        self.per_layer = [m for m in bench['per_layer'] if mine(m)]

    def module(self, kind, name):
        """``<kind>/<name>.py`` of this cell's ``portbench`` folder."""
        return load_module(kind, name, self.base)

    @property
    def shape(self):
        """``(n, d, k)`` of the fit."""
        c = self.config
        return int(c['n']), int(c['d']), int(c['k'])
