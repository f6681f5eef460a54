#!/usr/bin/env python3
"""Time builds of the Gram kernel (``csrc/gram.cu``) against the gather
kernel on the materialized Khatri-Rao rows and ``torch.sparse.mm``, on
one card, in turns.

Run from the root of a checkout, on a machine with a CUDA card::

    python3 tools/bench_gram_kernel.py [--runs 5] [--variants default,u1]
        [--baseline DIR ...]

Each variant compiles ``gram.cu`` with ``nvcc`` and its ``-D`` flags
(:data:`VARIANTS`: the tile side, the nonzeros in flight, the block size)
into its own library under ``build/bench_gram/``, all at once; ``default``
is the source's own flags. The sources: the package's ``csrc``, and each
``--baseline DIR`` (e.g. an earlier commit's ``csrc`` unpacked with
``git archive`` into a directory that ``.gitignore`` lists), which must
have the Gram kernel's interface. The problem is ``chip_smoke.py``'s recorded
sparse mask (100,000×50,000, 25M observations, its Gram plan on the
card). Cases, float32: Γ and Θ at k=32 (the 528 unique rows) and the
first 52-topic panel at k=128 (6656 rows) of each; float64: Γ at k=32.
Per case it prints one JSON line for each variant and for the gather
kernel on the materialized rows (``sparse_kernels.gather_contract``, the
rows built beforehand) and ``torch.sparse.mm`` of the mask by them: the
median and all CUDA-event ms of one call (in turns), and the largest
difference from the gather kernel relative to its largest entry; a
variant's line also says whether two launches gave the same bits. Each
variant's ``-Xptxas -v`` lines are printed first.

With ``--cell rs-ml25m`` it times the benchmark cell's own mask instead:
the configuration ``portbench/configs/rs-ml25m.json`` drawn by its
generator (``portbench/gen/rs_ratings_half.py``, on the card; nothing is
downloaded), its Gram plan, and per direction (Γ over the movies, Θ over
the users) and per panel of the fit's k=128 split, each build in turns:
every ``--baseline`` source as it is, and the package's at each chunk
share of ``--shares`` (L = max(``CHUNK_FLOOR``, ⌈nnz / (resident teams ·
share)⌉), ``sparse_kernels.chunk_length``'s rule at another share; ``0``:
L past every column, each column whole). It prints the longest column of each layout
(from its ``colptr``), each panel's work list (L, split columns, chunks,
longest item), the largest difference from the first build relative to
its largest entry, and whether two launches gave the same bits.

A source whose ``gram.cu`` has no ``rri_gram_resident`` entry (before the
work list) is called with its own arguments.

With ``--trees A,B`` it then runs ``chip_smoke.py``'s phase 18 (the
Gram-phase fit at k=32, the O(nnz) fit and the k=128 panel sweep on the
same problem, each tree's own code and build) in the trees A, B, B, A,
one process each, their output passed through: e.g. ``--trees
build/parent,.`` with ``build/parent`` an earlier commit's
``chip_smoke.py`` and ``rri_nmf_tpu_torch`` unpacked with ``git
archive``. ``--skip-kernels`` skips the kernel timings.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from rri_nmf_tpu_torch.ops import _build  # noqa: E402
from rri_nmf_tpu_torch.ops import sparse_kernels as sk  # noqa: E402
from rri_nmf_tpu_torch.ops import sweep_masked_gram as mg  # noqa: E402

OUT_DIR = REPO / 'build' / 'bench_gram'
VARIANTS = {
    'default': [],
    'u1': ['-DGC_U=1'],
    'u4': ['-DGC_U=4', '-DGC_MIN_BLOCKS=1'],
    'ti4': ['-DGC_TI_F32=4'],
    'ti16': ['-DGC_TI_F32=16', '-DGC_MIN_BLOCKS=1'],
    't128': ['-DGC_THREADS=128', '-DGC_MIN_BLOCKS=4'],
}


def build(names, sources):
    """Each variant of each source's ``gram.cu`` (``{tag: directory}``)
    into ``lib<tag>_<variant>.so``, all nvcc processes at once;
    {'tag/variant': library}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for tag, src in sources.items():
        for variant in names:
            name = '%s/%s' % (tag, variant)
            lib = OUT_DIR / ('lib%s_%s.so' % (tag, variant))
            cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS,
                   *VARIANTS[variant], '-Xptxas=-v', '-shared', '-o',
                   str(lib), str(Path(src) / 'gram.cu')]
            jobs[name] = (lib, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
    libs = {}
    for name, (lib, cmd, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError('nvcc failed: %s\n%s' % (' '.join(cmd), err))
        print(json.dumps({'build': name,
                          'ptxas': [ln.strip() for ln in err.splitlines()
                                    if 'registers' in ln or 'spill' in ln
                                    or 'Compiling entry' in ln]}),
              flush=True)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


# the C entry before the work list: Ft, colptr, gidx, vals, out; k, ldf,
# t0, p, ncols, device, stream
OLD_SIGNATURE = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def tile_side(variant, dtype):
    """The tile side of a variant's build in ``dtype``."""
    if dtype == torch.float64:
        return 4
    for flag in VARIANTS[variant]:
        if flag.startswith('-DGC_TI_F32='):
            return int(flag.split('=')[1])
    return 8


def launcher(lib, dtype, ti=None, share=sk.CHUNK_SHARE):
    """A build's ``(layout, Ft, k, panel, ncols) -> out``; ``ti`` its
    tile side in ``dtype`` (default the package's); a build with a work
    list cuts at the chunk length of ``share`` (:func:`work_length`).
    ``sparse_kernels.gram_args`` sizes the chunk scratch for the
    package's tile side, so a build of another side runs only lists that
    cut no column."""
    suffix = _build.SUFFIX[dtype]
    fn = getattr(lib, 'rri_gram_contract_' + suffix)
    resident = getattr(lib, 'rri_gram_resident_' + suffix, None)
    if resident is None:
        fn.argtypes = OLD_SIGNATURE
    else:
        fn.argtypes = _build.SIGNATURES['rri_gram_contract_' + suffix]
        resident.argtypes = _build.SIGNATURES['rri_gram_resident_' + suffix]
        resident.restype = ctypes.c_int
    fn.restype = ctypes.c_int
    # rows of 64 bytes: whole tiles of every variant (up to 16 float32)
    w = 64 // torch.empty(0, dtype=dtype).element_size()
    ti = ti or 32 // torch.empty(0, dtype=dtype).element_size()

    def call(lay, Ft, k, panel, ncols):
        kp = -(-k // w) * w
        rows = Ft
        if not (Ft.is_contiguous() and Ft.shape[1] == kp):
            rows = Ft.new_zeros(Ft.shape[0], kp)
            rows[:, :k] = Ft
        t0, p = (0, 0) if panel is None else panel
        index = Ft.get_device()
        if resident is None:
            nrows = sk.gram_pairs(k, panel)[0].shape[0]
            out = torch.empty(nrows, ncols, dtype=dtype, device=Ft.device)
            args = (rows.data_ptr(), lay.colptr.data_ptr(),
                    lay.gidx.data_ptr(), lay.vals.data_ptr(),
                    out.data_ptr(), k, kp, t0, p, ncols)
        else:
            work = lay.gram_work(work_length(resident, lay, k, t0, p, index,
                                             share))
            if work.n_split and ti != 32 // rows.element_size():
                raise ValueError('a build of tile side %d on a list that '
                                 'cuts a column' % ti)
            out, args, part = sk.gram_args(lay, work, rows, k, t0, p, ncols)
        err = fn(*args, index, _build._raw_stream(index))
        if resident is not None:
            del part  # enqueued
        if err:
            raise RuntimeError('launch failed: CUDA error %d' % err)
        return out
    return call


def work_length(resident, lay, k, t0, p, index, share):
    """The chunk length a build with a work list takes on ``lay``:
    :func:`chunk_at` the build's resident teams; past every column for
    ``share`` 0."""
    if not share:
        return lay.gidx.shape[0] + 1
    return chunk_at(lay.gidx.shape[0], resident(k, t0, p, index), share)


def chunk_at(nnz, teams, share):
    """``sparse_kernels.chunk_length``'s rule at a ``share``-th of a
    balanced share: max(CHUNK_FLOOR, ⌈nnz / (teams · share)⌉)."""
    return max(sk.CHUNK_FLOOR, -(-int(nnz) // (max(int(teams), 1) * share)))


def in_turns(fns, dev, runs):
    """{name: [ms of one call]}: each function once per round, rounds in
    alternating order."""
    ms = {name: [] for name in fns}
    for name in fns:
        fns[name]()
    torch.cuda.synchronize(dev)
    order = list(fns)
    for r in range(runs):
        for name in (order if r % 2 == 0 else order[::-1]):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fns[name]()
            b.record()
            b.synchronize()
            ms[name].append(a.elapsed_time(b))
    return ms


PHASE_18 = """
import time, torch, chip_smoke as c
from rri_nmf_tpu_torch.ops import sweep_masked_gram as mg
from rri_nmf_tpu_torch.ops import sparse_kernels as sk
from rri_nmf_tpu_torch.ops import sweep_masked_sparse as ms
from rri_nmf_tpu_torch.nmf import nmf
d = torch.device('cuda')
X, M = c.masked_record_problem(*c.MASKED_RECORD[:3])
t = time.perf_counter()
p = mg.plan_masked_gram(X, M, torch.float32, backend='mxu', device=d)
c.run_masked_record_phase(d, sk, nmf, mg, ms, X, M, p,
                          time.perf_counter() - t)
"""


def phase_18_in_turns(trees):
    """Phase 18 in the trees A, B, B, A, one process each."""
    a, b = trees
    for tree in (a, b, b, a):
        print(json.dumps({'phase 18 in tree': tree}), flush=True)
        subprocess.run([sys.executable, '-c', PHASE_18], cwd=tree,
                       check=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--runs', type=int, default=5)
    ap.add_argument('--variants', default='default',
                    help='comma-separated names of VARIANTS (default: '
                    'default; all: %s)' % ','.join(VARIANTS))
    ap.add_argument('--baseline', action='append', default=[],
                    metavar='DIR', help='also build DIR/gram.cu (e.g. an '
                    'earlier commit\'s csrc), tagged by its directory name')
    ap.add_argument('--trees', default=None, metavar='A,B',
                    help='then phase 18 of chip_smoke.py in the trees A, '
                    'B, B, A')
    ap.add_argument('--skip-kernels', action='store_true')
    ap.add_argument('--cell', default=None, metavar='CONFIG',
                    help='time the mask of portbench/configs/CONFIG.json '
                    '(e.g. rs-ml25m) instead of the recorded problem')
    ap.add_argument('--shares', default='8', help='with --cell: the '
                    'chunk shares of the package\'s build, comma-separated '
                    '(0: no work list)')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('bench_gram_kernel.py: no CUDA device')
    dev = torch.device('cuda', 0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({'card': smi}), flush=True)
    if args.cell:
        cell_mask(args, dev)
        torch.cuda.empty_cache()
    elif not args.skip_kernels:
        kernels(args, dev)
        torch.cuda.empty_cache()
    if args.trees:
        phase_18_in_turns(args.trees.split(','))


def kernels(args, dev):
    """The kernel timings: every variant of every source, in turns."""
    sources = {'package': _build.CSRC_DIR}
    sources.update({Path(d).name: d for d in args.baseline})
    libs = build(args.variants.split(','), sources)
    names = list(libs)
    n, d, q, k = chip_smoke.MASKED_RECORD
    X, M = chip_smoke.masked_record_problem(n, d, q, seed=0)
    lib_masks = None
    for dtype in (torch.float32, torch.float64):
        t0 = time.perf_counter()
        plan = mg.plan_masked_gram(X, M, dtype, backend='mxu', device=dev)
        torch.cuda.synchronize(dev)
        print(json.dumps({'plan': str(dtype), 'seconds':
                          time.perf_counter() - t0, 'nnz': plan.nnz}),
              flush=True)
        lib_masks = chip_smoke.library_masks(plan)
        calls = {name: launcher(libs[name], dtype,
                                tile_side(name.split('/')[1], dtype))
                 for name in names}
        rng = np.random.RandomState(3)
        kp = chip_smoke.MASKED_PANEL_K
        panel = mg.auto_panel(kp, n, d, 4)
        W = torch.as_tensor(rng.rand(n, kp), dtype=dtype, device=dev)
        T = torch.as_tensor(rng.rand(kp, d), dtype=dtype, device=dev)
        cases = [('Gamma', 't', W[:, :k].contiguous(), k, None, d),
                 ('Theta', 'w', T[:k].T.contiguous(), k, None, n),
                 ('Gamma panel', 't', W, kp, (0, panel), d),
                 ('Theta panel', 'w', T.T.contiguous(), kp, (0, panel), n)]
        if dtype == torch.float64:
            cases = cases[:1]
        for label, side, Ft, kk, pan, ncols in cases:
            pl = plan.m_t if side == 't' else plan.m_w
            a, b = (x.to(dev) for x in sk.gram_pairs(kk, pan))
            KR = Ft[:, a] * Ft[:, b]
            rows = KR.shape[1]
            want = sk.gather_contract(pl, KR, rows, ncols)
            scale = float(want.abs().max())
            S = lib_masks[(side, False)]
            fns = {name: (lambda c=calls[name]: c(pl, Ft, kk, pan, ncols))
                   for name in names}
            fns['gather on the rows'] = lambda: sk.gather_contract(
                pl, KR, rows, ncols)
            fns['torch.sparse.mm'] = lambda: torch.sparse.mm(S, KR)
            first = None
            for name in names:
                got, again = fns[name](), fns[name]()
                torch.cuda.synchronize(dev)
                err = float((got - want).abs().max()) / scale
                if first is None:
                    first = got
                print(json.dumps({'case': label, 'dtype': str(dtype),
                                  'rows': rows, 'variant': name,
                                  'rel_err_vs_gather': err,
                                  'bitwise_repeat': bool(
                                      torch.equal(got, again)),
                                  'bitwise_equal_to_' + names[0]: bool(
                                      torch.equal(got, first))}),
                      flush=True)
                del got, again
            del first
            ms = in_turns(fns, dev, args.runs)
            nnz = pl.gidx.shape[0]
            for name, v in ms.items():
                print(json.dumps({'case': label, 'dtype': str(dtype),
                                  'rows': rows, 'k': kk, 'nnz': nnz,
                                  'which': name,
                                  'ms': float(np.median(v)), 'all_ms': v,
                                  'gflop_per_s': 2 * nnz * rows
                                  / float(np.median(v)) / 1e6}),
                      flush=True)
            del KR, want
        del plan, lib_masks, W, T


def cell_mask(args, dev):
    """Γ and Θ of a benchmark configuration's mask, per panel of its
    fit's split, each build in turns (``--cell``)."""
    import scipy.sparse as sp
    from portbench.core.spec import load_module
    cfg = json.loads((REPO / 'portbench' / 'configs'
                      / (args.cell + '.json')).read_text())
    t0 = time.perf_counter()
    pairs, stars = load_module('gen', cfg['generator']).make(cfg, 0, dev)
    n, d, k = int(cfg['n']), int(cfg['d']), int(cfg['k'])
    X = sp.csr_matrix((stars, (pairs[:, 0], pairs[:, 1])), shape=(n, d))
    M = X.copy()
    M.data[:] = 1.0
    del pairs, stars
    plan = mg.plan_masked_gram(X, M, torch.float32, backend='mxu',
                               device=dev)
    torch.cuda.synchronize(dev)
    print(json.dumps({'cell mask': args.cell, 'n': n, 'd': d,
                      'nnz': plan.nnz, 'seconds': time.perf_counter() - t0,
                      'longest_column': {
                          side: int(torch.diff((plan.m_t if side == 'Gamma'
                                                else plan.m_w).colptr.long())
                                    .max())
                          for side in ('Gamma', 'Theta')}}), flush=True)
    del X, M
    sources = dict((Path(b).name, b) for b in args.baseline)
    sources['package'] = _build.CSRC_DIR
    libs = build(['default'], sources)
    calls = {}
    for name, lib in libs.items():
        if name.startswith('package/'):
            for share in (int(x) for x in args.shares.split(',')):
                calls['package 1/%d' % share if share else 'package whole'] \
                    = launcher(lib, torch.float32, share=share)
        else:
            calls[name] = launcher(lib, torch.float32)
    names = list(calls)
    rng = np.random.RandomState(3)
    W = torch.as_tensor(rng.rand(n, k), dtype=torch.float32, device=dev)
    Tt = torch.as_tensor(rng.rand(d, k), dtype=torch.float32, device=dev)
    step = mg.auto_panel(k, n, d, 4) or k
    nnz = plan.nnz
    for label, lay, Ft, ncols in (('Gamma', plan.m_t, W, d),
                                  ('Theta', plan.m_w, Tt, n)):
        for t0 in range(0, k, step):
            panel = (t0, min(step, k - t0))
            rows = panel[1] * k
            index = dev.index or 0
            teams = sk.resident_teams(torch.float32, k, *panel, index)
            for share in (int(x) for x in args.shares.split(',') if x != '0'):
                work = lay.gram_work(chunk_at(nnz, teams, share))
                print(json.dumps({'case': label, 'panel': panel,
                                  'resident_teams': teams, 'share': share,
                                  'L': work.length, 'split': work.n_split,
                                  'chunks': work.n_chunks,
                                  'longest_item': work.longest}),
                      flush=True)
            fns = {name: (lambda c=calls[name]: c(lay, Ft, k, panel, ncols))
                   for name in names}
            first = fns[names[0]]()
            scale = float(first.abs().max())
            for name in names:
                got, again = fns[name](), fns[name]()
                torch.cuda.synchronize(dev)
                print(json.dumps({
                    'case': label, 'panel': panel, 'which': name,
                    'rel_err_vs_' + names[0]:
                        float((got - first).abs().max()) / scale,
                    'bitwise_equal_to_' + names[0]: bool(
                        torch.equal(got, first)),
                    'bitwise_repeat': bool(torch.equal(got, again))}),
                    flush=True)
                del got, again
            del first
            ms = in_turns(fns, dev, args.runs)
            for name, v in ms.items():
                med = float(np.median(v))
                print(json.dumps({'case': label, 'panel': panel,
                                  'rows': rows, 'nnz': nnz, 'which': name,
                                  'ms': med, 'all_ms': v,
                                  'bound_share_pct': 100 * 2 * nnz * rows
                                  / 67e12 / (med / 1e3)}), flush=True)


if __name__ == '__main__':
    main()
