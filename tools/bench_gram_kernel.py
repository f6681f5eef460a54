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


def launcher(lib, dtype):
    """A variant's ``(layout, Ft, k, panel, ncols) -> out``."""
    suffix = _build.SUFFIX[dtype]
    fn = getattr(lib, 'rri_gram_contract_' + suffix)
    fn.argtypes = _build.SIGNATURES['rri_gram_contract_' + suffix]
    fn.restype = ctypes.c_int
    # rows of 64 bytes: whole tiles of every variant (up to 16 float32)
    ti = 64 // torch.empty(0, dtype=dtype).element_size()

    def call(lay, Ft, k, panel, ncols):
        kp = -(-k // ti) * ti
        rows = Ft
        if not (Ft.is_contiguous() and Ft.shape[1] == kp):
            rows = Ft.new_zeros(Ft.shape[0], kp)
            rows[:, :k] = Ft
        t0, p = (0, 0) if panel is None else panel
        nrows = sk.gram_pairs(k, panel)[0].shape[0]
        out = torch.empty(nrows, ncols, dtype=dtype, device=Ft.device)
        index = Ft.get_device()
        err = fn(rows.data_ptr(), lay.colptr.data_ptr(), lay.gidx.data_ptr(),
                 lay.vals.data_ptr(), out.data_ptr(), k, kp, t0, p, ncols,
                 index, _build._raw_stream(index))
        if err:
            raise RuntimeError('launch failed: CUDA error %d' % err)
        return out
    return call


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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('bench_gram_kernel.py: no CUDA device')
    dev = torch.device('cuda', 0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({'card': smi}), flush=True)
    if not args.skip_kernels:
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
        calls = {name: launcher(libs[name], dtype) for name in names}
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
            for name in names:
                got, again = fns[name](), fns[name]()
                torch.cuda.synchronize(dev)
                err = float((got - want).abs().max()) / scale
                print(json.dumps({'case': label, 'dtype': str(dtype),
                                  'rows': rows, 'variant': name,
                                  'rel_err_vs_gather': err,
                                  'bitwise_repeat': bool(
                                      torch.equal(got, again))}),
                      flush=True)
                del got, again
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


if __name__ == '__main__':
    main()
