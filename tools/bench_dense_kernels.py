#!/usr/bin/env python3
"""Time builds of the dense kernels B1 (``csrc/gs.cu``) and B2
(``csrc/tm_proj.cu``) against each other on one card, in turns.

Run from the root of a checkout, on a machine with a CUDA card::

    python3 tools/bench_dense_kernels.py [--baseline DIR] [--runs 7]

Each build compiles ``gs.cu`` and ``tm_proj.cu`` with ``nvcc`` into its
own library under ``build/bench_dense/``: ``current`` from the
package's sources, and ``baseline`` from ``DIR`` (e.g. an earlier
commit's ``rri_nmf_tpu_torch/csrc``, unpacked with ``git archive`` into a
directory that ``.gitignore`` lists). Either launch interface of B2 is
accepted: with the scratch argument, or the earlier one without it.

At the main path's shapes in float32 (B1 at the T- and W-phases of
``nmf()`` 16384x8192 k=128, the TM fit's W-phase and the sparse fit's
W-phase; B2 at the TM fit's T-phase and at k=128, d=8192, and at the TM
shape on rows that are already feasible, one row-wide reduction per
topic, which with the first case prices a reduction) every build
runs on the same inputs (numpy seeds), its output is compared with the
first build's, and CUDA-event times are taken over ``--runs`` rounds,
the builds in turns (forward, then backward). Prints the card's name and
power limit, one JSON line per case and build (median and all ms, max
abs difference from the first build), the Michelot round counts of each
B2 case (``chip_smoke.michelot_rounds``) and, per build, the ms of one
row-wide reduction of B2 (the regular TM case less the feasible one,
over the reductions the regular case takes beyond one per topic), and one
summary JSON line.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from chip_smoke import michelot_rounds  # noqa: E402
from rri_nmf_tpu_torch.ops import _build  # noqa: E402

OUT_DIR = REPO / 'build' / 'bench_dense'
# (label, k, m) of B1 and (label, k, d) of B2
GS_SHAPES = [('nmf T-phase', 128, 8192), ('nmf W-phase', 128, 16384),
             ('TM W-phase', 50, 11314), ('sparse W-phase', 128, 50000)]
TM_SHAPES = [('TM T-phase', 50, 26214), ('k=128 d=8192', 128, 8192),
             ('TM T-phase, every row feasible', 50, 26214)]
INF = float('inf')


def build(name, src_dir):
    """``gs.cu`` and ``tm_proj.cu`` of ``src_dir`` into one library."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    objs, procs = [], []
    for src in ('gs.cu', 'tm_proj.cu'):
        obj = OUT_DIR / ('%s_%s.o' % (name, src[:-3]))
        cmd = [nvcc, *_build.NVCC_FLAGS, '-Xptxas=-v', '-c', '-o',
               str(obj), str(Path(src_dir) / src)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE,
                                            text=True)))
        objs.append(str(obj))
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError('nvcc failed: %s\n%s' % (' '.join(cmd), err))
        ptxas = [ln for ln in err.splitlines() if 'registers' in ln
                 or 'Compiling entry' in ln]
        print(json.dumps({'build': name, 'ptxas': ptxas}), flush=True)
    lib = OUT_DIR / ('lib%s.so' % name)
    subprocess.run([nvcc, '-shared', '-Xcompiler', '-fPIC', '-o', str(lib),
                    *objs], check=True)
    return ctypes.CDLL(str(lib))


class Kernels:
    """One build's ``rri_gs_f32`` and ``rri_tm_proj_f32``."""

    def __init__(self, lib):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.gs = lib.rri_gs_f32
        self.gs.argtypes = [P] * 5 + [I, I, F, F, F, I, I, P]
        self.tm = lib.rri_tm_proj_f32
        self.scratch = None
        if hasattr(lib, 'rri_tm_proj_scratch_bytes'):
            self.scratch = torch.empty(lib.rri_tm_proj_scratch_bytes(),
                                       dtype=torch.uint8, device='cuda')
            self.tm.argtypes = [P] * 5 + [I, I, F, F, F, I, I, P]
        else:
            self.tm.argtypes = [P] * 4 + [I, I, F, F, F, I, I, P]
        self.gs.restype = self.tm.restype = ctypes.c_int

    @staticmethod
    def _check(err, what):
        if err:
            raise RuntimeError('%s launch failed: CUDA error %d' % (what, err))

    def run_gs(self, G, N, F, out):
        k, m = F.shape
        stream = torch.cuda.current_stream().cuda_stream
        self._check(self.gs(G.data_ptr(), N.data_ptr(), F.data_ptr(), None,
                            out.data_ptr(), k, m, 0.0, 0.0, INF, 1, 0,
                            stream), 'gs')

    def run_tm(self, G, N, F, out):
        k, d = F.shape
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [G.data_ptr(), N.data_ptr(), F.data_ptr(), out.data_ptr()]
        if self.scratch is not None:
            ptrs.append(self.scratch.data_ptr())
        self._check(self.tm(*ptrs, k, d, 0.0, 0.0, 1.0, 1, 0, stream),
                    'tm_proj')


def gs_inputs(k, m, seed):
    rng = np.random.RandomState(seed)
    A = torch.as_tensor(rng.rand(k, 256), dtype=torch.float32, device='cuda')
    G = A @ A.T
    F = torch.as_tensor(rng.rand(k, m), dtype=torch.float32, device='cuda')
    N = G @ torch.as_tensor(rng.rand(k, m), dtype=torch.float32,
                            device='cuda')
    return G, N, F


def tm_inputs(k, d, seed):
    if seed == len(TM_SHAPES) - 1:
        return tm_feasible(k, d)
    rng = np.random.RandomState(seed)
    W = torch.as_tensor(rng.rand(2048, k), dtype=torch.float32,
                        device='cuda')
    Xs = torch.as_tensor(rng.rand(2048, d) ** 8, dtype=torch.float32,
                         device='cuda')
    F = torch.as_tensor(rng.rand(k, d), dtype=torch.float32, device='cuda')
    return W.T @ W, W.T @ Xs, F / F.sum(1, keepdim=True)


def tm_feasible(k, d):
    """Every row's [numer]+ / (denom + eps) already on the simplex (G = I,
    F = 0, N a row of powers of two summing to 1): each topic takes the
    shortcut, one row-wide reduction, with the same numerator work."""
    G = torch.eye(k, dtype=torch.float32, device='cuda')
    pat = torch.full((d,), -1.0, dtype=torch.float32, device='cuda')
    pat[[0, d // 3, 2 * d // 3, d - 1]] = torch.tensor(
        [0.5, 0.25, 0.125, 0.125], device='cuda')
    return G, pat.repeat(k, 1), torch.zeros(k, d, device='cuda')


def time_turns(builds, run, args, runs):
    """ms of each build's call, ``runs`` rounds in turns; outputs."""
    outs = {name: torch.empty_like(args[2]) for name in builds}
    for name, kern in builds.items():          # warm-up, and the outputs
        run(kern, *args, outs[name])
    torch.cuda.synchronize()
    ms = {name: [] for name in builds}
    order = list(builds)
    for r in range(runs):
        for name in (order if r % 2 == 0 else order[::-1]):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run(builds[name], *args, outs[name])
            b.record()
            b.synchronize()
            ms[name].append(a.elapsed_time(b))
    return ms, outs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--baseline', help='directory with gs.cu and tm_proj.cu')
    ap.add_argument('--runs', type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('bench_dense_kernels.py: no CUDA device')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    specs = [('current', _build.CSRC_DIR)]
    if args.baseline:
        specs.append(('baseline', args.baseline))
    builds = {name: Kernels(build(name, src)) for name, src in specs}
    summary = {}
    reductions = {}
    for kind, shapes, make, run in (
            ('gs', GS_SHAPES, gs_inputs, Kernels.run_gs),
            ('tm_proj', TM_SHAPES, tm_inputs, Kernels.run_tm)):
        for i, (label, k, m) in enumerate(shapes):
            inputs = make(k, m, seed=i)
            if kind == 'tm_proj':
                rounds = michelot_rounds(*inputs, 0.0, 0.0, 1.0)
                reductions[label] = rounds['reductions_per_topic']
                print(json.dumps({'michelot_rounds': label, **rounds}),
                      flush=True)
            ms, outs = time_turns(builds, run, inputs, args.runs)
            first = outs['current']
            for name in builds:
                med = float(np.median(ms[name]))
                summary['%s %s %s' % (kind, label, name)] = med
                print(json.dumps({
                    'kernel': kind, 'case': label, 'k': k, 'cols': m,
                    'build': name, 'ms': med, 'all_ms': ms[name],
                    'max_abs_diff_vs_current': float(
                        (outs[name] - first).abs().max()),
                    'finite': bool(torch.isfinite(outs[name]).all())}),
                    flush=True)
            del inputs, outs
    regular, feasible = TM_SHAPES[0], TM_SHAPES[-1]
    extra = regular[1] * (reductions[regular[0]] - 1)
    per_reduction = {
        name: (summary['tm_proj %s %s' % (regular[0], name)]
               - summary['tm_proj %s %s' % (feasible[0], name)]) / extra
        for name in builds}
    print(json.dumps({'card': smi, 'median_ms': summary,
                      'tm_proj_ms_per_reduction': per_reduction}),
          flush=True)


if __name__ == '__main__':
    os.chdir(REPO)
    main()
