#!/usr/bin/env python3
"""Time kernels B3 and B4 (``csrc/masked.cu``, the masked sweep's two
passes) against another build of them, on one card, in turns, in
float32 and in the 16-bit builds; and the RS sweep of whole checkouts
against each other.

Run from the root of a checkout, on a machine with a CUDA card::

    python3 tools/bench_masked_kernels.py [--baseline DIR] [--runs 9]
        [--dtypes float32,bfloat16,float16] [--variants default,a16]
        [--rs-tree ROOT ...]

Each build compiles ``masked.cu`` with ``nvcc`` into its own library under
``build/bench_masked/``, all at once: ``current/<variant>`` from the
package's source with the variant's ``-D`` flags (:data:`VARIANTS`:
the rows in flight of B3's 16-bit form, the column steps in flight of
B4's), and ``baseline`` from ``DIR/masked.cu`` with ``DIR/storage.cuh``
(e.g. the parent commit's ``rri_nmf_tpu_torch/csrc``, unpacked with ``git
archive`` into a directory that ``.gitignore`` lists).

The cases are ``chip_smoke.py``'s RS shape, 6040×3952: R a random
residual, M the mask of 1M synthetic ratings, numpy seeds, in each dtype
of ``--dtypes``. In the 16-bit dtypes also the scalar form at the same
shape (R and M one element past a 16-byte boundary, so every build takes
it). Each build is checked first, on fresh copies of R:

- against the twin (``masked_kernels.phase_a_ref``/``phase_b_ref`` on the
  card): R relative to its largest entry (16 bits: ``chip_smoke.err_16``,
  one ulp plus the float32 build's own difference), each sum relative to
  its sum of absolute terms;
- against itself: two launches give the same bits;
- against ``baseline``: R bit for bit, and the sums bit for bit where the
  order is unchanged (float32 and float64, B3 in every dtype; B4's 16-bit
  16-byte form adds its row sums in a new order: their share of equal
  entries and largest relative difference are printed);
- B4's 16-bit row sums against a float32 mirror of each form's order
  (:func:`b4_mirror`): which form's order they follow bit for bit, the
  16-byte form's where R and M are aligned, else the scalar form's.

Then, over ``--runs`` rounds in turns (forward, then backward),
CUDA-event ms of ``B3 <build> <dtype>`` and ``B4 <build> <dtype>`` (10
launches of the build's C entry straight after each other, outputs
allocated once, no checks, over 10), of ``B3 call``/``B4 call`` (the
package's wrappers as the sweep calls them, ``out=`` given) and of ``same
bytes, R.add_(M)`` (one PyTorch elementwise kernel that moves B3's bytes:
what a tuned streaming kernel reaches with this traffic on this card).
Before the timed rounds it prints the host microseconds per call of the
float32 wrappers, of ``check_operands`` and of the wrappers'
``_build._raw_stream``. Output: the card's name and power limit, each
build's ``-Xptxas -v`` lines, one JSON line per check and per timed call
(median and all ms, the byte bound, 3 n d words over 3.35 TB/s, and its
share), and a summary line.

With ``--rs-tree ROOT`` (repeatable; ``.`` is this checkout) it then
times the RS sweep of the package in each ROOT, each in a process of its
own, in the order given (e.g. parent, ., ., parent): ``NMF_RS_Estimator``
at the RS shape, k=40, a 3-sweep warm-up fit, then 10 sweeps from its
factors without the objective, as ``chip_smoke.py`` phase 8 times them:
the median of the fit's per-sweep ``iter_cputime`` stamps, in ms; then
3 more sweeps under ``torch.profiler``, whose device time per sweep it
splits into B3 (its kernels), B4 and everything else (the whole fit, its
host-side set-up's kernels included).

With ``--fit16-tree ROOT`` (repeatable, the same way) it then times, in
each ROOT's process, ``chip_smoke.py`` phase 26's masked 16-bit fit (low-
rank 6040×3952 data under a 60% mask, k=40, ``use_pallas=True``, the
objective each sweep) in bfloat16 and float16: :data:`FIT16_REPEATS`
fits of ``MASKED_SWEEPS_16`` sweeps each, the median of their per-sweep
stamps, then one more fit under ``torch.profiler``, its device ms per
sweep split as above.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

OUT_DIR = REPO / 'build' / 'bench_masked'
ALONE_REPS = 10
RS_SWEEPS = 10
PROFILED_SWEEPS = 3
FIT16_REPEATS = 3
VARIANTS = {
    'default': [],
    'a2': ['-DA16_DEPTH=2'],
    'a6': ['-DA16_DEPTH=6'],
    'a8': ['-DA16_DEPTH=8'],
    'b2': ['-DB16_DEPTH=2'],
}
DTYPES = {'float32': torch.float32, 'float64': torch.float64,
          'bfloat16': torch.bfloat16, 'float16': torch.float16}
P, I = ctypes.c_void_p, ctypes.c_int


def build(builds):
    """Each ``{name: (source dir, extra nvcc flags)}`` into
    ``lib<name>.so``, every nvcc process at once; {name: ctypes library}
    (argtypes set for B3's and B4's entries)."""
    from rri_nmf_tpu_torch.ops import _build
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, (src_dir, flags) in builds.items():
        lib = OUT_DIR / ('lib%s.so' % name.replace('/', '_'))
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, *flags, '-Xptxas=-v',
               '-shared', '-o', str(lib), str(Path(src_dir) / 'masked.cu')]
        jobs[name] = (cmd, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (cmd, lib, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError('nvcc failed: %s\n%s' % (' '.join(cmd), err))
        ptxas = [ln for ln in err.splitlines() if 'registers' in ln
                 or 'spill' in ln or 'Compiling entry' in ln]
        print(json.dumps({'build': name, 'ptxas': ptxas}), flush=True)
        cdll = ctypes.CDLL(str(lib))
        for suffix in ('f32', 'f64', 'bf16', 'f16'):
            fa = getattr(cdll, 'rri_masked_phase_a_' + suffix)
            fa.argtypes = [P] * 7 + [I, I, I, I, P]
            fb = getattr(cdll, 'rri_masked_phase_b_' + suffix)
            fb.argtypes = [P] * 8 + [I, I, I, P]
            fa.restype = fb.restype = ctypes.c_int
        libs[name] = cdll
    return libs


def offset_view(a):
    """A contiguous copy of ``a`` that starts one element past a 16-byte
    boundary (the kernels' scalar form)."""
    buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
    out = buf[1:].view(a.shape)
    out.copy_(a)
    return out


class Case:
    """B3's and B4's operands in one dtype, the sums' buffers, and each
    build's raw launches on them."""

    def __init__(self, R, M, vecs, scalar):
        self.R, self.M = R, M
        self.dw, self.tp, self.w, self.tn = vecs
        self.weff = 1.3 * self.w
        self.scalar = scalar
        n, d = R.shape
        acc = torch.float64 if R.dtype == torch.float64 else torch.float32
        self.a_out = tuple(torch.empty(d, dtype=acc, device=R.device)
                           for _ in range(2))
        self.b_out = tuple(torch.empty(n, dtype=acc, device=R.device)
                           for _ in range(2))

    def fresh(self, R0):
        return offset_view(R0) if self.scalar else R0.clone()

    def launcher(self, lib, kind, R=None, out=None):
        """One raw launch of ``lib``'s B3 or B4 on ``R`` (the case's own
        when None) into ``out`` (the case's buffers when None)."""
        from rri_nmf_tpu_torch.ops import _build
        from rri_nmf_tpu_torch.ops import masked_kernels as mk
        R = self.R if R is None else R
        n, d = R.shape
        dev = R.device
        fn = getattr(lib, 'rri_masked_%s_%s' % (kind,
                                                _build.SUFFIX[R.dtype]))
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kind == 'phase_a':
            out = self.a_out if out is None else out
            vecs = (self.dw, self.tp, self.w)
            tail = (n, d, mk.phase_a_layout(n, d, R.element_size())[1])
        else:
            out = self.b_out if out is None else out
            vecs = (self.w, self.weff, self.tp, self.tn)
            tail = (n, d)
        args = (R.data_ptr(), self.M.data_ptr(),
                *(v.data_ptr() for v in vecs),
                *(o.data_ptr() for o in out), *tail, dev.index, stream)

        def launch():
            err = fn(*args)
            if err:
                raise RuntimeError('%s launch failed: CUDA error %d'
                                   % (kind, err))
            return out
        return launch


def make_case(dtype, scalar, dev):
    n, d, q, _ = chip_smoke.RS_SHAPE
    rng = np.random.RandomState(3)
    M = torch.as_tensor(chip_smoke.synth_ratings(n, d, q, 8) != 0,
                        device=dev).to(dtype)
    R = torch.as_tensor(rng.randn(n, d), device=dev).to(dtype)
    vecs = [torch.as_tensor(v, device=dev).to(dtype) for v in (
        rng.rand(n) - 0.5, rng.rand(d), rng.rand(n), rng.rand(d))]
    if scalar:
        R, M = offset_view(R), offset_view(M)
    return Case(R, M, vecs, scalar)


def b4_mirror(R, M, t_new, packed):
    """B4's 16-bit row sums on the updated residual ``R`` in the order of
    a form of ``csrc/masked.cu``, in float32: lane l of a row's warp adds
    its columns in order (``packed``, the 16-byte form: 256 s + 8 l + v, v
    = 0..7, of each step s; else l + 32 s), then the shuffle tree adds
    lane l + off into lane l for off = 16, 8, 4, 2, 1. The terms
    ``rnd(M ⊙ R)·t_new`` and ``M·rnd(t_new²)`` (torch's 16-bit products
    round once, as the kernels' ``rnd``) are exact in float32, as in the
    kernels' fused multiply-adds."""
    n, d = R.shape
    lane = torch.arange(32, device=R.device)[:, None]
    if packed:
        k = torch.arange(-(-d // 256) * 8, device=R.device)[None, :]
        cols = 256 * (k // 8) + 8 * lane + k % 8
    else:
        cols = lane + 32 * torch.arange(-(-d // 32), device=R.device)[None]
    cols = torch.where(cols < d, cols, d)       # d: a zero column
    out = []
    for terms in ((M * R).float() * t_new.float()[None, :],
                  M.float() * (t_new * t_new).float()[None, :]):
        padded = torch.cat([terms, terms.new_zeros(n, 1)], 1)
        lanes = terms.new_zeros(n, 32)
        for j in range(cols.shape[1]):
            lanes = lanes + padded[:, cols[:, j]]
        for off in (16, 8, 4, 2, 1):
            lanes[:, :off] = lanes[:, :off] + lanes[:, off:2 * off]
        out.append(lanes[:, 0].clone())
    return out


def check(case, libs, label):
    """Every build against the twin, itself and ``baseline``; one JSON
    line per build and kernel. Returns False on a failed check."""
    from rri_nmf_tpu_torch.ops import masked_kernels as mk
    R0 = case.R.clone()
    dt = R0.dtype
    narrow = dt in chip_smoke.NARROW
    ok = True
    args = {'phase_a': (case.dw, case.tp, case.w),
            'phase_b': (case.w, case.weff, case.tp, case.tn)}
    for kind in ('phase_a', 'phase_b'):
        twin = getattr(mk, kind + '_ref')
        Rt = R0.clone()
        want = twin(Rt, case.M, *args[kind])
        if narrow:
            # the float32 build and twin on the same values, for err_16
            R32, Rt32 = R0.float(), R0.float()
            c32 = Case(R32, case.M.float(), [case.dw.float(),
                       case.tp.float(), case.w.float(), case.tn.float()],
                       False)
            c32.launcher(libs['baseline' if 'baseline' in libs
                              else next(iter(libs))], kind, R32)()
            twin(Rt32, case.M.float(), *(a.float() for a in args[kind]))
        results = {}
        for name, lib in libs.items():
            got = []
            for _ in range(2):
                R = case.fresh(R0)
                out = tuple(torch.empty_like(o) for o in (
                    case.a_out if kind == 'phase_a' else case.b_out))
                case.launcher(lib, kind, R, out)()
                got.append((R, out))
            torch.cuda.synchronize()
            (Ra, sa), (Rb, sb) = got
            line = {'check': label, 'kernel': kind, 'build': name,
                    'bitwise_repeat': bool(torch.equal(Ra, Rb) and all(
                        torch.equal(x, y) for x, y in zip(sa, sb)))}
            scale = (((case.M * Rt).abs().T.to(sa[0].dtype)
                      @ case.w.abs().to(sa[0].dtype),
                      (case.w * case.w).to(sa[0].dtype)
                      @ case.M.to(sa[0].dtype)) if kind == 'phase_a' else
                     ((case.M * Rt).abs().to(sa[0].dtype)
                      @ case.tn.abs().to(sa[0].dtype),
                      case.M.to(sa[0].dtype)
                      @ (case.tn * case.tn).to(sa[0].dtype)))
            line['rel_err_sums'] = [chip_smoke.scaled_err(g, h, s)
                                    for g, h, s in zip(sa, want, scale)]
            if narrow:
                gate, ulps, share, err, _ = chip_smoke.err_16(
                    Ra, Rt, R32, Rt32, dt)
                line.update(R_gate=gate, R_ulps=ulps, R_within_one_ulp=share)
                good = gate <= 1.0
            else:
                line['rel_err_R'] = chip_smoke.rel_err(Ra, Rt)
                tol = (chip_smoke.TOL_F64 if dt == torch.float64
                       else chip_smoke.TOL_F32)
                good = line['rel_err_R'] <= tol
            good = (good and max(line['rel_err_sums']) <= chip_smoke.TOL_F32
                    and line['bitwise_repeat'])
            results[name] = (Ra, sa)
            if 'baseline' in results and name != 'baseline':
                Rz, sz = results['baseline']
                line['R_equal_to_baseline'] = bool(torch.equal(Ra, Rz))
                line['sums_equal_to_baseline'] = [
                    float((x == y).double().mean()) for x, y in zip(sa, sz)]
                line['sums_rel_diff_to_baseline'] = [
                    chip_smoke.rel_err(x, y) for x, y in zip(sa, sz)]
                same_order = (not narrow or kind == 'phase_a'
                              or case.scalar)
                good = good and line['R_equal_to_baseline'] and (
                    not same_order
                    or min(line['sums_equal_to_baseline']) == 1.0)
            if narrow and kind == 'phase_b':
                orders = [form for form, packed in (('16-byte', True),
                                                    ('scalar', False))
                          if all(torch.equal(x, y) for x, y in zip(
                              sa, b4_mirror(Ra, case.M, case.tn, packed)))]
                line['sums_follow_order_of'] = orders
                if name != 'baseline':
                    good = good and orders == [
                        'scalar' if case.scalar else '16-byte']
            line['ok'] = good
            ok = ok and good
            print(json.dumps(line), flush=True)
    return ok


def time_turns(calls, runs):
    """ms of each ``calls[name] = (fn, reps)``, ``runs`` rounds in turns:
    the events span ``reps`` calls, and the time is over ``reps``."""
    for fn, _ in calls.values():
        fn()
    torch.cuda.synchronize()
    ms = {name: [] for name in calls}
    order = list(calls)
    for r in range(runs):
        for name in (order if r % 2 == 0 else order[::-1]):
            fn, reps = calls[name]
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            b.synchronize()
            ms[name].append(a.elapsed_time(b) / reps)
    return ms


def host_us(fn, calls=200):
    """Host microseconds per ``fn()`` (the card's queue does not fill:
    each call enqueues at most a few kernels)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def kernels(args, smi):
    from rri_nmf_tpu_torch.ops import _build
    from rri_nmf_tpu_torch.ops import masked_kernels as mk
    from rri_nmf_tpu_torch.ops._build import check_operands
    dev = torch.device('cuda', 0)
    builds = {'current/' + v: (_build.CSRC_DIR, VARIANTS[v])
              for v in args.variants.split(',')}
    if args.baseline:
        builds = dict({'baseline': (args.baseline, [])}, **builds)
    libs = build(builds)
    cases = {}
    for name in args.dtypes.split(','):
        dt = DTYPES[name]
        cases[name] = make_case(dt, False, dev)
        if dt in chip_smoke.NARROW:
            cases[name + ' scalar form'] = make_case(dt, True, dev)
    ok = all([check(case, libs, label) for label, case in cases.items()])

    calls = {}
    for label, case in cases.items():
        for kind, tag in (('phase_a', 'B3'), ('phase_b', 'B4')):
            for name, lib in libs.items():
                calls['%s %s %s' % (tag, name, label)] = (
                    case.launcher(lib, kind), ALONE_REPS)
        if case.scalar:
            continue
        c = case
        calls['B3 call ' + label] = (lambda c=c: mk.phase_a(
            c.R, c.M, c.dw, c.tp, c.w, out=c.a_out), 1)
        calls['B4 call ' + label] = (lambda c=c: mk.phase_b(
            c.R, c.M, c.w, c.weff, c.tp, c.tn, out=c.b_out), 1)
        # the same bytes through one PyTorch elementwise kernel (read R
        # and M, write R): what a tuned streaming kernel reaches
        calls['same bytes, R.add_(M) ' + label] = (
            lambda c=c: c.R.add_(c.M), ALONE_REPS)
    if 'float32' in cases:
        c = cases['float32']
        n, d = c.R.shape
        host = {name: host_us(calls[name][0])
                for name in ('B3 call float32', 'B4 call float32')}
        host['check_operands, 7 operands'] = host_us(lambda: check_operands(
            c.R, {'R': (c.R, (n, d)), 'M': (c.M, (n, d)),
                  'dw': (c.dw, (n,)), 't_prev': (c.tp, (d,)),
                  'w': (c.w, (n,)), 'wR0': (c.a_out[0], (d,)),
                  'nw': (c.a_out[1], (d,))}))
        host['_build._raw_stream'] = host_us(lambda: _build._raw_stream(0))
        print(json.dumps({'host_us_per_call': host, 'card': smi}),
              flush=True)
    ms = time_turns(calls, args.runs)
    summary = {}
    for name in calls:
        label = next(lb for lb in sorted(cases, key=len, reverse=True)
                     if name.endswith(lb))
        n, d = cases[label].R.shape
        bound_ms = (3 * n * d * cases[label].R.element_size()
                    / chip_smoke.PEAK_BYTES_PER_S * 1e3)
        med = float(np.median(ms[name]))
        summary[name] = med
        print(json.dumps({'call': name, 'shape': [n, d], 'card': smi,
                          'ms': med, 'all_ms': ms[name],
                          'bound_ms': bound_ms,
                          'bound_share': bound_ms / med}), flush=True)
    n, d = chip_smoke.RS_SHAPE[:2]
    geometry = {}
    for item in (2, 4, 8):
        stripes, cluster, ranges = mk.phase_a_layout(n, d, item)
        geometry['%d-byte words' % item] = {
            'stripes': stripes, 'cluster': cluster,
            'rank_rows': [b - a for a, b in ranges]}
    return ok, {'card': smi, 'checks_ok': ok, 'median_ms': summary,
                'b3_geometry': geometry}


def import_tree(root):
    """The package under ``root`` (its kernels built), in this process:
    its path."""
    sys.path.insert(0, str(Path(root).resolve()))
    import rri_nmf_tpu_torch
    from rri_nmf_tpu_torch.ops import _build
    where = Path(rri_nmf_tpu_torch.__file__).resolve()
    if Path(root).resolve() not in where.parents:
        raise RuntimeError('imported %s, not the package under %s'
                           % (where, root))
    _build.load()
    return where.parent


def device_ms(prof, sweeps):
    """Device ms per sweep of a profile, split into B3, B4 and the
    rest."""
    device = {}
    for ev in prof.key_averages():
        key = ('B3' if 'phase_a_kernel' in ev.key else
               'B4' if 'phase_b' in ev.key else 'other')
        device[key] = device.get(key, 0.0) + ev.self_device_time_total
    return {key: us / 1e3 / sweeps for key, us in device.items()}


def fit16(root):
    """Phase 26's masked 16-bit fit with the package under ``root``."""
    where = import_tree(root)
    from rri_nmf_tpu_torch.nmf import nmf
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device('cuda', 0)
    n, d, _, k = chip_smoke.RS_SHAPE
    X = chip_smoke.lowrank(n, d, k, dev, seed=13)
    X /= X.max()
    M = torch.as_tensor((np.random.RandomState(14).rand(n, d) < 0.6)
                        .astype(np.float32), device=dev)
    sweeps = chip_smoke.MASKED_SWEEPS_16
    for dt in chip_smoke.NARROW:
        def fit():
            res = nmf(X, k, W_mat=M, dtype=dt, use_pallas=True,
                      max_iter=sweeps, compute_obj_each_iter=True,
                      random_state=0, eps_stop=0.0, reset_topic_method=None)
            torch.cuda.synchronize()
            return res
        ms = []
        for _ in range(FIT16_REPEATS):
            ms += list(np.diff(fit()['iter_cputime']) * 1e3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fit()
        print(json.dumps({'fit16_tree': str(root), 'package': str(where),
                          'dtype': str(dt),
                          'ms_per_sweep_with_objective': float(np.median(ms)),
                          'all_ms': [float(x) for x in ms],
                          'device_ms_per_sweep': device_ms(prof, sweeps)}),
              flush=True)


def rs_sweep(root):
    """The RS sweep of the package under ``root``, in this process."""
    where = import_tree(root)
    from rri_nmf_tpu_torch.sklearn_interface import NMF_RS_Estimator
    dev = torch.device('cuda', 0)
    n, d, q, k = chip_smoke.RS_SHAPE
    p_tr, r_tr, _, _ = (torch.as_tensor(a, device=dev) for a in
                        chip_smoke.rs_split(chip_smoke.synth_ratings(
                            n, d, q, 8)))
    r_tr = r_tr.float()
    kw = dict(random_state=0, use_validation_early_stopping=False)
    est = NMF_RS_Estimator(n, d, k, max_iter=3, **kw).fit(p_tr, r_tr)
    est = NMF_RS_Estimator(n, d, k, max_iter=RS_SWEEPS, W=est.W, T=est.T,
                           nmf_kwargs=dict(compute_obj_each_iter=False),
                           **kw).fit(p_tr, r_tr)
    torch.cuda.synchronize()
    ms = list(np.diff(est.nmf_outputs['iter_cputime']) * 1e3)
    # device time per sweep by kernel, from the profiler over a few more
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        NMF_RS_Estimator(n, d, k, max_iter=PROFILED_SWEEPS, W=est.W, T=est.T,
                         nmf_kwargs=dict(compute_obj_each_iter=False),
                         **kw).fit(p_tr, r_tr)
        torch.cuda.synchronize()
    print(json.dumps({'rs_tree': str(root), 'package': str(where),
                      'ms_per_sweep': float(np.median(ms)),
                      'all_ms': [float(x) for x in ms],
                      'device_ms_per_sweep': device_ms(prof,
                                                       PROFILED_SWEEPS)}),
          flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--baseline', help='directory with a masked.cu and '
                    'its storage.cuh')
    ap.add_argument('--runs', type=int, default=9)
    ap.add_argument('--dtypes', default='float32,bfloat16,float16')
    ap.add_argument('--variants', default='default',
                    help='comma-separated names of VARIANTS')
    ap.add_argument('--rs-tree', action='append', default=[],
                    help='a checkout root whose RS sweep to time')
    ap.add_argument('--fit16-tree', action='append', default=[],
                    help='a checkout root whose masked 16-bit fit to time')
    ap.add_argument('--rs-child', help=argparse.SUPPRESS)
    ap.add_argument('--fit16-child', help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('bench_masked_kernels.py: no CUDA device')
    if args.rs_child:
        rs_sweep(args.rs_child)
        return
    if args.fit16_child:
        fit16(args.fit16_child)
        return
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    ok, summary = kernels(args, smi)
    for root in args.rs_tree:
        subprocess.run([sys.executable, __file__, '--rs-child', root],
                       check=True)
    for root in args.fit16_tree:
        subprocess.run([sys.executable, __file__, '--fit16-child', root],
                       check=True)
    print(json.dumps(summary), flush=True)
    if not ok:
        sys.exit('bench_masked_kernels.py: a build failed its checks')


if __name__ == '__main__':
    os.chdir(REPO)
    main()
