"""Readings that set a cell's limits: the compared numbers of the
program's fit and of the control on many seeds, in one process.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 \\
        [--variant program|program_tf32|reference_tf32|program_f64] \\
        [--out FILE]

For each seed it makes the cell's inputs, fits them once as a timed fit
does, fits them with the float64 reference, and prints one JSON line of
the numbers ``core/check.py`` compares. ``--variant`` puts another fit
in the program's place: the controls, ``program_tf32`` (the program with
its own TensorFloat-32 path switched on, ``matmul_precision=
'tensorfloat32'``) and ``reference_tf32`` (the plain reference computed
in TensorFloat-32), and a witness, ``program_f64`` (the program in
float64). No window, no metric: the benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
VARIANTS = ('program', 'program_tf32', 'reference_tf32', 'program_f64')


def reading(cell, seed, device, variant='program'):
    """The compared numbers of one seed: ``dict(seed, numbers..., s)``."""
    import torch
    from portbench.core import check
    from portbench.core.harness import Program, fit_random_state
    t0 = time.perf_counter()
    random_state = fit_random_state(cell.config, seed)
    inputs = cell.module('gen', cell.config['generator']).make(
        cell.config, seed, device)
    preset = cell.workload['reference']
    ref_mod = cell.module('reference', preset['path'])
    if variant == 'reference_tf32':
        got = ref_mod.fit(inputs, cell.config, preset, random_state, device,
                          precision='tf32')
        W, T, sweeps = got['W'].cpu(), got['T'].cpu(), got['sweeps']
    else:
        extra = {'program_tf32': dict(matmul_precision='tensorfloat32'),
                 'program_f64': dict(dtype='float64')}.get(variant, {})
        cell.traffic['nmf_kwargs'] = dict(cell.traffic.get('nmf_kwargs', {}),
                                          **extra)
        est, rec = Program(cell, random_state, device).fit(inputs)
        W, T, sweeps = est.W.cpu(), est.T.cpu(), rec.sweeps
        del est
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    ref = ref_mod.fit(inputs, cell.config, preset, random_state, device)
    out = dict(seed=seed, variant=variant)
    out.update(check.numbers(W, T, sweeps, ref))
    out['sweeps'] = sweeps
    out['s'] = time.perf_counter() - t0
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--variant', choices=VARIANTS, default='program')
    ap.add_argument('--out')
    args = ap.parse_args(argv)
    import torch
    from portbench.core.spec import Cell
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 2
    device = torch.device('cuda', 0)
    for seed in (int(s) for s in args.seeds.split(',')):
        line = json.dumps(reading(Cell(args.workload, ROOT), seed, device,
                                  args.variant))
        print(line, flush=True)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(line + '\n')
    return 0


if __name__ == '__main__':
    sys.path[:] = [str(ROOT)] + [
        p for p in sys.path
        if Path(p or '.').resolve() != ROOT / 'portbench']
    sys.exit(main())
