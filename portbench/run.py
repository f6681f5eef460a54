"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Prints, as the last line of standard output,
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``; with ``--trace 1`` also ``breakdown``; ``checks`` last), and
as the last lines of standard error each compared number beside its
limit. Exits 2 without a result when the cell's cards are not there, and
4 when a module of JAX or of the JAX package is loaded once the window
has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def log(msg):
    print('[portbench] ' + msg, file=sys.stderr, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.core.spec import Cell
    cell = Cell(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log('no result: the cell needs %d CUDA device(s), this machine has '
            '%d' % (cell.chips, torch.cuda.device_count()
                    if torch.cuda.is_available() else 0))
        return 2
    try:
        import rri_nmf_tpu_torch  # noqa: F401
    except ImportError as e:
        log('no result: the program does not import (%s)' % (e,))
        return 3
    from portbench.core.harness import forbidden_modules, run_cell
    device = torch.device('cuda', 0)
    torch.cuda.set_device(device)
    result, rows = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            device, T_START, log=log)
    bad = forbidden_modules()
    if bad:
        log('no result: modules loaded that no run may hold: %s'
            % ', '.join(bad))
        return 4
    for name, value, limit in rows:
        print('check %s %r limit %r' % (name, value, limit),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    # the checkout's root, not this folder, is where modules come from
    sys.path[:] = [str(ROOT)] + [
        p for p in sys.path
        if Path(p or '.').resolve() != ROOT / 'portbench']
    sys.exit(main())
