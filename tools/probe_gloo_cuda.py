#!/usr/bin/env python3
"""Which ``torch.distributed`` collectives a gloo world runs on CUDA
tensors, and what an all-reduce costs there, on one card.

Run from the root of a checkout, on a machine with a CUDA card::

    python3 tools/probe_gloo_cuda.py [--ranks 4] [--mb 4]

Starts ``--ranks`` processes (this script with ``--rank``), each on
device 0, in one gloo world that meets through a ``FileStore`` in a
temporary directory. Each tries an all-reduce of float32, float64,
bfloat16, an int32 MAX and a 0-d tensor, an all-gather, a broadcast and
an all-reduce over a ``DeviceMesh`` axis group, all on CUDA tensors, then
times ten all-reduces of ``--mb`` MB of float32 (the host clock around
them, the device synchronized). ``nmf(mesh=...)`` under gloo on cards
needs the all-reduce (its mesh sums and gathers) and nothing else. Prints
the card's name and power limit, one JSON line per rank and the exit
codes; exits non-zero when a rank fails.
"""

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist


def rank_main(rank, world, store, mb):
    torch.cuda.set_device(0)
    dist.init_process_group(
        'gloo', store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    dev = torch.device('cuda', 0)
    out = {'rank': rank}
    tries = [
        ('all_reduce_f32', lambda: dist.all_reduce(
            torch.full((1000,), rank + 1.0, device=dev))),
        ('all_reduce_f64', lambda: dist.all_reduce(
            torch.ones(10, dtype=torch.float64, device=dev))),
        ('all_reduce_bf16', lambda: dist.all_reduce(
            torch.ones(10, dtype=torch.bfloat16, device=dev))),
        ('all_reduce_max_i32', lambda: dist.all_reduce(
            torch.ones(1, dtype=torch.int32, device=dev),
            op=dist.ReduceOp.MAX)),
        ('all_reduce_0d', lambda: dist.all_reduce(
            torch.ones((), device=dev).reshape(-1))),
        ('all_gather', lambda: dist.all_gather(
            [torch.empty(5, device=dev) for _ in range(world)],
            torch.ones(5, device=dev))),
        ('broadcast', lambda: dist.broadcast(torch.ones(5, device=dev), 0)),
    ]
    for name, fn in tries:
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = 'ok'
        except RuntimeError as e:
            out[name] = repr(e)[:200]
    from torch.distributed.device_mesh import DeviceMesh
    mesh = DeviceMesh('cpu', torch.arange(world).reshape(world, 1),
                      mesh_dim_names=('dp', 'tp'))
    x = torch.ones(mb * (1 << 18), device=dev)
    dist.all_reduce(x, group=mesh.get_group('dp'))
    torch.cuda.synchronize()
    out['mesh_axis_all_reduce'] = bool((x == world).all())
    dist.all_reduce(x)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(10):
        dist.all_reduce(x)
    torch.cuda.synchronize()
    out['ms_all_reduce_%dMB' % mb] = (time.perf_counter() - t) * 100
    print(json.dumps(out), flush=True)
    dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--ranks', type=int, default=4)
    ap.add_argument('--mb', type=int, default=4)
    ap.add_argument('--rank', type=int, default=None)
    ap.add_argument('--store', default=None)
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args.rank, args.ranks, args.store, args.mb)
        return
    if not torch.cuda.is_available():
        sys.exit('probe_gloo_cuda.py: no CUDA device')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps({'torch': torch.__version__, 'cuda': torch.version.cuda,
                      'card': torch.cuda.get_device_name(0)}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), '--rank', str(r),
             '--ranks', str(args.ranks), '--mb', str(args.mb), '--store',
             os.path.join(tmp, 'store')]) for r in range(args.ranks)]
        try:
            rcs = [p.wait(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    print(json.dumps({'exit_codes': rcs}), flush=True)
    if any(rcs):
        sys.exit(1)


if __name__ == '__main__':
    main()
