#!/usr/bin/env python3
"""Disassemble the kernels of ``rri_nmf_tpu_torch/csrc``: per kernel its
registers, instruction count and opcode counts, and whether its machine
code is the same as that of another source tree.

Run from the root of a checkout, on a machine with the CUDA toolkit::

    python3 tools/sass_report.py [--baseline DIR] [--match REGEX]
                                 [--top 30] [--out DIR]

Each ``.cu`` of the package's ``csrc`` (and of ``DIR``, e.g. the parent
commit's ``rri_nmf_tpu_torch/csrc`` unpacked with ``git archive`` into a
directory that ``.gitignore`` lists) compiles to a cubin with the
package's ``nvcc`` flags (``ops/_build.NVCC_FLAGS``), all at once, under
``build/sass/``; ``cuobjdump -sass`` and ``-res-usage`` read them. It
prints one JSON line per kernel whose demangled name matches ``--match``
(every kernel by default): the tree, the source, the name, its registers,
its instruction count, its ``--top`` most frequent opcodes with their
counts (the whole opcode with its modifiers, e.g. ``F2F.F32.BF16``), and
with ``--baseline`` ``same_as_baseline``: whether its instruction words
(the encodings, control bits included) equal those of the kernel of the
same mangled name in ``DIR`` (null where ``DIR`` has none). The whole
listings go to ``--out`` (default ``build/sass/``), one file per tree and
source.
"""

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from rri_nmf_tpu_torch.ops import _build  # noqa: E402

INSN = re.compile(r'^\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;\s*/\*\s*(0x[0-9a-f]+)')
WORD = re.compile(r'^\s*/\*\s*(0x[0-9a-f]+)\s*\*/\s*$')
FUNC = re.compile(r'^\s*Function\s*:\s*(\S+)')
REGS = re.compile(r'Function\s+(\S+?):\s+REG:(\d+)')


def compile_tree(tag, src_dir, out_dir):
    """Every ``.cu`` of ``src_dir`` into ``out_dir/<tag>/<stem>.cubin``,
    all nvcc processes at once; {stem: cubin}."""
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ('-Xcompiler', '-fPIC')]
    dest = out_dir / tag
    dest.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for src in sorted(Path(src_dir).glob('*.cu')):
        cubin = dest / (src.stem + '.cubin')
        cmd = [_build.find_nvcc(), *flags, '-cubin', '-o', str(cubin),
               str(src)]
        jobs[src.stem] = (cmd, cubin, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = {}
    for stem, (cmd, cubin, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError('nvcc failed: %s\n%s' % (' '.join(cmd), err))
        out[stem] = cubin
    return out


def disassemble(cubin, listing):
    """{mangled name: (instruction texts, instruction words, registers)}
    of the kernels in ``cubin``; the listing is written to ``listing``."""
    tool = str(Path(_build.find_nvcc()).parent / 'cuobjdump')
    sass = subprocess.run([tool, '-sass', str(cubin)], capture_output=True,
                          text=True, check=True).stdout
    listing.write_text(sass)
    usage = subprocess.run([tool, '-res-usage', str(cubin)],
                           capture_output=True, text=True,
                           check=True).stdout
    regs = {m.group(1): int(m.group(2)) for m in REGS.finditer(usage)}
    kernels, name = {}, None
    for line in sass.splitlines():
        m = FUNC.match(line)
        if m:
            name = m.group(1)
            kernels[name] = ([], [], regs.get(name))
            continue
        if name is None:
            continue
        m = INSN.match(line)
        if m:
            kernels[name][0].append(m.group(1))
            kernels[name][1].append(m.group(2))
            continue
        m = WORD.match(line)
        if m:
            kernels[name][1].append(m.group(1))
    return kernels


def demangle(names):
    """Demangled names through ``c++filt`` where it exists."""
    tool = shutil.which('c++filt')
    if not tool or not names:
        return {n: n for n in names}
    res = subprocess.run([tool], input='\n'.join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return dict(zip(names, res))


def opcode(text):
    """The opcode of an instruction, its predicate dropped."""
    return re.sub(r'^@!?U?P[T\d]+\s+', '', text).split()[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--baseline', help='a csrc directory to compare with')
    ap.add_argument('--match', default='', help='regex on demangled names')
    ap.add_argument('--top', type=int, default=30)
    ap.add_argument('--out', default=str(REPO / 'build' / 'sass'))
    args = ap.parse_args()
    out_dir = Path(args.out)
    trees = {'current': _build.CSRC_DIR}
    if args.baseline:
        trees['baseline'] = Path(args.baseline)
    found = {}
    for tag, src_dir in trees.items():
        for stem, cubin in compile_tree(tag, src_dir, out_dir).items():
            listing = out_dir / ('%s_%s.sass' % (tag, stem))
            for name, k in disassemble(cubin, listing).items():
                found[tag, name] = (stem, k)
    names = demangle(sorted({name for _, name in found}))
    pattern = re.compile(args.match)
    for (tag, name), (stem, (texts, words, regs)) in sorted(found.items()):
        if not pattern.search(names[name]):
            continue
        line = {'tree': tag, 'source': stem + '.cu', 'kernel': names[name],
                'registers': regs, 'instructions': len(texts),
                'opcodes': collections.Counter(
                    opcode(t) for t in texts).most_common(args.top)}
        if args.baseline and tag == 'current':
            other = found.get(('baseline', name))
            line['same_as_baseline'] = (None if other is None
                                        else other[1][1] == words)
        print(json.dumps(line), flush=True)


if __name__ == '__main__':
    main()
