"""The gather kernel's order of summation (``csrc/sparse.cu``
``gather_kernel``), mirrored in NumPy.

The kernel's index logic runs only on the card; this mirror follows it on
the host, so its output can be held against the kernel's (bit for bit in
the 16-bit builds, whose products of 16-bit values are exact in float32)
and against the twin (``sparse_kernels.gather_contract_ref``). It reads
the block constants from the source. The tests and ``chip_smoke.py`` use
it; nothing on the fit's path does.
"""

import re

import numpy as np
import torch

from . import _build

SOURCE = _build.CSRC_DIR / 'sparse.cu'


def kernel_constants():
    """``{'SG_NC': columns a block, 'SG_WARPS': warps a block}`` as the
    source defines them."""
    text = SOURCE.read_text()
    return {name: int(re.search(r'#define %s (\d+)' % name, text).group(1))
            for name in ('SG_NC', 'SG_WARPS')}


def slice_groups(k, itemsize):
    """32 / L for ``slice_lanes``: L lanes of one 16-byte load each
    (``16 / itemsize`` values) cover a k-slice, L = 4, 8, 16 or 32."""
    lanes = -(-k // (16 // itemsize))
    return 32 // next((L for L in (4, 8, 16) if lanes <= L), 32)


def cut_columns(lay, nc, nw):
    """How many columns of the layout ``lay`` blocks of ``nc`` columns in
    ``nw`` equal runs of nonzeros cut between runs (warps)."""
    colptr = lay.colptr.cpu().numpy().astype(np.int64)
    cut = 0
    for c0 in range(0, colptr.shape[0] - 1, nc):
        cp = colptr[c0:c0 + nc + 1]
        lo = cp[0]
        q = max(1, -(-(cp[-1] - lo) // nw))
        s0, s1 = cp[:-1], cp[1:]
        held = s1 > s0
        cut += int(((s0[held] - lo) // q != (s1[held] - 1 - lo) // q).sum())
    return cut


def _xor_tree(acc):
    """The groups' partial sums combined as the kernel's shuffle tree:
    at each level, group g adds the partial of group g ^ off."""
    acc = acc.copy()
    off = 1
    while off < acc.shape[0]:
        acc = acc + acc[np.arange(acc.shape[0]) ^ off]
        off <<= 1
    return acc[0]


def kernel_mirror(lay, Ft, k, ncols, nc, nw, groups, dtype=np.float64,
                  wrong_pieces=False):
    """``gather_kernel``'s arithmetic for the layout ``lay`` (a
    ``sparse_plan.ColumnLayout`` on any device) and Fᵀ ``Ft``: blocks of
    ``nc`` columns, ``nw`` equal runs of nonzeros per block, ``groups``
    (32 / L) interleaved partial sums per run piece, pieces of a cut column
    added in warp order, empty columns 0; in ``dtype`` (float32: the 16-bit
    builds). Returns a (k, ncols) array; unwritten outputs stay NaN.
    ``wrong_pieces``: a cut column starts from its first warp's other
    piece, a fault the tests must catch."""
    colptr, gidx = lay.colptr.cpu().numpy(), lay.gidx.cpu().numpy()
    wide = torch.float32 if dtype == np.float32 else torch.float64
    vals = lay.vals.cpu().to(wide).numpy()
    F = Ft[:, :k].cpu().to(wide).numpy()
    out = np.full((k, ncols), np.nan, dtype=dtype)
    for c0 in range(0, ncols, nc):
        cn = min(nc, ncols - c0)
        cp = colptr[c0:c0 + cn + 1]
        lo, hi = int(cp[0]), int(cp[cn])
        q = -(-(hi - lo) // nw)
        tile = np.full((cn, k), np.nan, dtype=dtype)
        piece = np.full((nw, 2, k), np.nan, dtype=dtype)
        for w in range(nw):
            a = min(hi, lo + w * q)
            b = min(hi, a + q)
            if a >= b:
                continue
            c = 0
            while cp[c + 1] <= a:
                c += 1
            s = a
            while s < b:
                e = min(b, int(cp[c + 1]))
                acc = np.zeros((groups, k), dtype=dtype)
                for base in range(s, e, 32):
                    for j in range(min(32, e - base)):
                        i = base + j
                        acc[j % groups] += vals[i] * F[gidx[i]]
                total = _xor_tree(acc)
                if cp[c] >= a and cp[c + 1] <= b:
                    tile[c] = total
                else:
                    piece[w, 0 if cp[c] <= a else 1] = total
                s = e
                c += 1
                while c < cn and cp[c + 1] <= s:
                    c += 1
        for c in range(cn):
            s0, s1 = int(cp[c]), int(cp[c + 1])
            if s0 == s1:
                tile[c] = 0.0
                continue
            w0, w1 = (s0 - lo) // q, (s1 - 1 - lo) // q
            if w0 == w1:
                continue
            first = 0 if lo + w0 * q == s0 else 1
            total = piece[w0, 1 - first if wrong_pieces else first].copy()
            for w in range(w0 + 1, w1 + 1):
                total += piece[w, 0]
            tile[c] = total
        out[:, c0:c0 + cn] = tile.T
    return out
