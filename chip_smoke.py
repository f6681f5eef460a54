#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py`` (no
arguments; one card). It builds the CUDA kernels of
``rri_nmf_tpu_torch/csrc`` and drives the port's main path at the sizes
its users run, one line per phase:

1. the card, its power limit, the torch and CUDA versions;
2. the kernel build;
3. B1's and B2's shared-memory gates at the shapes below; kernel B1
   (Gauss-Seidel topic loop) against its plain twin at the shapes of the
   fit and the transform, at the W-phases of the TM fit (k=50, 11,314
   columns) and the sparse fit (k=128, 50,000 columns), and at k=256
   (the Gram staged per topic block), the concave branch included, in
   float64 (logic, 1e-10) and float32, each launch repeated on the same
   input and matched bit for bit, with CUDA-event times of kernel and
   twin;
4. kernel B2 (projected T-phase) the same way, the concave branch, the
   feasible shortcut and k=256 (a Gram row per topic) included, plus the
   simplex checks and the Michelot round counts of its projections at
   the TM fit's shape;
5. ``nmf()`` with the phase recipe at 16384×8192 k=128 float32 (launch
   counts, a non-increasing objective, ms/sweep), and a 2048×1024 k=32
   fit on the card against the same fit on the CPU in float64;
6. ``NMF_TM_Estimator`` with the fast-TM recipe at the 20 Newsgroups
   train-split shape 11,314×26,214 k=50 on a synthetic Zipf/Dirichlet
   corpus (tf-idf and normalization on the card): fit, transform and
   score of 512 held-out documents, the Michelot round counts of the
   fitted state's T-phase, and a 600×1500 k=10 fit on the card against
   the same fit on the CPU in float64;
7. kernels B3 and B4 (the masked WRRI streaming passes) against their
   twins at the MovieLens-1M shape 6040×3952, a ragged 517×1030 and B4's
   fixed-T form, and B3 at its edge shapes (rows fewer than its
   cluster's row split, fewer columns than one stripe, an odd width), in
   float64 and float32, the updated residual included, each launch
   repeated on the same input and matched bit for bit; B3's cluster
   geometry, CUDA-event times of the wrappers (as the sweep calls them)
   and twins, and B3's kernel alone;
8. ``NMF_RS_Estimator`` at MovieLens-1M class (6040×3952, 1M synthetic
   ratings, a 90/10 split, k=40, float32 on the card): a default fit
   with validation early stopping; a fit of 30 sweeps (B3 and B4 k times
   per sweep, the masked objective not rising, ms/sweep with and without
   the objective, train and test RMSE); the transform of 512 users' test
   ratings (the sparse-mask sweep: no B3 or B4) with predict and score;
   B4's fixed-T form through ``nmf()`` with the dense mask of those
   ratings and ``'random'`` resets (B4 4k times a call); and a 600×400
   k=8 fit on the card against the same fit on the CPU in float64;
9. the sparse gather kernel, which serves B5 and B6 (the sparse
   contractions ``WᵀX`` and ``T Xᵀ``), in both directions: the layouts
   derived from the B5 and B6 plans equal, the kernel through both
   wrappers and the sweep's products (each launch repeated and matched
   bit for bit) against its twin and the two plan twins, in float64 and
   float32, at a ragged 1000×700 2% case with duplicates and an empty
   tile band (k=16, and k=128 f64 / k=200 f32: two k-slices), at the TM
   corpus as CSR (k=50, Zipf word columns) and in float32 at the JAX
   package's recorded sparse configuration, 50,000×30,000 at 0.5%
   density (~7.5M nonzeros), k=128; the host plan and the layout build
   seconds, the layout's bytes, CUDA-event times of the kernel and its
   twin, and ``torch.sparse.mm`` of the CSR X (and Xᵀ) by the factor,
   the library call for the same product, with the ratio;
10. ``nmf()`` on that matrix as a CUDA CSR tensor, k=128 float32, with
    ``sparse='mxu'``, ``'dma'``, ``'auto'`` (which densifies on an 80 GB
    card: 6 GB dense) and ``True`` (``torch.sparse.mm``): exact launch
    counts, a non-increasing objective, ms/sweep with and without it, the
    final objectives in agreement; ``'auto'`` taking B5 on a card that
    reports too little memory; and a 2000×1500 k=16 sparse fit on the
    card against the same fit on the CPU in float64;
11. ``NMF_TM_Estimator`` with ``sparse='mxu'`` on the 20 Newsgroups
    train-split shape as a CUDA CSR tensor (the counts of phase 6, tf-idf
    and normalization kept sparse on the card): fit, a sparse transform
    of 512 documents, and score;
12. ``nmf()`` with every default (the interleaved order with
    ``'max_resid_document'`` resets, the plain sweep of ``ops/sweep.py``,
    no kernel of this repo) at 16384×8192 k=128 float32: a non-increasing
    objective, ms/sweep with and without it beside the byte floor of the
    W side (X streamed once per topic), the speculative sweep run with
    every synchronizing CUDA call an error, its kernels and device ms per
    sweep (``torch.profiler``), and its time as one CUDA graph and as
    separate launches (the same bits);
13. the same fit from a warm start with a dead topic: the reset fires,
    ``n_resets_remaining`` drops, the objective does not rise;
14. ``use_pallas=False`` in phase order at the same shape (the plain
    Gram-blocked sweep) beside the kernel sweep of phase 5, and the kernel
    sweep with resets on (B1, one check a sweep): ms/sweep, and final
    objectives within 1e-4;
15. ``NMF_TM_Estimator`` with its default preset on the corpus of phase
    6: a fit (ms/sweep beside the byte floor), then transform (B1 four
    times a call, the W-phase with T fixed) and score of the 512 held-out
    documents, T and transform rows on the simplex;
16. card (float32) against CPU (float64) from one init, with the same
    reset count and the same reset documents: the default ``nmf()`` at
    2048×1024 k=32 with a dead topic, the TM default preset at 600×1500
    k=10, a masked fit with ``'max_resid_document'`` at 600×400 k=8;
17. the gather kernel as the Gram-phase sparse-mask sweep calls it, on
    the mask's layouts with M⊙X as a second value set: A = Wᵀ(M⊙X) and
    C = (M⊙X)Tᵀ (k rows), Γ and Θ (the k(k+1)/2 Khatri-Rao rows) and a
    p·k-row panel, at the MovieLens shape (k=40, float64 and float32)
    and at the JAX package's recorded masked shape, 100,000×50,000 with
    25M observations, k=32 (float32): against the twin, each launch
    repeated and matched bit for bit, CUDA-event times beside
    ``torch.sparse.mm`` of the mask's CSR by the same rows, the host plan
    seconds;
18. ``nmf()`` on that recorded problem (scipy CSR X and mask, float32 on
    the card): ``update_order='phase'`` (the Gram-phase sweep, 4 gather
    launches a sweep and 2 an objective), its Gram objective against the
    observed-entry one, the defaults (the O(nnz) interleaved sweep, no
    kernel of this repo, sync-free, one CUDA graph a sweep), and a k=128
    sweep in Γ/Θ panels: launch counts, non-increasing objectives, ms
    per sweep, device time by kernel, peak memory;
19. ``NMF_RS_Estimator(sparse_obs=True)`` on phase 8's ratings: a default
    fit (the O(nnz) sweep), transform, predict and score, its held-out
    RMSE beside phase 8's dense-mask fit; the same with
    ``nmf_kwargs=dict(update_order='phase')`` (the Gram-phase sweep);
    and a 600×400 k=8 sparse-obs fit of each kind on the card against
    the CPU in float64.

Phases 5-6, phase 8, phases 10-11, phases 12-16 and phases 18-19 each
drive a main path with the launch counts set to 0 just before and read
just after (no kernel of this repo runs in phases 12-13; phases 14-15
run B1; phases 18-19 the gather kernel). Then one JSON
line of the kernels (those launches, error against the twin, kernel and
twin ms, the least time the card could take for the same work with what
binds it, and the library call's ms where one computes the same
function), and as the last line
``{"ok": true, "device": {...}}``. Any failure raises before that line
and exits non-zero; without a CUDA device the script exits non-zero
before doing anything. Data come from numpy seeds.
"""

import json
import logging
import subprocess
import sys
import time

import numpy as np
import torch

# float64 logic check: the kernel and its twin differ only in summation
# order, so they agree to ~1e-14 relative; 1e-10 leaves margin yet
# catches any indexing or branch fault.
TOL_F64 = 1e-10
# float32: the numerators N - G·F sum k products in another order than
# the twin (a cuBLAS GEMV), and the Gauss-Seidel chain over k topics
# carries that rounding (float32 eps 6e-8) forward: ~1e-6 of the row
# scale at these shapes on an H100; 1e-4 keeps margin for cancellation
# in N - G·F. Logic errors are caught by the float64 check above.
# The same 1e-4 holds B3/B4 in float32 (phase 7): the kernels fuse each
# rank-one update into one FMA where the twin rounds twice (one rounding
# of R, relative to its largest entry), and each column (B3) or row (B4)
# sum adds up to 6040 or 3952 products in another order than the twin's
# GEMV: about sqrt(terms)·eps ≈ 5e-6 of the sum of absolute terms, the
# scale phase 7 divides by (n·eps ≈ 4e-4 only in the worst case).
TOL_F32 = 1e-4
# float32 row sums of a simplex-projected row over d <= 26214 columns,
# re-summed by torch in another order: |sum - s| <= d·eps·s ≈ 2e-3 in
# the worst case, ~1e-6 in practice; 1e-4 is stated.
TOL_SIMPLEX_F32 = 1e-4
# float32 objective slack: 0.5||X - WT||² is a sum of n·d squares in
# float32; successive values may tick up by rounding, not by descent.
# The same 1e-5 holds the sparse objective 0.5(||X||² - 2·cross +
# tr(WᵀW·TTᵀ)) (phases 10-11): each term is a float32 sum over 7.5M
# nonzeros or a k×k Gram product, good to ~1e-6 of its size (tree sums on
# the card), and a rank-k fit of these random sparse matrices keeps the
# objective near 0.5||X||², so the cancellation costs less than a digit.
OBJ_SLACK_F32 = 1e-5
# The published peaks of an H100 SXM at 700 W (NVIDIA's data sheet): the
# bound of a kernel's timed call is the larger of its flop over the rate
# of its type outside the tensor cores and its bytes (each input read
# once, each output written once) over the memory rate.
PEAK_FLOPS = {'float32': 67e12, 'float64': 34e12}
PEAK_BYTES_PER_S = 3.35e12
# card float32 vs CPU float64 fit of the same problem from the same init:
# final objectives after 20 sweeps differ by float32 rounding of the
# trajectory (~1e-6 relative); 1e-3 is stated.
TOL_CPU_GPU_OBJ = 1e-3

B1 = {'name': 'gs', 'route': 'cuda',
      'source': 'rri_nmf_tpu_torch/csrc/gs.cu',
      'replaces': 'rri_nmf_tpu/ops/dense_pallas.py:151'}
B2 = {'name': 'tm_proj', 'route': 'cuda',
      'source': 'rri_nmf_tpu_torch/csrc/tm_proj.cu',
      'replaces': 'rri_nmf_tpu/ops/dense_pallas.py:248'}
B3 = {'name': 'masked_phase_a', 'route': 'cuda',
      'source': 'rri_nmf_tpu_torch/csrc/masked.cu',
      'replaces': 'rri_nmf_tpu/ops/sweep_pallas.py:94'}
B4 = {'name': 'masked_phase_b', 'route': 'cuda',
      'source': 'rri_nmf_tpu_torch/csrc/masked.cu',
      'replaces': 'rri_nmf_tpu/ops/sweep_pallas.py:133'}
# B5 and B6: one kernel, gather_kernel, serves both plans
B5 = {'name': 'sparse_mxu', 'route': 'cuda',
      'source': 'rri_nmf_tpu_torch/csrc/sparse.cu',
      'replaces': 'rri_nmf_tpu/ops/sparse_mxu.py:298'}
B6 = {'name': 'sparse_dma', 'route': 'cuda',
      'source': 'rri_nmf_tpu_torch/csrc/sparse.cu',
      'replaces': 'rri_nmf_tpu/ops/sparse_dma.py:164'}
FAST_TM = dict(update_order='phase', reset_topic_method=None)

# (n, d, k): bench.py's headline fit; the small card-vs-CPU fit
NMF_SHAPE = (16384, 8192, 128)
SMALL_SHAPE = (2048, 1024, 32)
# (train docs, held-out docs, words, topics): the 20 Newsgroups
# train-split shape of BASELINE #2
TM_SHAPE = (11314, 512, 26214, 50)
# (docs, words, topics) of the small card-vs-CPU estimator fit
TM_SMALL = (600, 1500, 10)
# B2 shapes: the TM fit's T-phase, bench.py's (k, d), and a k whose Gram
# (256 KB in float32) does not fit shared memory beside the slice, so a
# block loads one Gram row per topic (in float64 the slice does not fit
# either and is worked in place in the output)
TM_PROJ_SHAPES = [(50, 26214), (128, 8192), (256, 4000)]
# B1 at two more W-phases (k, columns): the TM fit's, and the sparse
# fit's at SPARSE_SHAPE
GS_W_SHAPES = [(50, 11314), (128, 50000)]
# B1 where the whole Gram does not fit beside the strip (k=256: 299 KB in
# float32, 594 KB in float64), so each topic block stages its 16 Gram rows
GS_STAGED = (256, 3000)
SWEEPS = 20
# (users, items, observations, topics): MovieLens-1M class, BASELINE #3
RS_SHAPE = (6040, 3952, 1_000_000, 40)
# a ragged B3/B4 shape (no dimension a multiple of a warp or a block;
# B3's scalar-load form in float32)
RS_RAGGED = (517, 1030)
# B3's edge shapes: two row tiles for a cluster of eight (six ranks sum
# nothing), fewer columns than one stripe, an odd width (the scalar-load
# form in both dtypes)
RS_B3_EDGES = [(40, 300), (700, 100), (300, 257)]
# (users, items, observations, topics) of the small card-vs-CPU RS fit
RS_SMALL = (600, 400, 24000, 8)
RS_SWEEPS = 30
# users whose test ratings the RS transform takes
RS_TRANSFORM_ROWS = 512
# (n, d, density, k): the JAX package's recorded sparse configuration
# (benchmarks/results_round2_sparse_mxu.json), and B5/B6's ragged float64
# case (duplicates, an empty 128-column band)
SPARSE_SHAPE = (50000, 30000, 0.005, 128)
SPARSE_RAGGED = (1000, 700, 0.02, 16)
# (n, d, density, k) of the small card-vs-CPU sparse fit
SPARSE_SMALL = (2000, 1500, 0.02, 16)
SPARSE_SWEEPS = 10
# the sparse modes' final objectives (float32, 10 sweeps from one init):
# B5 and B6 run one kernel on equal layouts, 'auto' the dense GEMMs, True
# torch.sparse.mm; the trajectories differ by float32 rounding (~1e-6
# relative); 1e-4 is stated. The same 1e-4 holds the plain Gram-blocked
# phase sweep (use_pallas=False) against the kernel sweep (phase 14): the
# same coordinate updates, summed in another order.
TOL_MODES = 1e-4
# sweeps of the interleaved nmf() (phases 12-13) and of the default-preset
# TM fit (phase 15)
INTERLEAVED_SWEEPS = 5
TM_DEFAULT_SWEEPS = 10
# (n, d, k) of the small card-vs-CPU default nmf() (phase 16), whose row
# BUMP_ROW carries a large residual, so the reset's document is not a
# float32 tie; (users, items, observations, k) of the masked one
DEFAULT_SMALL = (2048, 1024, 32)
BUMP_ROW = 777
MASKED_SMALL = (600, 400, 24000, 8)
# (n, d, observations, k): the JAX package's recorded sparse-mask problem
# (benchmarks/exp_round5_masked.py, the defaults of its main()), the rank
# of its panel run, and the Gram-phase sweeps of phase 18
MASKED_RECORD = (100_000, 50_000, 25_000_000, 32)
MASKED_PANEL_K = 128
GRAM_SWEEPS = 5
INTERLEAVED_MASKED_SWEEPS = 3
# the gate's panel (rows p·k): p at the MovieLens shape
GRAM_GATE_PANEL = 4
# The Gram objective 0.5(Σ m x² − 2·cross + quad) against the
# observed-entry sum 0.5 Σ m (x − (WT))², relative to Σ m x²: each of
# the three terms is a float32 sum over up to 25M observations or k²n
# products, summed as trees on the card (~log2(terms)·eps ≈ 2e-6 of its
# size, and each term is at most ~Σ m x²); 1e-4 is stated.
TOL_GRAM_OBJ = 1e-4
# Held-out RMSE of the sparse-mask default fit against the dense-mask
# one (phase 19 against phase 8): the same interleaved updates in another
# summation order (float32); 1e-2 relative is stated.
TOL_RMSE_ROUTES = 1e-2


def log(phase, **fields):
    print(json.dumps({'phase': phase, **fields}), flush=True)


def sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def time_ms(fn, dev, runs=5):
    """Median milliseconds of ``fn()`` over ``runs`` runs after one
    warm-up: CUDA events on a card, the host clock otherwise."""
    fn()
    sync(dev)
    out = []
    for _ in range(runs):
        if dev.type == 'cuda':
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
        else:
            t = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t) * 1e3)
    return float(np.median(out))


def bound(flop, nbytes, dtype='float32'):
    """``(bound_ms, bound_by)``: the least time the card could take for
    ``flop`` operations in ``dtype`` moving ``nbytes``, and which of the
    two binds."""
    t_ops = flop / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ('operations' if t_ops > t_bytes
                                 else 'bytes')


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def scaled_err(a, b, scale):
    """max |a - b| / scale, entry by entry: ``scale`` is each sum's sum of
    absolute terms, the size its rounding error is proportional to."""
    return float(((a - b).abs() / scale.clamp_min(1e-300)).max())


# --------------------------------------------------------------------------
# data (numpy seeds)
# --------------------------------------------------------------------------

def lowrank(n, d, k, dev, seed=0, noise=0.01):
    """Low-rank plus noise X (benchmarks/run_baselines.py _synth_lowrank),
    float32 on ``dev``; the rank-k product is formed on the device."""
    rng = np.random.RandomState(seed)
    W = torch.as_tensor(rng.rand(n, k), dtype=torch.float32, device=dev)
    T = torch.as_tensor(rng.rand(k, d), dtype=torch.float32, device=dev)
    E = torch.as_tensor(rng.rand(n, d).astype(np.float32), device=dev)
    return (W @ T).add_(E, alpha=noise)


def synth_ratings(n_users, n_items, n_obs, k, seed=0):
    """MovieLens-like ratings (benchmarks/run_baselines.py
    _synth_ratings): a low-rank preference structure, ``n_obs`` random
    (user, item) draws, integer ratings 1-5. Returns float64 numpy."""
    rng = np.random.RandomState(seed)
    U = rng.rand(n_users, k)
    V = rng.rand(k, n_items)
    scores = U @ V
    scores = 1 + 4 * (scores - scores.min()) / (scores.max() - scores.min())
    I = rng.randint(0, n_users, n_obs)
    J = rng.randint(0, n_items, n_obs)
    X = np.zeros((n_users, n_items))
    X[I, J] = np.clip(np.round(scores[I, J] + 0.5 * rng.randn(n_obs)), 1, 5)
    return X


def rs_split(X, seed=1):
    """(pairs, ratings) of the nonzeros of ``X``, split 90/10 over the
    observations with ``RandomState(seed)`` (benchmarks/exp_rs_target.py
    :32-40): ``(train pairs, train ratings, test pairs, test ratings)``."""
    I, J = X.nonzero()
    R = X[I, J]
    pairs = np.stack([I, J], axis=1)
    test = np.random.RandomState(seed).rand(len(R)) < 0.1
    return pairs[~test], R[~test], pairs[test], R[test]


def zipf_corpus(n_docs, n_words, n_topics, seed=0, doc_len=120):
    """Synthetic topic-model counts (benchmarks/run_baselines.py
    _synth_text): permuted-Zipf topics, Dirichlet(0.1) mixtures,
    multinomial documents of ``doc_len`` words. Returns float32 numpy."""
    rng = np.random.RandomState(seed)
    rank = 1.0 / np.arange(1, n_words + 1, dtype=float)
    topics = np.zeros((n_topics, n_words))
    for t in range(n_topics):
        topics[t, rng.permutation(n_words)] = rank
        topics[t] /= topics[t].sum()
    probs = rng.dirichlet(np.full(n_topics, 0.1), size=n_docs) @ topics
    probs /= probs.sum(axis=1, keepdims=True)
    X = np.zeros((n_docs, n_words), dtype=np.float32)
    for i in range(n_docs):
        X[i] = rng.multinomial(doc_len, probs[i])
    return X


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def gs_cases(X, Xt_new, T_new, k, dev, seed=1):
    """B1 inputs at the fit's shapes (X (n, d), k topics) and the
    transform's (the learned T_new (k', d) against Xt_new (d, m)):
    ``(label, G, N, F, kwargs)`` in float64."""
    rng = np.random.RandomState(seed)
    n, d = X.shape
    X = X.double()
    W = torch.as_tensor(rng.rand(n, k), device=dev)
    T = torch.as_tensor(rng.rand(k, d), device=dev)
    Wd = W.clone()
    Wd[:, 5] = 0                                   # a dead topic
    Td = T.clone()
    Td[5] = 0
    ub = torch.as_tensor(rng.rand(n) + 0.5, device=dev)
    Tn = T_new.double()
    k_new, m_new = Tn.shape[0], Xt_new.shape[1]
    Wn = torch.as_tensor(rng.rand(k_new, m_new), device=dev)
    Wn = Wn / Wn.sum(0, keepdim=True)
    inf = float('inf')
    extra = []
    for label, (kk, mm) in ([('W-phase', s) for s in GS_W_SHAPES]
                            + [('staged Gram', GS_STAGED)]):
        A = torch.as_tensor(rng.rand(kk, 256), device=dev)
        G = A @ A.T
        extra.append(('%s k=%d m=%d' % (label, kk, mm), G,
                      G @ torch.as_tensor(rng.rand(kk, mm), device=dev),
                      torch.as_tensor(rng.rand(kk, mm), device=dev),
                      dict(l1=0.0, l2=0.0, bound=inf)))
    return [
        ('T-phase k=%d m=%d' % (k, d), W.T @ W, W.T @ X, T,
         dict(l1=0.0, l2=0.0, bound=inf)),
        ('T-phase neg-l1', W.T @ W, W.T @ X, T,
         dict(l1=-0.05, l2=0.1, bound=inf)),
        ('T-phase dead topic', Wd.T @ Wd, Wd.T @ X, T,
         dict(l1=-0.01, l2=0.0, bound=1.0)),
        ('T-phase reps=3', W.T @ W, W.T @ X, T,
         dict(l1=0.0, l2=0.0, bound=inf, reps=3)),
        ('W-phase k=%d m=%d' % (k, n), T @ T.T, T @ X.T, W.T.contiguous(),
         dict(l1=0.0, l2=0.0, bound=inf)),
        ('W-phase dead topic, vector ub', Td @ Td.T, Td @ X.T,
         W.T.contiguous(), dict(l1=-0.05, l2=0.0, bound=inf, ub=ub)),
        ('transform W-phase k=%d m=%d' % (k_new, m_new), Tn @ Tn.T,
         Tn @ Xt_new.double(), Wn, dict(l1=0.0, l2=0.0, bound=1.0)),
    ] + extra


def check_dense_gates(dk, dev):
    """B1's and B2's gates on the card (the launchers' own): the main
    path's shapes and the staged layouts of GS_STAGED and
    TM_PROJ_SHAPES fit in both dtypes; a float64 k=4096 strip, a Gram row
    of k=40000 in float64 and d past 2^24 do not."""
    want = {}
    for dt in (torch.float32, torch.float64):
        name = str(dt).split('.')[1]
        for kk in (50, 128, GS_STAGED[0]):
            want['gs k=%d %s' % (kk, name)] = (dk.gs_fits(kk, dt, dev), True)
        for kk, dd in TM_PROJ_SHAPES:
            want['tm_proj k=%d d=%d %s' % (kk, dd, name)] = (
                dk.tm_proj_fits(kk, dd, dt, dev), True)
    want['gs k=4096 float64'] = (dk.gs_fits(4096, torch.float64, dev), False)
    want['tm_proj k=40000 d=100 float64'] = (
        dk.tm_proj_fits(40000, 100, torch.float64, dev), False)
    want['tm_proj k=50 d=2^24+1 float32'] = (
        dk.tm_proj_fits(50, 2 ** 24 + 1, torch.float32, dev), False)
    wrong = {key: got for key, (got, exp) in want.items() if got != exp}
    if wrong:
        raise AssertionError('dense shared-memory gates: %s' % wrong)
    # a fit the kernels cover by design raises where the gate refuses it,
    # with resets or without; use_pallas=False takes the plain sweep
    from rri_nmf_tpu_torch.nmf import nmf
    X = torch.rand(64, 48, dtype=torch.float64, device=dev)
    for kw in (dict(reset_topic_method=None), {}):
        try:
            nmf(X, 4096, max_iter=1, update_order='phase', **kw)
        except ValueError as e:
            if 'do not fit' not in str(e):
                raise
        else:
            raise AssertionError('a refused gate did not raise: %r' % kw)
    r = nmf(X, 4096, max_iter=1, use_pallas=False, **FAST_TM)
    if not bool(torch.isfinite(r['T']).all()):
        raise AssertionError('use_pallas=False at k=4096: non-finite T')
    log('dense gates', refused_gate_raises=True,
        **{key: got for key, (got, _) in want.items()})


def check_kernel(name, update, ref, cases, dev, timed):
    """Kernel vs twin on every case in float64 and float32, each launch
    repeated on the same input and matched bit for bit; times the cases
    named in ``timed``. Returns (max float32 error, ms, plain_ms) of the
    first timed case."""
    worst32, ms, plain_ms = 0.0, None, None
    for label, *args, kw in cases:
        for dtype, tol in ((torch.float64, TOL_F64),
                           (torch.float32, TOL_F32)):
            a = [x.to(dtype).contiguous() for x in args]
            kwd = {key: (v.to(dtype) if isinstance(v, torch.Tensor) else v)
                   for key, v in kw.items()}
            got = update(*a, **kwd)
            again = update(*a, **kwd)
            want = ref(*a, **kwd)
            sync(dev)
            err = rel_err(got, want)
            if not (err <= tol and bool(torch.isfinite(got).all())):
                raise AssertionError('%s %s %s: error %.3g > %g'
                                     % (name, label, dtype, err, tol))
            if not torch.equal(got, again):
                raise AssertionError('%s %s %s: two launches on the same '
                                     'input differ' % (name, label, dtype))
            line = {'case': label, 'dtype': str(dtype), 'rel_err': err,
                    'bitwise_repeat': True}
            if dtype == torch.float32:
                worst32 = max(worst32, float((got - want).abs().max()))
                if label in timed:
                    line['ms'] = time_ms(lambda: update(*a, **kwd), dev)
                    line['plain_ms'] = time_ms(lambda: ref(*a, **kwd), dev)
                    if ms is None:
                        ms, plain_ms = line['ms'], line['plain_ms']
            log('kernel %s' % name, **line)
    return worst32, ms, plain_ms


def tm_cases(k_d_list, dev, seed=2):
    """B2 inputs: (label, G, N, F, kwargs) in float64, F on the simplex."""
    rng = np.random.RandomState(seed)
    out = []
    for k, d in k_d_list:
        n = 2048
        W = torch.as_tensor(rng.rand(n, k), device=dev)
        Xs = torch.as_tensor(rng.rand(n, d) ** 8, device=dev)
        F = torch.as_tensor(rng.rand(k, d), device=dev)
        F = F / F.sum(1, keepdim=True)
        out.append(('k=%d d=%d' % (k, d), W.T @ W, W.T @ Xs, F,
                    dict(l1=0.0, l2=0.0, s=1.0)))
        if len(out) == 1:
            Wd = W.clone()
            Wd[:, 3] = 0                           # concave branch
            out.append(('k=%d d=%d dead topic' % (k, d), Wd.T @ Wd,
                        Wd.T @ Xs, F, dict(l1=0.0, l2=0.0, s=1.0)))
            # the feasible shortcut: G = I and F = 0, so numer = N, and
            # the even rows' N / (1 + eps) are powers of two summing to 1
            Nf = torch.as_tensor(rng.rand(k, d) - 0.5, device=dev)
            pat = torch.full((d,), -1.0, dtype=torch.float64, device=dev)
            pat[[0, d // 3, 2 * d // 3, d - 1]] = torch.tensor(
                [0.5, 0.25, 0.125, 0.125], dtype=torch.float64, device=dev)
            Nf[::2] = pat * (1 + float(np.spacing(10)))
            out.append(('k=%d d=%d feasible rows' % (k, d),
                        torch.eye(k, dtype=torch.float64, device=dev), Nf,
                        torch.zeros_like(F), dict(l1=0.0, l2=0.0, s=1.0)))
            out.append(('k=%d d=%d reps=3 l2' % (k, d), W.T @ W, W.T @ Xs,
                        F, dict(l1=0.0, l2=0.5, s=1.0, reps=3)))
    return out


def michelot_rounds(G, N, F, l1, l2, s):
    """The Michelot round counts of B2's projections on these inputs:
    the serial twin's chain (``dense_kernels.tm_proj_update_ref``), its
    rounds counted, first projections and drift re-projections apart.
    Each round is one row-wide reduction of the kernel, after the (sum,
    min) one of each topic."""
    from rri_nmf_tpu_torch.matrixops import EPS_DIV_BY_ZERO

    def project(v):
        d = v.numel()
        sv = v.sum()
        if bool(sv == s) and bool(v.min() >= 0):
            return v, 0
        tau = (sv - s) / d
        m_prev, it, changed = d + 1, 0, True
        while changed and it < d + 2:
            active = v > tau
            m = int(active.sum())
            tau = (torch.where(active, v, 0.0).sum() - s) / max(m, 1)
            changed, m_prev, it = m != m_prev, m, it + 1
        return torch.where(v > tau, v - tau, 0.0), it

    F = F.clone()
    first, drift = [], []
    for t in range(F.shape[0]):
        gtt = G[t, t]
        numer = N[t] - G[t] @ F + gtt * F[t] - l1
        if bool(gtt + l2 > 0):
            row, r = project(numer.clamp_min(0.0) / (gtt + l2
                                                     + EPS_DIV_BY_ZERO))
            first.append(r)
        else:
            row = torch.zeros_like(F[t])
            row[int(torch.argmax(numer))] = s
        if bool((row.sum() - s).abs() > 1e-15):
            row, r = project(row)
            drift.append(r)
        F[t] = row
    k = F.shape[0]
    return {'topics': k,
            'first_mean': float(np.mean(first)) if first else 0.0,
            'first_max': max(first, default=0),
            'drift_reprojections': len(drift),
            'drift_mean': float(np.mean(drift)) if drift else 0.0,
            'drift_max': max(drift, default=0),
            'reductions_per_topic': (k + sum(first) + sum(drift)) / k}


def check_simplex(T, s, what):
    T = T.float()
    dev_sum = float((T.sum(1) - s).abs().max())
    if dev_sum > TOL_SIMPLEX_F32 or float(T.min()) < 0:
        raise AssertionError('%s off the simplex: |sum-s| %.3g, min %.3g'
                             % (what, dev_sum, float(T.min())))
    return dev_sum


def run_nmf_phase(dev, dk, nmf, frob):
    n, d, k = NMF_SHAPE
    X = lowrank(n, d, k, dev, seed=0)
    before = dict(dk.LAUNCHES)
    t0 = time.perf_counter()
    res = nmf(X, k, max_iter=SWEEPS, compute_obj_each_iter=True,
              random_state=0, **FAST_TM)
    sync(dev)
    wall = time.perf_counter() - t0
    gs = dk.LAUNCHES['gs'] - before['gs']
    obj = res['obj_history']
    sweeps = len(obj)
    if gs != 2 * sweeps or dk.LAUNCHES['tm_proj'] != before['tm_proj']:
        raise AssertionError('nmf(): %d B1 launches for %d sweeps' %
                             (gs, sweeps))
    for a, b in zip(obj, obj[1:]):
        if b > a + OBJ_SLACK_F32 * abs(a):
            raise AssertionError('objective rose: %r -> %r' % (a, b))
    W, T = res['W'], res['T']
    if not (bool(torch.isfinite(W).all()) and bool(torch.isfinite(T).all())
            and np.all(np.isfinite(obj))):
        raise AssertionError('non-finite factors or objective')
    stamps = np.diff([0.0] + list(res['iter_cputime']))
    # sweep-only time: the same fit continued, no objective per sweep
    res2 = nmf(X, k, max_iter=10, W_in=W, T_in=T, random_state=0,
               **FAST_TM)
    sync(dev)
    sweep_ms = float(np.median(np.diff(res2['iter_cputime']))) * 1e3
    log('nmf %dx%d k=%d float32' % (n, d, k), sweeps=sweeps,
        gs_launches=gs, obj_first=obj[0], obj_last=obj[-1],
        rel_frobenius_error=frob(X, W, T), wall_s=wall,
        ms_per_sweep_with_objective=float(np.median(stamps[1:])) * 1e3,
        ms_per_sweep=sweep_ms)

    # the same fit on the card (float32) and on the CPU (float64, twins)
    n, d, k = SMALL_SHAPE
    kw = dict(max_iter=SWEEPS, compute_obj_each_iter=True, init='random',
              random_state=3, **FAST_TM)
    Xs = lowrank(n, d, k, torch.device('cpu'), seed=4).double()
    o_gpu = nmf(Xs.to(dev).float(), k, **kw)['obj_history']
    o_cpu = nmf(Xs, k, **kw)['obj_history']
    diff = abs(o_gpu[-1] - o_cpu[-1]) / abs(o_cpu[-1])
    if len(o_gpu) != len(o_cpu) or not diff <= TOL_CPU_GPU_OBJ:
        raise AssertionError('card vs CPU objective: %r vs %r'
                             % (o_gpu[-1], o_cpu[-1]))
    log('nmf %dx%d k=%d card float32 vs cpu float64' % (n, d, k),
        sweeps=len(o_gpu), obj_card=o_gpu[-1], obj_cpu=o_cpu[-1],
        rel_diff=diff)


def _tm_fit(Est, X, k, iters, **nmf_kwargs):
    n, d = X.shape
    return Est(n, d, k, random_state=0, max_iter=iters,
               nmf_kwargs=dict(FAST_TM, **nmf_kwargs)).fit(X)


def run_tm_phase(dev, dk, Est, counts):
    from rri_nmf_tpu_torch.matrixops import normalize, tfidf
    n_train, _, _, k = TM_SHAPE
    X = torch.as_tensor(counts, device=dev)
    # tf-idf and row normalization on the card, the train split's idf
    # applied to the held-out documents
    Xtr, idf = tfidf(X[:n_train], return_idf=True)
    Xtr = normalize(Xtr)
    Xte = normalize(X[n_train:] * idf)
    del X
    n, d = Xtr.shape
    b0 = dict(dk.LAUNCHES)
    t0 = time.perf_counter()
    est = _tm_fit(Est, Xtr, k, SWEEPS)
    sync(dev)
    fit_s = time.perf_counter() - t0
    b1 = dict(dk.LAUNCHES)
    sweeps = len(est.nmf_outputs['iter_cputime'])
    if (b1['tm_proj'] - b0['tm_proj'] != sweeps
            or b1['gs'] - b0['gs'] != sweeps):
        raise AssertionError('fit: B2 %d, B1 %d launches for %d sweeps' % (
            b1['tm_proj'] - b0['tm_proj'], b1['gs'] - b0['gs'], sweeps))
    t_dev = check_simplex(est.T, 1.0, 'T rows')
    # the rounds B2's projections take at the fitted state
    W = est.W
    log('michelot rounds, fitted TM state %dx%d k=%d float32' % (n, d, k),
        **michelot_rounds(W.T @ W, W.T @ Xtr, est.T.contiguous(), 0.0, 0.0,
                          1.0))
    Wn = est.transform(Xte)
    sync(dev)
    b2 = dict(dk.LAUNCHES)
    if b2['gs'] - b1['gs'] != 4 or b2['tm_proj'] != b1['tm_proj']:
        raise AssertionError('transform: %d B1 launches for 4 sweeps'
                             % (b2['gs'] - b1['gs']))
    w_dev = check_simplex(Wn, 1.0, 'transform rows')
    r2 = est.score(Xte)
    scores = est.score_all(Xte)
    sync(dev)
    if not (np.isfinite(r2) and all(np.isfinite(v)
                                    for v in scores.values())):
        raise AssertionError('non-finite score: %r %r' % (r2, scores))
    stamps = np.diff([0.0] + list(est.nmf_outputs['iter_cputime']))
    log('NMF_TM_Estimator %dx%d k=%d float32' % (n, d, k), sweeps=sweeps,
        fit_s=fit_s, s_per_sweep=float(np.median(stamps[1:])),
        T_row_sum_err=t_dev, transform_rows=list(Wn.shape),
        transform_row_sum_err=w_dev, score_r2=r2, **scores)

    # the same small fit on the card (float32) and on the CPU (float64)
    small = normalize(tfidf(torch.as_tensor(zipf_corpus(*TM_SMALL, seed=1),
                                            dtype=torch.float64)))
    kw = dict(init='random', compute_obj_each_iter=True)
    o_gpu = _tm_fit(Est, small.to(dev).float(), TM_SMALL[2], SWEEPS,
                    **kw).nmf_outputs['obj_history']
    o_cpu = _tm_fit(Est, small, TM_SMALL[2], SWEEPS,
                    **kw).nmf_outputs['obj_history']
    diff = abs(o_gpu[-1] - o_cpu[-1]) / abs(o_cpu[-1])
    if len(o_gpu) != len(o_cpu) or not diff <= TOL_CPU_GPU_OBJ:
        raise AssertionError('TM card vs CPU objective: %r vs %r'
                             % (o_gpu[-1], o_cpu[-1]))
    log('NMF_TM_Estimator %dx%d k=%d card float32 vs cpu float64'
        % TM_SMALL, sweeps=len(o_gpu), obj_card=o_gpu[-1],
        obj_cpu=o_cpu[-1], rel_diff=diff)


def masked_cases(dev, X, M, seed=6):
    """B3/B4 inputs at the RS shape (the ratings ``X`` and their mask
    ``M``, a residual of random factors) and at the ragged shape, and B3's
    at its edge shapes: ``(label, kernel, R, M, args)`` in float64,
    ``args`` without R and M."""
    rng = np.random.RandomState(seed)
    out = []
    n_r, d_r = RS_RAGGED
    for tag, X, M in (('rs', X, M),
                      ('ragged', torch.as_tensor(rng.rand(n_r, d_r) * 5,
                                                 device=dev),
                       torch.as_tensor((rng.rand(n_r, d_r) < 0.3) * 1.0,
                                       device=dev))):
        n, d = X.shape
        W = torch.as_tensor(rng.rand(n, 4), device=dev)
        T = torch.as_tensor(rng.rand(4, d), device=dev)
        R = X.double() - W @ T
        M = M.double()
        dw = torch.as_tensor(rng.rand(n) - 0.5, device=dev)
        t_new = torch.as_tensor(rng.rand(d), device=dev)
        label = '%s %dx%d' % (tag, n, d)
        out.append(('B3 ' + label, 'phase_a', R, M,
                    (dw, T[1], W[:, 0].contiguous())))
        out.append(('B4 ' + label, 'phase_b', R, M,
                    (W[:, 0].contiguous(), 1.3 * W[:, 0], T[0], t_new)))
        out.append(('B4 fixed-T ' + label, 'phase_b', R, M,
                    (dw, torch.zeros_like(dw), T[0], t_new)))
    for n, d in RS_B3_EDGES:
        R = torch.as_tensor(rng.randn(n, d), device=dev)
        M = torch.as_tensor((rng.rand(n, d) < 0.3) * 1.0, device=dev)
        out.append(('B3 edge %dx%d' % (n, d), 'phase_a', R, M,
                    tuple(torch.as_tensor(v, device=dev) for v in (
                        rng.rand(n) - 0.5, rng.rand(d), rng.rand(n)))))
    return out


def b3_alone_ms(mk, R, M, dw, t_prev, w, dev, reps=20):
    """B3's kernel alone: ``reps`` launches of the C entry straight after
    each other (outputs allocated once, no checks) between two CUDA
    events, over ``reps``."""
    from rri_nmf_tpu_torch.ops import _build
    n, d = R.shape
    wR0, nw = torch.empty(d, device=dev), torch.empty(d, device=dev)
    fn = _build.load().rri_masked_phase_a_f32
    args = (R.data_ptr(), M.data_ptr(), dw.data_ptr(), t_prev.data_ptr(),
            w.data_ptr(), wR0.data_ptr(), nw.data_ptr(), n, d,
            mk.phase_a_layout(n, d, 4)[1], dev.index,
            torch.cuda.current_stream(dev).cuda_stream)

    def run():
        for _ in range(reps):
            if fn(*args):
                raise AssertionError('B3 launch failed')
    return time_ms(run, dev) / reps


def check_masked(mk, cases, dev):
    """B3/B4 against their twins on every case in float64 and float32:
    the updated residual relative to its largest entry, each reduction
    relative to its own sum of absolute terms. Times the RS-shape cases in
    float32. Returns {kernel: (max float32 abs error, ms, plain_ms,
    bound_ms, bound_by)}: per element of R, B3 reads R and M and writes R
    (7 flop), B4 the same (9 flop), besides their vectors."""
    out = {'phase_a': [0.0, None, None, None, None],
           'phase_b': [0.0, None, None, None, None]}
    for label, kind, R, M, args in cases:
        kernel = getattr(mk, kind)
        ref = getattr(mk, kind + '_ref')
        for dtype, tol in ((torch.float64, TOL_F64),
                           (torch.float32, TOL_F32)):
            R0, Mc = R.to(dtype).contiguous(), M.to(dtype).contiguous()
            a = [x.to(dtype).contiguous() for x in args]
            Rk, Rr, Rt = R0.clone(), R0.clone(), R0.clone()
            got = kernel(Rk, Mc, *a)
            again = kernel(Rr, Mc, *a)
            want = ref(Rt, Mc, *a)
            # each sum's scale: the same sum over absolute terms
            if kind == 'phase_a':
                scales = ((Mc * Rt.abs()).T @ a[2].abs(), (a[2] ** 2) @ Mc)
            else:
                scales = ((Mc * Rt.abs()) @ a[3].abs(), Mc @ (a[3] ** 2))
            sync(dev)
            errs = [rel_err(Rk, Rt)] + [scaled_err(g, h, sc) for g, h, sc
                                        in zip(got, want, scales)]
            finite = all(bool(torch.isfinite(g).all()) for g in (Rk, *got))
            if not (max(errs) <= tol and finite):
                raise AssertionError('%s %s: errors %r > %g'
                                     % (label, dtype, errs, tol))
            if not (torch.equal(Rk, Rr) and all(
                    torch.equal(g, h) for g, h in zip(got, again))):
                raise AssertionError('%s %s: two launches on the same input '
                                     'differ' % (label, dtype))
            line = {'case': label, 'dtype': str(dtype), 'rel_err_R': errs[0],
                    'rel_err_sums': errs[1:], 'bitwise_repeat': True}
            if kind == 'phase_a':
                stripes, cluster, ranges = mk.phase_a_layout(
                    *R0.shape, R0.element_size())
                line['b3_geometry'] = {
                    'stripes': stripes, 'cluster': cluster,
                    'blocks': stripes * cluster,
                    'rank_rows': [b - a for a, b in ranges],
                    'form': ('16-byte' if R0.shape[1] % (
                        16 // R0.element_size()) == 0 else 'scalar')}
            if dtype == torch.float32:
                stats = out[kind]
                stats[0] = max(stats[0], *(float((g - h).abs().max())
                                           for g, h in zip((Rk, *got),
                                                           (Rt, *want))))
                if label.startswith(('B3 rs', 'B4 rs')):
                    # the wrapper as the sweep calls it: outputs given
                    pre = tuple(torch.empty_like(g) for g in got)
                    line['ms'] = time_ms(
                        lambda: kernel(Rk, Mc, *a, out=pre), dev)
                    line['plain_ms'] = time_ms(lambda: ref(Rt, Mc, *a), dev)
                    if kind == 'phase_a' and dev.type == 'cuda':
                        line['kernel_alone_ms'] = b3_alone_ms(
                            mk, Rk, Mc, *a, dev)
                    line['GB_per_s'] = 12 * R0.numel() / line['ms'] / 1e6
                    n, d = R0.shape
                    vectors = (3 * n + 3 * d) if kind == 'phase_a' \
                        else (5 * n + 2 * d)
                    stats[1], stats[2] = line['ms'], line['plain_ms']
                    stats[3], stats[4] = bound(
                        (7 if kind == 'phase_a' else 9) * n * d,
                        (3 * n * d + vectors) * R0.element_size())
            log('kernel masked', **line)
    return {key: tuple(v) for key, v in out.items()}


def _rs_fit(Est, pairs, ratings, shape, **kw):
    n, d, _, k = shape
    return Est(n, d, k, random_state=0, **kw).fit(pairs, ratings)


def run_rs_phase(dev, mk, Est, nmf, X):
    """Phase 8 on the ratings ``X`` (numpy): returns the launches of the
    main path (everything up to and with predict and score) and the
    default fit's held-out RMSE."""
    n, d, _, k = RS_SHAPE
    p_tr, r_tr, p_te, r_te = (torch.as_tensor(a, device=dev) for a in
                              rs_split(X))
    r_tr, r_te = r_tr.float(), r_te.float()

    mk.reset_launches()
    t0 = time.perf_counter()
    est = _rs_fit(Est, p_tr, r_tr, RS_SHAPE)
    sync(dev)
    fit_s = time.perf_counter() - t0
    a, b = mk.LAUNCHES['phase_a'], mk.LAUNCHES['phase_b']
    if a == 0 or a != b or a % k:
        raise AssertionError('default fit: B3 %d, B4 %d launches' % (a, b))
    rmse_default = est.score(p_te, r_te)
    log('NMF_RS_Estimator %dx%d k=%d float32, validation early stopping'
        % (n, d, k), fit_s=fit_s, sweeps_run=a // k,
        sweeps_kept=len(est.nmf_outputs['iter_cputime']),
        test_rmse=rmse_default)

    b0 = dict(mk.LAUNCHES)
    est = _rs_fit(Est, p_tr, r_tr, RS_SHAPE, max_iter=RS_SWEEPS,
                  use_validation_early_stopping=False,
                  nmf_kwargs=dict(eps_stop=0.0))
    sync(dev)
    obj = est.nmf_outputs['obj_history']
    sweeps = len(obj)
    for key in ('phase_a', 'phase_b'):
        if mk.LAUNCHES[key] - b0[key] != k * sweeps:
            raise AssertionError('%s: %d launches for %d sweeps of k=%d' % (
                key, mk.LAUNCHES[key] - b0[key], sweeps, k))
    for o1, o2 in zip(obj, obj[1:]):
        if o2 > o1 + OBJ_SLACK_F32 * abs(o1):
            raise AssertionError('masked objective rose: %r -> %r' % (o1, o2))
    if not (np.all(np.isfinite(obj)) and bool(torch.isfinite(est.W).all())
            and bool(torch.isfinite(est.T).all())):
        raise AssertionError('non-finite RS factors or objective')
    stamps = np.diff([0.0] + list(est.nmf_outputs['iter_cputime']))
    # sweep-only time: the same fit continued, no objective per sweep
    est2 = _rs_fit(Est, p_tr, r_tr, RS_SHAPE, max_iter=10, W=est.W, T=est.T,
                   use_validation_early_stopping=False,
                   nmf_kwargs=dict(compute_obj_each_iter=False))
    sync(dev)
    sweep_ms = float(np.median(np.diff(est2.nmf_outputs['iter_cputime'])))
    train_rmse = est.score(p_tr, r_tr)
    mean_rmse = float(torch.sqrt(((r_tr - r_tr.mean()) ** 2).mean()))
    if not train_rmse < mean_rmse:
        raise AssertionError('train RMSE %.4f not below the global mean\'s '
                             '%.4f' % (train_rmse, mean_rmse))
    log('NMF_RS_Estimator %dx%d k=%d float32, %d sweeps' % (n, d, k, sweeps),
        obj_first=obj[0], obj_last=obj[-1], train_rmse=train_rmse,
        global_mean_rmse=mean_rmse, test_rmse=est.score(p_te, r_te),
        ms_per_sweep_with_objective=float(np.median(stamps[1:])) * 1e3,
        ms_per_sweep=sweep_ms * 1e3)

    # transform: the test ratings of the first users, as a dense matrix
    rows = RS_TRANSFORM_ROWS
    sel = p_te[:, 0] < rows
    Xnew = torch.zeros(rows, d, device=dev)
    Xnew[p_te[sel, 0], p_te[sel, 1]] = r_te[sel]
    b1 = dict(mk.LAUNCHES)
    t0 = time.perf_counter()
    Wn = est.transform(Xnew)
    sync(dev)
    transform_s = time.perf_counter() - t0
    if mk.LAUNCHES != b1:
        raise AssertionError('transform: B3/B4 launched (%r -> %r); it takes '
                             'the sparse-mask sweep' % (b1, mk.LAUNCHES))
    if tuple(Wn.shape) != (rows, k) or not bool(torch.isfinite(Wn).all()):
        raise AssertionError('transform output %s' % (tuple(Wn.shape),))
    # B4's fixed-T form: the same W-phase through nmf() with the dense
    # mask of those ratings
    Wd = nmf(Xnew, k, W_mat=(Xnew != 0).float(), T_in=est.T, fix_T=True,
             reset_topic_method='random', max_iter=4, t_row_sum=1.0,
             random_state=0)['W']
    sync(dev)
    da = mk.LAUNCHES['phase_a'] - b1['phase_a']
    db = mk.LAUNCHES['phase_b'] - b1['phase_b']
    if da != 0 or db != 4 * k or not bool(torch.isfinite(Wd).all()):
        raise AssertionError('fixed-T dense-mask nmf(): B3 %d, B4 %d '
                             'launches (want 0, %d)' % (da, db, 4 * k))
    pred = est.predict(p_te)
    rmse = est.score(p_te, r_te)
    if not (np.all(np.isfinite(pred)) and np.isfinite(rmse)
            and pred.min() >= est.min_rating
            and pred.max() <= est.max_rating):
        raise AssertionError('predict/score: %r' % (rmse,))
    launches = dict(mk.LAUNCHES)
    log('NMF_RS_Estimator transform, predict, score', transform_rows=rows,
        transform_ratings=int(sel.sum()), transform_s=transform_s,
        transform_B3_B4_launches=0, fixed_T_nmf_B4_launches=db,
        transform_vs_fixed_T_rel_diff=rel_err(Wn, Wd),
        predicted=len(pred), test_rmse=rmse)

    # the same small fit on the card (float32) and on the CPU (float64)
    n_s, d_s, q_s, k_s = RS_SMALL
    p_s, r_s, _, _ = rs_split(synth_ratings(n_s, d_s, q_s, 4, seed=2))
    kw = dict(max_iter=SWEEPS, use_validation_early_stopping=False,
              nmf_kwargs=dict(init='random', eps_stop=0.0))
    o_gpu = _rs_fit(Est, torch.as_tensor(p_s, device=dev),
                    torch.as_tensor(r_s, device=dev).float(), RS_SMALL,
                    **kw).nmf_outputs['obj_history']
    o_cpu = _rs_fit(Est, p_s, r_s, RS_SMALL, device='cpu',
                    **kw).nmf_outputs['obj_history']
    diff = abs(o_gpu[-1] - o_cpu[-1]) / abs(o_cpu[-1])
    if len(o_gpu) != len(o_cpu) or not diff <= TOL_CPU_GPU_OBJ:
        raise AssertionError('RS card vs CPU objective: %r vs %r'
                             % (o_gpu[-1], o_cpu[-1]))
    log('NMF_RS_Estimator %dx%d k=%d card float32 vs cpu float64'
        % (n_s, d_s, k_s), sweeps=len(o_gpu), obj_card=o_gpu[-1],
        obj_cpu=o_cpu[-1], rel_diff=diff)
    return launches, rmse_default


# --------------------------------------------------------------------------
# the sparse slice
# --------------------------------------------------------------------------

def sparse_coo(n, d, density, dev, seed=0, dup=False, empty_band=None):
    """A sparse (n, d) float64 COO tensor on ``dev``: int(n·d·density)
    coordinates drawn with replacement (benchmarks/exp_sparse_mxu.py:
    35-43), values uniform; optionally a fifth of them repeated and one
    128-column band left empty. Uncoalesced: duplicates stay entries."""
    rng = np.random.RandomState(seed)
    nnz = int(n * d * density)
    rows = rng.randint(0, n, nnz)
    cols = rng.randint(0, d, nnz)
    if dup:
        rows = np.concatenate([rows, rows[:nnz // 5]])
        cols = np.concatenate([cols, cols[:nnz // 5]])
    if empty_band is not None:
        keep = cols // 128 != empty_band
        rows, cols = rows[keep], cols[keep]
    vals = rng.rand(len(rows))
    return torch.sparse_coo_tensor(
        torch.as_tensor(np.stack([rows, cols])), torch.as_tensor(vals),
        (n, d)).to(dev)


def sparse_csr(n, d, density, dev, seed=0, dtype=torch.float32):
    """The coalesced CSR form of :func:`sparse_coo` (duplicates summed),
    the way a user hands a corpus to the card."""
    return sparse_coo(n, d, density, dev, seed).coalesce().to(
        dtype).to_sparse_csr()


def row_err(got, want):
    """max over output rows of max |got - want| / max |want| in the row."""
    scale = want.abs().amax(1, keepdim=True).clamp_min(1e-300)
    return float(((got - want).abs() / scale).max())


def sparse_cases(dev, counts):
    """Phase 9's cases: ``(label, X, k, dtype, tol, timed)``. The ragged
    case (duplicates, an empty tile band) at k=16 and at k=128 float64 /
    k=200 float32 (two k-slices of the kernel), the TM corpus as CSR at
    k=50 (Zipf word columns; 200-byte rows in float32), and the sparse
    fit's shape at k=128 float32."""
    n_r, d_r, dens_r, k_r = SPARSE_RAGGED
    ragged = sparse_coo(n_r, d_r, dens_r, dev, seed=1, dup=True,
                        empty_band=2)
    out = [('ragged %dx%d k=%d' % (n_r, d_r, kk), ragged, kk, dtype, tol,
            False)
           for kk, dtype, tol in ((k_r, torch.float64, TOL_F64),
                                  (k_r, torch.float32, TOL_F32),
                                  (128, torch.float64, TOL_F64),
                                  (200, torch.float32, TOL_F32))]
    n_train, _, n_words, k_tm = TM_SHAPE
    tm = torch.as_tensor(counts[:n_train], device=dev).to_sparse_coo()
    out += [('TM corpus %dx%d k=%d' % (n_train, n_words, k_tm), tm, k_tm,
             dtype, tol, dtype == torch.float32)
            for dtype, tol in ((torch.float64, TOL_F64),
                               (torch.float32, TOL_F32))]
    n, d, dens, k = SPARSE_SHAPE
    out.append(('%dx%d %.1f%% k=%d' % (n, d, 100 * dens, k),
                sparse_csr(n, d, dens, dev, seed=0), k, torch.float32,
                TOL_F32, True))
    return out


def check_sparse(dev, sk, spl, counts):
    """Phase 9: the gather kernel (B5 and B6) against its twins in both
    directions. Per case, the B5 and the B6 plan, their output-column
    layouts (equal, array for array; build seconds and bytes), and per
    direction: the kernel through ``mxu_contract`` and ``dma_contract``
    (B5's padded panel, B6's slabs) and through the sweep's
    ``contract_wtx``/``contract_xtt``, each launched twice (the same
    bits; the three paths too), against the gather twin on the layout and
    the two plan twins; on the timed cases the CUDA-event ms of the
    sweep's call and of ``torch.sparse.mm`` of the CSR X (or Xᵀ) by the
    factor, checked equal, their ratio and the L2 gather rate. Returns
    {kernel: (max float32 abs error, ms, plain_ms, bound_ms, bound_by,
    library_ms)} of the sparse fit's ``WᵀX``: the bound counts 2·nnz·k
    flop and the bytes of W, the layout and the output."""
    out = {'mxu': [0.0, None, None, None, None, None],
           'dma': [0.0, None, None, None, None, None]}
    for label, X, kk, dtype, tol, timed in sparse_cases(dev, counts):
        rng = np.random.RandomState(2)
        nn, dd = X.shape
        nnz = int(X._nnz())
        W = torch.as_tensor(rng.rand(nn, kk), dtype=dtype, device=dev)
        T = torch.as_tensor(rng.rand(kk, dd), dtype=dtype, device=dev)
        plans, build_s = {}, {}
        for kind, make in (('mxu', spl.plan_sparse_matrix),
                           ('dma', spl.plan_sparse_matrix_dma)):
            t0 = time.perf_counter()
            plans[kind] = make(X, dtype, device=dev)
            sync(dev)
            build_s[kind] = time.perf_counter() - t0
        library = {}
        if timed and dev.type == 'cuda':
            # the library call for the same products: torch.sparse.mm of
            # the CSR X (and of Xᵀ) by the dense factor
            Xc = X.to(dtype).to_sparse_csr()
            Xtc = X.to(dtype).t().to_sparse_csr()
            Tt = T.T.contiguous()
            library = {'WtX': (lambda: torch.sparse.mm(Xtc, W).T),
                       'TXt': (lambda: torch.sparse.mm(Xc, Tt).T)}
        for dirn, F, m, cols in (('WtX', W.T, nn, dd), ('TXt', T, dd, nn)):
            dirs = {kind: (p.t_phase if dirn == 'WtX' else p.w_phase)
                    for kind, p in plans.items()}
            layouts = {}
            for kind, direction in dirs.items():
                t0 = time.perf_counter()
                layouts[kind] = spl.column_layout(direction)
                sync(dev)
                build_s['layout ' + kind] = time.perf_counter() - t0
            lay = layouts['mxu']
            for f in spl.ColumnLayout._fields:
                if not torch.equal(getattr(lay, f),
                                   getattr(layouts['dma'], f)):
                    raise AssertionError('%s %s: the B5 and B6 plans give '
                                         'different layouts (%s)'
                                         % (label, dirn, f))
            Fm, F3 = sk._padded(F, m), sk._tile_cols(F, m)
            contract = sk.contract_wtx if dirn == 'WtX' else sk.contract_xtt
            factor = W if dirn == 'WtX' else T
            calls = {
                'mxu': lambda: sk.mxu_contract(dirs['mxu'], Fm),
                'dma': lambda: sk.dma_contract(dirs['dma'], F3),
                'mxu sweep': lambda: contract(plans['mxu'], factor),
                'dma sweep': lambda: contract(plans['dma'], factor)}
            got = {}
            for name, fn in calls.items():
                first, again = fn(), fn()
                sync(dev)
                if not torch.equal(first, again):
                    raise AssertionError('%s %s %s %s: two launches differ'
                                         % (name, dirn, label, dtype))
                got[name] = first
            if not all(torch.equal(got[name][:, :cols], got['mxu'][:, :cols])
                       for name in got):
                raise AssertionError('%s %s %s: the wrappers\' launches '
                                     'differ' % (dirn, label, dtype))
            twins = {'gather': lambda: sk.gather_contract_ref(
                         lay, F.T, kk, lay.n_cols),
                     'mxu plan': lambda: sk.mxu_contract_ref(dirs['mxu'], Fm),
                     'dma plan': lambda: sk.dma_contract_ref(dirs['dma'], F3)}
            errs = {}
            for name, fn in twins.items():
                want = fn()
                sync(dev)
                errs[name] = row_err(got['mxu'], want)
                if not (errs[name] <= tol
                        and bool(torch.isfinite(got['mxu']).all())):
                    raise AssertionError('%s %s %s: error %.3g against the '
                                         '%s twin > %g' % (dirn, label,
                                                           dtype, errs[name],
                                                           name, tol))
                if name == 'gather':
                    abs_err = float((got['mxu'] - want).abs().max())
                del want
            line = {'case': label, 'direction': dirn, 'dtype': str(dtype),
                    'rel_err': errs, 'bitwise_repeat': True, 'nnz': nnz,
                    'layout_MB': lay.nbytes / 1e6,
                    'layout_build_s': {kind: build_s['layout ' + kind]
                                       for kind in layouts},
                    'plan_build_s': {kind: build_s[kind] for kind in plans}}
            if library:
                lib_err = row_err(got['mxu'][:, :cols], library[dirn]())
                if not lib_err <= tol:
                    raise AssertionError('%s %s: torch.sparse.mm differs by '
                                         '%.3g' % (dirn, label, lib_err))
                line['library_rel_err'] = lib_err
            if dtype == torch.float32:
                for kind in out:
                    out[kind][0] = max(out[kind][0], abs_err)
            if timed:
                ms = {name: time_ms(fn, dev, runs=7)
                      for name, fn in calls.items()}
                line['ms'] = ms
                line['plain_ms'] = time_ms(twins['gather'], dev, runs=3)
                line['gather_TB_per_s'] = nnz * kk * 4 / ms['mxu sweep'] / 1e9
                if library:
                    lib_ms = time_ms(library[dirn], dev, runs=7)
                    line['library_ms'] = lib_ms
                    line['ms_over_library_ms'] = {
                        kind: ms[kind + ' sweep'] / lib_ms
                        for kind in ('mxu', 'dma')}
                if dirn == 'WtX' and label.startswith(
                        '%dx%d' % SPARSE_SHAPE[:2]):
                    nbytes = (W.nbytes + lay.nbytes + kk * dd
                              * W.element_size())
                    for kind in out:
                        out[kind][1:] = [ms[kind + ' sweep'],
                                         line['plain_ms'],
                                         *bound(2 * nnz * kk, nbytes),
                                         line.get('library_ms')]
            log('kernel sparse gather', **line)
            del got, Fm, F3, calls, twins
        del plans, library
    return {key: tuple(v) for key, v in out.items()}


class _Messages(logging.Handler):
    """Collects the messages of a logger (nmf()'s mode decisions)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def run_sparse_nmf_phase(dev, dk, sk, nmf):
    """Phase 10: ``nmf()`` on the recorded sparse configuration with each
    sparse mode; returns the three final objectives."""
    n, d, dens, k = SPARSE_SHAPE
    X = sparse_csr(n, d, dens, dev, seed=0)
    nlog = logging.getLogger('rri_nmf_tpu_torch.nmf')
    finals = {}
    for mode in ('mxu', 'dma', 'auto', True):
        msgs = _Messages()
        nlog.addHandler(msgs)
        level = nlog.level
        nlog.setLevel(logging.INFO)
        b0 = dict(dk.LAUNCHES), dict(sk.LAUNCHES)
        t0 = time.perf_counter()
        try:
            res = nmf(X, k, max_iter=SPARSE_SWEEPS, compute_obj_each_iter=True,
                      random_state=0, sparse=mode, **FAST_TM)
            sync(dev)
        finally:
            nlog.removeHandler(msgs)
            nlog.setLevel(level)
        wall = time.perf_counter() - t0
        obj = res['obj_history']
        sweeps = len(obj)
        gs = dk.LAUNCHES['gs'] - b0[0]['gs']
        sparse_l = {key: sk.LAUNCHES[key] - b0[1][key] for key in sk.LAUNCHES}
        want = {key: (2 * sweeps if key == mode else 0) for key in sparse_l}
        # sparse=True: torch.sparse.mm (cuSPARSE), no kernel of this repo
        decisions = [m for m in msgs.messages if m.startswith('sparse')]
        densified = any('densifying' in m for m in decisions)
        if (gs != 2 * sweeps or sparse_l != want
                or dk.LAUNCHES['tm_proj'] != b0[0]['tm_proj']
                or (mode == 'auto' and dev.type == 'cuda' and not densified)):
            raise AssertionError('nmf(sparse=%r): B1 %d, B5/B6 %r for %d '
                                 'sweeps; log %r' % (mode, gs, sparse_l,
                                                     sweeps, decisions))
        for a, b in zip(obj, obj[1:]):
            if b > a + OBJ_SLACK_F32 * abs(a):
                raise AssertionError('sparse=%r objective rose: %r -> %r'
                                     % (mode, a, b))
        W, T = res['W'], res['T']
        if not (bool(torch.isfinite(W).all()) and bool(torch.isfinite(T).all())
                and np.all(np.isfinite(obj))):
            raise AssertionError('non-finite sparse factors or objective')
        stamps = np.diff([0.0] + list(res['iter_cputime']))
        # sweep-only time: the same fit continued, no objective per sweep
        res2 = nmf(X, k, max_iter=5, W_in=W, T_in=T, random_state=0,
                   sparse=mode, **FAST_TM)
        sync(dev)
        finals[mode] = obj[-1]
        log('nmf %dx%d %.1f%% k=%d float32 sparse=%r' % (n, d, 100 * dens, k,
                                                           mode),
            sweeps=sweeps, gs_launches=gs, sparse_launches=sparse_l,
            auto_densified=densified, mode_log=decisions,
            obj_first=obj[0], obj_last=obj[-1], wall_s=wall,
            ms_per_sweep_with_objective=float(np.median(stamps[1:])) * 1e3,
            ms_per_sweep=float(np.median(np.diff(res2['iter_cputime'])))
            * 1e3)
        del res, res2, W, T
    lo, hi = min(finals.values()), max(finals.values())
    if not (hi - lo) <= TOL_MODES * abs(lo):
        raise AssertionError('sparse modes disagree: %r' % finals)
    log('nmf sparse modes agree', final_objectives={
        str(key): v for key, v in finals.items()},
        rel_spread=(hi - lo) / abs(lo))
    del X

    # 'auto' past the card's budget takes B5: the same decision on a card
    # that reports 1 MB of memory
    n, d, dens, k = SPARSE_SMALL
    Xs = sparse_csr(n, d, dens, dev, seed=5)
    msgs = _Messages()
    nlog.addHandler(msgs)
    level = nlog.level
    nlog.setLevel(logging.INFO)
    real = torch.cuda.mem_get_info
    torch.cuda.mem_get_info = lambda *a: (10 ** 6, 10 ** 6)
    b0 = sk.LAUNCHES['mxu']
    try:
        res = nmf(Xs, k, max_iter=3, random_state=0, **FAST_TM)
        sync(dev)
    finally:
        torch.cuda.mem_get_info = real
        nlog.removeHandler(msgs)
        nlog.setLevel(level)
    decisions = [m for m in msgs.messages if m.startswith('sparse')]
    got = sk.LAUNCHES['mxu'] - b0
    if dev.type == 'cuda' and (got != 6 or 'B5' not in ' '.join(decisions)):
        raise AssertionError("sparse='auto' past the budget: %d B5 launches "
                             'for 3 sweeps; log %r' % (got, decisions))
    log("nmf %dx%d sparse='auto' past a 1 MB budget" % (n, d),
        mxu_launches=got, mode_log=decisions,
        finite=bool(torch.isfinite(res['W']).all()))

    # the same small sparse fit on the card (float32) and on the CPU
    # (float64, the twins)
    n, d, dens, k = SPARSE_SMALL
    kw = dict(max_iter=SWEEPS, compute_obj_each_iter=True, init='random',
              random_state=3, sparse='mxu', **FAST_TM)
    Xs = sparse_coo(n, d, dens, torch.device('cpu'), seed=4).coalesce()
    o_gpu = nmf(Xs.float().to(dev).to_sparse_csr(), k, **kw)['obj_history']
    o_cpu = nmf(Xs, k, **kw)['obj_history']
    diff = abs(o_gpu[-1] - o_cpu[-1]) / abs(o_cpu[-1])
    if len(o_gpu) != len(o_cpu) or not diff <= TOL_CPU_GPU_OBJ:
        raise AssertionError('sparse card vs CPU objective: %r vs %r'
                             % (o_gpu[-1], o_cpu[-1]))
    log('nmf sparse %dx%d k=%d card float32 vs cpu float64' % (n, d, k),
        sweeps=len(o_gpu), obj_card=o_gpu[-1], obj_cpu=o_cpu[-1],
        rel_diff=diff)
    return finals


def run_sparse_tm_phase(dev, dk, sk, Est, counts):
    """Phase 11: the TM estimator with ``sparse='mxu'`` on the corpus of
    phase 6 as CUDA CSR tensors."""
    n_train, _, n_words, k = TM_SHAPE
    X = torch.as_tensor(counts, device=dev)
    Xtr = X[:n_train].to_sparse_csr()
    Xte = X[n_train:].to_sparse_csr()
    del X
    b0 = dict(dk.LAUNCHES), dict(sk.LAUNCHES)
    t0 = time.perf_counter()
    est = Est(n_train, n_words, k, random_state=0, max_iter=SWEEPS,
              handle_tfidf=True, handle_normalization=True,
              nmf_kwargs=dict(FAST_TM, sparse='mxu'))
    est.fit(Xtr)
    sync(dev)
    fit_s = time.perf_counter() - t0
    sweeps = len(est.nmf_outputs['iter_cputime'])
    got = (sk.LAUNCHES['mxu'] - b0[1]['mxu'],
           dk.LAUNCHES['tm_proj'] - b0[0]['tm_proj'],
           dk.LAUNCHES['gs'] - b0[0]['gs'])
    if got != (2 * sweeps, sweeps, sweeps):
        raise AssertionError('sparse TM fit: B5, B2, B1 launches %r for %d '
                             'sweeps' % (got, sweeps))
    t_dev = check_simplex(est.T, 1.0, 'sparse TM T rows')
    b1 = dict(dk.LAUNCHES), dict(sk.LAUNCHES)
    Wn = est.transform(Xte)
    sync(dev)
    got = (sk.LAUNCHES['mxu'] - b1[1]['mxu'], dk.LAUNCHES['gs'] - b1[0]['gs'])
    if got != (4, 4) or tuple(Wn.shape) != (Xte.shape[0], k):
        raise AssertionError('sparse transform: B5, B1 launches %r, shape %r'
                             % (got, tuple(Wn.shape)))
    w_dev = check_simplex(Wn, 1.0, 'sparse transform rows')
    r2 = est.score(Xte)
    if not np.isfinite(r2):
        raise AssertionError('non-finite sparse score %r' % r2)
    stamps = np.diff([0.0] + list(est.nmf_outputs['iter_cputime']))
    log('NMF_TM_Estimator sparse=\'mxu\' %dx%d k=%d float32'
        % (n_train, n_words, k), nnz=int(Xtr.values().numel()),
        sweeps=sweeps, fit_s=fit_s, s_per_sweep=float(np.median(stamps[1:])),
        T_row_sum_err=t_dev, transform_rows=list(Wn.shape),
        transform_row_sum_err=w_dev, score_r2=r2)


# --------------------------------------------------------------------------
# the plain sweep: the defaults (phases 12-16)
# --------------------------------------------------------------------------

def stream_floor_ms(n, d, k, itemsize=4):
    """The byte floor of an interleaved sweep's W side: X (n, d) read once
    per topic, k times, at the card's memory rate."""
    return k * n * d * itemsize / PEAK_BYTES_PER_S * 1e3


def sync_free(fn, dev):
    """``fn()`` with every synchronizing CUDA call an error (on a card)."""
    if dev.type != 'cuda':
        return fn()
    torch.cuda.set_sync_debug_mode('error')
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def device_kernels(fn, dev):
    """``(kernels, device ms, by_name)`` of one call of ``fn``
    (torch.profiler): ``by_name`` maps each kernel name to its launches
    and device ms in that call."""
    from torch.profiler import ProfilerActivity, profile
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync(dev)
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in ev:
        c, ms = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c + 1, ms + e.device_time / 1e3)
    return len(ev), sum(e.device_time for e in ev) / 1e3, by_name


# kernel-name fragments of a sweep trace's shares (lower case)
SHARES = (('gemv', ('gemv',)), ('gemm', ('gemm', 'cutlass', 'xmma')),
          ('sort', ('sort',)), ('scan', ('scan',)))


def trace_shares(fn, dev):
    """Device time of one call of ``fn`` split by kernel name into
    SHARES and the rest (``other``), with the ten costliest kernels."""
    kernels, device_ms, by_name = device_kernels(fn, dev)
    shares = {key: [0, 0.0] for key, _ in SHARES + (('other', ()),)}
    for name, (c, ms) in by_name.items():
        low = name.lower()
        key = next((key for key, frags in SHARES
                    if any(f in low for f in frags)), 'other')
        shares[key][0] += c
        shares[key][1] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return dict(kernels=kernels, device_ms=device_ms,
                launches_and_ms_by_share={k: tuple(v)
                                          for k, v in shares.items()},
                top_kernels=[(name[:90], c, ms) for name, (c, ms) in top])


def non_increasing(obj, what, scale=None):
    """No rise past OBJ_SLACK_F32 of ``scale`` (default: the objective
    itself). The Gram objective 0.5(Σ m x² − 2·cross + quad) rounds
    relative to its terms, so its scale is Σ m x²."""
    for a, b in zip(obj, obj[1:]):
        if b > a + OBJ_SLACK_F32 * (abs(a) if scale is None else scale):
            raise AssertionError('%s: objective rose: %r -> %r' % (what, a, b))
    if not np.all(np.isfinite(obj)):
        raise AssertionError('%s: non-finite objective %r' % (what, obj))


class _ResetLog(_Messages):
    """The documents the resets picked: the plain sweep's log lines."""

    def __enter__(self):
        self.logger = logging.getLogger('rri_nmf_tpu_torch.ops.sweep')
        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.level)

    def documents(self):
        return [m for m in self.messages if 'reset to document' in m]


def _sweep_ms(res):
    return float(np.median(np.diff([0.0] + list(res['iter_cputime']))[1:]
                           )) * 1e3


def run_interleaved_phase(dev, dk, nmf):
    """Phases 12-14: the default ``nmf()`` and ``use_pallas=False`` at
    NMF_SHAPE; none launches a kernel of this repo."""
    from rri_nmf_tpu_torch.ops.sweep import (SweepConfig, make_draws,
                                             make_sweep)
    n, d, k = NMF_SHAPE
    X = lowrank(n, d, k, dev, seed=0)
    floor = stream_floor_ms(n, d, k)
    b0 = dict(dk.LAUNCHES)
    t0 = time.perf_counter()
    res = nmf(X, k, max_iter=INTERLEAVED_SWEEPS, compute_obj_each_iter=True,
              random_state=0)
    sync(dev)
    wall = time.perf_counter() - t0
    non_increasing(res['obj_history'], 'interleaved nmf()')
    W, T = res['W'], res['T']
    # sweep-only time: the same fit continued, no objective per sweep
    res2 = nmf(X, k, max_iter=INTERLEAVED_SWEEPS, W_in=W, T_in=T,
               random_state=0)
    sync(dev)
    if dk.LAUNCHES != b0:
        raise AssertionError('the interleaved nmf() launched kernels: %r -> '
                             '%r' % (b0, dk.LAUNCHES))
    # the speculative sweep alone: no synchronizing call, its kernels, and
    # its time as one CUDA graph and as separate launches
    sw = make_sweep(SweepConfig(k=k))
    draws = make_draws(0, dev)
    (_, _, left), dead = sync_free(
        lambda: sw.speculate(X, W, T, draws, 23), dev)
    if dead is None or bool(dead) or left != 23:
        raise AssertionError('speculative sweep: dead %r, budget %r'
                             % (dead, left))
    trace = trace_shares(lambda: sw.speculate(X, W, T, draws, 23), dev)

    def launched():
        out, dead = sw.speculate(X, W, T, draws, 23)
        bool(dead)
        return out
    launch_ms = time_ms(launched, dev, runs=3)
    Wl, Tl, _ = launched()
    sw(X, W, T, draws, 23)        # launch by launch; the next call captures
    graph_ms = time_ms(lambda: sw(X, W, T, draws, 23), dev, runs=3)
    Wg, Tg, _ = sw(X, W, T, draws, 23)
    sync(dev)
    if not (torch.equal(Wg, Wl) and torch.equal(Tg, Tl)):
        raise AssertionError('the CUDA graph and the launches differ')
    log('nmf %dx%d k=%d float32, defaults (interleaved, resets)' % (n, d, k),
        sweeps=len(res['obj_history']), obj_first=res['obj_history'][0],
        obj_last=res['obj_history'][-1], wall_s=wall,
        ms_per_sweep_with_objective=_sweep_ms(res),
        ms_per_sweep=_sweep_ms(res2), byte_floor_ms=floor,
        n_resets_remaining=res2['n_resets_remaining'],
        speculative_sweep_sync_free=True, speculative_sweep_trace=trace,
        graph_ms=graph_ms,
        launches_ms=launch_ms, graph_equals_launches=True)

    # 13. a dead topic: its reset fires on the first sweep
    W0 = res2['W'].clone()
    W0[:, 5] = 0.0
    with _ResetLog() as resets:
        res3 = nmf(X, k, max_iter=3, compute_obj_each_iter=True,
                   random_state=0, W_in=W0, T_in=res2['T'])
        sync(dev)
    left = res3['n_resets_remaining']
    docs = resets.documents()
    if not (left < 23 and len(docs) == 23 - left
            and docs[0].startswith('topic 5 ')):
        raise AssertionError('forced reset: %r left, log %r' % (left, docs))
    non_increasing(res3['obj_history'], 'nmf() with a reset')
    # sweep 1 runs speculatively, then again with the reset; sweep 2
    # captures the CUDA graph; sweep 3 replays it
    log('nmf %dx%d k=%d float32, a dead topic' % (n, d, k),
        n_resets_remaining=left, resets=docs,
        obj=res3['obj_history'],
        ms_each_sweep_with_objective=list(np.diff(
            [0.0] + list(res3['iter_cputime'])) * 1e3))
    del res, res2, res3, W, T, W0, sw

    # 14. use_pallas=False in phase order: the plain Gram-blocked sweep;
    # beside it the kernel sweep, without resets and with them (the
    # kernels, then one check of the factors a sweep)
    finals, ms = {}, {}
    for label, kw in (('kernels', FAST_TM),
                      ('plain', dict(FAST_TM, use_pallas=False)),
                      ('kernels, resets on', dict(update_order='phase'))):
        b0 = dict(dk.LAUNCHES)
        r = nmf(X, k, max_iter=SWEEPS // 2, compute_obj_each_iter=True,
                init='random', random_state=0, **kw)
        sync(dev)
        gs = dk.LAUNCHES['gs'] - b0['gs']
        want = 0 if label == 'plain' else 2 * len(r['obj_history'])
        if gs != want or r['n_resets_remaining'] != 23:
            raise AssertionError('%s phase sweep: %d B1 launches, %d resets '
                                 'left' % (label, gs,
                                           r['n_resets_remaining']))
        non_increasing(r['obj_history'], '%s phase sweep' % label)
        finals[label] = r['obj_history'][-1]
        r2 = nmf(X, k, max_iter=5, W_in=r['W'], T_in=r['T'], random_state=0,
                 **kw)
        sync(dev)
        ms[label] = (_sweep_ms(r2), _sweep_ms(r))
    lo, hi = min(finals.values()), max(finals.values())
    if not (hi - lo) <= TOL_MODES * abs(lo):
        raise AssertionError('use_pallas=False vs the kernels: %r' % finals)
    log('nmf %dx%d k=%d float32, phase order, use_pallas=False' % (n, d, k),
        ms_per_sweep={key: v[0] for key, v in ms.items()},
        ms_per_sweep_with_objective={key: v[1] for key, v in ms.items()},
        final_objectives=finals, rel_spread=(hi - lo) / abs(lo))


def run_tm_default_phase(dev, dk, Est, counts):
    """Phase 15: the TM estimator with its default preset."""
    from rri_nmf_tpu_torch.matrixops import normalize, tfidf
    n_train, _, _, k = TM_SHAPE
    X = torch.as_tensor(counts, device=dev)
    Xtr, idf = tfidf(X[:n_train], return_idf=True)
    Xtr = normalize(Xtr)
    Xte = normalize(X[n_train:] * idf)
    del X
    n, d = Xtr.shape
    b0 = dict(dk.LAUNCHES)
    t0 = time.perf_counter()
    est = Est(n, d, k, random_state=0, max_iter=TM_DEFAULT_SWEEPS,
              nmf_kwargs=dict(compute_obj_each_iter=True)).fit(Xtr)
    sync(dev)
    fit_s = time.perf_counter() - t0
    if dk.LAUNCHES != b0:
        raise AssertionError('the default TM fit launched kernels')
    out = est.nmf_outputs
    if not np.all(np.isfinite(out['obj_history'])):
        raise AssertionError('non-finite TM objective')
    t_dev = check_simplex(est.T, 1.0, 'T rows')
    # sweep-only time: the same fit continued, no objective per sweep
    est2 = Est(n, d, k, random_state=0, max_iter=5, W=est.W, T=est.T).fit(Xtr)
    sync(dev)
    transforms = []
    for _ in range(2):
        b1 = dict(dk.LAUNCHES)
        Wn = est.transform(Xte)
        sync(dev)
        transforms.append(dk.LAUNCHES['gs'] - b1['gs'])
    if transforms != [4, 4] or dk.LAUNCHES['tm_proj'] != b0['tm_proj']:
        raise AssertionError('transform: B1 launches %r (want 4 a call)'
                             % transforms)
    w_dev = check_simplex(Wn, 1.0, 'transform rows')
    transform_ms = time_ms(lambda: est.transform(Xte), dev, runs=3)
    # the fit's speculative sweep, traced: its device time by kernel
    from rri_nmf_tpu_torch.ops.sweep import (SweepConfig, make_draws,
                                             make_sweep)
    sw = make_sweep(SweepConfig(k=k, project_T_each_iter=True, t_row_sum=1.0,
                                w_row_sum=1.0))
    draws = make_draws(0, dev)
    trace = trace_shares(
        lambda: sw.speculate(Xtr, est.W, est.T, draws, 23), dev)
    r2 = est.score(Xte)
    if not np.isfinite(r2):
        raise AssertionError('non-finite score %r' % r2)
    log('NMF_TM_Estimator %dx%d k=%d float32, default preset' % (n, d, k),
        sweeps=len(out['iter_cputime']), fit_s=fit_s,
        obj_first=out['obj_history'][0], obj_last=out['obj_history'][-1],
        n_resets_remaining=out['n_resets_remaining'],
        ms_per_sweep_with_objective=_sweep_ms(out),
        ms_per_sweep=_sweep_ms(est2.nmf_outputs),
        byte_floor_ms=stream_floor_ms(n, d, k),
        speculative_sweep_trace=trace, T_row_sum_err=t_dev,
        transform_rows=list(Wn.shape), transform_b1_launches=transforms,
        transform_ms=transform_ms, transform_row_sum_err=w_dev, score_r2=r2)


def _card_vs_cpu(label, fit, dev):
    """``fit(device)`` on the card (float32) and on the CPU (float64): the
    final objectives within TOL_CPU_GPU_OBJ, the same budget left and the
    same reset documents."""
    runs = {}
    for where in (dev, torch.device('cpu')):
        with _ResetLog() as resets:
            out = fit(where)
            sync(dev)
        runs[where.type] = (out['obj_history'], out['n_resets_remaining'],
                            resets.documents())
    (o_gpu, l_gpu, d_gpu), (o_cpu, l_cpu, d_cpu) = runs[dev.type], runs['cpu']
    diff = abs(o_gpu[-1] - o_cpu[-1]) / abs(o_cpu[-1])
    if not (len(o_gpu) == len(o_cpu) and diff <= TOL_CPU_GPU_OBJ
            and l_gpu == l_cpu and d_gpu == d_cpu):
        raise AssertionError('%s card vs CPU: objective %r vs %r, budget %r '
                             'vs %r, resets %r vs %r' % (
                                 label, o_gpu[-1], o_cpu[-1], l_gpu, l_cpu,
                                 d_gpu, d_cpu))
    log('%s card float32 vs cpu float64' % label, sweeps=len(o_gpu),
        obj_card=o_gpu[-1], obj_cpu=o_cpu[-1], rel_diff=diff,
        n_resets_remaining=l_gpu, resets=d_gpu)


def run_default_small_phase(dev, nmf, Est):
    """Phase 16: the defaults on the card against the CPU, small."""
    from rri_nmf_tpu_torch.matrixops import normalize, tfidf
    cpu = torch.device('cpu')
    n, d, k = DEFAULT_SMALL
    X = lowrank(n, d, k, cpu, seed=4).double()
    X[BUMP_ROW] += 3.0
    rng = np.random.RandomState(5)
    W0, T0 = rng.rand(n, k), rng.rand(k, d)
    W0[:, 3] = 0.0

    def default_fit(where):
        dt = torch.float32 if where.type == 'cuda' else torch.float64
        return nmf(X.to(where, dt), k, max_iter=SWEEPS,
                   compute_obj_each_iter=True, random_state=3,
                   W_in=torch.as_tensor(W0, device=where, dtype=dt),
                   T_in=torch.as_tensor(T0, device=where, dtype=dt))
    _card_vs_cpu('nmf %dx%d k=%d defaults, a dead topic' % (n, d, k),
                 default_fit, dev)

    docs, words, kt = TM_SMALL
    small = normalize(tfidf(torch.as_tensor(zipf_corpus(docs, words, kt,
                                                        seed=1),
                                            dtype=torch.float64)))

    def tm_fit(where):
        Xw = small.to(where, torch.float32 if where.type == 'cuda'
                      else torch.float64)
        est = Est(docs, words, kt, random_state=0, max_iter=SWEEPS,
                  nmf_kwargs=dict(init='random',
                                  compute_obj_each_iter=True)).fit(Xw)
        return est.nmf_outputs
    _card_vs_cpu('NMF_TM_Estimator %dx%d k=%d default preset' % TM_SMALL,
                 tm_fit, dev)

    nu, ni, q, km = MASKED_SMALL
    R = synth_ratings(nu, ni, q, 4, seed=2)
    R[BUMP_ROW % nu] = np.where(R[BUMP_ROW % nu] > 0, 5.0, 0.0)
    M = (R != 0).astype(float)
    rng = np.random.RandomState(6)
    Wm0, Tm0 = rng.rand(nu, km), rng.rand(km, ni)
    Wm0[:, 2] = 0.0

    def masked_fit(where):
        dt = torch.float32 if where.type == 'cuda' else torch.float64

        def t(a):
            return torch.as_tensor(a, device=where, dtype=dt)
        return nmf(t(R), km, W_mat=t(M), max_iter=SWEEPS,
                   compute_obj_each_iter=True, t_row_sum=1.0,
                   random_state=0, W_in=t(Wm0), T_in=t(Tm0))
    _card_vs_cpu('masked nmf %dx%d k=%d max_resid_document' % (nu, ni, km),
                 masked_fit, dev)


# --------------------------------------------------------------------------
# the sparse-mask WRRI sweeps (phases 17-19)
# --------------------------------------------------------------------------

def masked_record_problem(n, d, nnz, seed=0):
    """The JAX package's recorded sparse-mask problem
    (benchmarks/exp_round5_masked.py:build_problem): ``nnz`` (row, column)
    draws with replacement, values ``rand + 0.5`` (float32), duplicates
    summed; X and its binary mask as scipy CSR of one pattern."""
    import scipy.sparse as sp
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, n, nnz).astype(np.int64)
    cols = rng.randint(0, d, nnz).astype(np.int64)
    vals = rng.rand(nnz).astype(np.float32) + 0.5
    X = sp.coo_matrix((vals, (rows, cols)), shape=(n, d)).tocsr()
    M = X.copy()
    M.data = np.ones_like(M.data)
    return X, M


def masked_cfg(k, **kw):
    from rri_nmf_tpu_torch.ops.sweep import SweepConfig
    return SweepConfig(k=k, masked=True, masked_sparse=True,
                       reset_topic_method=None, **kw)


def gram_contractions(mg, plan, W, T, p, names=None):
    """The gather-kernel calls of the Gram-phase sweep on ``plan`` for the
    factors W (n, k), T (k, d): {name: (direction, plan direction, Fᵀ's
    rows, rows, output columns, values or None)}; ``p`` the panel."""
    n, d = plan.shape
    k = W.shape[1]
    p = min(p, k)
    it, is_, _ = mg._pairs_on(k, W.device)
    Tt = T.T.contiguous()
    calls = {
        'A (k rows, M⊙X)': lambda: ('t', W, k, True),
        'Gamma (k(k+1)/2 rows)': lambda: ('t', W[:, it] * W[:, is_],
                                          it.shape[0], False),
        'Gamma panel (p·k rows)': lambda: (
            't', (W[:, :p, None] * W[:, None, :]).reshape(n, p * k),
            p * k, False),
        'C (k rows, M⊙X)': lambda: ('w', Tt, k, True),
        'Theta (k(k+1)/2 rows)': lambda: ('w', Tt[:, it] * Tt[:, is_],
                                          it.shape[0], False),
        'Theta panel (p·k rows)': lambda: (
            'w', (Tt[:, :p, None] * Tt[:, None, :]).reshape(d, p * k),
            p * k, False)}
    for name in (names or calls):
        side, Ft, rows, mx = calls[name]()
        yield name, (side, plan.m_t if side == 't' else plan.m_w, Ft, rows,
                     d if side == 't' else n,
                     plan.mx_layout_values(side) if mx else None)


def library_masks(plan):
    """torch.sparse.mm's operands for the same products: the mask (and
    M⊙X) as CSR, Mᵀ (d, n) for the T side and M (n, d) for the W side."""
    coo = plan.coo
    nz = coo.nnz
    r, c = coo.rows[:nz].long(), coo.cols[:nz].long()
    m = coo.m_vals[:nz]
    n, d = plan.shape

    def csr(a, b, v, shape):
        return torch.sparse_coo_tensor(torch.stack([a, b]), v, shape) \
            .coalesce().to_sparse_csr()
    return {('t', False): csr(c, r, m, (d, n)),
            ('t', True): csr(c, r, m * coo.x_vals[:nz], (d, n)),
            ('w', False): csr(r, c, m, (n, d)),
            ('w', True): csr(r, c, m * coo.x_vals[:nz], (n, d))}


def check_masked_gram(dev, sk, spl, mg, cases):
    """Phase 17: the gather kernel with the Gram sweep's operands against
    its twin. ``cases``: ``(label, X, M, dtype, tol, timed, runs)``, runs
    a list of ``(k, p, names)``. Returns {label: (plan, build seconds)}
    of the timed cases."""
    plans = {}
    for label, X, M, dtype, tol, timed, runs in cases:
        t0 = time.perf_counter()
        plan = mg.plan_masked_gram(X, M, dtype, backend='mxu', device=dev)
        sync(dev)
        plan_s = time.perf_counter() - t0
        n, d = plan.shape
        lib = library_masks(plan) if timed and dev.type == 'cuda' else {}
        size = torch.empty(0, dtype=dtype).element_size()
        for k, p, names in runs:
            rng = np.random.RandomState(3)
            W = torch.as_tensor(rng.rand(n, k), dtype=dtype, device=dev)
            T = torch.as_tensor(rng.rand(k, d), dtype=dtype, device=dev)
            for name, (side, pl, Ft, rows, ncols, vals) in \
                    gram_contractions(mg, plan, W, T, p, names):
                def call():
                    return sk.gather_contract(pl, Ft, rows, ncols, 'mxu',
                                              vals)
                first, again = call(), call()
                sync(dev)
                if not torch.equal(first, again):
                    raise AssertionError('%s %s %s: two launches differ'
                                         % (label, name, dtype))
                lay = spl.column_layout(pl)

                def twin():
                    return sk.gather_contract_ref(lay, Ft, rows, ncols, vals)
                err = row_err(first, twin())
                if not (err <= tol and bool(torch.isfinite(first).all())):
                    raise AssertionError('%s %s %s: error %.3g against the '
                                         'twin > %g' % (label, name, dtype,
                                                        err, tol))
                line = {'case': label, 'contraction': name, 'k': k,
                        'rows': rows, 'dtype': str(dtype), 'rel_err': err,
                        'bitwise_repeat': True, 'nnz': plan.nnz,
                        'plan_build_s': plan_s}
                if timed:
                    nnz = lay.gidx.shape[0]
                    ms = time_ms(call, dev, runs=5)
                    line.update(
                        ms=ms, plain_ms=time_ms(twin, dev, runs=1),
                        gather_TB_per_s=nnz * rows * size / ms / 1e9)
                    b = bound(2 * nnz * rows,
                              Ft.numel() * size + lay.nbytes
                              + rows * ncols * size, str(dtype)[6:])
                    line.update(bound_ms=b[0], bound_by=b[1])
                    if lib:
                        S = lib[(side, vals is not None)]
                        got = torch.sparse.mm(S, Ft).T
                        line['library_rel_err'] = row_err(first, got)
                        if not line['library_rel_err'] <= tol:
                            raise AssertionError('%s %s: torch.sparse.mm '
                                                 'differs' % (label, name))
                        del got
                        line['library_ms'] = time_ms(
                            lambda: torch.sparse.mm(S, Ft), dev, runs=5)
                        line['ms_over_library_ms'] = ms / line['library_ms']
                log('kernel gather, Gram-phase contractions', **line)
                del first, again
        if timed:
            plans[label] = (plan, plan_s)
        del lib
    return plans


def run_masked_record_phase(dev, sk, nmf, mg, ms, X, M, plan, plan_s):
    """Phase 18 on the recorded problem (scipy CSR ``X``, ``M``; ``plan``
    its Gram plan from phase 17): returns the gather launches of the
    main path."""
    from rri_nmf_tpu_torch.ops.sweep import make_draws
    n, d, _, k = MASKED_RECORD
    nnz = int(M.nnz)
    main = 0

    def fit(**kw):
        """nmf() on the problem: (result, wall s, gather launches, peak
        GB)."""
        if dev.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(dev)
        b0 = sk.LAUNCHES['mxu']
        t0 = time.perf_counter()
        res = nmf(X, kw.pop('k', k), W_mat=M, compute_obj_each_iter=True,
                  random_state=0, eps_stop=0.0, device=dev, **kw)
        sync(dev)
        peak = (torch.cuda.max_memory_allocated(dev) / 1e9
                if dev.type == 'cuda' else None)
        return (res, time.perf_counter() - t0, sk.LAUNCHES['mxu'] - b0,
                peak)

    # 18a. the Gram-phase sweep (4 launches a sweep, 2 an objective)
    res, wall, got, peak = fit(update_order='phase', reset_topic_method=None,
                               max_iter=GRAM_SWEEPS)
    obj = res['obj_history']
    if got != 6 * len(obj):
        raise AssertionError('Gram-phase nmf(): %d gather launches for %d '
                             'sweeps (want 6 a sweep)' % (got, len(obj)))
    main += got
    non_increasing(obj, 'Gram-phase nmf()', float(plan.sum_mx2))
    W, T = res['W'], res['T']
    o_gram = float(mg.make_masked_gram_objective('mxu')(plan, W, T))
    o_obs = float(ms.make_masked_sparse_objective()(plan.coo, W, T))
    gap = abs(o_gram - o_obs) / float(plan.sum_mx2)
    if not gap <= TOL_GRAM_OBJ:
        raise AssertionError('Gram objective %r vs observed-entry %r'
                             % (o_gram, o_obs))
    sweep = mg.make_masked_gram_sweep(masked_cfg(k, update_order='phase'),
                                      'mxu')
    draws = make_draws(0, dev)
    sweep_ms = time_ms(lambda: sweep(plan, W, T, draws, 0), dev, runs=3)
    trace = trace_shares(lambda: sweep(plan, W, T, draws, 0), dev)
    gram_objective = mg.make_masked_gram_objective('mxu')
    log('nmf %dx%d %d observations k=%d float32, update_order=phase '
        '(Gram-phase)' % (n, d, nnz, k), sweeps=len(obj),
        gather_launches=got, obj_first=obj[0], obj_last=obj[-1], wall_s=wall,
        host_plan_s=plan_s, peak_GB=peak, sum_mx2=float(plan.sum_mx2),
        gram_vs_observed_objective_rel_sum_mx2=gap,
        ms_per_sweep_with_objective=_sweep_ms(res), ms_per_sweep=sweep_ms,
        objective_ms=time_ms(lambda: gram_objective(plan, W, T), dev,
                             runs=3),
        sweep_trace=trace)
    del res, W, T

    # 18b. the defaults: the O(nnz) interleaved sweep, no kernel of ours
    t0 = time.perf_counter()
    coo = ms.plan_masked_coo(X, M, torch.float32, device=dev)
    sync(dev)
    coo_s = time.perf_counter() - t0
    before = dict(sk.LAUNCHES)
    res, wall, _, peak = fit(max_iter=INTERLEAVED_MASKED_SWEEPS)
    if sk.LAUNCHES != before:
        raise AssertionError('the O(nnz) sweep launched the gather kernel')
    obj = res['obj_history']
    non_increasing(obj, 'interleaved sparse-mask nmf()')
    W, T = res['W'], res['T']
    sw = ms.make_masked_sparse_sweep(masked_cfg(k))
    (_, _, _), dead = sync_free(lambda: sw.speculate(coo, W, T, draws, 0),
                                dev)
    trace = trace_shares(lambda: sw.speculate(coo, W, T, draws, 0), dev)
    launch_ms = time_ms(lambda: sw.speculate(coo, W, T, draws, 0), dev,
                        runs=2)
    outs = [sw.speculate(coo, W, T, draws, 0)[0][:2] for _ in range(2)]
    sw(coo, W, T, draws, 0)       # launch by launch; the next call captures
    graph_ms = time_ms(lambda: sw(coo, W, T, draws, 0), dev, runs=3)
    outs += [sw(coo, W, T, draws, 0)[:2] for _ in range(2)]
    sync(dev)
    # no atomics: two launched runs and two graph replays, the same bits
    if not all(torch.equal(Wo, outs[0][0]) and torch.equal(To, outs[0][1])
               for Wo, To in outs):
        raise AssertionError('the O(nnz) sweep does not repeat bit for bit '
                             '(launches, graph): %r' % [
                                 (rel_err(Wo, outs[0][0]),
                                  rel_err(To, outs[0][1]))
                                 for Wo, To in outs])
    objective = ms.make_masked_sparse_objective()
    log('nmf %dx%d %d observations k=%d float32, defaults (O(nnz) '
        'interleaved)' % (n, d, nnz, k), sweeps=len(obj), obj_first=obj[0],
        obj_last=obj[-1], wall_s=wall, host_plan_s=coo_s, peak_GB=peak,
        objective_ms=time_ms(lambda: objective(coo, W, T), dev, runs=3),
        graph_ms=graph_ms, launches_ms=launch_ms, graph_equals_launches=True,
        speculative_sweep_sync_free=True, speculative_sweep_trace=trace)
    del res, W, T, outs, sw, coo

    # 18c. k=128: Γ/Θ past the 4 GB budget, in panels
    kp = MASKED_PANEL_K
    panel = mg.auto_panel(kp, n, d, 4)
    npan = -(-kp // panel)
    rng = np.random.RandomState(7)
    W0 = torch.as_tensor(rng.rand(n, kp), dtype=torch.float32, device=dev)
    T0 = torch.as_tensor(rng.rand(kp, d), dtype=torch.float32, device=dev)
    res, wall, got, peak = fit(k=kp, update_order='phase',
                               reset_topic_method=None, max_iter=1,
                               W_in=W0, T_in=T0)
    if got != (2 + 2 * npan) + (1 + npan):
        raise AssertionError('k=%d panel sweep: %d gather launches (want %d)'
                             % (kp, got, 3 + 3 * npan))
    main += got
    if not (bool(torch.isfinite(res['W']).all())
            and np.isfinite(res['obj_history'][-1])):
        raise AssertionError('non-finite panel sweep')
    sweep = mg.make_masked_gram_sweep(masked_cfg(kp, update_order='phase'),
                                      'mxu', panel)
    log('nmf %dx%d k=%d float32, Gram-phase in %d-topic panels'
        % (n, d, kp, panel), panels=npan, gather_launches=got,
        obj=res['obj_history'], wall_s=wall, peak_GB=peak,
        ms_per_sweep=time_ms(lambda: sweep(plan, W0, T0, draws, 0), dev,
                             runs=1))
    return main


def run_sparse_obs_phase(dev, mk, sk, Est, X, rmse_dense):
    """Phase 19 on phase 8's ratings ``X`` (numpy): returns the gather
    launches of the main path."""
    n, d, _, k = RS_SHAPE
    p_tr, r_tr, p_te, r_te = (torch.as_tensor(a, device=dev) for a in
                              rs_split(X))
    r_tr, r_te = r_tr.float(), r_te.float()
    rows = RS_TRANSFORM_ROWS
    sel = p_te[:, 0] < rows
    Xnew = torch.zeros(rows, d, device=dev)
    Xnew[p_te[sel, 0], p_te[sel, 1]] = r_te[sel]
    main = 0
    rmse = {}
    from rri_nmf_tpu_torch.ops import sweep_masked_gram as mg
    from rri_nmf_tpu_torch.ops import sweep_masked_sparse as ms
    sweeps = {'interleaved': ms.make_masked_sparse_sweep(masked_cfg(
        k, t_row_sum=1.0)), 'Gram-phase': mg.make_masked_gram_sweep(
            masked_cfg(k, t_row_sum=1.0, update_order='phase'), 'mxu')}
    for label, kw in (('interleaved', {}),
                      ('Gram-phase', dict(nmf_kwargs=dict(
                          update_order='phase')))):
        b0 = dict(mk.LAUNCHES), sk.LAUNCHES['mxu']
        t0 = time.perf_counter()
        est = _rs_fit(Est, p_tr, r_tr, RS_SHAPE, sparse_obs=True, **kw)
        sync(dev)
        fit_s = time.perf_counter() - t0
        got = sk.LAUNCHES['mxu'] - b0[1]
        obj = est.nmf_outputs['obj_history']
        # an early stop runs one sweep more than it keeps
        want = {0} if label == 'interleaved' else {6 * len(obj),
                                                   6 * (len(obj) + 1)}
        if mk.LAUNCHES != b0[0] or got not in want:
            raise AssertionError('sparse_obs %s fit: B3/B4 %r, gather %d '
                                 'launches for %d sweeps kept' % (
                                     label, mk.LAUNCHES, got, len(obj)))
        main += got
        non_increasing(obj, 'sparse_obs %s fit' % label,
                       float((r_tr ** 2).sum()) if got else None)
        b1 = dict(mk.LAUNCHES), sk.LAUNCHES['mxu']
        t0 = time.perf_counter()
        Wn = est.transform(Xnew)
        sync(dev)
        transform_s = time.perf_counter() - t0
        if mk.LAUNCHES != b1[0] or sk.LAUNCHES['mxu'] != b1[1] or \
                tuple(Wn.shape) != (rows, k) or \
                not bool(torch.isfinite(Wn).all()):
            raise AssertionError('sparse_obs transform: launches or output')
        pred = est.predict(p_te)
        rmse[label] = est.score(p_te, r_te)
        if not (np.all(np.isfinite(pred)) and np.isfinite(rmse[label])):
            raise AssertionError('sparse_obs predict/score')
        # the fit's sweep alone on the fit's own plan (the objective's)
        plan = est.nmf_outputs['obj_calculator'].X
        sw = sweeps[label]
        sw(plan, est.W, est.T, None, 0)
        log('NMF_RS_Estimator(sparse_obs=True) %dx%d k=%d float32, %s'
            % (n, d, k, label), fit_s=fit_s, sweeps_kept=len(obj),
            gather_launches=got, obj_first=obj[0], obj_last=obj[-1],
            ms_per_sweep=time_ms(lambda: sw(plan, est.W, est.T, None, 0),
                                 dev, runs=5),
            transform_rows=rows, transform_s=transform_s,
            test_rmse=rmse[label], dense_mask_test_rmse=rmse_dense)
    diff = abs(rmse['interleaved'] - rmse_dense) / rmse_dense
    if not diff <= TOL_RMSE_ROUTES:
        raise AssertionError('sparse-mask RMSE %r vs dense-mask %r'
                             % (rmse['interleaved'], rmse_dense))

    # the same small fits on the card (float32) and the CPU (float64)
    n_s, d_s, q_s, k_s = RS_SMALL
    p_s, r_s, _, _ = rs_split(synth_ratings(n_s, d_s, q_s, 4, seed=2))
    for label, extra in (('interleaved', {}),
                         ('Gram-phase', dict(update_order='phase'))):
        kw = dict(max_iter=SWEEPS, use_validation_early_stopping=False,
                  sparse_obs=True, nmf_kwargs=dict(init='random',
                                                   eps_stop=0.0, **extra))
        b0 = sk.LAUNCHES['mxu']
        o_gpu = _rs_fit(Est, torch.as_tensor(p_s, device=dev),
                        torch.as_tensor(r_s, device=dev).float(), RS_SMALL,
                        **kw).nmf_outputs['obj_history']
        main += sk.LAUNCHES['mxu'] - b0
        o_cpu = _rs_fit(Est, p_s, r_s, RS_SMALL, device='cpu',
                        **kw).nmf_outputs['obj_history']
        diff = abs(o_gpu[-1] - o_cpu[-1]) / abs(o_cpu[-1])
        if len(o_gpu) != len(o_cpu) or not diff <= TOL_CPU_GPU_OBJ:
            raise AssertionError('sparse_obs %s card vs CPU objective: %r vs '
                                 '%r' % (label, o_gpu[-1], o_cpu[-1]))
        log('NMF_RS_Estimator(sparse_obs=True) %dx%d k=%d %s card float32 '
            'vs cpu float64' % (n_s, d_s, k_s, label), sweeps=len(o_gpu),
            obj_card=o_gpu[-1], obj_cpu=o_cpu[-1], rel_diff=diff)
    return main


def run(dev):
    """Phases 3-19 on ``dev``; returns the kernels' JSON entries."""
    from rri_nmf_tpu_torch.metrics import frobenius_relative_error
    from rri_nmf_tpu_torch.nmf import nmf
    from rri_nmf_tpu_torch.ops import dense_kernels as dk
    from rri_nmf_tpu_torch.ops import masked_kernels as mk
    from rri_nmf_tpu_torch.ops import sparse_kernels as sk
    from rri_nmf_tpu_torch.ops import sparse_plan as spl
    from rri_nmf_tpu_torch.ops import sweep_masked_gram as mg
    from rri_nmf_tpu_torch.ops import sweep_masked_sparse as msp
    from rri_nmf_tpu_torch.sklearn_interface import (NMF_RS_Estimator,
                                                     NMF_TM_Estimator)

    # data for phases 3-6 (numpy seeds)
    t0 = time.perf_counter()
    n_train, n_test, n_words, k_tm = TM_SHAPE
    counts = zipf_corpus(n_train + n_test, n_words, k_tm, seed=0)
    log('data', corpus_seconds=time.perf_counter() - t0)
    X = lowrank(*NMF_SHAPE, dev, seed=0)
    Xte = torch.as_tensor(counts[n_train:], device=dev)
    rng = np.random.RandomState(5)
    T_new = torch.as_tensor(rng.rand(k_tm, n_words), device=dev)
    T_new = T_new / T_new.sum(1, keepdim=True)

    # 3. B1 against its twin (and B1's and B2's gates)
    if dev.type == 'cuda':
        check_dense_gates(dk, dev)
    cases = gs_cases(X, Xte.T, T_new, NMF_SHAPE[2], dev)
    del X
    err1, ms1, pms1 = check_kernel(
        'gs', dk.gs_update, dk.gs_update_ref, cases, dev,
        timed={cases[0][0], cases[4][0], cases[6][0], cases[7][0],
               cases[8][0]})
    # the first timed case: the T-phase of nmf() at NMF_SHAPE
    k1, m1 = cases[0][3].shape
    b1 = bound(2 * k1 * k1 * m1, (k1 * k1 + 3 * k1 * m1) * 4)
    del cases
    sync(dev)

    # 4. B2 against its twin, plus simplex checks on the kernel output
    cases = tm_cases(TM_PROJ_SHAPES, dev)
    err2, ms2, pms2 = check_kernel(
        'tm_proj', dk.tm_proj_update, dk.tm_proj_update_ref, cases, dev,
        timed={cases[0][0], cases[4][0]})
    for label, G, N, F, kw in cases:
        check_simplex(dk.tm_proj_update(*(x.float() for x in (G, N, F)),
                                        **kw), 1.0, 'B2 ' + label)
    # the first timed case: the TM fit's T-phase; its projections' rounds
    label, G, N, F, kw = cases[0]
    k2, d2 = F.shape
    b2 = bound(2 * k2 * k2 * d2, (k2 * k2 + 3 * k2 * d2) * 4)
    log('michelot rounds, ' + label + ' float32',
        **michelot_rounds(*(x.float() for x in (G, N, F)), **kw))
    del cases
    sync(dev)

    # 5-6. the main path, counted from zero
    dk.reset_launches()
    run_nmf_phase(dev, dk, nmf, frobenius_relative_error)
    sync(dev)
    run_tm_phase(dev, dk, NMF_TM_Estimator, counts)
    sync(dev)
    launches = dict(dk.LAUNCHES)
    if launches['gs'] == 0 or launches['tm_proj'] == 0:
        raise AssertionError('a kernel of the path never ran: %r' % launches)

    # 7. B3 and B4 against their twins
    n, d, q, _ = RS_SHAPE
    t0 = time.perf_counter()
    ratings = synth_ratings(n, d, q, 8)
    log('rs data', seconds=time.perf_counter() - t0,
        observations=int((ratings != 0).sum()))
    X = torch.as_tensor(ratings, device=dev)
    stats = check_masked(mk, masked_cases(dev, X, (X != 0).double()), dev)
    del X
    sync(dev)

    # 8. the RS main path, counted from zero
    masked, rmse_dense = run_rs_phase(dev, mk, NMF_RS_Estimator, nmf,
                                      ratings)
    if masked['phase_a'] == 0 or masked['phase_b'] == 0:
        raise AssertionError('a kernel of the path never ran: %r' % masked)
    sync(dev)

    # 9. the gather kernel (B5 and B6) against its twins
    sparse_stats = check_sparse(dev, sk, spl, counts)
    sync(dev)

    # 10-11. the sparse main path, counted from zero
    dk.reset_launches()
    sk.reset_launches()
    run_sparse_nmf_phase(dev, dk, sk, nmf)
    sync(dev)
    run_sparse_tm_phase(dev, dk, sk, NMF_TM_Estimator, counts)
    sync(dev)
    for key in ('gs', 'tm_proj'):
        launches[key] += dk.LAUNCHES[key]
    sparse = dict(sk.LAUNCHES)
    if sparse['mxu'] == 0 or sparse['dma'] == 0 or dk.LAUNCHES['gs'] == 0:
        raise AssertionError('a kernel of the path never ran: %r %r'
                             % (sparse, dk.LAUNCHES))

    # 12-16. the defaults through the plain sweep, counted from zero: B1
    # runs in phase 14's kernel sweeps and the default-preset transform
    dk.reset_launches()
    run_interleaved_phase(dev, dk, nmf)
    sync(dev)
    run_tm_default_phase(dev, dk, NMF_TM_Estimator, counts)
    sync(dev)
    run_default_small_phase(dev, nmf, NMF_TM_Estimator)
    sync(dev)
    if dk.LAUNCHES['gs'] == 0:
        raise AssertionError('B1 never ran on the default paths: %r'
                             % dk.LAUNCHES)
    for key in ('gs', 'tm_proj'):
        launches[key] += dk.LAUNCHES[key]

    # 17. the gather kernel with the Gram-phase sweep's operands
    import scipy.sparse as sp
    n, d, q, k = MASKED_RECORD
    t0 = time.perf_counter()
    Xr, Mr = masked_record_problem(n, d, q, seed=0)
    log('masked record data', seconds=time.perf_counter() - t0,
        observations=int(Mr.nnz))
    Rs = sp.csr_matrix(ratings)
    Ms = Rs.copy()
    Ms.data[:] = 1.0
    record = '%dx%d %d observations' % (n, d, Mr.nnz)
    k_rs = RS_SHAPE[3]
    plans = check_masked_gram(dev, sk, spl, mg, [
        ('MovieLens %dx%d' % Rs.shape, Rs, Ms, dtype, tol, False,
         [(k_rs, GRAM_GATE_PANEL, None)])
        for dtype, tol in ((torch.float64, TOL_F64),
                           (torch.float32, TOL_F32))] + [
        (record, Xr, Mr, torch.float32, TOL_F32, True,
         [(k, 2 * GRAM_GATE_PANEL, None),
          (MASKED_PANEL_K, mg.auto_panel(MASKED_PANEL_K, n, d, 4),
           ['Gamma panel (p·k rows)'])])])
    del Rs, Ms
    sync(dev)

    # 18-19. the sparse-mask paths, counted from zero
    sk.reset_launches()
    gram = run_masked_record_phase(dev, sk, nmf, mg, msp, Xr, Mr,
                                   *plans[record])
    del Xr, Mr, plans
    sync(dev)
    gram += run_sparse_obs_phase(dev, mk, sk, NMF_RS_Estimator, ratings,
                                 rmse_dense)
    sync(dev)
    if gram == 0:
        raise AssertionError('the gather kernel never ran on the sparse-mask '
                             'paths')
    sparse['mxu'] += gram
    del ratings
    # no single PyTorch call computes B1-B4 (sequential topic chains with
    # clamps, a simplex projection, fused in-place rank-one updates)
    return [dict(B1, launches=launches['gs'], max_abs_err=err1, ms=ms1,
                 plain_ms=pms1, bound_ms=b1[0], bound_by=b1[1],
                 library_ms=None),
            dict(B2, launches=launches['tm_proj'], max_abs_err=err2, ms=ms2,
                 plain_ms=pms2, bound_ms=b2[0], bound_by=b2[1],
                 library_ms=None)] + [
        dict(entry, launches=masked[key], max_abs_err=stats[key][0],
             ms=stats[key][1], plain_ms=stats[key][2],
             bound_ms=stats[key][3], bound_by=stats[key][4], library_ms=None)
        for entry, key in ((B3, 'phase_a'), (B4, 'phase_b'))] + [
        dict(entry, launches=sparse[key], max_abs_err=sparse_stats[key][0],
             ms=sparse_stats[key][1], plain_ms=sparse_stats[key][2],
             bound_ms=sparse_stats[key][3], bound_by=sparse_stats[key][4],
             library_ms=sparse_stats[key][5])
        for entry, key in ((B5, 'mxu'), (B6, 'dma'))]


def main():
    if not torch.cuda.is_available():
        sys.exit('chip_smoke.py: no CUDA device; it runs on the card only')
    from rri_nmf_tpu_torch.ops import _build
    dev = torch.device('cuda', 0)

    # 1. the card
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log('card', nvidia_smi=smi, name=torch.cuda.get_device_name(0),
        torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0])

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    log('build', seconds=time.perf_counter() - t0,
        library=str(_build.library_path().name))

    kernels = run(dev)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
