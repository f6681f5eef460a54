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
   contractions ``WᵀX`` and ``T Xᵀ``), in both directions: the kernel
   over a layout's padded width and through the sweep's products (each
   launch repeated and matched bit for bit) against its twin, in float64
   and float32, at a ragged 1000×700 2% case with duplicates and an empty
   tile band (k=16, and k=128 f64 / k=200 f32: two k-slices), at the TM
   corpus as CSR (k=50, Zipf word columns) and in float32 at the JAX
   package's recorded sparse configuration, 50,000×30,000 at 0.5%
   density (~7.5M nonzeros), k=128; the plan's build seconds (its two
   layouts, from X's COO on the card), the layout's bytes, CUDA-event
   times of the kernel and its twin, and ``torch.sparse.mm`` of the
   CSR X (and Xᵀ) by the factor, the library call for the same
   product, with the ratio;
10. ``nmf()`` on that matrix as a CUDA CSR tensor, k=128 float32, with
    ``sparse='mxu'``, ``'dma'``, ``'auto'`` (which densifies on an 80 GB
    card: 6 GB dense) and ``True`` (``torch.sparse.mm``): exact launch
    counts, a non-increasing objective, ms/sweep with and without it, the
    final objectives in agreement (``'mxu'`` and ``'dma'`` bit for bit);
    ``'auto'`` taking the gather kernel on a card that reports too
    little memory; and a 2000×1500 k=16 sparse fit on the card against
    the same fit on the CPU in float64;
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
    6: a fit (ms/sweep beside the byte floor; the W side's ``X @ T[t]``
    through the SpMV kernel ``csrc/spmv.cu``, at least k launches a
    sweep), then transform (B1 four times a call, the W-phase with T
    fixed) and score of the 512 held-out documents, T and transform rows
    on the simplex; the SpMV on the fit's X with rows of its T against
    the float64 product, its twin and the GEMV on the dense X, two
    launches bit for bit, and the device ms of each beside
    ``torch.sparse``'s CSR ``mv``;
16. card (float32) against CPU (float64) from one init, with the same
    reset count and the same reset documents: the default ``nmf()`` at
    2048×1024 k=32 with a dead topic, the TM default preset at 600×1500
    k=10, a masked fit with ``'max_resid_document'`` at 600×400 k=8;
17. the Gram-phase sparse-mask sweep's contractions on the mask's
    layouts: the gather kernel for A = Wᵀ(M⊙X) and C = (M⊙X)Tᵀ (k rows,
    M⊙X as a second value set), the Gram kernel (``csrc/gram.cu``) for Γ
    and Θ (the k(k+1)/2 Khatri-Rao rows, formed on chip) and p·k-row
    panels, at the MovieLens shape (k=40, float64 and float32) and at
    the JAX package's recorded masked shape, 100,000×50,000 with 25M
    observations, k=32 and the 6656-row panels of k=128 (float32):
    against the twins and, for Γ/Θ, the gather kernel on the
    materialized rows, each launch repeated and matched bit for bit,
    CUDA-event times beside ``torch.sparse.mm`` of the mask's CSR by the
    same rows (and the gather kernel's on them), the plan seconds; then
    the Gram kernel's chunked columns on a skewed 60,000×60,000 mask
    (three columns and three rows each observed 48,000 times, empty
    ones, 2M uniform draws): Γ and Θ whole and in panels, float64 and
    float32 (k=128 in the ML-25M fit's 4480- and 2944-row panels), the launches counted under ``'gram_split'``, against the
    float64 twin (float32 at 2.5e-6 of a row's largest entry) and bit
    for bit on repeat, and no column cut on the recorded uniform mask;
18. ``nmf()`` on that recorded problem (scipy CSR X and mask, float32 on
    the card): ``update_order='phase'`` (the Gram-phase sweep: 3 gather
    launches (A, C, the objective's C) and 3 Gram launches (Γ, Θ, the
    objective's Θ) a tracked sweep), its Gram objective against the
    observed-entry one, the defaults (the O(nnz) interleaved sweep, no
    kernel of this repo, sync-free, one CUDA graph a sweep), and a k=128
    sweep in Γ/Θ panels: launch counts, non-increasing objectives, ms
    per sweep, device time by kernel, peak memory;
19. ``NMF_RS_Estimator(sparse_obs=True)`` on phase 8's ratings: a default
    fit (the O(nnz) sweep), transform, predict and score, its held-out
    RMSE beside phase 8's dense-mask fit; the same with
    ``nmf_kwargs=dict(update_order='phase')`` (the Gram-phase sweep);
    and a 600×400 k=8 sparse-obs fit of each kind on the card against
    the CPU in float64;
20. HER (``nmf(accel='her')``) over the dense kernel sweep at
    16384×8192 k=128 on U[0,1] factors (the factors from a numpy seed,
    the product formed on the card): 60 plain and 60 HER sweeps from one
    NNDSVD init (B1 twice a sweep in both; HER's error below plain's;
    ms/sweep, the objective check's ms alone, the restarts), HER with
    ``sweeps_per_dispatch=10`` bit for bit the per-sweep loop and the
    recursion run by hand, one HER step with every synchronizing CUDA
    call an error; then ``NMF_TM_Estimator`` with HER at the 20
    Newsgroups shape, 20 sweeps (B2 and B1 once a sweep, T rows on the
    simplex, the objective check's ms alone at that shape);
21. ``NMF_RS_Estimator`` with ``nmf_kwargs=dict(accel='her')`` on phase
    8's ratings: 30 sweeps beside 30 plain ones (B3 and B4 k times a
    sweep; ms/sweep with and without the objective, train and test
    RMSE), then the default fit with validation early stopping and HER;
22. checkpoint/resume: phase 20's HER fit, 10 sweeps straight against 5
    with ``checkpoint_every=5`` and a resume to 10, and a default-order
    fit with ``'random'`` resets and DP noise at 2048×1024 k=32 from a
    warm start with a dead topic, without and with DP noise: W, T,
    ``obj_history`` and the reset budget bit for bit; the save and
    restore seconds and the bytes on disk;
23. ``nmf(w_row=...)`` in the phase recipe at 16384×8192 k=128: 20
    sweeps and the 10-sweep fixed-T W refit (B1 2·20 + 10 times,
    ``obj_history`` of 30 entries non-increasing in each part, ms/sweep
    of each), and at 2048×1024 k=32 the card (float32) against the CPU
    (float64) from one init for ``w_row`` and for 20 HER sweeps, with
    both HER restart sequences, gated on a matrix with sparse factors and
    on the mean-dominated U[0,1]-factor class (the refit's NNDSVD is
    scikit-learn's algorithm in float64 on both sides);
24. init at 16384×8192 k=128: the card's float64 randomized SVD against
    the host copy of scikit-learn's on the same test matrix (U[0,1]
    factors; S and U·diag(S)·Vt), NNSVD-LRC beside NNDSVD on low-rank
    data through both SVD backends (B1 in each correction: float64 after
    the float64 SVD, held against the host form at 1e-9), the masked
    SVD init's torch backend beside its numpy one at the MovieLens shape,
    and the PMI beam search on the 20 Newsgroups corpus; seconds of each;
25. the storage modes at the north-star shape 100,000×50,000 k=256 (X
    formed on the card): one NNDSVD of the int16 code through the device
    backend, then 4 sweeps from it with X in float32, in bfloat16 beside
    float32 factors, and as the int16 code (a ``QuantizedX``; only one
    form of X on the card during each fit): ms/sweep, peak device memory
    (the int16 fit at least 8 GB below the float32 fit), B1/B2 launches,
    relative errors beside the float32 fit's;
26. every kernel's 16-bit build (bfloat16 and float16 storage, float32
    work) against its twin at the main path's shapes (B1 k=128 m=8192,
    B2 k=50 d=26,214, B3/B4 6040×3952 in their 16-byte forms and
    517×1030 in their scalar forms, B4 also with fixed T, the gather
    kernel through both plans at 50,000×30,000 0.5% k=128 in both
    directions beside ``torch.sparse.mm`` in its dtype, with its L2
    gather rate, and at k = 24, 50, 200 and on the TM corpus within 1e-4
    of its twin, and bit for bit the float32 NumPy mirror of its order of
    summation, ``ops/sparse_mirror``, on 700×500 and on Zipf columns cut
    between warps at k = 24, 50, 128, 200; the ragged cases checked, not
    timed): each entry of
    B1-B4 within one ulp of the storage type plus the float32 build's own
    difference from the float32 twin at that entry, on the same (upcast)
    inputs (the share of entries within one ulp logged), the gather
    within 1e-4 of its twin, bits repeating, timed in turns beside the
    float32 build; then in each 16-bit dtype ``nmf()`` at
    16384×8192 k=128 (objective non-increasing within 1e-3·obj₀ + 1e-6),
    the TM estimator, the masked fit with ``use_pallas=True`` and the
    sparse ``'mxu'``/``'dma'`` fits (ms a sweep with the objective, and
    continued without it);
27. the mesh (``rri_nmf_tpu_torch.parallel``): (a) a one-rank NCCL world
    and a (1, 1) mesh, ``nmf(mesh=...)`` at 16384×8192 k=128 float32 in
    the phase recipe bit for bit the single-device fit with the same B1
    launches, ms/sweep of both in turns and the mesh sweeps' collective
    kernels (``torch.profiler``); (b) 4 rank processes sharing the card
    in a gloo world on a (2, 2) mesh (this script run with
    ``--mesh-rank``), each fitting its block of ``nmf()`` at that shape
    (B1) and of the TM preset at 11,314×26,214 k=50 (B2 on the panels
    gathered over tp), in float64 and float32 from numpy-seeded warm
    starts, against the single-device card fits: float64 within 1e-10,
    float32 within 1e-4 relative objective, B1/B2 launches per rank.
    These ranks share one card: the times are no scaling reading;
28. the masked mesh (``parallel/sharded_masked``) on phase 7-8's ratings
    and their observed mask at 6040×3952 k=40, the RS preset from a
    numpy-seeded warm start: (a) in the one-rank world, float64 and
    float32, W, T and ``obj_history`` bit for bit the single-device fit
    with B3 and B4 k times a sweep in both, ms/sweep of both in turns;
    a fixed-T fit with ``'max_resid_document'`` resets and a dead topic
    at 600×400 k=8 on one device (B4 alone, k times a sweep), card
    against CPU with the same reset documents; (b) 4 gloo ranks on a
    (2, 2) mesh: the preset in float64 and float32 (B3/B4 k times a
    sweep on each rank), its fixed-T form (B4 alone) and a
    ``store_gradients`` fit (the plain masked sweep, no B3/B4) in
    float64, against the single-device card fits at phase 27's gates
    (the stores within 1e-10 of the largest entry);
29. the sparse mesh (``parallel/sparse_mesh``) on phase 9's matrix,
    50,000×30,000 0.5% k=128 as a CSR tensor: (a) ``sparse='mxu'`` in the
    one-rank world, bit for bit the single-device fit with 2 gather
    launches a sweep in both, ms/sweep of both in turns; (b) 4 gloo
    ranks, float64 and float32: ``'mxu'`` on (2, 2), ``'mxu'`` with the TM
    preset on (4, 1) (B2 on each rank's whole rows) and ``sparse=True``
    on (2, 2), at phase 27's gates, the gather, B1 and B2 launches per
    rank;
30. the sparse-mask meshes (``parallel/masked_gram_mesh``,
    ``parallel/masked_sparse_mesh``) on phase 18's recorded problem,
    100,000×50,000 with 25M observations as scipy CSR, from numpy-seeded
    warm starts: (a) in the one-rank world, the Gram-phase fit at k=32,
    the defaults (the O(nnz) sweep, one CUDA graph a sweep) and k=128 in
    panels, W, T and ``obj_history`` bit for bit the single-device fits
    with the same gather and Gram launches (3 and 3 a tracked Gram
    sweep), ms/sweep of each sweep in turns with the single-device one;
    (b) 4
    gloo ranks on (4, 1): the Gram fit in float32 and float64 and the
    O(nnz) fit in float32 at phase 27's gates, k=128 in panels on phase
    8's ratings in float64 with the Gram budget lowered in each rank
    (3 gather and 3·⌈k/p⌉ Gram launches a tracked sweep), the guards
    ((2, 2), a ``'random'``
    reset), and ``NMF_RS_Estimator(sparse_obs=True)`` in the phase order
    on phase 8's ratings (its test RMSE beside the single-device fit's,
    a pickle round trip); the host plan seconds per rank, the bytes of
    each all-reduce a sweep and the rank walls (gloo copies through the
    host: no scaling reading);
31. the multi-host layer (``parallel/multihost``), every fit from the
    rank's own slab or pre-built plan: (a) in the one-rank NCCL world,
    ``initialize_distributed()`` (the world it is in), ``make_global_mesh()``,
    ``process_row_block`` and the ``distribute_*`` calls; ``nmf()`` on
    ``distribute_dense`` at 16384×8192 k=128 (B1) and ``'mxu'`` on
    ``distribute_sparse_coo`` at 50,000×30,000 0.5% k=128 (the gather
    kernel, B1), each bit for bit the whole-X mesh fit and the
    single-device fit with the same launches; the Gram fit at k=32 and the
    O(nnz) fit on ``distribute_masked_coo`` of the recorded problem, bit
    for bit phase 30 (a)'s fits of the same settings with the same
    launches; the mesh NNDSVD (float64, 16384×8192 k=128, one Ω) bit for
    bit ``randomized_svd_torch``'s on the whole X; (b) 4 gloo ranks as two
    hosts of two (``LOCAL_WORLD_SIZE=2``), each joining through
    ``initialize_distributed('localhost:<port>', 4, rank,
    backend='gloo')``: the dense fit on the default ``make_global_mesh()``
    (float64) and on (2, 2) (float32), a checkpointed fit resumed from
    other warm starts through per-rank directories (only the first rank's
    holds the checkpoint), the TM preset on (4, 1) (B2 on each rank's
    rows), the COO plan on (2, 2), ``'mxu'`` on (4, 1),
    the masked COO and Gram plans on (4, 1), each bit for bit the same
    ranks' whole-X mesh fit with the same launches and at phase 27's gates
    against the single-device card fit, and the mesh NNDSVD in float64
    within 1e-10 of the single-device one with the same Ω; the host plan
    seconds per rank.

Phases 5-6, phase 8, phases 10-11, phases 12-16, phases 18-19, phases
20-23, phases 24-25, each dtype's fits of phase 26, phases 27-30 and
phase 31 drive a main path with the launch counts set to 0 just before and
read just after (no kernel of this repo runs in phases 12-13; phases 14-15
run B1, phase 15 the SpMV; phases 18-19 the gather and Gram kernels;
phases 20-23 B1-B4; phases 24-25 B1; phase 26 the 16-bit builds of all six; phases 27-29
B1-B5, phase 30 the gather and Gram kernels and phase 31 B1, B2, the
gather and the Gram kernel, in this process and in each rank, counted
there;
the HER recursion run by hand, the sync check of phases 20 and 23 and
the sweeps timed beside phases 18 and 30's fits leave the counts as they
were).
Then one JSON line of the kernels (those launches, error against the
twin, kernel and twin ms, the least time the card could take for the same
work with what binds it, and the library call's ms where one computes the
same function; the Gram kernel as ``gram_contract``, timed at phase
17's k=32 Γ; the SpMV as ``spmv``, in device ms at phase 15's corpus,
with the GEMV it replaced as ``gemv_ms``; the 16-bit builds as
``<name>_bf16`` and ``<name>_f16``),
and as the last line ``{"ok": true, "device": {...}}``. Any failure raises before that line
and exits non-zero; without a CUDA device the script exits non-zero
before doing anything. Data come from numpy seeds.
"""

import contextlib
import json
import logging
import os
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
# The SpMV (phase 15) in float32 against the exact (float64) product, its
# twin and the GEMV on the dense X, relative to the largest row of
# |X|·|t|: each sums a row's products in its own order (the kernel in a
# shuffle tree, ~log2(nonzeros)·eps ≈ 7e-7 at most at the corpus's
# longest rows; the GEMV and the twin likewise). The tests on the card
# hold the kernel to the same 2e-6.
TOL_SPMV_F32 = 2e-6
# calls of each product back to back whose device time phase 15 averages
SPMV_CALLS = 20
# The published peaks of an H100 SXM at 700 W (NVIDIA's data sheet): the
# bound of a kernel's timed call is the larger of its flop over the peak
# rate for the type of its operands (float32 and float64 outside the
# tensor cores; bfloat16 and float16 dense on them, with float32 sums)
# and its bytes (each input read once, each output written once) over the
# memory rate.
PEAK_FLOPS = {'float32': 67e12, 'float64': 34e12, 'bfloat16': 989e12,
              'float16': 989e12}
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
# B5 and B6: one kernel, gather_kernel, on one layout plan
GATHER = {'name': 'sparse_gather', 'route': 'cuda',
          'source': 'rri_nmf_tpu_torch/csrc/sparse.cu',
          'replaces': 'rri_nmf_tpu/ops/sparse_mxu.py:298 and '
                      'rri_nmf_tpu/ops/sparse_dma.py:164'}
# B5 on the Khatri-Rao rows of the Gram-phase sweep (Γ/Θ): the Gram
# kernel forms them on chip (csrc/gram.cu)
GRAM = {'name': 'gram_contract', 'route': 'cuda',
        'source': 'rri_nmf_tpu_torch/csrc/gram.cu',
        'replaces': 'rri_nmf_tpu/ops/sparse_mxu.py:298'}
# no TPU kernel: the SpMV takes the place of the library GEMV on the dense
# X in the interleaved W side's X @ T[t] (JAX forms it with XLA's dot)
SPMV = {'name': 'spmv', 'route': 'cuda',
        'source': 'rri_nmf_tpu_torch/csrc/spmv.cu', 'replaces': None}
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
# (benchmarks/results_round2_sparse_mxu.json), and the gather kernel's
# ragged float64 case (duplicates, an empty 128-column band)
SPARSE_SHAPE = (50000, 30000, 0.005, 128)
SPARSE_RAGGED = (1000, 700, 0.02, 16)
# (n, d, density, k) of the small card-vs-CPU sparse fit
SPARSE_SMALL = (2000, 1500, 0.02, 16)
SPARSE_SWEEPS = 10
# the sparse modes' final objectives (float32, 10 sweeps from one init):
# 'mxu' and 'dma' run one kernel on one plan, 'auto' the dense GEMMs, True
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
# phase 17's skewed mask for the Gram kernel's chunked columns: (n, d,
# uniform observations, heavy columns and as many heavy rows, the share
# of the other side each heavy one observes), and the (dtype, k, panels)
# contractions run on it (None: whole). k=128's panels are the fit's of
# rs-ml25m.fit-gram: 80 and 48 tiles a column, teams of 80 and 48
# threads across warps, 3 and 5 teams a block.
GRAM_SPLIT_MASK = (60_000, 60_000, 2_000_000, 3, 0.8)
GRAM_SPLIT_RUNS = ((torch.float64, 16, (None, (5, 5))),
                   (torch.float32, 32, (None, (5, 12))),
                   (torch.float32, 128, ((35, 35), (105, 23))))
# float32 Gram kernel on that mask against the float64 twin of the same
# inputs, relative to a row's largest entry: chunk sums of at most ~2k
# positive products, then ~30 chunk sums, where the float32 twin adds a
# 48k-term column one product at a time (index_add_; 1.1-1.3e-5 on an
# H100); the kernel's 5.2-5.4e-7 there leaves room for rounding and none
# for a lost or doubled chunk (~4% of a heavy column).
TOL_GRAM_SPLIT_F32 = 2.5e-6
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
# phases 20-23: HER sweeps (plain and HER from one init) and the group of
# sweeps_per_dispatch; the TM estimator's HER sweeps; a checkpoint after
# the first number of sweeps, resumed to the second; the w_row fit's
# sweeps before the JAX package's 10-sweep fixed-T W refit
HER_SWEEPS = 60
HER_GROUP = 10
TM_HER_SWEEPS = 20
CKPT_SWEEPS = (5, 10)
W_ROW_SWEEPS = 20
W_ROW_REFIT = 10
# the warm start's dead topic in phase 22, and the DP noise of its second
# fit: sigma = sqrt(2 ln(1.25/delta)) · 1000 / eps ≈ 0.048 (the nmf()
# formula), small beside the numerators, so the fit stays a fit while
# every sweep draws
CKPT_DP = dict(eps_gauss_t=1e5, delta_gauss_t=1e-5)
DEAD_TOPIC = 5
# the density of the factors of phase 23's card-vs-CPU matrix
SPARSE_FACTOR_DENSITY = 0.1
# phase 24: the init problems at bench.py's shape (the U[0,1]-factor class
# for the SVD, low-rank plus noise for NNSVD-LRC), and the float64 card
# SVD's gates against the host copy of scikit-learn's on the same test
# matrix: both run the same float64 algorithm in other summation orders,
# so singular values agree to ~1e-13 relative and the rank-k product to
# ~1e-12 of its largest entry; 1e-10 and 1e-9 are stated
INIT_SHAPE = (16384, 8192, 128)
TOL_SVD_S = 1e-10
TOL_SVD_R = 1e-9
# NNSVD-LRC's card factors (float64 SVD, B1's float64 build) against the
# host form's, relative to each factor's largest entry
TOL_LRC = 1e-9
# phase 25: the north-star shape (BASELINE.md, targets row 4) and the
# sweeps of each storage mode's fit; the int16 fit's peak device memory
# must sit this far below the float32 fit's (X is 20 GB in float32, its
# int16 code 10 GB: a hidden n×d float copy would close the gap)
NORTH_STAR = (100_000, 50_000, 256)
STORAGE_SWEEPS = 4
STORAGE_PEAK_GAP = 8e9
# phase 26: the sweeps of the 16-bit fits (dense and TM; masked, see
# run_16_bit_fits; sparse); the JAX suite's 16-bit objective slack
# (tests/test_bfloat16.py: each step may rise by 1e-3·obj₀ + 1e-6)
SWEEPS_16 = 10
MASKED_SWEEPS_16 = 4
SPARSE_SWEEPS_16 = 3
# the 16-bit sparse fits continued without the objective, for the ms a
# sweep of the sweep alone; the other k of the 16-bit gather's checks
SPARSE_PLAIN_SWEEPS_16 = 5
GATHER_KS_16 = (24, 50, 200)
# the 16-bit gather bit for bit the float32 NumPy mirror of its order of
# summation (ops/sparse_mirror), at every k a slice width gives, on a
# random matrix (n, d, density) and on Zipf word columns (documents,
# words, topics, words a document) that the kernel's blocks cut between
# warps
MIRROR_KS_16 = (24, 50, 128, 200)
MIRROR_RANDOM = (700, 500, 0.03)
MIRROR_ZIPF = (400, 700, 8, 40)
OBJ_SLACK_16 = (1e-3, 1e-6)
NARROW = (torch.bfloat16, torch.float16)
# phase 27: the mesh. (a) a one-rank NCCL world at NMF_SHAPE, bit for bit
# the single-device fit; (b) MESH_RANKS processes sharing the card in a
# gloo world of MESH_SHAPE, MESH_SWEEPS sweeps of nmf() at NMF_SHAPE (B1)
# and of the TM preset at TM_SHAPE (B2 on tp-gathered panels), each in
# float64 and float32, against the single-device card fit from the same
# warm start (numpy seed MESH_SEED): float64 at 1e-10 of the largest
# entry and relative objective (the all-reduces sum in another order:
# ~1e-15 a sweep), float32 at 1e-4 relative final objective (float32
# sums in another order: no tighter bound is honest).
MESH_RANKS = 4
MESH_SHAPE = (2, 2)
MESH_SWEEPS = 10
MESH_SEED = 11
TOL_MESH_F64 = 1e-10
TOL_MESH_F32_OBJ = 1e-4
MESH_SECONDS = 600
# phase 28: the masked mesh at RS_SHAPE (phase 7-8's ratings and mask),
# the RS preset from a MESH_SEED warm start: (a) the one-rank world, bit
# for bit; (b) MESH_RANKS gloo ranks on MASKED_MESH_SHAPE, at the mesh
# gates above (float64 also for the gradient stores)
MASKED_MESH_SHAPE = (2, 2)
MASKED_MESH_SWEEPS = 5
MASKED_MESH_STORE_SWEEPS = 2
# phase 29: the sparse mesh at SPARSE_SHAPE: (a) 'mxu' in the one-rank
# world, bit for bit; (b) 'mxu' on (2, 2), 'mxu' with the TM preset on
# (4, 1), sparse=True on (2, 2), at the mesh gates above
SPARSE_MESH_SWEEPS = 5
# phase 30: the sparse-mask meshes on phase 18's recorded problem
# (MASKED_RECORD, scipy CSR) from MESH_SEED warm starts: (a) the one-rank
# world, bit for bit: the Gram-phase fit at k=32 (GRAM_MESH_SWEEPS), the
# defaults (the O(nnz) sweep, INTERLEAVED_MASKED_SWEEPS), k=MASKED_PANEL_K
# in panels (PANEL_MESH_SWEEPS); (b) MESH_RANKS gloo ranks on
# GRAM_MESH_SHAPE at phase 27's gates: the Gram fit in float32 and float64
# (GRAM_MESH_F64_SWEEPS), the O(nnz) fit in float32, k=MASKED_PANEL_K on
# RS_SHAPE's ratings in float64 with the Gram budget lowered to
# PANEL_MESH_UNITS (k, n / dp + d) rows (so the panel is that many topics),
# the guards, and NMF_RS_Estimator(sparse_obs=True) with its pickle
GRAM_MESH_SHAPE = (4, 1)
GRAM_MESH_SWEEPS = 3
GRAM_MESH_F64_SWEEPS = 2
PANEL_MESH_SWEEPS = 2
PANEL_MESH_UNITS = 32
# phase 31: the multi-host layer (parallel/multihost), each fit from the
# rank's own slab or plan: (a) in the one-rank world, NMF_SHAPE dense and
# SPARSE_SHAPE 'mxu' (MULTIHOST_SWEEPS) bit for bit the whole-X mesh fit
# and the single-device fit, the Gram and O(nnz) fits of phase 30 (a)'s
# settings bit for bit its fits, the mesh NNDSVD in float64 bit for bit
# the single-device one; (b) MESH_RANKS gloo ranks as two hosts of two
# (LOCAL_WORLD_SIZE=MULTIHOST_LOCAL), bit for bit the same ranks' whole-X
# mesh fits, at phase 27's gates against one device (the mesh NNDSVD at
# TOL_MESH_F64), a checkpointed fit resumed through per-rank directories
MULTIHOST_SWEEPS = 3
MULTIHOST_MASKED_SWEEPS = 2
MULTIHOST_LOCAL = 2
# the mesh NNDSVD at NMF_SHAPE: its SVD (S, U·diag(S)·Vt) within
# TOL_MESH_F64 of one device's, its W and H within TOL_NNDSVD_MESH. The
# low-rank X's trailing singular values cluster far below the first, so
# the (p, p) Gram's eigenvectors, and the NNDSVD sections built on them,
# move with the summation order; phase 31 logs how far moving every entry
# of X by about one ulp moves the single-device W and H, beside the
# mesh's gap
TOL_NNDSVD_MESH = 1e-8


def log(phase, **fields):
    print(json.dumps({'phase': phase, **fields}), flush=True)


def sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def time_ms(fn, dev, runs=5, warm=True):
    """Median milliseconds of ``fn()`` over ``runs`` runs after one
    warm-up (none without ``warm``): CUDA events on a card, the host
    clock otherwise."""
    if warm:
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
    """Phase 9: the gather kernel (JAX's B5 and B6) against its twin in
    both directions. Per case, the plan of X (its two output-column
    layouts, built on the card from X's COO: build seconds and bytes),
    and per direction the kernel over the layout's padded width and
    through the sweep's ``contract_wtx``/``contract_xtt``, each launched
    twice (the same bits; the two paths too), against the gather twin on
    the layout; on the timed cases the CUDA-event ms of the sweep's call
    and of ``torch.sparse.mm`` of the CSR X (or Xᵀ) by the factor,
    checked equal, their ratio and the L2 gather rate. Returns (max
    float32 abs error, ms, plain_ms, bound_ms, bound_by, library_ms) of
    the sparse fit's ``WᵀX``: the bound counts 2·nnz·k flop and the
    bytes of W, the layout and the output."""
    out = [0.0, None, None, None, None, None]
    for label, X, kk, dtype, tol, timed in sparse_cases(dev, counts):
        rng = np.random.RandomState(2)
        nn, dd = X.shape
        nnz = int(X._nnz())
        W = torch.as_tensor(rng.rand(nn, kk), dtype=dtype, device=dev)
        T = torch.as_tensor(rng.rand(kk, dd), dtype=dtype, device=dev)
        t0 = time.perf_counter()
        plan = spl.plan_sparse_matrix(X, dtype, device=dev)
        sync(dev)
        build_s = time.perf_counter() - t0
        library = {}
        if timed and dev.type == 'cuda':
            # the library call for the same products: torch.sparse.mm of
            # the CSR X (and of Xᵀ) by the dense factor
            Xc = X.to(dtype).to_sparse_csr()
            Xtc = X.to(dtype).t().to_sparse_csr()
            Tt = T.T.contiguous()
            library = {'WtX': (lambda: torch.sparse.mm(Xtc, W).T),
                       'TXt': (lambda: torch.sparse.mm(Xc, Tt).T)}
        for dirn, Ft, cols in (('WtX', W, dd), ('TXt', T.T, nn)):
            lay = plan.t_phase if dirn == 'WtX' else plan.w_phase
            contract = sk.contract_wtx if dirn == 'WtX' else sk.contract_xtt
            factor = W if dirn == 'WtX' else T
            calls = {
                'layout': lambda: sk.gather_contract(lay, Ft, kk,
                                                     lay.n_cols),
                'sweep': lambda: contract(plan, factor)}
            got = {}
            for name, fn in calls.items():
                first, again = fn(), fn()
                sync(dev)
                if not torch.equal(first, again):
                    raise AssertionError('%s %s %s %s: two launches differ'
                                         % (name, dirn, label, dtype))
                got[name] = first
            if not torch.equal(got['sweep'], got['layout'][:, :cols]):
                raise AssertionError('%s %s %s: the wrappers\' launches '
                                     'differ' % (dirn, label, dtype))

            def twin():
                return sk.gather_contract_ref(lay, Ft, kk, lay.n_cols)
            want = twin()
            sync(dev)
            err = row_err(got['layout'], want)
            if not (err <= tol and bool(torch.isfinite(got['layout']).all())):
                raise AssertionError('%s %s %s: error %.3g against the '
                                     'gather twin > %g' % (dirn, label,
                                                           dtype, err, tol))
            abs_err = float((got['layout'] - want).abs().max())
            del want
            line = {'case': label, 'direction': dirn, 'dtype': str(dtype),
                    'rel_err': err, 'bitwise_repeat': True, 'nnz': nnz,
                    'layout_MB': lay.nbytes / 1e6, 'plan_build_s': build_s}
            if library:
                lib_err = row_err(got['sweep'], library[dirn]())
                if not lib_err <= tol:
                    raise AssertionError('%s %s: torch.sparse.mm differs by '
                                         '%.3g' % (dirn, label, lib_err))
                line['library_rel_err'] = lib_err
            if dtype == torch.float32:
                out[0] = max(out[0], abs_err)
            if timed:
                ms = {name: time_ms(fn, dev, runs=7)
                      for name, fn in calls.items()}
                line['ms'] = ms
                line['plain_ms'] = time_ms(twin, dev, runs=3)
                line['gather_TB_per_s'] = nnz * kk * 4 / ms['sweep'] / 1e9
                if library:
                    lib_ms = time_ms(library[dirn], dev, runs=7)
                    line['library_ms'] = lib_ms
                    line['ms_over_library_ms'] = ms['sweep'] / lib_ms
                if dirn == 'WtX' and label.startswith(
                        '%dx%d' % SPARSE_SHAPE[:2]):
                    nbytes = (W.nbytes + lay.nbytes + kk * dd
                              * W.element_size())
                    out[1:] = [ms['sweep'], line['plain_ms'],
                               *bound(2 * nnz * kk, nbytes),
                               line.get('library_ms')]
            log('kernel sparse gather', **line)
            del got, calls
        del plan, library
    return tuple(out)


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
        want = {key: (2 * sweeps if key == 'gather' and mode in ('mxu', 'dma')
                      else 0) for key in sparse_l}
        # sparse=True: torch.sparse.mm (cuSPARSE), no kernel of this repo
        decisions = [m for m in msgs.messages if m.startswith('sparse')]
        densified = any('densifying' in m for m in decisions)
        if (gs != 2 * sweeps or sparse_l != want
                or dk.LAUNCHES['tm_proj'] != b0[0]['tm_proj']
                or (mode == 'auto' and dev.type == 'cuda' and not densified)):
            raise AssertionError('nmf(sparse=%r): B1 %d, gather %r for %d '
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
    if not (hi - lo) <= TOL_MODES * abs(lo) or (finals['mxu']
                                                 != finals['dma']):
        raise AssertionError('sparse modes disagree: %r' % finals)
    log('nmf sparse modes agree', final_objectives={
        str(key): v for key, v in finals.items()},
        rel_spread=(hi - lo) / abs(lo))
    del X

    # 'auto' past the card's budget takes the gather kernel: the same
    # decision on a card that reports 1 MB of memory
    n, d, dens, k = SPARSE_SMALL
    Xs = sparse_csr(n, d, dens, dev, seed=5)
    msgs = _Messages()
    nlog.addHandler(msgs)
    level = nlog.level
    nlog.setLevel(logging.INFO)
    real = torch.cuda.mem_get_info
    torch.cuda.mem_get_info = lambda *a: (10 ** 6, 10 ** 6)
    b0 = sk.LAUNCHES['gather']
    try:
        res = nmf(Xs, k, max_iter=3, random_state=0, **FAST_TM)
        sync(dev)
    finally:
        torch.cuda.mem_get_info = real
        nlog.removeHandler(msgs)
        nlog.setLevel(level)
    decisions = [m for m in msgs.messages if m.startswith('sparse')]
    got = sk.LAUNCHES['gather'] - b0
    if dev.type == 'cuda' and (got != 6 or 'gather-kernel'
                               not in ' '.join(decisions)):
        raise AssertionError("sparse='auto' past the budget: %d gather "
                             'launches for 3 sweeps; log %r'
                             % (got, decisions))
    log("nmf %dx%d sparse='auto' past a 1 MB budget" % (n, d),
        gather_launches=got, mode_log=decisions,
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
    got = (sk.LAUNCHES['gather'] - b0[1]['gather'],
           dk.LAUNCHES['tm_proj'] - b0[0]['tm_proj'],
           dk.LAUNCHES['gs'] - b0[0]['gs'])
    if got != (2 * sweeps, sweeps, sweeps):
        raise AssertionError('sparse TM fit: gather, B2, B1 launches %r '
                             'for %d sweeps' % (got, sweeps))
    t_dev = check_simplex(est.T, 1.0, 'sparse TM T rows')
    b1 = dict(dk.LAUNCHES), dict(sk.LAUNCHES)
    Wn = est.transform(Xte)
    sync(dev)
    got = (sk.LAUNCHES['gather'] - b1[1]['gather'],
           dk.LAUNCHES['gs'] - b1[0]['gs'])
    if got != (4, 4) or tuple(Wn.shape) != (Xte.shape[0], k):
        raise AssertionError('sparse transform: gather, B1 launches %r, '
                             'shape %r'
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


def device_ms_a_call(fn, dev, calls=SPMV_CALLS):
    """``(device ms, kernels)`` of one of ``calls`` calls of ``fn`` back
    to back (torch.profiler: the kernels' device time, no host gaps; the
    operands stay in L2 from call to call, as between the sweep's k
    products)."""
    fn()
    kernels, ms, _ = device_kernels(lambda: [fn() for _ in range(calls)],
                                    dev)
    return ms / calls, kernels / calls


def check_spmv(dev, spmv, X, T):
    """The SpMV at the fit's shape (phase 15): ``spmv.spmv`` on X's
    nonzeros, with rows of the fitted T as t, against the exact product,
    its twin and the GEMV on the dense X (:data:`TOL_SPMV_F32`), two
    launches bit for bit; device ms of the kernel, the twin, the GEMV it
    replaced and ``torch.sparse``'s CSR ``mv``, and its bound (bytes:
    8 a nonzero, the row pointers, t and the output once). Returns the
    kernel's stats."""
    t0 = time.perf_counter()
    rows = spmv.sparse_rows(X)
    sync(dev)
    build_s = time.perf_counter() - t0
    if rows is None:
        raise AssertionError('the corpus takes no SpMV route')
    n, d = X.shape
    nnz = rows.cols.shape[0]
    max_err, worst = 0.0, {}
    for i in (0, T.shape[0] // 2, T.shape[0] - 1):
        t = T[i].contiguous()
        got = spmv.spmv(rows, t)
        if not torch.equal(got, spmv.spmv(rows, t)):
            raise AssertionError('two SpMV launches differ (topic %d)' % i)
        scale = float((X.abs() @ t.abs()).max().clamp_min(1e-30))
        for what, want in (('exact', (X.double() @ t.double())),
                           ('twin', spmv.spmv_ref(rows, t)),
                           ('gemv', X @ t)):
            err = float((got.double() - want.double()).abs().max())
            worst[what] = max(worst.get(what, 0.0), err / scale)
            if err > TOL_SPMV_F32 * scale:
                raise AssertionError('SpMV vs %s, topic %d: %.3g > %.3g'
                                     % (what, i, err, TOL_SPMV_F32 * scale))
            if what == 'twin':
                max_err = max(max_err, err)
    t = T[0].contiguous()
    Xcsr = torch.sparse_csr_tensor(rows.rowptr, rows.cols, rows.vals,
                                   size=(n, d))
    ms, per = {}, {}
    for what, fn in (('kernel', lambda: spmv.spmv(rows, t)),
                     ('plain', lambda: spmv.spmv_ref(rows, t)),
                     ('gemv', lambda: X @ t[:, None]),
                     ('library', lambda: torch.mv(Xcsr, t))):
        ms[what], per[what] = device_ms_a_call(fn, dev)
    del Xcsr
    size = X.element_size()
    nbytes = nnz * (4 + size) + 4 * (n + 1) + size * (d + n)
    b = bound(2 * nnz, nbytes)
    log("SpMV %dx%d %d nonzeros float32, the fit's X" % (n, d, nnz),
        density=nnz / (n * d), blocks=int(rows.blocks.shape[0] - 1),
        longest_row=int(torch.diff(rows.rowptr.long()).max()),
        rows_s=build_s, err_over_scale=worst,
        device_ms=ms, kernels_a_call=per, bound_bytes=nbytes,
        bound_ms=b[0], bound_by=b[1],
        ms_over_bound_ms=ms['kernel'] / b[0])
    return dict(max_abs_err=max_err, ms=ms['kernel'], plain_ms=ms['plain'],
                bound_ms=b[0], bound_by=b[1], library_ms=ms['library'],
                gemv_ms=ms['gemv'])


def run_tm_default_phase(dev, dk, Est, counts):
    """Phase 15: the TM estimator with its default preset; the W side
    reads the corpus's nonzeros (``ops/spmv.py``), k launches a sweep.
    Returns the SpMV's stats (:func:`check_spmv`) and the fit's
    launches of it."""
    from rri_nmf_tpu_torch.matrixops import normalize, tfidf
    from rri_nmf_tpu_torch.ops import spmv
    n_train, _, _, k = TM_SHAPE
    X = torch.as_tensor(counts, device=dev)
    Xtr, idf = tfidf(X[:n_train], return_idf=True)
    Xtr = normalize(Xtr)
    Xte = normalize(X[n_train:] * idf)
    del X
    n, d = Xtr.shape
    b0 = dict(dk.LAUNCHES)
    s0 = spmv.LAUNCHES['spmv']
    t0 = time.perf_counter()
    est = Est(n, d, k, random_state=0, max_iter=TM_DEFAULT_SWEEPS,
              nmf_kwargs=dict(compute_obj_each_iter=True)).fit(Xtr)
    sync(dev)
    fit_s = time.perf_counter() - t0
    if dk.LAUNCHES != b0:
        raise AssertionError('the default TM fit launched kernels')
    spmv_launches = spmv.LAUNCHES['spmv'] - s0
    sweeps = len(est.nmf_outputs['iter_cputime'])
    if dev.type == 'cuda' and spmv_launches < k * sweeps:
        raise AssertionError('the default TM fit launched the SpMV %d times '
                             'in %d sweeps of k=%d' % (spmv_launches, sweeps,
                                                       k))
    spmv_stats = check_spmv(dev, spmv, Xtr, est.T)
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
    sw.rows(Xtr, est.W)         # the corpus's nonzeros, as the fit's sweep
    trace = trace_shares(
        lambda: sw.speculate(Xtr, est.W, est.T, draws, 23), dev)
    r2 = est.score(Xte)
    if not np.isfinite(r2):
        raise AssertionError('non-finite score %r' % r2)
    log('NMF_TM_Estimator %dx%d k=%d float32, default preset' % (n, d, k),
        sweeps=len(out['iter_cputime']), fit_s=fit_s,
        obj_first=out['obj_history'][0], obj_last=out['obj_history'][-1],
        n_resets_remaining=out['n_resets_remaining'],
        spmv_launches=spmv_launches,
        ms_per_sweep_with_objective=_sweep_ms(out),
        ms_per_sweep=_sweep_ms(est2.nmf_outputs),
        byte_floor_ms=stream_floor_ms(n, d, k),
        speculative_sweep_trace=trace, T_row_sum_err=t_dev,
        transform_rows=list(Wn.shape), transform_b1_launches=transforms,
        transform_ms=transform_ms, transform_row_sum_err=w_dev, score_r2=r2)
    return dict(spmv_stats, launches=spmv_launches)


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
    """The contractions of the Gram-phase sweep on ``plan`` for the
    factors W (n, k), T (k, d): {name: (direction, plan direction, Fᵀ's
    rows, k, pairs, rows, output columns, values or None)}; ``p`` the
    panel. A and C (pairs None, the M⊙X values) run the gather kernel on
    the k factor rows; Γ and Θ the Gram kernel on the Khatri-Rao rows of
    ``pairs`` (``'unique'`` or a panel ``(0, p)``)."""
    n, d = plan.shape
    k = W.shape[1]
    p = min(p, k)
    Tt = T.T.contiguous()
    calls = {
        'A (k rows, M⊙X)': ('t', W, None, k),
        'Gamma (k(k+1)/2 rows)': ('t', W, 'unique', k * (k + 1) // 2),
        'Gamma panel (p·k rows)': ('t', W, (0, p), p * k),
        'C (k rows, M⊙X)': ('w', Tt, None, k),
        'Theta (k(k+1)/2 rows)': ('w', Tt, 'unique', k * (k + 1) // 2),
        'Theta panel (p·k rows)': ('w', Tt, (0, p), p * k)}
    for name in (names or calls):
        side, Ft, pairs, rows = calls[name]
        yield name, (side, plan.m_t if side == 't' else plan.m_w, Ft, k,
                     pairs, rows, d if side == 't' else n,
                     plan.mx_layout_values(side) if pairs is None else None)


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


def check_masked_gram(dev, sk, mg, cases):
    """Phase 17: the Gram-phase sweep's contractions on the card: A and C
    through the gather kernel against its twin; Γ and Θ through the Gram
    kernel against its twin and against the gather kernel on the
    materialized Khatri-Rao rows (the path it replaced); each repeats bit
    for bit. ``cases``: ``(label, X, M, dtype, tol, timed, runs)``, runs
    a list of ``(k, p, names)``. A timed call logs its ms beside its
    twin's, its bound and ``torch.sparse.mm``'s ms on the same operand
    (the Gram kernel's: on the materialized rows, beside the gather
    kernel's ms on them). Returns ({label: (plan, build seconds)} of the
    timed cases, {(label, contraction, k): line} of the Gram kernel's
    timed calls)."""
    plans, gram = {}, {}
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
            for name, (side, pl, Ft, kk, pairs, rows, ncols, vals) in \
                    gram_contractions(mg, plan, W, T, p, names):
                lay = pl
                panel = None if pairs == 'unique' else pairs
                if pairs is None:
                    kernel, KR = 'gather', None

                    def call():
                        return sk.gather_contract(pl, Ft, rows, ncols, vals)

                    def twin():
                        return sk.gather_contract_ref(lay, Ft, rows, ncols,
                                                      vals)
                else:
                    kernel = 'gram'
                    a, b = (x.to(dev) for x in sk.gram_pairs(kk, panel))
                    KR = Ft[:, a] * Ft[:, b]
                    del a, b

                    def call():
                        return sk.gram_contract(pl, Ft, kk, panel, ncols)

                    def twin():
                        return sk.gram_contract_ref(lay, Ft, kk, panel,
                                                    ncols)

                    def gather():
                        return sk.gather_contract(pl, KR, rows, ncols)
                first, again = call(), call()
                sync(dev)
                if not torch.equal(first, again):
                    raise AssertionError('%s %s %s: two launches differ'
                                         % (label, name, dtype))
                want = twin()
                errs = {'twin': row_err(first, want)}
                if KR is not None:
                    errs['gather_kernel_on_rows'] = row_err(first, gather())
                if not (max(errs.values()) <= tol
                        and bool(torch.isfinite(first).all())):
                    raise AssertionError('%s %s %s: error %r > %g'
                                         % (label, name, dtype, errs, tol))
                line = {'case': label, 'contraction': name, 'k': kk,
                        'rows': rows, 'dtype': str(dtype),
                        'rel_err': errs['twin'],
                        'max_abs_err': float((first - want).abs().max()),
                        'bitwise_repeat': True, 'nnz': plan.nnz,
                        'plan_build_s': plan_s}
                if KR is not None:
                    line['rel_err_gather_kernel_on_rows'] = \
                        errs['gather_kernel_on_rows']
                del want
                if timed:
                    nnz = lay.gidx.shape[0]
                    ms = time_ms(call, dev, runs=5)
                    line.update(ms=ms, plain_ms=time_ms(twin, dev, runs=1))
                    b = bound(2 * nnz * rows,
                              Ft.numel() * size + lay.nbytes
                              + rows * ncols * size, str(dtype)[6:])
                    line.update(bound_ms=b[0], bound_by=b[1])
                    if KR is not None:
                        line['gather_kernel_on_rows_ms'] = time_ms(
                            gather, dev, runs=5)
                    if lib:
                        S = lib[(side, vals is not None)]
                        operand = Ft if KR is None else KR
                        got = torch.sparse.mm(S, operand).T
                        line['library_rel_err'] = row_err(first, got)
                        if not line['library_rel_err'] <= tol:
                            raise AssertionError('%s %s: torch.sparse.mm '
                                                 'differs' % (label, name))
                        del got
                        line['library_ms'] = time_ms(
                            lambda: torch.sparse.mm(S, operand), dev, runs=5)
                        line['ms_over_library_ms'] = ms / line['library_ms']
                    if KR is not None:
                        gram[(label, name, kk)] = line
                log('kernel %s, Gram-phase contractions' % kernel, **line)
                del first, again, KR
        if timed:
            plans[label] = (plan, plan_s)
        del lib
    return plans, gram


def gram_split_problem(n, d, q, heavy, share, seed=0):
    """``(X, M)`` scipy CSR, M binary: ``q`` uniform (row, column)
    draws, ``heavy`` columns (10, 11, ..) and as many rows observed in
    ``share`` of the other side, rows and columns 3 and the last empty;
    values ``rand + 0.5``, duplicates summed."""
    import scipy.sparse as sp
    rng = np.random.RandomState(seed)
    rows, cols = [rng.randint(0, n, q)], [rng.randint(0, d, q)]
    for h in range(heavy):
        r = rng.choice(n, int(share * n), replace=False)
        c = rng.choice(d, int(share * d), replace=False)
        rows += [r, np.full(c.size, 10 + h)]
        cols += [np.full(r.size, 10 + h), c]
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    keep = ~(np.isin(rows, (3, n - 1)) | np.isin(cols, (3, d - 1)))
    rows, cols = rows[keep], cols[keep]
    vals = rng.rand(rows.size).astype(np.float32) + 0.5
    X = sp.coo_matrix((vals, (rows, cols)), shape=(n, d)).tocsr()
    M = X.copy()
    M.data = np.ones_like(M.data)
    return X, M


def check_gram_split(dev, sk, mg, uniform):
    """Phase 17, the Gram kernel's chunked columns: on the skewed
    :data:`GRAM_SPLIT_MASK`, Γ and Θ whole and in panels
    (:data:`GRAM_SPLIT_RUNS`) cut their heavy columns (each at least 20
    chunk lengths) into chunks, counted under ``LAUNCHES['gram_split']``;
    float64 against the twin at :data:`TOL_F64`, float32 against the
    float64 twin of the same inputs at :data:`TOL_GRAM_SPLIT_F32` and
    against the float32 twin at :data:`TOL_F32`, two launches bit for
    bit; each line gives the work list and the kernel's ms. On the
    uniform ``uniform`` plan (the recorded problem's, k=32 whole and
    the k=128 panel) no launch cuts a column: ``'gram_split'`` stays."""
    n, d, q, heavy, share = GRAM_SPLIT_MASK
    X, M = gram_split_problem(n, d, q, heavy, share)
    index = (dev.index or 0) if dev.type == 'cuda' else None
    for dtype, k, panels in GRAM_SPLIT_RUNS:
        plan = mg.plan_masked_gram(X, M, dtype, backend='mxu', device=dev)
        rng = np.random.RandomState(3)
        W = torch.as_tensor(rng.rand(n, k), dtype=dtype, device=dev)
        Tt = torch.as_tensor(rng.rand(d, k), dtype=dtype, device=dev)
        for side, lay, Ft, ncols in (('Gamma', plan.m_t, W, d),
                                     ('Theta', plan.m_w, Tt, n)):
            for panel in panels:
                t0, p = panel or (0, 0)
                longest = int(torch.diff(lay.colptr.long()).max())
                line = {'case': side, 'dtype': str(dtype), 'k': k,
                        'panel': panel, 'nnz': plan.nnz,
                        'longest_column': longest}
                if index is not None:
                    L = sk.chunk_length(lay.gidx.shape[0], sk.resident_teams(
                        dtype, k, t0, p, index))
                    work = lay.gram_work(L)
                    line.update(L=L, split_columns=work.n_split,
                                chunks=work.n_chunks,
                                longest_item=work.longest)
                    if work.n_split < heavy or longest < 20 * L \
                            or work.longest > L:
                        raise AssertionError('Gram split phase: %r' % line)
                before = sk.LAUNCHES['gram_split']

                def call():
                    return sk.gram_contract(lay, Ft, k, panel, ncols)
                first, again = call(), call()
                sync(dev)
                if index is not None and \
                        sk.LAUNCHES['gram_split'] != before + 2:
                    raise AssertionError('%s %s: gram_split %d -> %d'
                                         % (side, dtype, before,
                                            sk.LAUNCHES['gram_split']))
                if not torch.equal(first, again):
                    raise AssertionError('%s %s %s: two launches differ'
                                         % (side, dtype, panel))
                want = sk.gram_contract_ref(lay, Ft.double(), k, panel,
                                            ncols)
                line['rel_err_f64_twin'] = row_err(first.double(), want)
                del want
                tol = TOL_F64
                if dtype == torch.float32:
                    tol = TOL_GRAM_SPLIT_F32
                    line['rel_err_twin'] = row_err(first, sk.gram_contract_ref(
                        lay, Ft, k, panel, ncols))
                    if not line['rel_err_twin'] <= TOL_F32:
                        raise AssertionError('%s float32: %r' % (side, line))
                if not (line['rel_err_f64_twin'] <= tol
                        and bool(torch.isfinite(first).all())):
                    raise AssertionError('%s %s: error %r > %g'
                                         % (side, dtype, line, tol))
                if index is not None:
                    line['ms'] = time_ms(call, dev, runs=5)
                line['bitwise_repeat'] = True
                log('kernel gram, chunked columns', **line)
                del first, again
        del plan, W, Tt
    if index is None:
        return
    plan = uniform
    n, d = plan.shape
    before = sk.LAUNCHES['gram_split']
    rng = np.random.RandomState(3)
    for k, panel in ((MASKED_RECORD[3], None),
                     (MASKED_PANEL_K, (0, mg.auto_panel(MASKED_PANEL_K, n, d,
                                                        4)))):
        W = torch.as_tensor(rng.rand(n, k), dtype=torch.float32, device=dev)
        Tt = torch.as_tensor(rng.rand(d, k), dtype=torch.float32, device=dev)
        for side, lay, Ft, ncols in (('Gamma', plan.m_t, W, d),
                                     ('Theta', plan.m_w, Tt, n)):
            sk.gram_contract(lay, Ft, k, panel, ncols)
            t0, p = panel or (0, 0)
            L = sk.chunk_length(lay.gidx.shape[0], sk.resident_teams(
                torch.float32, k, t0, p, index))
            log('kernel gram, uniform mask', case=side, k=k, panel=panel,
                L=L, longest_column=int(torch.diff(
                    lay.colptr.long()).max()),
                split_columns=lay.gram_work(L).n_split)
        del W, Tt
    sync(dev)
    if sk.LAUNCHES['gram_split'] != before:
        raise AssertionError('the uniform mask cut a column: gram_split '
                             '%d -> %d' % (before, sk.LAUNCHES['gram_split']))


def sparse_launches(sk):
    """The sparse kernels' launch counts now: the gather kernel's
    (A and C of a Gram sweep) and the Gram kernel's (Γ, Θ)."""
    return {key: sk.LAUNCHES[key] for key in ('gather', 'gram')}


def launched_since(sk, before):
    return {key: sk.LAUNCHES[key] - v for key, v in before.items()}


def gram_launches(sweeps, panels=None):
    """The launches of ``sweeps`` tracked Gram-phase sweeps (each with its
    objective): 3 gather (A, C, the objective's C) and 3 Gram (Γ, Θ, the
    objective's Θ) a sweep; in ``panels`` panels, 3·panels Gram."""
    return {'gather': 3 * sweeps, 'gram': 3 * (panels or 1) * sweeps}


def run_masked_record_phase(dev, sk, nmf, mg, ms, X, M, plan, plan_s):
    """Phase 18 on the recorded problem (scipy CSR ``X``, ``M``; ``plan``
    its Gram plan from phase 17): returns the gather and Gram kernels'
    launches of the main path's fits, ``{'gather': .., 'gram': ..}``."""
    from rri_nmf_tpu_torch.ops.sweep import make_draws
    n, d, _, k = MASKED_RECORD
    nnz = int(M.nnz)
    main = gram_launches(0)

    def fit(**kw):
        """nmf() on the problem: (result, wall s, {'mxu', 'gram'}
        launches, peak GB)."""
        if dev.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(dev)
        b0 = sparse_launches(sk)
        t0 = time.perf_counter()
        res = nmf(X, kw.pop('k', k), W_mat=M, compute_obj_each_iter=True,
                  random_state=0, eps_stop=0.0, device=dev, **kw)
        sync(dev)
        peak = (torch.cuda.max_memory_allocated(dev) / 1e9
                if dev.type == 'cuda' else None)
        return (res, time.perf_counter() - t0, launched_since(sk, b0), peak)

    # 18a. the Gram-phase sweep (A, Γ, C, Θ a sweep; C, Θ an objective)
    res, wall, got, peak = fit(update_order='phase', reset_topic_method=None,
                               max_iter=GRAM_SWEEPS)
    obj = res['obj_history']
    if got != gram_launches(len(obj)):
        raise AssertionError('Gram-phase nmf(): launches %r for %d sweeps '
                             '(want %r)' % (got, len(obj),
                                            gram_launches(len(obj))))
    main = got
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
        gather_launches=got['gather'], gram_launches=got['gram'],
        obj_first=obj[0], obj_last=obj[-1], wall_s=wall,
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
        raise AssertionError('the O(nnz) sweep launched a sparse kernel')
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
    if got != gram_launches(1, npan):
        raise AssertionError('k=%d panel sweep: launches %r (want %r)'
                             % (kp, got, gram_launches(1, npan)))
    main = {key: main[key] + got[key] for key in main}
    if not (bool(torch.isfinite(res['W']).all())
            and np.isfinite(res['obj_history'][-1])):
        raise AssertionError('non-finite panel sweep')
    sweep = mg.make_masked_gram_sweep(masked_cfg(kp, update_order='phase'),
                                      'mxu', panel)
    log('nmf %dx%d k=%d float32, Gram-phase in %d-topic panels'
        % (n, d, kp, panel), panels=npan, gather_launches=got['gather'],
        gram_launches=got['gram'], obj=res['obj_history'], wall_s=wall,
        peak_GB=peak,
        ms_per_sweep=time_ms(lambda: sweep(plan, W0, T0, draws, 0), dev,
                             runs=1))
    return main


def run_sparse_obs_phase(dev, mk, sk, Est, X, rmse_dense):
    """Phase 19 on phase 8's ratings ``X`` (numpy): returns the gather
    and Gram kernels' launches of the main path's fits."""
    n, d, _, k = RS_SHAPE
    p_tr, r_tr, p_te, r_te = (torch.as_tensor(a, device=dev) for a in
                              rs_split(X))
    r_tr, r_te = r_tr.float(), r_te.float()
    rows = RS_TRANSFORM_ROWS
    sel = p_te[:, 0] < rows
    Xnew = torch.zeros(rows, d, device=dev)
    Xnew[p_te[sel, 0], p_te[sel, 1]] = r_te[sel]
    main = gram_launches(0)
    rmse = {}
    from rri_nmf_tpu_torch.ops import sweep_masked_gram as mg
    from rri_nmf_tpu_torch.ops import sweep_masked_sparse as ms
    sweeps = {'interleaved': ms.make_masked_sparse_sweep(masked_cfg(
        k, t_row_sum=1.0)), 'Gram-phase': mg.make_masked_gram_sweep(
            masked_cfg(k, t_row_sum=1.0, update_order='phase'), 'mxu')}
    for label, kw in (('interleaved', {}),
                      ('Gram-phase', dict(nmf_kwargs=dict(
                          update_order='phase')))):
        b0 = dict(mk.LAUNCHES), sparse_launches(sk)
        t0 = time.perf_counter()
        est = _rs_fit(Est, p_tr, r_tr, RS_SHAPE, sparse_obs=True, **kw)
        sync(dev)
        fit_s = time.perf_counter() - t0
        got = launched_since(sk, b0[1])
        obj = est.nmf_outputs['obj_history']
        # an early stop runs one sweep more than it keeps
        want = ([gram_launches(0)] if label == 'interleaved' else
                [gram_launches(len(obj)), gram_launches(len(obj) + 1)])
        if mk.LAUNCHES != b0[0] or got not in want:
            raise AssertionError('sparse_obs %s fit: B3/B4 %r, launches %r '
                                 'for %d sweeps kept' % (
                                     label, mk.LAUNCHES, got, len(obj)))
        main = {key: main[key] + got[key] for key in main}
        non_increasing(obj, 'sparse_obs %s fit' % label,
                       float((r_tr ** 2).sum()) if got['gather'] else None)
        b1 = dict(mk.LAUNCHES), sparse_launches(sk)
        t0 = time.perf_counter()
        Wn = est.transform(Xnew)
        sync(dev)
        transform_s = time.perf_counter() - t0
        if mk.LAUNCHES != b1[0] or sparse_launches(sk) != b1[1] or \
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
            gather_launches=got['gather'], gram_launches=got['gram'],
            obj_first=obj[0], obj_last=obj[-1],
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
        b0 = sparse_launches(sk)
        o_gpu = _rs_fit(Est, torch.as_tensor(p_s, device=dev),
                        torch.as_tensor(r_s, device=dev).float(), RS_SMALL,
                        **kw).nmf_outputs['obj_history']
        got = launched_since(sk, b0)
        main = {key: main[key] + got[key] for key in main}
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


# --------------------------------------------------------------------------
# HER, checkpoints and row weights (phases 20-23)
# --------------------------------------------------------------------------

def uniform_factor(n, d, k, dev, seed=0):
    """The U[0,1]-factor class (tests/test_accel.py,
    benchmarks/exp_northstar3.py): U[0,1] factors from a numpy seed, their
    product formed on ``dev`` in float32."""
    rng = np.random.RandomState(seed)
    W = torch.as_tensor(rng.rand(n, k).astype(np.float32), device=dev)
    T = torch.as_tensor(rng.rand(k, d).astype(np.float32), device=dev)
    return W @ T


@contextlib.contextmanager
def uncounted(*modules):
    """Leave the launch counts of ``modules`` as they were: the launches
    of a side call that does not go through ``nmf()`` or an estimator
    (the recursion by hand, a sync check) stay off the ``kernels``
    line."""
    before = [dict(m.LAUNCHES) for m in modules]
    try:
        yield
    finally:
        for m, counts in zip(modules, before):
            m.LAUNCHES.update(counts)


def her_trace(X, W, T, cfg, sweeps):
    """The recursion of ``nmf(accel='her')`` over the dense kernel sweep,
    run step by step: ``(W, T, restarts)``, the iterate ``nmf()`` returns
    (the best accepted one when it beats the last) and the sweeps whose
    objective check restarted (beta halved), read on the host after each
    step."""
    from rri_nmf_tpu_torch.ops.accel import make_her_step, make_residual_obj
    from rri_nmf_tpu_torch.ops.dense_kernels import make_dense_phase_sweep
    sweep = make_dense_phase_sweep(cfg)
    step = make_her_step(lambda X, W, T: sweep(X, W, T),
                         make_residual_obj(cfg))
    inf = torch.tensor(float('inf'), dtype=W.dtype, device=W.device)
    beta = torch.tensor(0.5, dtype=torch.float32, device=W.device)
    state = (W, T, W, T, W, T, inf, beta, inf)
    restarts = []
    for i in range(sweeps):
        before = float(state[7])
        state = step(X, *state)
        if float(state[7]) < before:
            restarts.append(i)
    W1, T1, _, _, Wb, Tb, eb, _, e = state
    return (Wb, Tb, restarts) if bool(eb < e) else (W1, T1, restarts)


def run_her_phase(dev, dk, nmf, frob, Est, counts):
    """Phase 20: HER over the dense kernel sweep, then the TM estimator
    with HER (B2 and B1)."""
    from rri_nmf_tpu_torch.initialization import initialize_nmf
    from rri_nmf_tpu_torch.matrixops import normalize, tfidf
    from rri_nmf_tpu_torch.ops.accel import make_her_step, make_residual_obj
    from rri_nmf_tpu_torch.ops.dense_kernels import make_dense_phase_sweep
    from rri_nmf_tpu_torch.ops.sweep import SweepConfig
    n, d, k = NMF_SHAPE
    X = uniform_factor(n, d, k, dev, seed=0)
    W0, T0 = initialize_nmf(X, k, 'nndsvd', random_state=0,
                            svd_backend='torch', device=dev)
    kw = dict(W_in=W0, T_in=T0, max_iter=HER_SWEEPS, random_state=0,
              **FAST_TM)
    fits = {}
    for label, extra in (('plain', {}), ('her', dict(accel='her'))):
        b0 = dk.LAUNCHES['gs']
        fits[label] = nmf(X, k, **kw, **extra)
        sync(dev)
        gs = dk.LAUNCHES['gs'] - b0
        if gs != 2 * HER_SWEEPS:
            raise AssertionError('%s: %d B1 launches for %d sweeps'
                                 % (label, gs, HER_SWEEPS))
    errs = {key: frob(X, r['W'], r['T']) for key, r in fits.items()}
    her = fits['her']
    if not (errs['her'] < errs['plain'] and bool((her['W'] >= 0).all())
            and bool((her['T'] >= 0).all())):
        raise AssertionError('HER error %r, plain %r' % (errs['her'],
                                                          errs['plain']))
    grouped = nmf(X, k, **kw, accel='her', sweeps_per_dispatch=HER_GROUP)
    sync(dev)
    if not (torch.equal(grouped['W'], her['W'])
            and torch.equal(grouped['T'], her['T'])):
        raise AssertionError('HER: grouped dispatch differs from the '
                             'per-sweep loop')
    # the recursion by hand: its restarts, the same bits as nmf()
    cfg = SweepConfig(k=k, reset_topic_method=None, update_order='phase')
    obj = make_residual_obj(cfg)
    obj_ms = time_ms(lambda: obj(X, W0, T0), dev)
    sweep = make_dense_phase_sweep(cfg)
    step = make_her_step(lambda X, W, T: sweep(X, W, T), obj)
    inf = torch.tensor(float('inf'), device=dev)
    beta = torch.tensor(0.5, device=dev)
    with uncounted(dk):
        Wt, Tt, restarts = her_trace(X, W0, T0, cfg, HER_SWEEPS)
        sync_free(lambda: step(X, W0, T0, W0, T0, W0, T0, inf, beta, inf),
                  dev)
    if not (torch.equal(Wt, her['W']) and torch.equal(Tt, her['T'])):
        raise AssertionError('HER by hand differs from nmf(accel=\'her\')')
    log('HER nmf %dx%d k=%d float32, U[0,1] factors' % (n, d, k),
        sweeps=HER_SWEEPS, rel_frobenius_error_plain=errs['plain'],
        rel_frobenius_error_her=errs['her'],
        error_ratio=errs['her'] / errs['plain'],
        ms_per_sweep_plain=_sweep_ms(fits['plain']),
        ms_per_sweep_her=_sweep_ms(her),
        ms_per_sweep_her_grouped=float(
            np.diff(grouped['iter_cputime'][HER_GROUP - 1::HER_GROUP]).mean()
            / HER_GROUP * 1e3),
        objective_check_ms=obj_ms, restarts=len(restarts),
        restart_sweeps=restarts, b1_per_sweep=2,
        grouped_equals_per_sweep=True, step_sync_free=True)
    del fits, her, grouped, X, W0, T0, Wt, Tt

    # the TM estimator with HER: B2 for the T-phase, B1 for the W-phase
    n_train, _, _, k_tm = TM_SHAPE
    Xtr = normalize(tfidf(torch.as_tensor(counts[:n_train], device=dev)))
    b0 = dict(dk.LAUNCHES)
    t0 = time.perf_counter()
    est = _tm_fit(Est, Xtr, k_tm, TM_HER_SWEEPS, accel='her')
    sync(dev)
    fit_s = time.perf_counter() - t0
    sweeps = len(est.nmf_outputs['iter_cputime'])
    b2, b1 = (dk.LAUNCHES[key] - b0[key] for key in ('tm_proj', 'gs'))
    if sweeps != TM_HER_SWEEPS or b2 != sweeps or b1 != sweeps:
        raise AssertionError('TM + HER: B2 %d, B1 %d launches for %d sweeps'
                             % (b2, b1, sweeps))
    # the objective check of the TM fit's HER step, alone
    obj = make_residual_obj(SweepConfig(
        k=k_tm, reset_topic_method=None, update_order='phase',
        reg_w_l1=est.wr1, reg_w_l2=est.wr2, reg_t_l1=est.tr1,
        reg_t_l2=est.tr2))
    W_tm, T_tm = (torch.as_tensor(a, device=dev) for a in (est.W, est.T))
    log('NMF_TM_Estimator + HER %dx%d k=%d float32' % (Xtr.shape + (k_tm,)),
        sweeps=sweeps, fit_s=fit_s, ms_per_sweep=_sweep_ms(est.nmf_outputs),
        objective_check_ms=time_ms(lambda: obj(Xtr, W_tm, T_tm), dev),
        b2_launches=b2, b1_launches=b1,
        T_row_sum_err=check_simplex(est.T, 1.0, 'TM + HER T rows'))


def run_rs_her_phase(dev, mk, Est, X):
    """Phase 21: ``NMF_RS_Estimator`` with HER (B3 and B4) beside the
    plain fit of the same sweeps, then the default fit with HER."""
    n, d, _, k = RS_SHAPE
    p_tr, r_tr, p_te, r_te = (torch.as_tensor(a, device=dev) for a in
                              rs_split(X))
    r_tr, r_te = r_tr.float(), r_te.float()
    out = {}
    for label, extra in (('plain', {}), ('her', dict(accel='her'))):
        b0 = dict(mk.LAUNCHES)
        est = _rs_fit(Est, p_tr, r_tr, RS_SHAPE, max_iter=RS_SWEEPS,
                      use_validation_early_stopping=False,
                      nmf_kwargs=dict(eps_stop=0.0, **extra))
        sync(dev)
        sweeps = len(est.nmf_outputs['obj_history'])
        for key in ('phase_a', 'phase_b'):
            if mk.LAUNCHES[key] - b0[key] != k * sweeps:
                raise AssertionError('RS %s: %s %d launches for %d sweeps' % (
                    label, key, mk.LAUNCHES[key] - b0[key], sweeps))
        # sweep-only time: the same fit continued, no objective per sweep
        est2 = _rs_fit(Est, p_tr, r_tr, RS_SHAPE, max_iter=10, W=est.W,
                       T=est.T, use_validation_early_stopping=False,
                       nmf_kwargs=dict(compute_obj_each_iter=False, **extra))
        sync(dev)
        out[label] = dict(
            sweeps=sweeps, obj_last=est.nmf_outputs['obj_history'][-1],
            train_rmse=est.score(p_tr, r_tr), test_rmse=est.score(p_te, r_te),
            ms_per_sweep_with_objective=_sweep_ms(est.nmf_outputs),
            ms_per_sweep=_sweep_ms(est2.nmf_outputs))
    if not (np.isfinite(out['her']['train_rmse'])
            and out['her']['obj_last'] <= out['plain']['obj_last']):
        raise AssertionError('RS + HER: %r' % (out,))
    b0 = dict(mk.LAUNCHES)
    est = _rs_fit(Est, p_tr, r_tr, RS_SHAPE, nmf_kwargs=dict(accel='her'))
    sync(dev)
    run = mk.LAUNCHES['phase_a'] - b0['phase_a']
    if run == 0 or run % k or mk.LAUNCHES['phase_b'] - b0['phase_b'] != run:
        raise AssertionError('RS + HER, validation early stop: B3 %d launches'
                             % run)
    out['her, validation early stop'] = dict(
        sweeps_run=run // k, sweeps_kept=len(est.nmf_outputs['iter_cputime']),
        test_rmse=est.score(p_te, r_te))
    log('NMF_RS_Estimator + HER %dx%d k=%d float32' % (n, d, k), **out)


def run_checkpoint_phase(dev, nmf):
    """Phase 22: a checkpointed and resumed fit equals the straight one,
    bit for bit: phase 20's HER fit, and a default-order fit with
    ``'random'`` resets from a warm start with a dead topic (its reset
    fires in the first sweep, before the checkpoint), without and with DP
    noise (every sweep after the checkpoint draws its noise from the
    generator state the checkpoint carries)."""
    import tempfile
    from rri_nmf_tpu_torch.checkpoint import NMFCheckpointer
    from rri_nmf_tpu_torch.initialization import initialize_nmf
    first, total = CKPT_SWEEPS
    n, d, k = NMF_SHAPE
    X = uniform_factor(n, d, k, dev, seed=0)
    W0, T0 = initialize_nmf(X, k, 'nndsvd', random_state=0,
                            svd_backend='torch', device=dev)
    n2, d2, k2 = SMALL_SHAPE
    rng = np.random.RandomState(7)
    W2 = rng.rand(n2, k2).astype(np.float32)
    W2[:, DEAD_TOPIC] = 0.0
    T2 = rng.rand(k2, d2).astype(np.float32)
    X2 = lowrank(n2, d2, k2, dev, seed=6)
    warm = dict(W_in=torch.as_tensor(W2, device=dev),
                T_in=torch.as_tensor(T2, device=dev),
                reset_topic_method='random')
    fits = [('HER %dx%d k=%d' % (n, d, k), X, k,
             dict(W_in=W0, T_in=T0, accel='her', **FAST_TM)),
            ('random resets %dx%d k=%d' % (n2, d2, k2), X2, k2, warm),
            ('random resets, DP noise %dx%d k=%d' % (n2, d2, k2), X2, k2,
             dict(warm, **CKPT_DP))]
    out = {}
    for label, Xc, kc, kw in fits:
        kw = dict(kw, random_state=0, compute_obj_each_iter=True,
                  eps_stop=0.0)
        straight = nmf(Xc, kc, max_iter=total, **kw)
        with tempfile.TemporaryDirectory() as ck:
            nmf(Xc, kc, max_iter=first, checkpoint=ck,
                checkpoint_every=first, **kw)
            resumed = nmf(Xc, kc, max_iter=total, checkpoint=ck,
                          checkpoint_every=total + 1, **kw)
            sync(dev)
            ckpt = NMFCheckpointer(ck)
            nbytes = os.path.getsize(os.path.join(ck, 'step_%d.pt' % first))
            t0 = time.perf_counter()
            state = ckpt.restore(device=dev)
            sync(dev)
            restore_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            ckpt.save(first, state)
            save_s = time.perf_counter() - t0
        if not (torch.equal(resumed['W'], straight['W'])
                and torch.equal(resumed['T'], straight['T'])
                and resumed['obj_history'] == straight['obj_history']
                and resumed['n_resets_remaining']
                == straight['n_resets_remaining']):
            raise AssertionError('%s: the resumed fit differs from the '
                                 'straight one' % label)
        out[label] = dict(sweeps=[first, total], bytes=nbytes, save_s=save_s,
                          restore_s=restore_s,
                          n_resets_remaining=resumed['n_resets_remaining'],
                          generator_state=state.generator_state is not None,
                          resumed_equals_straight=True)
    if out[fits[1][0]]['n_resets_remaining'] >= 23:
        raise AssertionError('the dead topic did not reset: %r' % (out,))
    # with DP noise the dead topic's T row comes back alive from its noisy
    # numerator, so it may not reset: its sweeps exercise the generator
    log('checkpoint/resume float32', **out)


def run_w_row_phase(dev, dk, nmf):
    """Phase 23: ``w_row`` in the phase recipe at NMF_SHAPE (the fit, then
    the 10-sweep fixed-T W refit), and ``w_row`` and HER on the card
    against the CPU."""
    n, d, k = NMF_SHAPE
    X = lowrank(n, d, k, dev, seed=0)
    w_row = np.random.RandomState(8).rand(n) + 0.5
    b0 = dk.LAUNCHES['gs']
    t0 = time.perf_counter()
    res = nmf(X, k, w_row=w_row, max_iter=W_ROW_SWEEPS, random_state=0,
              compute_obj_each_iter=True, eps_stop=0.0, **FAST_TM)
    sync(dev)
    wall = time.perf_counter() - t0
    gs = dk.LAUNCHES['gs'] - b0
    obj = res['obj_history']
    if gs != 2 * W_ROW_SWEEPS + W_ROW_REFIT or len(obj) != \
            W_ROW_SWEEPS + W_ROW_REFIT:
        raise AssertionError('w_row: %d B1 launches, %d objectives'
                             % (gs, len(obj)))
    non_increasing(obj[:W_ROW_SWEEPS], 'w_row fit')
    non_increasing(obj[W_ROW_SWEEPS:], 'w_row refit')
    stamps = res['iter_cputime']
    log('nmf %dx%d k=%d float32, w_row' % (n, d, k), wall_s=wall,
        b1_launches=gs, obj_fit_first=obj[0],
        obj_fit_last=obj[W_ROW_SWEEPS - 1],
        obj_refit_first=obj[W_ROW_SWEEPS], obj_refit_last=obj[-1],
        ms_per_sweep_fit_with_objective=float(np.median(
            np.diff(stamps[:W_ROW_SWEEPS]))) * 1e3,
        ms_per_sweep_refit_with_objective=float(np.median(
            np.diff(stamps[W_ROW_SWEEPS:]))) * 1e3)
    del X, res

    # card (float32) against CPU (float64) from one init, gated on both
    # classes: the refit's NNDSVD init is scikit-learn's randomized SVD in
    # float64 on both sides (on the card in torch.linalg, on the host the
    # package's copy of it: this machine has no scikit-learn), so the
    # mean-dominated U[0,1]-factor class starts its refit where the CPU's
    # does too
    n, d, k = SMALL_SHAPE
    rng = np.random.RandomState(4)
    Wf, mW = rng.rand(n, k), rng.rand(n, k) < SPARSE_FACTOR_DENSITY
    Tf, mT = rng.rand(k, d), rng.rand(k, d) < SPARSE_FACTOR_DENSITY
    E = 0.01 * rng.rand(n, d)
    sparse = (Wf * mW) @ (Tf * mT)
    w_row = np.random.RandomState(9).rand(n) + 0.5
    from rri_nmf_tpu_torch.initialization import initialize_nmf
    from rri_nmf_tpu_torch.ops.sweep import SweepConfig
    cfg = SweepConfig(k=k, reset_topic_method=None, update_order='phase')
    for data, Xs in (('sparse factors', sparse + E),
                     ('mean-dominated', Wf @ Tf + E)):
        Xs = torch.as_tensor(Xs)
        W0, T0 = initialize_nmf(Xs, k, 'random', random_state=3,
                                device=torch.device('cpu'))
        out = {}
        for label, kw in (('w_row', dict(w_row=w_row)),
                          ('HER', dict(accel='her'))):
            finals, restarts = {}, {}
            for where in (dev, torch.device('cpu')):
                Xw = Xs if where.type == 'cpu' else Xs.to(where).float()
                r = nmf(Xw, k, W_in=W0, T_in=T0, max_iter=W_ROW_SWEEPS,
                        random_state=3, eps_stop=0.0,
                        compute_obj_each_iter=True, device=where,
                        **FAST_TM, **kw)
                finals[where.type] = r['obj_history'][-1]
                if label == 'HER':
                    with uncounted(dk):
                        restarts[where.type] = her_trace(
                            Xw, W0.to(where, Xw.dtype),
                            T0.to(where, Xw.dtype), cfg, W_ROW_SWEEPS)[2]
            diff = abs(finals[dev.type] - finals['cpu']) / abs(finals['cpu'])
            if not diff <= TOL_CPU_GPU_OBJ:
                raise AssertionError('%s card vs CPU objective: %r'
                                     % (label, finals))
            out[label] = dict(obj_card=finals[dev.type],
                              obj_cpu=finals['cpu'], rel_diff=diff)
            if restarts:
                out[label].update(restarts_card=restarts[dev.type],
                                  restarts_cpu=restarts['cpu'],
                                  same_restarts=restarts[dev.type]
                                  == restarts['cpu'])
        log('w_row and HER %dx%d k=%d card float32 vs cpu float64, %s'
            % (n, d, k, data), sweeps=W_ROW_SWEEPS, gate=TOL_CPU_GPU_OBJ,
            **out)


# --------------------------------------------------------------------------
# phases 24-26: init, the storage modes, 16-bit factors
# --------------------------------------------------------------------------

def reset_peak(dev):
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(dev)


def peak_gb(dev):
    """Peak device memory allocated since :func:`reset_peak`, in GB (None
    off the card)."""
    if dev.type != 'cuda':
        return None
    return torch.cuda.max_memory_allocated(dev) / 1e9


def rel_frob_blocked(X, W, T, rows=8192):
    """||X - WT|| / ||X|| in float64 sums over row blocks (no n×d
    temporary beyond a block)."""
    num = den = 0.0
    for i in range(0, X.shape[0], rows):
        Xb = X[i:i + rows].float()
        num += float(((Xb - W[i:i + rows].float() @ T.float()) ** 2).sum(
            dtype=torch.float64))
        den += float((Xb ** 2).sum(dtype=torch.float64))
    return (num / den) ** 0.5


def non_increasing_16(obj, what):
    """The JAX suite's 16-bit slack: each objective at most 1e-3·obj₀ +
    1e-6 above the one before it."""
    rel, ab = OBJ_SLACK_16
    slack = rel * abs(obj[0]) + ab
    for a, b in zip(obj, obj[1:]):
        if not b <= a + slack:
            raise AssertionError('%s: objective rose %r -> %r' % (what, a, b))


def run_init_phase(dev, dk, counts, ratings):
    """Phase 24: the card's float64 randomized SVD against the host copy
    of scikit-learn's, NNSVD-LRC through both backends and its host form beside
    NNDSVD, the masked SVD init's torch backend beside its numpy one, and
    the PMI beam search on the TM corpus; the seconds of each."""
    from rri_nmf_tpu_torch import initialization as ti
    n, d, k = INIT_SHAPE
    X = uniform_factor(n, d, k, dev, seed=11)
    t0 = time.perf_counter()
    U, S, Vt = ti.randomized_svd_f64(X, k, random_state=0)
    sync(dev)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = ti.randomized_svd_np(X.double().cpu().numpy(), k, random_state=0)
    host_s = time.perf_counter() - t0
    Uh, Sh, Vh = (torch.as_tensor(a, device=dev) for a in host)
    s_err = float(((S - Sh).abs() / Sh.abs()).max())
    r_err = rel_err((U * S) @ Vt, (Uh * Sh) @ Vh)
    del U, Vt, Uh, Vh, host
    if not (s_err <= TOL_SVD_S and r_err <= TOL_SVD_R):
        raise AssertionError('float64 card SVD vs the host copy: S %.3g, '
                             'U S Vt %.3g' % (s_err, r_err))
    log('init svd %dx%d k=%d U[0,1] factors, card float64 vs host copy'
        % (n, d, k), card_s=card_s, host_s=host_s, s_rel_err=s_err,
        usvt_rel_err=r_err, gates=[TOL_SVD_S, TOL_SVD_R],
        sigma_first_last=[float(S[0]), float(S[-1])])
    del X

    # NNSVD-LRC on the card beside NNDSVD: the default backend (the
    # float64 SVD and B1's float64 build in the correction: 2 launches a
    # pass, 2 passes) held against the host form on the same X (the numpy
    # SVD copy and correction on the CPU), and the torch backend (the
    # float32 range finder, B1 in float32)
    X = lowrank(n, d, k, dev, seed=12)
    # off the card the default backend is the host form itself, which
    # reads a float32 X in float32 (scikit-learn's rule): give it float64
    X64 = X if dev.type == 'cuda' else X.double()
    out, factors = {}, {}
    for label, init, Xi, kw in (('nndsvd', 'nndsvd', X, {}),
                                ('nndsvd_lrc', 'nndsvd_lrc', X64,
                                 dict(dtype=torch.float64)),
                                ('nndsvd_lrc torch backend', 'nndsvd_lrc',
                                 X, dict(svd_backend='torch'))):
        b0 = dk.LAUNCHES['gs']
        t0 = time.perf_counter()
        W, H = ti.initialize_nmf(Xi, k, init, random_state=0, **kw)
        sync(dev)
        out[label] = dict(seconds=time.perf_counter() - t0,
                          rel_frobenius_error=rel_frob_blocked(X, W, H),
                          b1_launches=dk.LAUNCHES['gs'] - b0)
        factors[label] = W, H
    Xh = X.double().cpu().numpy()
    t0 = time.perf_counter()
    Wh, Hh = ti.initialize_nmf(Xh, k, 'nndsvd_lrc', random_state=0,
                               device='cpu')
    del Xh
    W, H = factors['nndsvd_lrc']
    W, H = W.double().cpu(), H.double().cpu()
    out['nndsvd_lrc host form'] = dict(
        seconds=time.perf_counter() - t0,
        card_vs_host_rel_err=[rel_err(W, Wh), rel_err(H, Hh)],
        gate=TOL_LRC)
    e0, ec, ed = (out[key]['rel_frobenius_error'] for key in
                  ('nndsvd', 'nndsvd_lrc', 'nndsvd_lrc torch backend'))
    if not (ec < e0 and ed < e0 and abs(ec - ed) < 0.05 * ec + 1e-3
            and max(out['nndsvd_lrc host form']['card_vs_host_rel_err'])
            <= TOL_LRC
            and out['nndsvd_lrc']['b1_launches'] == (4 if dev.type == 'cuda'
                                                     else 0)
            and out['nndsvd_lrc torch backend']['b1_launches'] == 4):
        raise AssertionError('NNSVD-LRC: %r' % out)
    log('init nndsvd_lrc %dx%d k=%d float32' % (n, d, k), **out)
    del X, X64, W, H, Wh, Hh, factors

    # the recommender's masked SVD init at the MovieLens shape
    Xr = torch.as_tensor(ratings, dtype=torch.float32, device=dev)
    M = (Xr != 0).float()
    k_rs = RS_SHAPE[3]
    obs = M.sum()
    base = float((M * (Xr - (M * Xr).sum() / obs)) .pow(2).sum() / obs)
    out = {}
    for backend in ('torch', 'numpy'):
        t0 = time.perf_counter()
        W, H = ti.masked_svd_init(Xr, M, k_rs, random_state=0,
                                  backend=backend)
        sync(dev)
        W, H = W.to(dev, torch.float32), H.to(dev, torch.float32)
        out[backend] = dict(
            seconds=time.perf_counter() - t0,
            observed_mse=float((M * (Xr - W @ H)).pow(2).sum() / obs),
            nonnegative=bool((W >= 0).all() and (H >= 0).all()))
    mt, mn = out['torch']['observed_mse'], out['numpy']['observed_mse']
    if not (out['torch']['nonnegative'] and mt < base
            and mt <= 1.05 * mn + 1e-9):
        raise AssertionError('masked_svd_init: %r, mean baseline %r'
                             % (out, base))
    log('init masked_svd_init %dx%d k=%d float32' % (Xr.shape + (k_rs,)),
        mean_baseline_mse=base, **out)
    del Xr, M, W, H

    # the PMI beam search on the TM corpus: C = XᵀX is d×d in float64
    n_train, _, n_words, k_tm = TM_SHAPE
    C = torch.as_tensor(counts[:n_train], device=dev)
    sync(dev)
    reset_peak(dev)
    t0 = time.perf_counter()
    W, T = ti.initialize_nmf(C, k_tm, 'coherence_pmi')
    sync(dev)
    secs = time.perf_counter() - t0
    words = (T > 0).sum(1)
    row_err = float((T.double().sum(1) - 1).abs().max())
    if not (row_err <= 1e-5 and int(words.max()) <= 20
            and bool(torch.isfinite(W).all()) and bool((W >= 0).all())):
        raise AssertionError('coherence_pmi: row sums %.3g, words %r'
                             % (row_err, words.tolist()))
    log('init coherence_pmi %dx%d k=%d' % (n_train, n_words, k_tm),
        seconds=secs, T_row_sum_err=row_err,
        words_per_topic=[int(words.min()), int(words.max())],
        peak_gb=peak_gb(dev))


def run_storage_phase(dev, dk, nmf):
    """Phase 25: the storage modes at the north-star shape. One NNDSVD
    init of the int16 code through the device backend, then a few sweeps
    from it with X in float32, in bfloat16 (float32 factors) and as the
    int16 code: ms/sweep, peak device memory, B1/B2 launches, and each
    fit's relative error beside the float32 fit's. Only one form of X
    lives on the card during each fit."""
    from rri_nmf_tpu_torch.initialization import initialize_nmf
    from rri_nmf_tpu_torch.ops.quantized import quantize_x
    n, d, k = NORTH_STAR

    def data():
        return uniform_factor(n, d, k, dev, seed=12)

    qx = quantize_x(data())
    sync(dev)
    reset_peak(dev)
    t0 = time.perf_counter()
    W0, T0 = initialize_nmf(qx, k, 'nndsvd', random_state=0,
                            svd_backend='torch')
    sync(dev)
    init = dict(seconds=time.perf_counter() - t0, peak_gb=peak_gb(dev),
                dead_topics=int(((W0.sum(0) == 0) | (T0.sum(1) == 0)).sum()))
    del qx
    fits = {}

    def fit(label, Xin, **kw):
        sync(dev)
        reset_peak(dev)
        b0 = dict(dk.LAUNCHES)
        t0 = time.perf_counter()
        res = nmf(Xin, k, W_in=W0, T_in=T0, max_iter=STORAGE_SWEEPS,
                  random_state=0, eps_stop=0.0, **FAST_TM, **kw)
        sync(dev)
        wall = time.perf_counter() - t0
        got = {key: dk.LAUNCHES[key] - b0[key] for key in ('gs', 'tm_proj')}
        if got != {'gs': 2 * STORAGE_SWEEPS, 'tm_proj': 0}:
            raise AssertionError('%s: launches %r' % (label, got))
        W, T = res['W'], res['T']
        if not (W.dtype == T.dtype == torch.float32
                and bool(torch.isfinite(W).all())
                and bool(torch.isfinite(T).all())):
            raise AssertionError('%s: factors %s' % (label, W.dtype))
        fits[label] = (W, T, dict(
            ms_per_sweep=float(np.median(np.diff(res['iter_cputime']))) * 1e3,
            peak_gb=peak_gb(dev), wall_s=wall,
            b1_launches=got['gs'], b2_launches=got['tm_proj']))

    X = data()
    fit('float32 X', X)
    Xb = X.to(torch.bfloat16)
    del X
    fit("x_dtype='bfloat16'", Xb, dtype=torch.float32, x_dtype='bfloat16')
    del Xb
    X = data()
    qx = quantize_x(X)
    del X
    fit("x_dtype='int16' (QuantizedX)", qx)
    del qx
    X = data()
    e_init = rel_frob_blocked(X, W0, T0)
    for label, (W, T, line) in fits.items():
        line['rel_frobenius_error'] = rel_frob_blocked(X, W, T)
    del X
    e32 = fits['float32 X'][2]['rel_frobenius_error']
    for label, (_, _, line) in fits.items():
        line['error_over_float32'] = line['rel_frobenius_error'] / e32
        if not line['rel_frobenius_error'] < e_init:
            raise AssertionError('%s did not descend: %r' % (label, line))
    p32 = fits['float32 X'][2]['peak_gb']
    p16 = fits["x_dtype='int16' (QuantizedX)"][2]['peak_gb']
    if dev.type == 'cuda' and not p16 <= p32 - STORAGE_PEAK_GAP / 1e9:
        raise AssertionError('int16 peak %.2f GB vs float32 %.2f GB'
                             % (p16, p32))
    log('storage %dx%d k=%d, %d sweeps from one init' % (n, d, k,
                                                         STORAGE_SWEEPS),
        init_nndsvd_on_the_code=dict(init, rel_frobenius_error=e_init),
        # an int16 product reads the code, writes and reads its float32
        # blocks; a float32 X is read once
        upcast_extra_bytes_per_product=n * d * (2 + 4),
        float32_x_bytes_per_product=4 * n * d,
        **{label: line for label, (_, _, line) in fits.items()})


def err_16(got, want, got32, want32, dtype):
    """A 16-bit output against its twin: ``(gate, ulps, share, err,
    rounded)``. ``got32``/``want32`` are the float32 build's and the float32
    twin's outputs on the same inputs upcast: the 16-bit forms work in
    float32 as those do, so each 16-bit entry may differ by their own
    difference at that entry (sums in other orders, cancellation) plus one
    ulp of the storage type from the final rounding; ``gate`` is the
    largest |got - want| over that entry's allowance (at most 1 passes).
    ``ulps`` is the largest difference in ulps alone, ``share`` the share
    of entries within one ulp, ``err`` the largest absolute difference,
    ``rounded`` the share of entries equal to the float32 build's output
    rounded to 16 bits."""
    g, w = got.double(), want.double()
    mant, tiny = (7, 2.0 ** -126) if dtype == torch.bfloat16 \
        else (10, 2.0 ** -14)
    ulp = torch.pow(2.0, torch.floor(torch.log2(
        torch.maximum(g.abs(), w.abs()).clamp_min(tiny))) - mant)
    diff = (g - w).abs()
    diff32 = (got32.double() - want32.double()).abs()
    gate = float((diff / (ulp + diff32)).max())
    return (gate, float((diff / ulp).max()),
            float((diff <= ulp).double().mean()), float(diff.max()),
            float((got == got32.to(dtype)).double().mean()))


def in_turns(fn16, fn32, dev):
    """CUDA-event ms of the 16-bit and the float32 builds in turns
    (16, 32, 32, 16): the mean of each build's two medians."""
    a, b = time_ms(fn16, dev), time_ms(fn32, dev)
    c, e = time_ms(fn32, dev), time_ms(fn16, dev)
    return (a + e) / 2, (b + c) / 2


def check_16_bit_kernels(dev, counts, ratings):
    """Phase 26, the kernels: each 16-bit build (bfloat16, float16 F,
    R, M or values; float32 work and sums) against its twin at the main
    path's shapes, each launch repeated and matched bit for bit, timed in
    turns beside its float32 build. Returns {(kernel, dtype): (max abs
    error, ms, plain_ms, bound_ms, bound_by, library_ms)}."""
    from rri_nmf_tpu_torch.ops import dense_kernels as dk
    from rri_nmf_tpu_torch.ops import masked_kernels as mk
    from rri_nmf_tpu_torch.ops import sparse_kernels as sk
    from rri_nmf_tpu_torch.ops import sparse_plan as spl
    rng = np.random.RandomState(21)
    f32 = torch.float32
    inf = float('inf')
    out = {}

    def same(label, got, again):
        if not all(torch.equal(g, h) for g, h in zip(got, again)):
            raise AssertionError('%s: two launches on the same input differ'
                                 % label)

    def narrow_ok(label, dt, got, want, got32, want32):
        """The gate of :func:`err_16`: (its log fields, the largest
        absolute difference)."""
        gate, ulps, share, err, rounded = err_16(got, want, got32, want32,
                                                 dt)
        if not (gate <= 1.0 and bool(torch.isfinite(got).all())):
            raise AssertionError('%s %s: %.6g of one ulp plus the float32 '
                                 'builds\' difference (%.6g ulps)'
                                 % (label, dt, gate, ulps))
        return dict(gate=gate, ulps=ulps, within_one_ulp=share,
                    equal_to_rounded_float32_build=rounded), err

    # B1 at the fit's T-phase (k=128, m=8192)
    k, m = NMF_SHAPE[2], NMF_SHAPE[1]
    A = torch.as_tensor(rng.rand(k, 256), dtype=f32, device=dev)
    G = A @ A.T
    N = G @ torch.as_tensor(rng.rand(k, m), dtype=f32, device=dev)
    F = torch.as_tensor(rng.rand(k, m), dtype=f32, device=dev)
    for dt in NARROW:
        F16, worst = F.to(dt), 0.0
        for kw in (dict(l1=0.0, l2=0.0, bound=inf),
                   dict(l1=-0.05, l2=0.1, bound=1.0, reps=3)):
            got, again = (dk.gs_update(G, N, F16, **kw) for _ in range(2))
            want = dk.gs_update_ref(G, N, F16, **kw)
            got32 = dk.gs_update(G, N, F16.float(), **kw)
            want32 = dk.gs_update_ref(G, N, F16.float(), **kw)
            sync(dev)
            same('B1', [got], [again])
            fields, err = narrow_ok('B1 %r' % kw, dt, got, want, got32,
                                    want32)
            worst = max(worst, err)
            log('kernel gs 16-bit', dtype=str(dt), case=str(kw),
                max_abs_err=err, bitwise_repeat=True, **fields)
        ms, ms32 = in_turns(lambda: dk.gs_update(G, N, F16, 0.0, 0.0, inf),
                            lambda: dk.gs_update(G, N, F, 0.0, 0.0, inf), dev)
        plain = time_ms(lambda: dk.gs_update_ref(G, N, F16, 0.0, 0.0, inf),
                        dev)
        b = bound(2 * k * k * m, (k * k + k * m) * 4 + 2 * k * m * 2,
                  str(dt)[6:])
        out[('gs', dt)] = (worst, ms, plain, b[0], b[1], None)
        log('kernel gs 16-bit k=%d m=%d' % (k, m), dtype=str(dt), ms=ms,
            float32_ms=ms32, plain_ms=plain, bound_ms=b[0], bound_by=b[1])

    # B2 at the TM fit's T-phase (k=50, d=26,214)
    label, G, N, F, kw = tm_cases(TM_PROJ_SHAPES[:1], dev)[0]
    G, N, F = G.float(), N.float(), F.float()
    k, d = F.shape
    for dt in NARROW:
        F16 = F.to(dt)
        got, again = (dk.tm_proj_update(G, N, F16, **kw) for _ in range(2))
        want = dk.tm_proj_update_ref(G, N, F16, **kw)
        got32 = dk.tm_proj_update(G, N, F16.float(), **kw)
        want32 = dk.tm_proj_update_ref(G, N, F16.float(), **kw)
        sync(dev)
        same('B2', [got], [again])
        fields, err = narrow_ok('B2', dt, got, want, got32, want32)
        row = float((got.double().sum(1) - 1).abs().max())
        ms, ms32 = in_turns(lambda: dk.tm_proj_update(G, N, F16, **kw),
                            lambda: dk.tm_proj_update(G, N, F, **kw), dev)
        plain = time_ms(lambda: dk.tm_proj_update_ref(G, N, F16, **kw), dev)
        b = bound(2 * k * k * d, (k * k + k * d) * 4 + 2 * k * d * 2,
                  str(dt)[6:])
        out[('tm_proj', dt)] = (err, ms, plain, b[0], b[1], None)
        log('kernel tm_proj 16-bit ' + label, dtype=str(dt), max_abs_err=err,
            row_sum_err=row, bitwise_repeat=True, ms=ms, float32_ms=ms32,
            plain_ms=plain, bound_ms=b[0], bound_by=b[1], **fields)

    # B3/B4 at the MovieLens shape (6040×3952, d % 8 == 0: the 16-byte
    # forms; timed) and the ragged shape (517×1030: the scalar forms), B4
    # also with fixed T (w_eff = 0)
    X = torch.as_tensor(ratings, device=dev)
    cases = masked_cases(dev, X, (X != 0).double())[:6]
    del X
    for label, kind, R, M, args in cases:
        kernel, twin = getattr(mk, kind), getattr(mk, kind + '_ref')
        n, d = R.shape
        form = '16-byte' if d % 8 == 0 else 'scalar'
        for dt in NARROW:
            R16, M16 = R.to(dt).contiguous(), M.to(dt).contiguous()
            a16 = [x.to(dt).contiguous() for x in args]
            Rk, Rr, Rt = R16.clone(), R16.clone(), R16.clone()
            got, again = kernel(Rk, M16, *a16), kernel(Rr, M16, *a16)
            want = twin(Rt, M16, *a16)
            Rk32, Rt32 = R16.float(), R16.float()
            kernel(Rk32, M16.float(), *(x.float() for x in a16))
            twin(Rt32, M16.float(), *(x.float() for x in a16))
            sync(dev)
            same(label, [Rk, *got], [Rr, *again])
            fields, err = narrow_ok(label + ' R', dt, Rk, Rt, Rk32, Rt32)
            sums = [rel_err(g, h) for g, h in zip(got, want)]
            if not max(sums) <= TOL_F32:
                raise AssertionError('%s %s: sums %r' % (label, dt, sums))
            err = max(err, *(float((g - h).abs().max())
                             for g, h in zip(got, want)))
            if not label.startswith(('B3 rs', 'B4 rs')):
                log('kernel masked 16-bit ' + label, dtype=str(dt),
                    form=form, R=fields, rel_err_sums=sums,
                    bitwise_repeat=True, max_abs_err=err)
                del Rk, Rr, Rt, Rk32, Rt32
                continue
            pre = tuple(torch.empty_like(g) for g in got)
            R32, M32 = R.float().contiguous(), M.float().contiguous()
            a32 = [x.float().contiguous() for x in args]
            pre32 = tuple(torch.empty_like(g) for g in pre)
            ms, ms32 = in_turns(lambda: kernel(Rk, M16, *a16, out=pre),
                                lambda: kernel(R32, M32, *a32, out=pre32),
                                dev)
            plain = time_ms(lambda: twin(Rt, M16, *a16), dev)
            vectors = (3 * n + 3 * d) if kind == 'phase_a' else (5 * n + 2 * d)
            sum_bytes = 2 * (d if kind == 'phase_a' else n) * 4
            b = bound((7 if kind == 'phase_a' else 9) * n * d,
                      3 * n * d * 2 + vectors * 2 + sum_bytes, str(dt)[6:])
            out[(kind, dt)] = (err, ms, plain, b[0], b[1], None)
            log('kernel masked 16-bit ' + label, dtype=str(dt), form=form,
                R=fields, rel_err_sums=sums, bitwise_repeat=True,
                max_abs_err=err, ms=ms, float32_ms=ms32, plain_ms=plain,
                bound_ms=b[0], bound_by=b[1])
            del Rk, Rr, Rt, R32, M32, Rk32, Rt32

    # the gather kernel (B5, B6) at the recorded sparse shape, both
    # directions, each beside torch.sparse.mm in its dtype; the kernels
    # line takes WᵀX's time
    n, d, dens, k = SPARSE_SHAPE
    X = sparse_csr(n, d, dens, dev, seed=0)
    nnz = X.values().numel()
    W = torch.as_tensor(rng.rand(n, k), dtype=f32, device=dev)
    T = torch.as_tensor(rng.rand(k, d), dtype=f32, device=dev)
    plan32 = spl.plan_sparse_matrix(X, f32, device=dev)
    for dt in NARROW:
        plan = spl.plan_sparse_matrix(X, dt, device=dev)
        W16, T16, X16 = W.to(dt), T.to(dt), X.to(dt)
        Xt16, Tt16 = X16.t().to_sparse_csr(), T16.T.contiguous()
        worst = 0.0
        for dirn, m, ncols, call, call32, lib_call in (
                ('WtX', n, d, lambda: sk.contract_wtx(plan, W16),
                 lambda: sk.contract_wtx(plan32, W),
                 lambda: torch.sparse.mm(Xt16, W16)),
                ('TXt', d, n, lambda: sk.contract_xtt(plan, T16),
                 lambda: sk.contract_xtt(plan32, T),
                 lambda: torch.sparse.mm(X16, Tt16))):
            lay = plan.t_phase if dirn == 'WtX' else plan.w_phase
            Ft = W16 if dirn == 'WtX' else T16.T
            got, again = call(), call()
            want = sk.gather_contract_ref(lay, Ft, k, ncols)
            sync(dev)
            same('gather %s' % dirn, [got], [again])
            err = rel_err(got, want)
            if not (got.dtype == f32 and err <= TOL_F32):
                raise AssertionError('gather %s %s: %.3g' % (dirn, dt, err))
            worst = max(worst, float((got - want).abs().max()))
            ms, ms32 = in_turns(call, call32, dev)
            plain = time_ms(lambda: sk.gather_contract_ref(
                lay, Ft, k, ncols), dev, runs=3)
            lib = None
            try:
                lib = time_ms(lib_call, dev)
            except (RuntimeError, NotImplementedError, TypeError):
                pass
            b = bound(2 * nnz * k, m * k * 2 + nnz * (2 + 4)
                      + (ncols + 1) * 4 + k * ncols * 4, str(dt)[6:])
            if dirn == 'WtX':
                stats = (ms, plain, b[0], b[1], lib)
            log('kernel gather 16-bit %s %dx%d %g k=%d'
                % (dirn, n, d, dens, k), dtype=str(dt),
                rel_err=err, bitwise_repeat=True, ms=ms,
                float32_ms=ms32, plain_ms=plain, library_ms=lib,
                bound_ms=b[0], bound_by=b[1],
                l2_gather_TB_per_s=nnz * k * 2 / ms / 1e9)
        out[('gather', dt)] = (worst,) + stats
        check_gather_16(dev, sk, spl, plan, X, dt, counts)
        check_gather_mirror_16(dev, sk, spl, dt)
        del plan, X16, Xt16, Tt16
    del plan32
    return out


def check_gather_16(dev, sk, spl, plan, X, dt, counts):
    """Phase 26, the 16-bit gather kernel beside the timed shape: k = 24
    and 50 (rows padded to 16 bytes, part of one slice), 200 (a second
    slice) on the same layout, and the TM corpus at k=50 (its Zipf word
    columns cut between warps), both directions, within ``TOL_F32`` of
    the twin and repeated bit for bit."""
    n_train, _, _, k_tm = TM_SHAPE
    Xtm = torch.as_tensor(counts[:n_train], device=dev).to_sparse_csr()
    rng = np.random.RandomState(22)
    cases = [('%dx%d k=%d' % (*X.shape, kk), plan, kk) for kk in GATHER_KS_16]
    cases.append(('TM corpus %dx%d k=%d' % (*Xtm.shape, k_tm),
                  spl.plan_sparse_matrix(Xtm, dt, device=dev), k_tm))
    for label, pl, k in cases:
        errs = {}
        for dirn, direction, m, ncols in (('WtX', pl.t_phase, pl.n, pl.d),
                                          ('TXt', pl.w_phase, pl.d, pl.n)):
            Ft = torch.as_tensor(rng.rand(m, k), dtype=torch.float32,
                                 device=dev).to(dt)
            got, again = (sk.gather_contract(direction, Ft, k, ncols)
                          for _ in range(2))
            want = sk.gather_contract_ref(direction, Ft, k, ncols)
            sync(dev)
            errs[dirn] = rel_err(got, want)
            if not (torch.equal(got, again) and errs[dirn] <= TOL_F32):
                raise AssertionError('gather 16-bit %s %s %s: %.3g, '
                                     'repeat %s' % (label, dirn, dt,
                                                    errs[dirn],
                                                    torch.equal(got, again)))
        log('kernel gather 16-bit ' + label, dtype=str(dt), rel_err=errs,
            bitwise_repeat=True)


def check_gather_mirror_16(dev, sk, spl, dt):
    """Phase 26, the 16-bit gather kernel's order of summation: through
    ``contract_wtx``/``contract_xtt`` on the :data:`MIRROR_RANDOM` and
    :data:`MIRROR_ZIPF` matrices at each k of :data:`MIRROR_KS_16`, both
    directions, bit for bit the float32 NumPy mirror of its decomposition
    on the layout the kernel read (its products of 16-bit values are exact
    in float32), and within ``TOL_F32`` of the twin. The Zipf case must
    hold columns cut between warps."""
    from rri_nmf_tpu_torch.ops import sparse_mirror as sm
    c = sm.kernel_constants()
    n_z, d_z, t_z, len_z = MIRROR_ZIPF
    mats = {'random %dx%d %g' % MIRROR_RANDOM: sparse_csr(
                *MIRROR_RANDOM, dev, seed=4),
            'zipf %dx%d' % (n_z, d_z): torch.as_tensor(zipf_corpus(
                n_z, d_z, t_z, seed=3, doc_len=len_z),
                device=dev).to_sparse_csr()}
    rng = np.random.RandomState(23)
    for label, X in mats.items():
        plan = spl.plan_sparse_matrix(X, dt, device=dev)
        cut = sm.cut_columns(plan.t_phase, c['SG_NC'], c['SG_WARPS'])
        if label.startswith('zipf') and not cut:
            raise AssertionError('gather mirror %s: no column cut between '
                                 'warps' % label)
        errs = {}
        for k in MIRROR_KS_16:
            W = torch.as_tensor(rng.rand(plan.n, k), dtype=torch.float32,
                                device=dev).to(dt)
            T = torch.as_tensor(rng.rand(k, plan.d), dtype=torch.float32,
                                device=dev).to(dt)
            for dirn, call, direction, Ft, ncols in (
                    ('WtX', lambda: sk.contract_wtx(plan, W), plan.t_phase,
                     W, plan.d),
                    ('TXt', lambda: sk.contract_xtt(plan, T), plan.w_phase,
                     T.T, plan.n)):
                got, again = call(), call()
                lay = direction
                want = sk.gather_contract_ref(lay, Ft, k, ncols)
                mirror = sm.kernel_mirror(
                    lay, Ft, k, ncols, c['SG_NC'], c['SG_WARPS'],
                    sm.slice_groups(k, Ft.element_size()), np.float32)
                sync(dev)
                err = rel_err(got, want)
                equal = bool(np.array_equal(got.cpu().numpy(), mirror))
                if not (equal and torch.equal(got, again)
                        and err <= TOL_F32):
                    raise AssertionError(
                        'gather mirror %s k=%d %s %s: bit for bit %s, '
                        'repeat %s, %.3g of the twin' % (
                            label, k, dirn, dt, equal,
                            torch.equal(got, again), err))
                errs['k=%d %s' % (k, dirn)] = err
        log('kernel gather 16-bit mirror ' + label, dtype=str(dt),
            nnz=int(X.values().numel()), columns_cut_between_warps=cut,
            bitwise_mirror=True, bitwise_repeat=True, rel_err=errs)


def run_16_bit_fits(dev, dk, mk, sk, nmf, Est, counts, ratings, dt):
    """Phase 26, the fits in ``dt``: ``nmf()`` in the phase recipe at
    16384×8192 k=128 (B1 twice a sweep), the TM estimator at the 20
    Newsgroups shape (B2 and B1 once a sweep), the masked fit with
    ``use_pallas=True`` at the MovieLens shape (B3 and B4 k times a sweep)
    and the sparse fits with ``'mxu'`` and ``'dma'`` (the gather kernel
    twice a sweep); every objective history non-increasing within the
    JAX suite's 16-bit slack."""
    from rri_nmf_tpu_torch.matrixops import normalize, tfidf
    name = str(dt).split('.')[1]
    line = {}
    n, d, k = NMF_SHAPE
    X = lowrank(n, d, k, dev, seed=0)
    b0 = dk.LAUNCHES['gs']
    res = nmf(X, k, dtype=dt, max_iter=SWEEPS_16, compute_obj_each_iter=True,
              random_state=0, eps_stop=0.0, **FAST_TM)
    sync(dev)
    obj = res['obj_history']
    if dk.LAUNCHES['gs'] - b0 != 2 * SWEEPS_16 or res['W'].dtype != dt:
        raise AssertionError('nmf %s: %d B1 launches, %s factors' % (
            name, dk.LAUNCHES['gs'] - b0, res['W'].dtype))
    non_increasing_16(obj, 'nmf ' + name)
    line['nmf %dx%d k=%d' % (n, d, k)] = dict(
        obj_first=obj[0], obj_last=obj[-1],
        rel_frobenius_error=rel_frob_blocked(X, res['W'], res['T']),
        ms_per_sweep_with_objective=float(np.median(np.diff(
            res['iter_cputime']))) * 1e3)
    del X, res

    n_train, _, _, k_tm = TM_SHAPE
    Xtr = normalize(tfidf(torch.as_tensor(counts[:n_train], device=dev)))
    b0 = dict(dk.LAUNCHES)
    est = _tm_fit(Est, Xtr, k_tm, SWEEPS_16, dtype=dt,
                  compute_obj_each_iter=True)
    sync(dev)
    got = [dk.LAUNCHES[key] - b0[key] for key in ('tm_proj', 'gs')]
    obj = est.nmf_outputs['obj_history']
    row = float((est.T.double().sum(1) - 1).abs().max())
    if got != [SWEEPS_16, SWEEPS_16] or est.T.dtype != dt or row > 1e-2:
        raise AssertionError('TM %s: B2/B1 %r, %s, row sums %.3g'
                             % (name, got, est.T.dtype, row))
    non_increasing_16(obj, 'TM ' + name)
    line['NMF_TM_Estimator %dx%d k=%d' % (Xtr.shape + (k_tm,))] = dict(
        obj_first=obj[0], obj_last=obj[-1], T_row_sum_err=row,
        ms_per_sweep_with_objective=float(np.median(np.diff(
            est.nmf_outputs['iter_cputime']))) * 1e3)
    del Xtr, est

    # the masked fit, B3 and B4 k times a sweep: the JAX suite's 16-bit
    # masked problem (tests/test_bfloat16.py: low-rank data under a 60%
    # mask) at the MovieLens shape, scaled to [0, 1]. 16-bit masked fits
    # are erratic in the JAX package too (on the synthetic ratings its
    # bfloat16 fits rise 2-5x before settling), and float16's range ends
    # at 65504: once a W entry passes 256 its square overflows in B3 and
    # the fit turns NaN, in the JAX package as here (unscaled, within 2-3
    # sweeps). So they run MASKED_SWEEPS_16 sweeps and are held, as the JAX
    # suite holds them, to finite objectives that end below where they
    # began (test_bf16_masked_runs)
    n, d, _, k_rs = RS_SHAPE
    X = lowrank(n, d, k_rs, dev, seed=13)
    X /= X.max()
    M = torch.as_tensor((np.random.RandomState(14).rand(n, d) < 0.6)
                        .astype(np.float32), device=dev)
    b0 = dict(mk.LAUNCHES)
    res = nmf(X, k_rs, W_mat=M, dtype=dt, use_pallas=True,
              max_iter=MASKED_SWEEPS_16, compute_obj_each_iter=True,
              random_state=0, eps_stop=0.0, reset_topic_method=None)
    sync(dev)
    got = [mk.LAUNCHES[key] - b0[key] for key in ('phase_a', 'phase_b')]
    obj = res['obj_history']
    if got != [k_rs * MASKED_SWEEPS_16] * 2 or res['W'].dtype != dt or not (
            np.all(np.isfinite(obj)) and obj[-1] < obj[0]):
        raise AssertionError('masked %s: B3/B4 %r, objectives %r'
                             % (name, got, obj))
    rel, ab = OBJ_SLACK_16
    line['masked %dx%d 60%% k=%d, use_pallas=True' % (n, d, k_rs)] = dict(
        obj_history=obj, non_increasing_within_slack=bool(np.all(
            np.diff(obj) <= rel * abs(obj[0]) + ab)),
        ms_per_sweep_with_objective=float(np.median(np.diff(
            res['iter_cputime']))) * 1e3)
    del X, M, res

    n, d, dens, k = SPARSE_SHAPE
    Xs = sparse_csr(n, d, dens, dev, seed=0)
    for mode in ('mxu', 'dma'):
        b0 = sk.LAUNCHES['gather']
        res = nmf(Xs, k, sparse=mode, dtype=dt, max_iter=SPARSE_SWEEPS_16,
                  compute_obj_each_iter=True, random_state=0, eps_stop=0.0,
                  **FAST_TM)
        sync(dev)
        obj = res['obj_history']
        # the same fit continued, no objective a sweep
        res2 = nmf(Xs, k, sparse=mode, dtype=dt, W_in=res['W'],
                   T_in=res['T'], max_iter=SPARSE_PLAIN_SWEEPS_16,
                   random_state=0, eps_stop=0.0, **FAST_TM)
        sync(dev)
        got = sk.LAUNCHES['gather'] - b0
        if got != 2 * (SPARSE_SWEEPS_16 + SPARSE_PLAIN_SWEEPS_16) or not (
                bool(torch.isfinite(res2['W']).all())
                and res2['W'].dtype == dt):
            raise AssertionError('sparse %s %s: %d launches, %s factors'
                                 % (mode, name, got, res2['W'].dtype))
        non_increasing_16(obj, 'sparse %s %s' % (mode, name))
        line["sparse='%s' %dx%d %g k=%d" % (mode, n, d, dens, k)] = dict(
            obj_first=obj[0], obj_last=obj[-1],
            ms_per_sweep_with_objective=float(np.median(np.diff(
                res['iter_cputime']))) * 1e3,
            ms_per_sweep=_sweep_ms(res2))
        del res, res2
    del Xs
    log('16-bit fits %s' % name, sweeps=SWEEPS_16,
        masked_sweeps=MASKED_SWEEPS_16, sparse_sweeps=SPARSE_SWEEPS_16,
        sparse_plain_sweeps=SPARSE_PLAIN_SWEEPS_16, slack=OBJ_SLACK_16,
        **line)


def run(dev):
    """Phases 3-31 on ``dev``; returns the kernels' JSON entries."""
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
    if sparse['gather'] == 0 or dk.LAUNCHES['gs'] == 0:
        raise AssertionError('a kernel of the path never ran: %r %r'
                             % (sparse, dk.LAUNCHES))

    # 12-16. the defaults through the plain sweep, counted from zero: B1
    # runs in phase 14's kernel sweeps and the default-preset transform
    dk.reset_launches()
    run_interleaved_phase(dev, dk, nmf)
    sync(dev)
    spmv_stats = run_tm_default_phase(dev, dk, NMF_TM_Estimator, counts)
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
    plans, gram_lines = check_masked_gram(dev, sk, mg, [
        ('MovieLens %dx%d' % Rs.shape, Rs, Ms, dtype, tol, False,
         [(k_rs, GRAM_GATE_PANEL, None)])
        for dtype, tol in ((torch.float64, TOL_F64),
                           (torch.float32, TOL_F32))] + [
        (record, Xr, Mr, torch.float32, TOL_F32, True,
         [(k, 2 * GRAM_GATE_PANEL, None),
          (MASKED_PANEL_K, mg.auto_panel(MASKED_PANEL_K, n, d, 4),
           ['Gamma panel (p·k rows)', 'Theta panel (p·k rows)'])])])
    # the Gram kernel's entry: Γ at k=32, the main path's full form
    gram_stats = gram_lines[record, 'Gamma (k(k+1)/2 rows)', k]
    del Rs, Ms
    sync(dev)
    # the Gram kernel's chunked columns on a skewed mask; none on the
    # recorded (uniform) one
    check_gram_split(dev, sk, mg, plans[record][0])
    sync(dev)

    # 18-19. the sparse-mask paths, counted from zero: the gather kernel
    # (A, C) and the Gram kernel (Γ, Θ)
    sk.reset_launches()
    masks = run_masked_record_phase(dev, sk, nmf, mg, msp, Xr, Mr,
                                    *plans[record])
    del plans
    sync(dev)
    more = run_sparse_obs_phase(dev, mk, sk, NMF_RS_Estimator, ratings,
                                rmse_dense)
    sync(dev)
    masks = {key: masks[key] + more[key] for key in masks}
    if masks['gather'] == 0 or masks['gram'] == 0:
        raise AssertionError('a kernel of the sparse-mask paths never ran: '
                             '%r' % masks)
    sparse['gather'] += masks['gather']
    sparse['gram'] = masks['gram']

    # 20-23. HER, checkpoint/resume and row weights, counted from zero:
    # B1 and B2 under HER and in the w_row fit and refit, B3 and B4 under
    # the RS estimator's HER
    dk.reset_launches()
    mk.reset_launches()
    run_her_phase(dev, dk, nmf, frobenius_relative_error, NMF_TM_Estimator,
                  counts)
    sync(dev)
    run_rs_her_phase(dev, mk, NMF_RS_Estimator, ratings)
    sync(dev)
    run_checkpoint_phase(dev, nmf)
    sync(dev)
    run_w_row_phase(dev, dk, nmf)
    sync(dev)
    later = dict(dk.LAUNCHES, **mk.LAUNCHES)
    if any(later[key] == 0 for key in ('gs', 'tm_proj', 'phase_a',
                                        'phase_b')):
        raise AssertionError('a kernel of phases 20-23 never ran: %r'
                             % later)
    log('launches, phases 20-23', **later)
    for key in ('gs', 'tm_proj'):
        launches[key] += later[key]
    for key in ('phase_a', 'phase_b'):
        masked[key] += later[key]

    # 24-25. init and the storage modes, counted from zero: B1 in both
    # NNSVD-LRC corrections and in the three storage fits
    dk.reset_launches()
    run_init_phase(dev, dk, counts, ratings)
    sync(dev)
    run_storage_phase(dev, dk, nmf)
    sync(dev)
    if dk.LAUNCHES['gs'] == 0:
        raise AssertionError('B1 never ran in phases 24-25: %r' % dk.LAUNCHES)
    log('launches, phases 24-25', **dk.LAUNCHES)
    for key in ('gs', 'tm_proj'):
        launches[key] += dk.LAUNCHES[key]

    # 26. the 16-bit builds against their twins, then the 16-bit fits of
    # each dtype, counted from zero
    stats16 = check_16_bit_kernels(dev, counts, ratings)
    sync(dev)
    counts16 = {}
    for dt in NARROW:
        dk.reset_launches()
        mk.reset_launches()
        sk.reset_launches()
        run_16_bit_fits(dev, dk, mk, sk, nmf, NMF_TM_Estimator, counts,
                        ratings, dt)
        sync(dev)
        counts16[dt] = dict(dk.LAUNCHES, **mk.LAUNCHES, **sk.LAUNCHES)
        if counts16[dt].pop('gram') or counts16[dt].pop('gram_split'):
            raise AssertionError('a 16-bit fit ran the Gram kernel')
        if any(v == 0 for v in counts16[dt].values()):
            raise AssertionError('a 16-bit kernel never ran: %r'
                                 % counts16[dt])
        log('launches, phase 26 %s' % dt, **counts16[dt])

    # 27-29. the meshes, counted from zero: B1 in the one-rank world's
    # fit (this process), B1 and B2 in the ranks' fits (each rank's
    # counts); B3/B4 in the masked mesh fits and the gather kernel in the
    # sparse ones, in this process and in the ranks
    dk.reset_launches()
    mk.reset_launches()
    sk.reset_launches()
    with one_rank_world(dev) as mesh:
        mesh_gs = run_mesh_one_rank_phase(dev, dk, nmf, mesh)
        sync(dev)
        ranks = run_mesh_ranks_phase(dev, dk, nmf, counts)
        if mesh_gs == 0 or ranks['gs'] == 0 or ranks['tm_proj'] == 0:
            raise AssertionError('a kernel of the mesh phase never ran: %d '
                                 '%r' % (mesh_gs, ranks))
        launches['gs'] += mesh_gs + ranks['gs']
        launches['tm_proj'] += ranks['tm_proj']

        one = run_masked_mesh_one_rank_phase(dev, mk, nmf, mesh, ratings)
        sync(dev)
        del ratings
        fixed = run_fixed_t_max_resid_phase(dev, mk, nmf)
        sync(dev)
        ranks = run_masked_mesh_ranks_phase(dev, nmf)
        for key in ('phase_a', 'phase_b'):
            if one[key] == 0 or ranks[key] == 0:
                raise AssertionError('a kernel of the masked mesh phase '
                                     'never ran: %r %r' % (one, ranks))
            masked[key] += one[key] + fixed[key] + ranks[key]

        one = run_sparse_mesh_one_rank_phase(dev, sk, nmf, mesh)
        sync(dev)
        ranks = run_sparse_mesh_ranks_phase(dev, nmf)
        if one == 0 or any(ranks[key] == 0 for key in ranks):
            raise AssertionError('a kernel of the sparse mesh phase never '
                                 'ran: %d %r' % (one, ranks))
        sparse['gather'] += one + ranks['gather']
        launches['gs'] += ranks['gs']
        launches['tm_proj'] += ranks['tm_proj']

        # 30. the sparse-mask meshes, counted from zero: the gather kernel
        # in the one-rank world's Gram fits (this process; the sweeps
        # timed beside them launch it too) and in the ranks' (each rank's
        # counts)
        sk.reset_launches()
        one, refs = run_sparse_mask_mesh_one_rank_phase(dev, sk, nmf, mesh,
                                                        Xr, Mr)
        sync(dev)
        log('launches, phase 30 (a)', gather=sk.LAUNCHES['gather'],
            gram=sk.LAUNCHES['gram'], fits=one)
        ranks = run_sparse_mask_mesh_ranks_phase(dev, nmf)
        if any(one[key] == 0 or ranks[key] == 0
               for key in ('gather', 'gram')):
            raise AssertionError('a kernel of the sparse-mask meshes never '
                                 'ran: %r %r' % (one, ranks))
        for key in ('gather', 'gram'):
            sparse[key] += one[key] + ranks[key]

        # 31. the multi-host layer, counted from zero: B1 and the gather
        # kernel in the one-rank world's slab fits (this process) and in
        # the ranks' (each rank's counts)
        dk.reset_launches()
        sk.reset_launches()
        t31 = time.perf_counter()
        one = run_multihost_one_rank_phase(dev, dk, sk, nmf, Xr, Mr, refs)
        sync(dev)
        del Xr, Mr, refs
        ranks = run_multihost_ranks_phase(dev, nmf)
        if any(one[key] == 0 or ranks[key] == 0
               for key in ('gs', 'gather', 'gram')) or ranks['tm_proj'] == 0:
            raise AssertionError('a kernel of the multi-host phase never '
                                 'ran: %r %r' % (one, ranks))
        log('launches, phase 31', gs=one['gs'] + ranks['gs'],
            tm_proj=ranks['tm_proj'], gather=one['gather'] + ranks['gather'],
            gram=one['gram'] + ranks['gram'], one_rank=one, ranks=ranks,
            seconds=time.perf_counter() - t31)
        launches['gs'] += one['gs'] + ranks['gs']
        launches['tm_proj'] += ranks['tm_proj']
        for key in ('gather', 'gram'):
            sparse[key] += one[key] + ranks[key]
    log('launches, phases 27-31', gs=launches['gs'],
        tm_proj=launches['tm_proj'], **masked, gather=sparse['gather'],
        gram=sparse['gram'])
    # no single PyTorch call computes B1-B4 (sequential topic chains with
    # clamps, a simplex projection, fused in-place rank-one updates)
    wide = [dict(B1, launches=launches['gs'], max_abs_err=err1, ms=ms1,
                 plain_ms=pms1, bound_ms=b1[0], bound_by=b1[1],
                 library_ms=None),
            dict(B2, launches=launches['tm_proj'], max_abs_err=err2, ms=ms2,
                 plain_ms=pms2, bound_ms=b2[0], bound_by=b2[1],
                 library_ms=None)] + [
        dict(entry, launches=masked[key], max_abs_err=stats[key][0],
             ms=stats[key][1], plain_ms=stats[key][2],
             bound_ms=stats[key][3], bound_by=stats[key][4], library_ms=None)
        for entry, key in ((B3, 'phase_a'), (B4, 'phase_b'))] + [
        dict(GATHER, launches=sparse['gather'], max_abs_err=sparse_stats[0],
             ms=sparse_stats[1], plain_ms=sparse_stats[2],
             bound_ms=sparse_stats[3], bound_by=sparse_stats[4],
             library_ms=sparse_stats[5])] + [
        dict(GRAM, launches=sparse['gram'],
             max_abs_err=gram_stats['max_abs_err'], ms=gram_stats['ms'],
             plain_ms=gram_stats['plain_ms'],
             bound_ms=gram_stats['bound_ms'],
             bound_by=gram_stats['bound_by'],
             library_ms=gram_stats.get('library_ms')),
        # the fit's launches; the library call computing the same product
        # from the same CSR, beside the GEMV it replaced on the dense X
        dict(SPMV, **spmv_stats)]
    # the 16-bit builds of the same sources (16-bit storage, float32 work)
    narrow = [
        dict(entry, name='%s_%s' % (entry['name'], tag),
             launches=counts16[dt][key], max_abs_err=stats16[key, dt][0],
             ms=stats16[key, dt][1], plain_ms=stats16[key, dt][2],
             bound_ms=stats16[key, dt][3], bound_by=stats16[key, dt][4],
             library_ms=stats16[key, dt][5])
        for dt, tag in ((torch.bfloat16, 'bf16'), (torch.float16, 'f16'))
        for entry, key in ((B1, 'gs'), (B2, 'tm_proj'), (B3, 'phase_a'),
                           (B4, 'phase_b'), (GATHER, 'gather'))]
    return wide + narrow


# --------------------------------------------------------------------------
# phases 27-30: the meshes
# --------------------------------------------------------------------------

@contextlib.contextmanager
def one_rank_world(dev):
    """A one-rank ``torch.distributed`` world (NCCL on a card, gloo on the
    CPU) and its (1, 1) mesh, for phases 27-29 (a)."""
    import tempfile

    import torch.distributed as dist

    from rri_nmf_tpu_torch.parallel import make_mesh
    backend = 'nccl' if dev.type == 'cuda' else 'gloo'
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, 'store'), 1),
            rank=0, world_size=1)
        try:
            yield make_mesh(1, (1, 1))
        finally:
            dist.destroy_process_group()


def mesh_problems(spec, dev):
    """The fits of phase 27 (b), as ``(name, X, nmf kwargs, mesh shape)``
    built from numpy seeds on ``dev`` (the same in the parent and in every
    rank): ``nmf()`` in the phase recipe at ``spec['nmf']`` (n, d, k) and
    the TM preset at ``spec['tm']`` (train docs, test docs, words, k),
    each in float64 and float32, from warm starts drawn with MESH_SEED."""
    from rri_nmf_tpu_torch.matrixops import normalize, tfidf
    shape = tuple(spec['mesh'])
    n, d, k = spec['nmf']
    rng = np.random.RandomState(MESH_SEED)
    W0, T0 = rng.rand(n, k), rng.rand(k, d)
    X = lowrank(n, d, k, dev, seed=0)
    base = dict(max_iter=spec['sweeps'], compute_obj_each_iter=True,
                random_state=0, W_in=W0, T_in=T0, **FAST_TM)
    for dt in (torch.float64, torch.float32):
        yield 'nmf %s' % str(dt)[6:], X.to(dt), dict(base, k=k), shape
    del X
    n_train, n_test, n_words, k = spec['tm']
    if spec.get('corpus'):
        # the parent's corpus of phase 6 (the same seed), not drawn again
        import scipy.sparse as sp
        counts = sp.load_npz(spec['corpus']).toarray()[:n_train]
    else:
        counts = zipf_corpus(n_train + n_test, n_words, k, seed=0)[:n_train]
    # unit rows, as the preset's init scales them: every topic stays alive
    # (a dead topic's T row is the simplex projection of rounding noise,
    # on which no two summation orders agree; from unscaled U[0,1] rows a
    # topic dies in the second sweep)
    W0, T0 = unit_rows(rng, n_train, n_words, k)
    tm = dict(max_iter=spec['sweeps'], compute_obj_each_iter=True,
              random_state=0, k=k, W_in=W0, T_in=T0,
              project_W_each_iter=False, w_row_sum=1.0,
              project_T_each_iter=True, t_row_sum=1.0, **FAST_TM)
    for dt in (torch.float64, torch.float32):
        Xt = normalize(tfidf(torch.as_tensor(counts, dtype=dt, device=dev)))
        yield 'tm %s' % str(dt)[6:], Xt, tm, shape
        del Xt


def unit_rows(rng, n, d, k):
    """U[0,1] warm starts W (n, k) and T (k, d) with unit row sums."""
    W0, T0 = rng.rand(n, k), rng.rand(k, d)
    return W0 / W0.sum(1, keepdims=True), T0 / T0.sum(1, keepdims=True)


def rs_preset(M, k, sweeps, W0, T0):
    """The RS estimator's masked ``nmf()`` settings (no resets, T entries
    bounded by t_row_sum=1, unprojected) from a warm start."""
    return dict(k=k, W_mat=M, max_iter=sweeps, compute_obj_each_iter=True,
                random_state=0, reset_topic_method=None, t_row_sum=1.0,
                W_in=W0, T_in=T0)


def masked_mesh_problems(spec, dev):
    """The fits of phase 28 (b) on a ``spec['mesh']`` mesh: the RS
    preset on phase 7-8's ratings and their observed mask at RS_SHAPE in
    float64 and float32 (B3/B4 on each rank), its fixed-T W-phase (B4
    alone) and a ``store_gradients`` fit (the plain masked sweep), both in
    float64, from warm starts drawn with MESH_SEED."""
    shape = tuple(spec['mesh'])
    n, d, q, k = spec['rs']
    X = torch.as_tensor(synth_ratings(n, d, q, 8), device=dev)
    M = (X != 0).double()
    rng = np.random.RandomState(MESH_SEED)
    W0, T0 = rng.rand(n, k), rng.rand(k, d)
    sweeps = spec['sweeps']
    for dt in (torch.float64, torch.float32):
        yield ('masked %s' % str(dt)[6:], X.to(dt),
               rs_preset(M.to(dt), k, sweeps, W0, T0), shape)
    T1 = T0 / T0.sum(1, keepdims=True)
    yield ('fixed T float64', X, dict(
        rs_preset(M, k, sweeps, W0, T1), fix_T=True), shape)
    yield ('store_gradients float64', X, dict(
        rs_preset(M, k, MASKED_MESH_STORE_SWEEPS, W0, T0),
        store_gradients=True), shape)


def sparse_mesh_problems(spec, dev):
    """The fits of phase 29 (b): phase 9's matrix at SPARSE_SHAPE as a CSR
    tensor on ``dev``, in float64 and float32, from warm starts drawn with
    MESH_SEED: ``sparse='mxu'`` on (2, 2) in the phase recipe, ``'mxu'``
    with the TM preset on (4, 1) (B2 on each rank's whole rows) and
    ``sparse=True`` (``torch.sparse.mm``) on (2, 2)."""
    n, d, dens, k = spec['sparse']
    rng = np.random.RandomState(MESH_SEED)
    W0, T0 = rng.rand(n, k), rng.rand(k, d)
    Wu, Tu = unit_rows(rng, n, d, k)
    base = dict(k=k, max_iter=spec['sweeps'], compute_obj_each_iter=True,
                random_state=0, **FAST_TM)
    tm = dict(project_W_each_iter=False, w_row_sum=1.0,
              project_T_each_iter=True, t_row_sum=1.0)
    for dt in (torch.float64, torch.float32):
        X = sparse_csr(n, d, dens, dev, seed=0, dtype=dt)
        tag = str(dt)[6:]
        yield ('mxu (2, 2) %s' % tag, X,
               dict(base, sparse='mxu', W_in=W0, T_in=T0), (2, 2))
        yield ('mxu TM (4, 1) %s' % tag, X,
               dict(base, sparse='mxu', W_in=Wu, T_in=Tu, **tm), (4, 1))
        yield ('torch (2, 2) %s' % tag, X,
               dict(base, sparse=True, W_in=W0, T_in=T0), (2, 2))
        del X


def sparse_mask_mesh_problems(spec, dev):
    """The problems of phase 30 (b), on a ``spec['mesh']`` mesh unless
    marked: the recorded problem at ``spec['record']`` (scipy CSR X and
    mask) through the Gram-phase fit in float32 and float64 and the
    O(nnz) fit in float32; phase 8's ratings at ``spec['rs']`` as CSR at
    k=MASKED_PANEL_K in float64 with ``gram_budget`` lowered to
    PANEL_MESH_UNITS (k, n / dp + d) float64 rows; the two guards, a
    (2, 2) mesh and a ``'random'`` reset (``raises``); and
    ``NMF_RS_Estimator(sparse_obs=True)`` in the phase order on the
    ratings' 90% split on ``dev`` (``estimator``). Warm starts are drawn
    with MESH_SEED."""
    import scipy.sparse as sp
    shape = tuple(spec['mesh'])
    n, d, q, k = spec['record']
    X, M = masked_record_problem(n, d, q, seed=0)
    rng = np.random.RandomState(MESH_SEED)
    base = dict(k=k, W_mat=M, W_in=rng.rand(n, k), T_in=rng.rand(k, d),
                compute_obj_each_iter=True, random_state=0, eps_stop=0.0,
                device=dev)
    gram = dict(base, update_order='phase', reset_topic_method=None)
    yield 'gram float32', X, dict(gram, max_iter=GRAM_MESH_SWEEPS), shape
    yield 'gram float64', X, dict(gram, max_iter=GRAM_MESH_F64_SWEEPS,
                                  dtype=torch.float64), shape
    yield ('interleaved float32', X,
           dict(base, max_iter=INTERLEAVED_MASKED_SWEEPS), shape)
    del X, M, base, gram
    nr, dr, qr, _ = spec['rs']
    kp = spec['panel_k']
    ratings = synth_ratings(nr, dr, qr, 8)
    R = sp.csr_matrix(ratings)
    Rm = R.copy()
    Rm.data[:] = 1.0
    yield ('panels float64', R, dict(
        k=kp, W_mat=Rm, W_in=rng.rand(nr, kp), T_in=rng.rand(kp, dr),
        update_order='phase', reset_topic_method=None,
        max_iter=PANEL_MESH_SWEEPS, compute_obj_each_iter=True,
        random_state=0, eps_stop=0.0, dtype=torch.float64, device=dev,
        gram_budget=spec['panel_budget']), shape)
    guard = dict(k=4, W_mat=Rm, max_iter=1, raises=True)
    yield 'guard (2, 2)', R, guard, (2, 2)
    yield 'guard random', R, dict(guard, reset_topic_method='random'), shape
    split = [torch.as_tensor(a, device=dev) for a in rs_split(ratings)]
    yield ('estimator float32', (tuple(spec['rs']), split),
           dict(estimator=True), shape)


def multihost_problems(spec, dev):
    """The problems of phase 31 (b), each with the way a rank builds its
    input from its slab (``slab``), and None for the default global mesh:
    the dense fit at ``spec['nmf']`` in float64 on ``make_global_mesh()``
    and in float32 on (2, 2); a checkpointed float32 fit (``'restore'``);
    the mesh NNDSVD in float64 (``'nndsvd'``); the TM preset on (4, 1)
    on X with unit rows; phase 9's CSR matrix at
    ``spec['sparse']`` through the COO plan on (2, 2) and ``'mxu'`` on
    (4, 1); the recorded problem at ``spec['record']`` through the Gram
    and the masked COO plans on (4, 1). Warm starts are drawn with
    MESH_SEED; X is made whole from its seed in every rank, which gives
    ``nmf()`` and the plans only its slab, and the whole-X mesh fit the
    whole."""
    n, d, k = spec['nmf']
    rng = np.random.RandomState(MESH_SEED)
    W0, T0 = rng.rand(n, k), rng.rand(k, d)
    X = lowrank(n, d, k, dev, seed=0)
    base = dict(k=k, max_iter=spec['sweeps'], compute_obj_each_iter=True,
                random_state=0, W_in=W0, T_in=T0, **FAST_TM)
    yield ('dense default float64', X.double(), dict(base, slab='dense'),
           None)
    yield 'dense float32', X, dict(base, slab='dense'), (2, 2)
    yield ('restore float32', X, dict(base, slab='restore',
                                      max_iter=2 * spec['sweeps']), (2, 2))
    yield 'nndsvd float64', X.double(), dict(k=k, slab='nndsvd'), (2, 2)
    # the TM preset on each rank's whole rows (B1 and B2) of X with unit
    # rows, from unit-row warm starts (phase 27's rule: every topic lives)
    from rri_nmf_tpu_torch.matrixops import normalize
    Wu, Tu = unit_rows(rng, n, d, k)
    yield ('tm (4, 1) float32', normalize(X), dict(
        base, W_in=Wu, T_in=Tu, project_W_each_iter=False, w_row_sum=1.0,
        project_T_each_iter=True, t_row_sum=1.0, slab='dense'), (4, 1))
    del X
    n, d, dens, k = spec['sparse']
    Xs = sparse_csr(n, d, dens, dev, seed=0)
    base = dict(base, k=k, W_in=rng.rand(n, k), T_in=rng.rand(k, d))
    yield 'coo float32', Xs, dict(base, sparse=True, slab='coo'), (2, 2)
    yield 'mxu float32', Xs, dict(base, sparse='mxu', slab='mxu'), (4, 1)
    del Xs
    n, d, q, k = spec['record']
    X, M = masked_record_problem(n, d, q, seed=0)
    masked = dict(k=k, W_mat=M, W_in=rng.rand(n, k), T_in=rng.rand(k, d),
                  compute_obj_each_iter=True, random_state=0, eps_stop=0.0,
                  device=dev)
    yield ('gram float32', X, dict(
        masked, max_iter=spec['sweeps'], update_order='phase',
        reset_topic_method=None, slab='masked_gram'), (4, 1))
    yield ('masked coo float32', X, dict(
        masked, max_iter=spec['masked_sweeps'], slab='masked_coo'), (4, 1))


RANK_PROBLEMS = {27: mesh_problems, 28: masked_mesh_problems,
                 29: sparse_mesh_problems, 30: sparse_mask_mesh_problems,
                 31: multihost_problems}


def csr_rows(X, lo, hi):
    """Rows [lo, hi) of a torch CSR tensor, as a CSR tensor."""
    crow = X.crow_indices()
    a, b = int(crow[lo]), int(crow[hi])
    return torch.sparse_csr_tensor(crow[lo:hi + 1] - a, X.col_indices()[a:b],
                                   X.values()[a:b], (hi - lo, X.shape[1]))


def _launch_counts():
    from rri_nmf_tpu_torch.ops import dense_kernels as dk
    from rri_nmf_tpu_torch.ops import masked_kernels as mk
    from rri_nmf_tpu_torch.ops import sparse_kernels as sk
    return dict(dk.LAUNCHES, **mk.LAUNCHES, **sk.LAUNCHES)


def slab_inputs(X, kw, mesh, slab):
    """This rank's X and warm starts built from its slab alone
    (``parallel.multihost``): a RankBlock of the dense slab, the COO or
    ``'mxu'`` plan of the sparse slab, the masked COO or Gram plan of the
    slabs of X and mask; with the fit's other settings. Returns
    ``(X_rank, kw, host plan seconds)``."""
    from rri_nmf_tpu_torch.parallel import (distribute_dense,
                                            distribute_factors,
                                            distribute_masked_coo,
                                            distribute_sparse_coo,
                                            process_row_block)
    n, d = X.shape
    kw = dict(kw)
    dev = kw.get('device')
    lo, hi = process_row_block(n, mesh)
    kw['W_in'], kw['T_in'] = distribute_factors(
        kw['W_in'][lo:hi], kw['T_in'], n, mesh,
        device=dev if dev is not None else X.device)
    t0 = time.perf_counter()
    if slab in ('dense', 'restore'):
        Xr = distribute_dense(X[lo:hi], (n, d), mesh)
    elif slab in ('coo', 'mxu'):
        Xr = distribute_sparse_coo(csr_rows(X, lo, hi), (n, d), mesh,
                                   backend=None if slab == 'coo' else 'mxu')
    else:
        M = kw.pop('W_mat')
        Xr = distribute_masked_coo(
            X[lo:hi], M[lo:hi], (n, d), mesh, device=dev,
            backend='mxu' if slab == 'masked_gram' else None)
    sync(dev if dev is not None else X.device)
    return Xr, kw, time.perf_counter() - t0


def solve_slab(nmf, X, kw, mesh, slab, out=None):
    """A phase 31 problem on ``mesh`` (None: one device, the whole X):
    the fit from this rank's slab (:func:`slab_inputs`), then the same
    ranks' whole-X mesh fit; the slab fit with ``same_as_whole`` (W, T
    and ``obj_history`` bit for bit), ``same_launches`` (the two fits'
    kernel launches) and ``plan_s`` (the slab plan's host seconds).
    ``'nndsvd'``: the NNDSVD init (``svd_backend='torch'``, through the
    mesh from the rank's block). ``'restore'``: 2 of ``max_iter`` sweeps
    with a checkpoint in ``out``/rank<r> (only the first rank writes),
    then ``max_iter`` from other warm starts, resuming; ``same_as_whole``
    is then the resumed fit against the straight slab fit."""
    from rri_nmf_tpu_torch.initialization import initialize_nmf
    kw = dict(kw)
    dev = kw['device'] if 'device' in kw else X.device
    if slab == 'nndsvd':
        from rri_nmf_tpu_torch.initialization import randomized_svd_torch
        Xi = X
        if mesh is not None:
            from rri_nmf_tpu_torch.parallel import (distribute_dense,
                                                    process_row_block)
            lo, hi = process_row_block(X.shape[0], mesh)
            Xi = distribute_dense(X[lo:hi], X.shape, mesh)
        W, H = initialize_nmf(Xi, kw['k'], 'nndsvd', random_state=0,
                              svd_backend='torch', mesh=mesh)
        # the SVD under it, from the same Ω (the seed's generator)
        U, S, Vt = randomized_svd_torch(
            Xi, kw['k'], generator=torch.Generator(dev).manual_seed(0),
            mesh=mesh)
        if mesh is not None:
            U, Vt = mesh.gather_rows(U, Xi.split), mesh.gather_cols(
                Vt, Xi.split)
        out = dict(W=W, T=H, obj_history=[], iter_cputime=[0.0, 0.0],
                   svd=(U.cpu(), S.cpu(), Vt.cpu()))
        if mesh is None:
            # the init's own conditioning: X with every entry moved by
            # about one ulp (a seeded relative 2^-52 normal draw)
            gen = torch.Generator(dev).manual_seed(1)
            Xp = X * (1 + 2.0 ** -52 * torch.randn(
                X.shape, generator=gen, dtype=X.dtype, device=dev))
            Wp, Hp = initialize_nmf(Xp, kw['k'], 'nndsvd', random_state=0,
                                    svd_backend='torch')
            out['ulp_gap'] = max(_mesh_gap(Wp, W), _mesh_gap(Hp, H))
            del Xp, Wp, Hp
        return out
    if mesh is None:
        return nmf(X, **dict(kw, max_iter=kw['max_iter'] // 2)
                   if slab == 'restore' else kw)
    Xr, skw, plan_s = slab_inputs(X, kw, mesh, slab)
    if slab == 'restore':
        import torch.distributed as dist

        from rri_nmf_tpu_torch.checkpoint import NMFCheckpointer
        ck = os.path.join(out, 'ckpt', 'rank%d' % dist.get_rank())
        sweeps = kw['max_iter'] // 2
        straight = nmf(Xr, mesh=mesh, **dict(skw, max_iter=sweeps))
        nmf(Xr, mesh=mesh, checkpoint=ck, checkpoint_every=sweeps // 2 or 1,
            **dict(skw, max_iter=sweeps // 2 or 1))
        disk = NMFCheckpointer(ck).steps()
        other = dict(kw, W_in=1.0 - kw['W_in'], T_in=1.0 - kw['T_in'])
        _, okw, _ = slab_inputs(X, other, mesh, 'dense')
        res = dict(nmf(Xr, mesh=mesh, checkpoint=ck, checkpoint_every=100,
                       **dict(okw, max_iter=sweeps)))
        res.update(same_as_whole=_bit_for_bit(res, straight),
                   same_launches=True, plan_s=plan_s, disk=disk)
        return res
    c0 = _launch_counts()
    res = dict(nmf(Xr, mesh=mesh, **skw))
    sync(dev)
    c1 = _launch_counts()
    whole = nmf(X, mesh=mesh, **kw)
    sync(dev)
    c2 = _launch_counts()
    res.update(same_as_whole=_bit_for_bit(res, whole), plan_s=plan_s,
               same_launches=all(c1[key] - c0[key] == c2[key] - c1[key]
                                 for key in c0))
    if slab == 'coo':
        # torch.sparse.mm on the card (cuSPARSE) need not repeat its bits:
        # the slab's block must equal partition_coo's bit for bit, the fit
        # the whole-X fit within the float32 gate; whether two whole-X
        # fits repeat is logged
        from rri_nmf_tpu_torch.parallel import partition_coo
        ref = partition_coo(X, mesh, Xr.dtype, dev).coo
        again = nmf(X, mesh=mesh, **kw)
        sync(dev)
        gap = abs(res['obj_history'][-1] - whole['obj_history'][-1]) / abs(
            whole['obj_history'][-1])
        res.update(whole_repeats=_bit_for_bit(whole, again), obj_gap=gap,
                   same_as_whole=(torch.equal(Xr.coo.indices(), ref.indices())
                                  and torch.equal(Xr.coo.values(),
                                                  ref.values())
                                  and gap <= TOL_MESH_F32_OBJ))
    return res


def solve(nmf, X, kw, mesh=None, out=None):
    """One problem of a rank phase on ``mesh`` (None: one device): an
    ``nmf()`` fit, with ``gram_budget`` as the Gram-phase sweep's budget
    around it; a refusal (``raises``: the ValueError's text);
    :func:`mesh_estimator` (``estimator``); or a phase 31 problem
    (``slab``, :func:`solve_slab`; ``out`` the rank's directory)."""
    from rri_nmf_tpu_torch.ops import sweep_masked_gram as mg
    kw = dict(kw)
    if 'slab' in kw:
        slab = kw.pop('slab')
        return solve_slab(nmf, X, kw, mesh, slab, out=out)
    if kw.pop('raises', False):
        try:
            nmf(X, mesh=mesh, **kw)
        except ValueError as e:
            return {'error': str(e)}
        raise AssertionError('a sparse-mask mesh guard did not raise')
    if kw.pop('estimator', False):
        return mesh_estimator(X, mesh)
    budget = mg.GRAM_BUDGET_BYTES
    mg.GRAM_BUDGET_BYTES = kw.pop('gram_budget', budget)
    try:
        return nmf(X, mesh=mesh, **kw)
    finally:
        mg.GRAM_BUDGET_BYTES = budget


def mesh_estimator(problem, mesh):
    """``NMF_RS_Estimator(sparse_obs=True)`` in the phase order (the
    Gram-phase sweep) on ``problem``, ``(shape, split)``: RS_SHAPE's form
    and :func:`rs_split`'s four arrays; on ``mesh`` when given. Returns
    W, T, the history, the test RMSE;
    on a mesh also a pickle round trip's test RMSE, whether the loaded
    ``nmf_kwargs`` hold a mesh, and what its objective calculator
    answers."""
    import pickle

    from rri_nmf_tpu_torch.sklearn_interface import NMF_RS_Estimator
    shape, (p_tr, r_tr, p_te, r_te) = problem
    kwargs = dict(update_order='phase')
    if mesh is not None:
        kwargs['mesh'] = mesh
    est = _rs_fit(NMF_RS_Estimator, p_tr, r_tr, shape, sparse_obs=True,
                  nmf_kwargs=kwargs)
    out = dict(W=est.W, T=est.T, rmse=est.score(p_te, r_te),
               obj_history=est.nmf_outputs['obj_history'],
               iter_cputime=est.nmf_outputs['iter_cputime'])
    if mesh is not None:
        loaded = pickle.loads(pickle.dumps(est))
        out.update(loaded_rmse=loaded.score(p_te, r_te),
                   loaded_mesh='mesh' in loaded.nmf_kwargs)
        try:
            loaded.nmf_outputs['obj_calculator'].true_objective()
            out['loaded_objective'] = 'evaluated'
        except ValueError as e:
            out['loaded_objective'] = str(e)
    return out


def mesh_rank(rank, world, store, out, spec):
    """One rank of phase 27, 28 or 29 (b) (``spec['phase']``): joins the
    gloo world on ``spec['device']`` (every rank on the one card), fits
    each of the phase's problems on its block of the problem's mesh, and
    saves its kernel launches (counted from zero around each fit) and, on
    the first rank, the whole factors, histories, gradient stores and
    seconds to ``out``."""
    import datetime

    import torch.distributed as dist

    from rri_nmf_tpu_torch.nmf import nmf
    from rri_nmf_tpu_torch.ops import dense_kernels as dk
    from rri_nmf_tpu_torch.ops import masked_kernels as mk
    from rri_nmf_tpu_torch.ops import sparse_kernels as sk
    from rri_nmf_tpu_torch.parallel import make_mesh
    dev = torch.device(spec['device'])
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    # the host's cores shared among the ranks
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    multihost = spec['phase'] == 31
    if multihost:
        # the multi-host entry: a coordinator address, as across hosts
        from rri_nmf_tpu_torch.parallel import (initialize_distributed,
                                                make_global_mesh)
        joined = initialize_distributed('localhost:%d' % spec['port'],
                                        world, rank, backend='gloo')
        if joined != (rank, world):
            raise AssertionError('initialize_distributed: %r' % (joined,))
    else:
        dist.init_process_group(
            'gloo', store=dist.FileStore(store, world), rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=MESH_SECONDS))
    # the host seconds of each fit's sparse-mask plan (nmf() looks its
    # partition functions up at call time)
    import rri_nmf_tpu_torch.nmf as driver
    plan_s = []
    for fn in ('partition_masked_coo', 'partition_masked_gram'):
        def timed(*args, _fn=getattr(driver, fn), **kwargs):
            t = time.perf_counter()
            plan = _fn(*args, **kwargs)
            plan_s.append(time.perf_counter() - t)
            return plan
        setattr(driver, fn, timed)
    try:
        meshes, launches, fits, plans, flags = {}, {}, {}, {}, {}
        for name, X, kw, shape in RANK_PROBLEMS[spec['phase']](spec, dev):
            if shape not in meshes:
                meshes[shape] = (make_global_mesh(shape) if multihost
                                 else make_mesh(world, shape))
            sync(dev)
            for module in (dk, mk, sk):
                module.reset_launches()
            del plan_s[:]
            t0 = time.perf_counter()
            res = solve(nmf, X, kw, meshes[shape], out=out)
            sync(dev)
            wall = time.perf_counter() - t0
            launches[name] = dict(dk.LAUNCHES, **mk.LAUNCHES, **sk.LAUNCHES)
            # (a slab fit: its own plan's seconds)
            plans[name] = res.get('plan_s', sum(plan_s))
            flags[name] = {key: res[key] for key in (
                'same_as_whole', 'same_launches', 'disk', 'whole_repeats',
                'obj_gap') if key in res}
            if rank == 0 and 'error' in res:
                fits[name] = res
            elif rank == 0:
                fits[name] = dict(W=res['W'].cpu(), T=res['T'].cpu(),
                                  obj=res['obj_history'], wall_s=wall,
                                  stamps=res['iter_cputime'])
                if 'numer_W' in res:
                    fits[name]['stores'] = {
                        key: {it: v.cpu() for it, v in res[key].items()}
                        for key in ('numer_W', 'denom_W')}
                fits[name].update((key, v) for key, v in res.items()
                                  if key in ('rmse', 'loaded_rmse',
                                             'loaded_mesh',
                                             'loaded_objective', 'svd'))
        torch.save({'launches': launches, 'fits': fits, 'plan_s': plans,
                    'flags': flags}, os.path.join(out, 'rank%d.pt' % rank))
    finally:
        dist.destroy_process_group()


def _mesh_gap(got, want):
    """max |got - want| over the largest |want|."""
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def run_ranks(spec, dev, nmf):
    """MESH_RANKS rank processes on the one card in a gloo world
    (:func:`mesh_rank`) fitting phase ``spec['phase']``'s problems, and
    the same fits on one device: ``(one-device fits, rank results,
    seconds from spawn to exit)``; any rank that fails fails the phase."""
    import tempfile
    want = {}
    for name, X, kw, _ in RANK_PROBLEMS[spec['phase']](spec, dev):
        if kw.get('raises'):
            continue
        res = solve(nmf, X, kw)
        sync(dev)
        want[name] = dict(W=res['W'].cpu(), T=res['T'].cpu(),
                          obj=res['obj_history'],
                          stamps=res['iter_cputime'])
        for key in ('rmse', 'svd', 'ulp_gap'):
            if key in res:
                want[name][key] = res[key]
        if 'numer_W' in res:
            want[name]['stores'] = {
                key: {it: v.cpu() for it, v in res[key].items()}
                for key in ('numer_W', 'denom_W')}
        del X, res
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, 'rank%d.log' % r), 'w+')
                for r in range(MESH_RANKS)]
        t0 = time.perf_counter()
        env = dict(os.environ, **spec.get('env', {}))
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), '--mesh-rank',
             str(r), str(MESH_RANKS), os.path.join(tmp, 'store'), tmp,
             json.dumps(spec)], stdout=logs[r], stderr=subprocess.STDOUT,
            env=env)
            for r in range(MESH_RANKS)]
        try:
            rcs = [p.wait(timeout=MESH_SECONDS) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        if any(rcs):
            tails = []
            for r, f in enumerate(logs):
                f.seek(0)
                tails.append('rank %d (rc %s): %s' % (r, rcs[r],
                                                      f.read()[-3000:]))
            raise AssertionError('a mesh rank failed:\n' + '\n'.join(tails))
        ranks = [torch.load(os.path.join(tmp, 'rank%d.pt' % r))
                 for r in range(MESH_RANKS)]
        for f in logs:
            f.close()
    return want, ranks, wall


def check_rank_fits(phase, want, ranks, expect):
    """Each rank fit of a phase against its one-device fit: float64
    within TOL_MESH_F64 (largest entry of W and T, relative objective,
    and the gradient stores), float32 within TOL_MESH_F32_OBJ relative
    final objective; every rank's launches ``expect(name, sweeps)``.
    Logs each fit; returns the launches summed over fits and ranks."""
    total = {}
    for name, ref in want.items():
        got = ranks[0]['fits'][name]
        sweeps = len(got['obj'])
        per_rank = [r['launches'][name] for r in ranks]
        for c in per_rank:
            for key, v in c.items():
                total[key] = total.get(key, 0) + v
        gap_w, gap_t = _mesh_gap(got['W'], ref['W']), _mesh_gap(got['T'],
                                                                 ref['T'])
        obj_gap = max(abs(a - b) / abs(b) for a, b in zip(got['obj'],
                                                           ref['obj']))
        gap_s = None
        if 'stores' in ref:
            gap_s = max(_mesh_gap(got['stores'][key][it], v)
                        for key, vs in ref['stores'].items()
                        for it, v in vs.items())
        shown = {key: v for key, v in per_rank[0].items() if v}
        log('mesh %d ranks sharing one card, gloo, phase %d: %s' % (
            MESH_RANKS, phase, name), sweeps=sweeps,
            launches_rank0=shown, rel_gap_W=gap_w, rel_gap_T=gap_t,
            max_rel_gap_obj=obj_gap, rel_gap_stores=gap_s,
            obj_last=got['obj'][-1], fit_wall_s=got['wall_s'],
            ms_per_sweep_with_objective=float(np.median(np.diff(
                got['stamps']))) * 1e3,
            ms_per_sweep_one_device=float(np.median(np.diff(
                ref['stamps']))) * 1e3)
        want_l = expect(name, sweeps)
        if any({key: c.get(key, 0) for key in want_l} != want_l
               for c in per_rank) or sweeps != len(ref['obj']):
            raise AssertionError('%s on the mesh: launches per rank %r for '
                                 '%d sweeps, want %r' % (name, per_rank,
                                                         sweeps, want_l))
        if name.endswith('float64'):
            ok = max(gap_w, gap_t, obj_gap, gap_s or 0.0) <= TOL_MESH_F64
        else:
            ok = abs(got['obj'][-1] - ref['obj'][-1]) / abs(
                ref['obj'][-1]) <= TOL_MESH_F32_OBJ
        if not ok:
            raise AssertionError('%s on the mesh against one device: W %.3g, '
                                 'T %.3g, objective %.3g, stores %r'
                                 % (name, gap_w, gap_t, obj_gap, gap_s))
    return total


def _bit_for_bit(a, b):
    return (torch.equal(a['W'], b['W']) and torch.equal(a['T'], b['T'])
            and a['obj_history'] == b['obj_history'])


def in_turns_ms(fit, mesh, dev):
    """ms/sweep (median of the sweeps' stamps) of ``fit(mesh)`` and
    ``fit(None)`` in turns: one device, mesh, mesh, one device."""
    ms = {'single': [], 'mesh': []}
    for which in ('single', 'mesh', 'mesh', 'single'):
        r = fit(mesh if which == 'mesh' else None)
        sync(dev)
        ms[which].append(float(np.median(np.diff(r['iter_cputime']))) * 1e3)
    return ms


def run_mesh_one_rank_phase(dev, dk, nmf, mesh):
    """Phase 27 (a): on the one-rank world's (1, 1) ``mesh``,
    ``nmf(mesh=...)`` at NMF_SHAPE in the phase recipe equals the
    single-device fit bit for bit with the same B1 launches; ms/sweep of
    both in turns, and the mesh sweeps' collective kernels by
    ``torch.profiler``. Returns the phase's B1 launches (its fits with
    and without the mesh)."""
    n, d, k = NMF_SHAPE
    X = lowrank(n, d, k, dev, seed=0)
    kw = dict(max_iter=SWEEPS, compute_obj_each_iter=True, random_state=0,
              **FAST_TM)
    gs0 = dk.LAUNCHES['gs']
    single = nmf(X, k, **kw)
    sync(dev)
    gs1 = dk.LAUNCHES['gs']
    meshed = nmf(X, k, mesh=mesh, **kw)
    sync(dev)
    gs_single, gs_mesh = gs1 - gs0, dk.LAUNCHES['gs'] - gs1
    same = _bit_for_bit(single, meshed)
    if not same or gs_mesh != gs_single or \
            gs_mesh != 2 * len(meshed['obj_history']):
        raise AssertionError('one-rank mesh fit: bit for bit %s, B1 %d '
                             'against %d' % (same, gs_mesh, gs_single))
    # ms/sweep without the objective, continuing from the fit
    cont = dict(max_iter=10, W_in=single['W'], T_in=single['T'],
                random_state=0, **FAST_TM)
    ms = in_turns_ms(lambda m: nmf(X, k, mesh=m, **cont), mesh, dev)
    kernels, device_ms, by_name = device_kernels(
        lambda: nmf(X, k, mesh=mesh, **dict(cont, max_iter=5)), dev)
    coll = [(c, t) for name, (c, t) in by_name.items()
            if 'nccl' in name.lower()]
    log('mesh one-rank %s world (1, 1) nmf %dx%d k=%d float32' % (
        mesh.backend, n, d, k), sweeps=len(meshed['obj_history']),
        bit_for_bit=same, gs_launches=gs_mesh,
        gs_launches_single=gs_single,
        ms_per_sweep_single=ms['single'], ms_per_sweep_mesh=ms['mesh'],
        device_ms_per_sweep=device_ms / 5, kernels_per_sweep=kernels / 5,
        collective_kernels_per_sweep=sum(c for c, _ in coll) / 5,
        collective_device_ms_per_sweep=sum(t for _, t in coll) / 5)
    return dk.LAUNCHES['gs'] - gs0


def run_mesh_ranks_phase(dev, dk, nmf, counts):
    """Phase 27 (b): MESH_RANKS ranks on a MESH_SHAPE mesh fitting
    :func:`mesh_problems`, held against the single-device card fits; the
    TM corpus is phase 6's ``counts``, handed to the ranks in a file (its
    multinomial draws take ~18 s). Returns the ranks' B1 and B2
    launches."""
    import tempfile

    import scipy.sparse as sp
    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, 'corpus.npz')
        sp.save_npz(corpus, sp.csr_matrix(counts), compressed=False)
        spec = dict(phase=27, device=str(dev), mesh=list(MESH_SHAPE),
                    nmf=list(NMF_SHAPE), tm=list(TM_SHAPE),
                    sweeps=MESH_SWEEPS, corpus=corpus)
        want, ranks, wall = run_ranks(spec, dev, nmf)
    total = check_rank_fits(27, want, ranks, lambda name, sweeps: (
        {'gs': sweeps, 'tm_proj': sweeps} if name.startswith('tm')
        else {'gs': 2 * sweeps, 'tm_proj': 0}))
    total = {key: total.get(key, 0) for key in ('gs', 'tm_proj')}
    log('mesh ranks phase', ranks=MESH_RANKS, wall_s=wall, **total)
    return total


def run_masked_mesh_one_rank_phase(dev, mk, nmf, mesh, ratings):
    """Phase 28 (a): on the one-rank world's (1, 1) ``mesh``, the RS
    preset at RS_SHAPE (phase 7-8's ratings and mask) in float64 and
    float32: W, T and ``obj_history`` bit for bit the single-device fit,
    B3 and B4 k launches a sweep in each; ms/sweep of both in turns.
    Returns the phase's B3 and B4 launches."""
    n, d, _, k = RS_SHAPE
    X = torch.as_tensor(ratings, device=dev)
    M = (X != 0).double()
    rng = np.random.RandomState(MESH_SEED)
    W0, T0 = rng.rand(n, k), rng.rand(k, d)
    b0 = dict(mk.LAUNCHES)
    for dt in (torch.float64, torch.float32):
        Xd, Md = X.to(dt), M.to(dt)
        kw = rs_preset(Md, k, MASKED_MESH_SWEEPS, W0, T0)
        counts = []
        fits = []
        for m in (None, mesh):
            c0 = dict(mk.LAUNCHES)
            fits.append(nmf(Xd, mesh=m, **kw))
            sync(dev)
            counts.append({key: mk.LAUNCHES[key] - c0[key] for key in c0})
        sweeps = len(fits[1]['obj_history'])
        same = _bit_for_bit(*fits)
        if not same or any(c != {'phase_a': k * sweeps,
                                 'phase_b': k * sweeps} for c in counts):
            raise AssertionError('one-rank masked mesh fit %s: bit for bit '
                                 '%s, launches %r for %d sweeps'
                                 % (dt, same, counts, sweeps))
        cont = dict(kw, max_iter=5, compute_obj_each_iter=False,
                    W_in=fits[0]['W'], T_in=fits[0]['T'])
        ms = in_turns_ms(lambda m: nmf(Xd, mesh=m, **cont), mesh, dev)
        log('masked mesh one-rank %s world (1, 1) %dx%d k=%d %s' % (
            mesh.backend, n, d, k, str(dt)[6:]), sweeps=sweeps,
            bit_for_bit=same, launches=counts[1],
            launches_single=counts[0], obj_last=fits[1]['obj_history'][-1],
            ms_per_sweep_single=ms['single'], ms_per_sweep_mesh=ms['mesh'])
        del fits, Xd, Md
    return {key: mk.LAUNCHES[key] - b0[key] for key in b0}


def run_fixed_t_max_resid_phase(dev, mk, nmf):
    """Phase 28, §C.2: a fixed-T dense-mask fit with
    ``'max_resid_document'`` resets and a dead topic on one device runs
    B4 alone, k times a sweep (the resets included), on the card, and
    picks the CPU's reset documents (float32 card, float64 CPU). Returns
    its B4 launches."""
    nu, ni, q, km = MASKED_SMALL
    R = synth_ratings(nu, ni, q, 4, seed=2)
    M = (R != 0).astype(float)
    rng = np.random.RandomState(7)
    T0 = rng.rand(km, ni)
    T0 /= T0.sum(1, keepdims=True)
    T0[2] = 0.0
    b0 = dict(mk.LAUNCHES)
    sweeps = []

    def fixed_t_fit(where):
        dt = torch.float32 if where.type == 'cuda' else torch.float64

        def t(a):
            return torch.as_tensor(a, device=where, dtype=dt)
        out = nmf(t(R), km, W_mat=t(M), T_in=t(T0), fix_T=True,
                  reset_topic_method='max_resid_document', max_iter=SWEEPS,
                  compute_obj_each_iter=True, t_row_sum=1.0, random_state=0)
        sweeps.append(len(out['obj_history']))
        if out['n_resets_remaining'] >= 23:
            raise AssertionError('fixed-T max_resid_document: no reset fired')
        return out
    _card_vs_cpu('masked fixed-T nmf %dx%d k=%d max_resid_document (B4)'
                 % (nu, ni, km), fixed_t_fit, dev)
    got = {key: mk.LAUNCHES[key] - b0[key] for key in b0}
    if dev.type == 'cuda' and got != {'phase_a': 0,
                                      'phase_b': km * sweeps[0]}:
        raise AssertionError('fixed-T max_resid_document: launches %r for '
                             '%d sweeps of k=%d' % (got, sweeps[0], km))
    log('fixed-T max_resid_document launches', **got)
    return got


def run_masked_mesh_ranks_phase(dev, nmf):
    """Phase 28 (b): MESH_RANKS ranks on a MASKED_MESH_SHAPE mesh fitting
    :func:`masked_mesh_problems`, held against the single-device card
    fits. Returns the ranks' B3 and B4 launches."""
    spec = dict(phase=28, device=str(dev), mesh=list(MASKED_MESH_SHAPE),
                rs=list(RS_SHAPE), sweeps=MASKED_MESH_SWEEPS)
    k = RS_SHAPE[3]
    want, ranks, wall = run_ranks(spec, dev, nmf)
    total = check_rank_fits(28, want, ranks, lambda name, sweeps: (
        {'phase_a': 0, 'phase_b': 0} if name.startswith('store')
        else {'phase_a': 0, 'phase_b': k * sweeps} if name.startswith('fix')
        else {'phase_a': k * sweeps, 'phase_b': k * sweeps}))
    total = {key: total.get(key, 0) for key in ('phase_a', 'phase_b')}
    log('masked mesh ranks phase', ranks=MESH_RANKS, wall_s=wall, **total)
    return total


def run_sparse_mesh_one_rank_phase(dev, sk, nmf, mesh):
    """Phase 29 (a): on the one-rank world's (1, 1) ``mesh``, ``'mxu'`` at
    SPARSE_SHAPE (phase 9's matrix, a float32 CSR tensor): W, T and
    ``obj_history`` bit for bit the single-device fit, 2 gather launches a
    sweep in each; ms/sweep of both in turns. Returns the phase's gather
    launches."""
    n, d, dens, k = SPARSE_SHAPE
    X = sparse_csr(n, d, dens, dev, seed=0)
    # a warm start: the card's NNDSVD of a CSR X (cuSPARSE and cuSOLVER
    # underneath) need not repeat bit for bit from one call to the next
    rng = np.random.RandomState(MESH_SEED)
    kw = dict(max_iter=SPARSE_MESH_SWEEPS, compute_obj_each_iter=True,
              random_state=0, sparse='mxu', W_in=rng.rand(n, k),
              T_in=rng.rand(k, d), **FAST_TM)
    b0 = sk.LAUNCHES['gather']
    fits, counts = [], []
    for m in (None, mesh):
        c0 = sk.LAUNCHES['gather']
        fits.append(nmf(X, k, mesh=m, **kw))
        sync(dev)
        counts.append(sk.LAUNCHES['gather'] - c0)
    sweeps = len(fits[1]['obj_history'])
    same = _bit_for_bit(*fits)
    if not same or counts != [2 * sweeps, 2 * sweeps]:
        raise AssertionError("one-rank sparse='mxu' mesh fit: bit for bit "
                             '%s, gather launches %r for %d sweeps'
                             % (same, counts, sweeps))
    cont = dict(kw, max_iter=5, compute_obj_each_iter=False,
                W_in=fits[0]['W'], T_in=fits[0]['T'])
    ms = in_turns_ms(lambda m: nmf(X, k, mesh=m, **cont), mesh, dev)
    log("sparse mesh one-rank %s world (1, 1) %dx%d %.1f%% k=%d 'mxu' "
        'float32' % (mesh.backend, n, d, 100 * dens, k), sweeps=sweeps,
        bit_for_bit=same, gather_launches=counts[1],
        gather_launches_single=counts[0],
        obj_last=fits[1]['obj_history'][-1],
        ms_per_sweep_single=ms['single'], ms_per_sweep_mesh=ms['mesh'])
    return sk.LAUNCHES['gather'] - b0


def run_sparse_mesh_ranks_phase(dev, nmf):
    """Phase 29 (b): MESH_RANKS ranks fitting :func:`sparse_mesh_problems`,
    held against the single-device card fits. Returns the ranks' B1, B2
    and gather launches."""
    spec = dict(phase=29, device=str(dev), sparse=list(SPARSE_SHAPE),
                sweeps=SPARSE_MESH_SWEEPS)
    want, ranks, wall = run_ranks(spec, dev, nmf)

    def expect(name, sweeps):
        gather = 2 * sweeps if name.startswith('mxu') else 0
        if ' TM ' in name:
            return {'gs': sweeps, 'tm_proj': sweeps, 'gather': gather}
        return {'gs': 2 * sweeps, 'tm_proj': 0, 'gather': gather}
    total = check_rank_fits(29, want, ranks, expect)
    total = {key: total.get(key, 0) for key in ('gs', 'tm_proj', 'gather')}
    log('sparse mesh ranks phase', ranks=MESH_RANKS, wall_s=wall, **total)
    return total


def run_sparse_mask_mesh_one_rank_phase(dev, sk, nmf, mesh, X, M):
    """Phase 30 (a): on the one-rank world's (1, 1) ``mesh``, the recorded
    problem (scipy CSR ``X``, ``M``) from MESH_SEED warm starts: the
    Gram-phase fit at k=32, the defaults (the O(nnz) sweep) and
    k=MASKED_PANEL_K in panels, each W, T and ``obj_history`` bit for bit
    the single-device fit with the same launches (:func:`gram_launches`;
    none in the O(nnz) fit); the mesh's O(nnz) sweep one CUDA graph;
    ms/sweep of each sweep in turns with the single-device one, on the
    fits' own plans. Returns the fits' gather and Gram launches and the
    Gram and O(nnz) mesh fits (W, T, ``obj_history``, launches) for phase
    31 (a)."""
    from rri_nmf_tpu_torch.ops import sweep_masked_gram as mg
    from rri_nmf_tpu_torch.ops import sweep_masked_sparse as msp
    from rri_nmf_tpu_torch.ops.sweep import make_draws
    from rri_nmf_tpu_torch.parallel import (make_sharded_masked_gram_sweep,
                                            make_sharded_masked_sparse_sweep)
    n, d, nnz, k = MASKED_RECORD
    kp = MASKED_PANEL_K
    rng = np.random.RandomState(MESH_SEED)
    W0, T0 = rng.rand(n, kp), rng.rand(kp, d)
    draws = make_draws(0, dev)
    total = gram_launches(0)

    def pair(kk, sweeps, expect, **kw):
        """The single-device fit and the (1, 1) mesh fit: bit for bit,
        each with the launches ``expect(sweeps)``."""
        kw = dict(k=kk, W_mat=M, W_in=W0[:, :kk], T_in=T0[:kk],
                  max_iter=sweeps, compute_obj_each_iter=True, random_state=0,
                  eps_stop=0.0, device=dev, **kw)
        fits, counts, walls = [], [], []
        for m in (None, mesh):
            c0 = sparse_launches(sk)
            t0 = time.perf_counter()
            fits.append(nmf(X, mesh=m, **kw))
            sync(dev)
            walls.append(time.perf_counter() - t0)
            counts.append(launched_since(sk, c0))
            for key in total:
                total[key] += counts[-1][key]
        got = len(fits[1]['obj_history'])
        same = _bit_for_bit(*fits)
        if not same or got != sweeps or counts != [expect(got)] * 2:
            raise AssertionError(
                'one-rank sparse-mask mesh fit k=%d %r: bit for bit %s, '
                '%d sweeps, launches %r (want %r)'
                % (kk, kw.get('update_order'), same, got, counts,
                   expect(got)))
        return fits, counts, walls

    def in_turns(single, meshed):
        """ms of ``single()`` and ``meshed()`` in turns (one device,
        mesh, mesh, one device)."""
        ms = {'single': [], 'mesh': []}
        for which in ('single', 'mesh', 'mesh', 'single'):
            fn = single if which == 'single' else meshed
            ms[which].append(time_ms(fn, dev, runs=2))
        return ms

    def plans(fits):
        return [f['obj_calculator'].X for f in fits]

    # the Gram-phase fit at k=32: A, Γ, C, Θ a sweep, C, Θ an objective
    cfg = masked_cfg(k, update_order='phase')
    fits, counts, walls = pair(k, GRAM_MESH_SWEEPS, gram_launches,
                               update_order='phase', reset_topic_method=None)
    refs = {'gram': dict(W=fits[1]['W'], T=fits[1]['T'],
                         obj_history=fits[1]['obj_history'],
                         launches=counts[1])}
    ps, pm = plans(fits)
    W, T = fits[0]['W'], fits[0]['T']
    one = mg.make_masked_gram_sweep(cfg, 'mxu')
    sharded = make_sharded_masked_gram_sweep(cfg, mesh, 'mxu')
    ms = in_turns(lambda: one(ps, W, T, draws, 0),
                  lambda: sharded(pm, W, T, draws, 0))
    log('sparse-mask mesh one-rank %s world (1, 1) %dx%d %d observations '
        'k=%d float32, Gram-phase' % (mesh.backend, n, d, nnz, k),
        sweeps=len(fits[1]['obj_history']), bit_for_bit=True,
        launches=counts[1], launches_single=counts[0],
        obj_last=fits[1]['obj_history'][-1], wall_s_single=walls[0],
        wall_s_mesh=walls[1], ms_per_sweep_single=ms['single'],
        ms_per_sweep_mesh=ms['mesh'])
    del fits, ps, pm, one, sharded

    # the defaults: the O(nnz) sweep, one CUDA graph a sweep on the mesh
    cfg = masked_cfg(k)
    fits, counts, walls = pair(k, INTERLEAVED_MASKED_SWEEPS,
                               lambda sweeps: gram_launches(0))
    refs['interleaved'] = dict(W=fits[1]['W'], T=fits[1]['T'],
                               obj_history=fits[1]['obj_history'],
                               launches=counts[1])
    ps, pm = plans(fits)
    W, T = fits[0]['W'], fits[0]['T']
    one = msp.make_masked_sparse_sweep(cfg)
    sharded = make_sharded_masked_sparse_sweep(cfg, mesh)
    launched = sharded.speculate(pm, W, T, draws, 0)[0][:2]
    for _ in range(2):     # launch by launch, then the capture
        sharded(pm, W, T, draws, 0)
    replayed = sharded(pm, W, T, draws, 0)[:2]
    sync(dev)
    graph = sharded._graph is not None
    if not ((graph or dev.type != 'cuda')
            and torch.equal(launched[0], replayed[0])
            and torch.equal(launched[1], replayed[1])):
        raise AssertionError('the mesh O(nnz) sweep: graph %s, replay equal '
                             'to the launches %s' % (graph, torch.equal(
                                 launched[0], replayed[0])))
    ms = in_turns(lambda: one(ps, W, T, draws, 0),
                  lambda: sharded(pm, W, T, draws, 0))
    log('sparse-mask mesh one-rank %s world (1, 1) %dx%d k=%d float32, '
        'defaults (O(nnz))' % (mesh.backend, n, d, k),
        sweeps=len(fits[1]['obj_history']), bit_for_bit=True,
        launches=counts[1], cuda_graph=graph,
        graph_equals_launches=True, obj_last=fits[1]['obj_history'][-1],
        wall_s_single=walls[0], wall_s_mesh=walls[1],
        graph_ms_per_sweep_single=ms['single'],
        graph_ms_per_sweep_mesh=ms['mesh'])
    del fits, ps, pm, one, sharded, launched, replayed

    # k=128 in panels (the panel from n / dp rows, dp = 1)
    panel = mg.auto_panel(kp, n, d, 4)
    npan = -(-kp // panel)
    cfg = masked_cfg(kp, update_order='phase')
    fits, counts, walls = pair(kp, PANEL_MESH_SWEEPS,
                               lambda sweeps: gram_launches(sweeps, npan),
                               update_order='phase', reset_topic_method=None)
    ps, pm = plans(fits)
    W, T = fits[0]['W'], fits[0]['T']
    one = mg.make_masked_gram_sweep(cfg, 'mxu', panel)
    sharded = make_sharded_masked_gram_sweep(cfg, mesh, 'mxu', panel)
    # (seconds a sweep, and each plan warm from its fit: one run each)
    ms = {'single': [], 'mesh': []}
    for which in ('single', 'mesh', 'mesh', 'single'):
        fn, plan = (one, ps) if which == 'single' else (sharded, pm)
        ms[which].append(time_ms(lambda: fn(plan, W, T, draws, 0), dev,
                                 runs=1, warm=False))
    log('sparse-mask mesh one-rank %s world (1, 1) %dx%d k=%d float32, '
        'Gram-phase in %d-topic panels' % (mesh.backend, n, d, kp, panel),
        panel=panel, panels=npan, sweeps=len(fits[1]['obj_history']),
        bit_for_bit=True, launches=counts[1],
        obj=fits[1]['obj_history'], wall_s_single=walls[0],
        wall_s_mesh=walls[1], ms_per_sweep_single=ms['single'],
        ms_per_sweep_mesh=ms['mesh'])
    return total, refs


def run_sparse_mask_mesh_ranks_phase(dev, nmf):
    """Phase 30 (b): MESH_RANKS gloo ranks fitting
    :func:`sparse_mask_mesh_problems`, held against the single-device
    card fits at phase 27's gates, every rank's launches counted
    (:func:`gram_launches`, in panels of ⌈k/p⌉; none in the O(nnz) fit);
    the guards' errors; the estimator's test RMSE beside the
    single-device one and its pickle round trip. Logs the host plan
    seconds per rank and the bytes of each all-reduce a sweep. Returns
    the ranks' gather and Gram launches."""
    from rri_nmf_tpu_torch.ops import sweep_masked_gram as mg
    nr, dr, _, _ = RS_SHAPE
    dp = GRAM_MESH_SHAPE[0]
    kp = MASKED_PANEL_K
    budget = PANEL_MESH_UNITS * kp * (nr / dp + dr) * 8
    panel = mg.auto_panel(kp, nr / dp, dr, 8, budget=budget)
    npan = -(-kp // panel)
    spec = dict(phase=30, device=str(dev), mesh=list(GRAM_MESH_SHAPE),
                record=list(MASKED_RECORD), rs=list(RS_SHAPE), panel_k=kp,
                panel_budget=budget)
    want, ranks, wall = run_ranks(spec, dev, nmf)
    ref = want.pop('estimator float32')
    mine = ranks[0]['fits'].pop('estimator float32')
    est_launches = [r['launches'].pop('estimator float32') for r in ranks]
    guards = {name: ranks[0]['fits'].pop(name)['error']
              for name in ('guard (2, 2)', 'guard random')}
    for r in ranks:
        for name in guards:
            r['launches'].pop(name)

    def expect(name, sweeps):
        launches = (gram_launches(sweeps) if name.startswith('gram') else
                    gram_launches(sweeps, npan) if name.startswith('panels')
                    else gram_launches(0))
        return dict(launches, gs=0, phase_a=0, phase_b=0)
    total = check_rank_fits(30, want, ranks, expect)
    if not ('row blocks' in guards['guard (2, 2)']
            and 'random' in guards['guard random']):
        raise AssertionError('the sparse-mask mesh guards: %r' % guards)
    # the estimator: an early stop runs one sweep more than it keeps
    kept = len(mine['obj'])
    gather = [{key: c[key] for key in ('gather', 'gram')}
              for c in est_launches]
    gap = abs(mine['rmse'] - ref['rmse']) / ref['rmse']
    if not (gap <= TOL_RMSE_ROUTES and mine['loaded_rmse'] == mine['rmse']
            and not mine['loaded_mesh']
            and 'mesh-sharded' in mine['loaded_objective']
            and all(g in (gram_launches(kept), gram_launches(kept + 1))
                    for g in gather)):
        raise AssertionError('the estimator on the mesh: RMSE %r against '
                             '%r, loaded %r, %r; launches %r for %d sweeps'
                             % (mine['rmse'], ref['rmse'],
                                mine['loaded_rmse'],
                                mine['loaded_objective'], gather, kept))
    n, d, _, k = MASKED_RECORD
    log('sparse-mask mesh ranks: NMF_RS_Estimator(sparse_obs=True, '
        "update_order='phase') %dx%d k=%d on %r" % (nr, dr, RS_SHAPE[3],
                                                    GRAM_MESH_SHAPE),
        sweeps_kept=kept, test_rmse=mine['rmse'],
        test_rmse_one_device=ref['rmse'], rel_gap=gap,
        pickled_test_rmse=mine['loaded_rmse'],
        pickled_objective=mine['loaded_objective'],
        launches_per_rank=gather, guards=guards)
    for key in ('gather', 'gram'):
        total[key] = total.get(key, 0) + sum(g[key] for g in gather)
    log('sparse-mask mesh ranks phase', ranks=MESH_RANKS, wall_s=wall,
        rank_walls_s={name: f['wall_s'] for name, f in
                      ranks[0]['fits'].items()},
        host_plan_s_per_rank={name: [r['plan_s'][name] for r in ranks]
                              for name in ranks[0]['plan_s']},
        allreduce_MB_per_sweep={
            'gram float32': (k + k * (k + 1) // 2) * d * 4 / 1e6,
            'gram float64': (k + k * (k + 1) // 2) * d * 8 / 1e6,
            'interleaved float32 (k of (2, d))': k * 2 * d * 4 / 1e6,
            'panels float64 (A, then %d panels)' % npan:
                (kp + kp * kp) * dr * 8 / 1e6},
        panel=panel, note='gloo copies each all-reduce through the host '
        '(~12 ms per 4 MB among 4 ranks, tools/probe_gloo_cuda.py) and the '
        'ranks share one card: no scaling reading', gather=total['gather'],
        gram=total['gram'])
    return total


# --------------------------------------------------------------------------
# phase 31: the multi-host layer
# --------------------------------------------------------------------------

def run_multihost_one_rank_phase(dev, dk, sk, nmf, Xr, Mr, refs):
    """Phase 31 (a), in the one-rank world: ``initialize_distributed()``
    returns the world it is in, ``make_global_mesh()`` is (1, 1); from the
    rank's slab (all rows here) ``nmf()`` at NMF_SHAPE (dense,
    ``distribute_dense``) and at SPARSE_SHAPE (``'mxu'``,
    ``distribute_sparse_coo``), MULTIHOST_SWEEPS each, bit for bit the
    whole-X mesh fit and the single-device fit with the same launches;
    the Gram and O(nnz) fits of phase 30 (a)'s settings on
    ``distribute_masked_coo`` plans of the recorded problem (``Xr``,
    ``Mr``), bit for bit phase 30 (a)'s fits (``refs``) with the same
    gather and Gram launches; the mesh NNDSVD in float64 at NMF_SHAPE bit
    for bit the single-device ``svd_backend='torch'`` one. Returns the
    phase's B1, gather and Gram launches."""
    from rri_nmf_tpu_torch.initialization import initialize_nmf
    from rri_nmf_tpu_torch.parallel import (distribute_dense,
                                            distribute_factors,
                                            distribute_masked_coo,
                                            distribute_sparse_coo,
                                            initialize_distributed,
                                            make_global_mesh,
                                            process_row_block)
    joined = initialize_distributed()
    mesh = make_global_mesh()
    if joined != (0, 1) or mesh.shape != (1, 1):
        raise AssertionError('the one-rank world: %r, %r' % (joined, mesh))
    total = {'gs': 0, 'gather': 0, 'gram': 0}

    def launched(fn):
        c0 = _launch_counts()
        t0 = time.perf_counter()
        res = fn()
        sync(dev)
        wall = time.perf_counter() - t0
        c1 = _launch_counts()
        got = {key: c1[key] - c0[key] for key in total}
        for key in total:
            total[key] += got[key]
        return res, got, wall

    def sweep_ms(res):
        return float(np.median(np.diff(res['iter_cputime']))) * 1e3

    def three(label, X, X_rank, k, kw, per_sweep):
        """The single-device, whole-X mesh and slab fits: bit for bit, the
        same launches, ``per_sweep`` of each kernel a sweep."""
        n = X.shape[0]
        lo, hi = process_row_block(n, mesh)
        W_r, T_r = distribute_factors(kw['W_in'][lo:hi], kw['T_in'], n, mesh,
                                      device=dev)
        fits = [launched(lambda: nmf(X, k, **kw)),
                launched(lambda: nmf(X, k, mesh=mesh, **kw)),
                launched(lambda: nmf(X_rank, k, mesh=mesh,
                                     **dict(kw, W_in=W_r, T_in=T_r)))]
        sweeps = len(fits[2][0]['obj_history'])
        want = {key: v * sweeps for key, v in per_sweep.items()}
        same = (_bit_for_bit(fits[2][0], fits[0][0])
                and _bit_for_bit(fits[2][0], fits[1][0]))
        if not same or any(f[1] != want for f in fits):
            raise AssertionError('%s from the slab: bit for bit %s, launches '
                                 '%r, want %r' % (label, same,
                                                  [f[1] for f in fits], want))
        log('multi-host one-rank %s world %s' % (mesh.backend, label),
            sweeps=sweeps, bit_for_bit=same, launches=fits[2][1],
            obj_last=fits[2][0]['obj_history'][-1],
            wall_s=[f[2] for f in fits],
            ms_per_sweep_with_objective={
                name: sweep_ms(f[0]) for name, f in zip(
                    ('single', 'whole-X mesh', 'slab'), fits)})

    # dense: distribute_dense at NMF_SHAPE (B1, 2 a sweep)
    n, d, k = NMF_SHAPE
    rng = np.random.RandomState(MESH_SEED)
    W0, T0 = rng.rand(n, k), rng.rand(k, d)
    X = lowrank(n, d, k, dev, seed=0)
    lo, hi = process_row_block(n, mesh)
    kw = dict(max_iter=MULTIHOST_SWEEPS, compute_obj_each_iter=True,
              random_state=0, W_in=W0, T_in=T0, **FAST_TM)
    three('nmf %dx%d k=%d float32 distribute_dense' % (n, d, k), X,
          distribute_dense(X[lo:hi], (n, d), mesh), k, kw,
          {'gs': 2, 'gather': 0, 'gram': 0})

    # the mesh NNDSVD in float64 from the rank's block, one Ω
    X = X.double()
    t0 = time.perf_counter()
    Wm, Hm = initialize_nmf(distribute_dense(X[lo:hi], (n, d), mesh), k,
                            'nndsvd', random_state=0, svd_backend='torch',
                            mesh=mesh)
    sync(dev)
    t1 = time.perf_counter()
    Ws, Hs = initialize_nmf(X, k, 'nndsvd', random_state=0,
                            svd_backend='torch')
    sync(dev)
    t2 = time.perf_counter()
    same = torch.equal(Wm, Ws) and torch.equal(Hm, Hs)
    if not same:
        raise AssertionError('the one-rank mesh NNDSVD differs from the '
                             'single-device one: %.3g, %.3g'
                             % (_mesh_gap(Wm, Ws), _mesh_gap(Hm, Hs)))
    log('multi-host one-rank NNDSVD %dx%d k=%d float64 (device backend)'
        % (n, d, k), bit_for_bit=same, seconds_mesh=t1 - t0,
        seconds_single=t2 - t1)
    del X, Wm, Hm, Ws, Hs

    # 'mxu': distribute_sparse_coo at SPARSE_SHAPE (gather 2, B1 2 a sweep)
    n, d, dens, k = SPARSE_SHAPE
    X = sparse_csr(n, d, dens, dev, seed=0)
    rng = np.random.RandomState(MESH_SEED)
    kw = dict(max_iter=MULTIHOST_SWEEPS, compute_obj_each_iter=True,
              random_state=0, sparse='mxu', W_in=rng.rand(n, k),
              T_in=rng.rand(k, d), **FAST_TM)
    lo, hi = process_row_block(n, mesh)
    t0 = time.perf_counter()
    plan = distribute_sparse_coo(csr_rows(X, lo, hi), (n, d), mesh,
                                 backend='mxu')
    sync(dev)
    plan_s = time.perf_counter() - t0
    three("'mxu' %dx%d %.1f%% k=%d float32 distribute_sparse_coo "
          '(host plan %.3f s)' % (n, d, 100 * dens, k, plan_s), X, plan, k,
          kw, {'gs': 2, 'gather': 2, 'gram': 0})
    del X, plan

    # the recorded problem: phase 30 (a)'s Gram and O(nnz) fits from
    # distribute_masked_coo plans
    n, d, nnz, k = MASKED_RECORD
    rng = np.random.RandomState(MESH_SEED)
    W0 = rng.rand(n, MASKED_PANEL_K)
    T0 = rng.rand(MASKED_PANEL_K, d)
    lo, hi = process_row_block(n, mesh)
    W_r, T_r = distribute_factors(W0[lo:hi, :k], T0[:k], n, mesh, device=dev)
    for name, backend, sweeps, extra in (
            ('gram', 'mxu', GRAM_MESH_SWEEPS,
             dict(update_order='phase', reset_topic_method=None)),
            ('interleaved', None, INTERLEAVED_MASKED_SWEEPS, {})):
        t0 = time.perf_counter()
        plan = distribute_masked_coo(Xr[lo:hi], Mr[lo:hi], (n, d), mesh,
                                     backend=backend, device=dev)
        sync(dev)
        plan_s = time.perf_counter() - t0
        res, got, wall = launched(lambda: nmf(
            plan, k, mesh=mesh, W_in=W_r, T_in=T_r, max_iter=sweeps,
            compute_obj_each_iter=True, random_state=0, eps_stop=0.0,
            device=dev, **extra))
        ref = refs[name]
        same = _bit_for_bit(res, ref)
        got = {key: got[key] for key in ('gather', 'gram')}
        if not same or got != ref['launches']:
            raise AssertionError('the %s fit on a distribute_masked_coo plan: '
                                 'bit for bit %s, launches %r against %r'
                                 % (name, same, got, ref['launches']))
        log('multi-host one-rank %s world %dx%d %d observations k=%d '
            'float32, %s from distribute_masked_coo(backend=%r)'
            % (mesh.backend, n, d, nnz, k, name, backend),
            sweeps=len(res['obj_history']), bit_for_bit_phase_30=same,
            launches=got, host_plan_s=plan_s, fit_wall_s=wall,
            ms_per_sweep_with_objective=sweep_ms(res))
        del plan, res
    return total


def run_multihost_ranks_phase(dev, nmf):
    """Phase 31 (b): MESH_RANKS gloo ranks as two hosts of MULTIHOST_LOCAL
    (``LOCAL_WORLD_SIZE``) joining through ``initialize_distributed`` at a
    localhost coordinator, fitting :func:`multihost_problems` from their
    slabs: each fit bit for bit the same ranks' whole-X mesh fit with the
    same launches (the COO plan's ``torch.sparse.mm`` fit, which cuSPARSE
    need not repeat bit for bit: its block bit for bit and the fit within
    the float32 gate of the whole-X fit), at phase 27's gates against the
    single-device card fits; the resumed fit bit for bit the straight one,
    only the first rank's directory holding the checkpoint; the mesh
    NNDSVD's SVD within TOL_MESH_F64 of the single-device one and its W,
    H within TOL_NNDSVD_MESH (beside what one ulp of X moves them).
    Launches per
    rank, each fit: 2 B1 a dense sweep; 2 gather and 2 B1 an ``'mxu'``
    sweep; B1 and B2 a TM sweep; 3 gather and 3 Gram a tracked Gram
    sweep; none in the O(nnz) fit (the COO problem fits three times).
    Returns the ranks' B1, B2, gather and Gram launches."""
    import socket
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        port = sock.getsockname()[1]
    spec = dict(phase=31, device=str(dev), nmf=list(NMF_SHAPE),
                sparse=list(SPARSE_SHAPE), record=list(MASKED_RECORD),
                sweeps=MULTIHOST_SWEEPS, masked_sweeps=MULTIHOST_MASKED_SWEEPS,
                port=port, env={'LOCAL_WORLD_SIZE': str(MULTIHOST_LOCAL)})
    want, ranks, wall = run_ranks(spec, dev, nmf)
    flags = [r['flags'] for r in ranks]
    bad = [(r, name, f) for r, fl in enumerate(flags)
           for name, f in fl.items()
           if not (f.get('same_as_whole', True)
                   and f.get('same_launches', True))]
    disk = [fl['restore float32']['disk'] for fl in flags]
    if bad or disk != [[MULTIHOST_SWEEPS // 2 or 1], [], [], []]:
        raise AssertionError('slab fits against the whole-X mesh fits: %r; '
                             'checkpoints on disk per rank %r' % (bad, disk))
    ref = want.pop('nndsvd float64')
    got = ranks[0]['fits'].pop('nndsvd float64')
    for r in ranks:
        r['launches'].pop('nndsvd float64')
    gap = max(_mesh_gap(got['W'], ref['W']), _mesh_gap(got['T'], ref['T']))
    (U, S, Vt), (Ur, Sr, Vtr) = got['svd'], ref['svd']
    gap_s = float(((S - Sr) / Sr).abs().max())
    gap_usv = _mesh_gap((U * S).to(dev) @ Vt.to(dev),
                        (Ur * Sr).to(dev) @ Vtr.to(dev))
    if not (max(gap_s, gap_usv) <= TOL_MESH_F64 and gap <= TOL_NNDSVD_MESH):
        raise AssertionError('the mesh NNDSVD against one device: W, H %.3g, '
                             'S %.3g, U·S·Vt %.3g' % (gap, gap_s, gap_usv))
    log('multi-host %d ranks (2 hosts of %d), gloo: NNDSVD %dx%d k=%d '
        'float64 through the mesh' % (MESH_RANKS, MULTIHOST_LOCAL,
                                      *NMF_SHAPE), rel_gap_W_H=gap,
        rel_gap_W_H_one_ulp_of_X=ref['ulp_gap'], rel_gap_S=gap_s,
        rel_gap_USVt=gap_usv)

    def expect(name, sweeps):
        none = {'gather': 0, 'gram': 0}
        if name.startswith('coo'):            # slab, whole X, whole X again
            return dict(none, gs=6 * sweeps)
        if name.startswith(('dense', 'restore')):
            return dict(none, gs=4 * sweeps)
        if name.startswith('tm'):
            return dict(none, gs=2 * sweeps, tm_proj=2 * sweeps)
        if name.startswith('mxu'):
            return dict(none, gs=4 * sweeps, gather=4 * sweeps)
        if name.startswith('gram'):           # slab and whole X
            return dict(gram_launches(2 * sweeps), gs=0)
        return dict(none, gs=0, phase_a=0, phase_b=0)
    total = check_rank_fits(31, want, ranks, expect)
    total = {key: total.get(key, 0)
             for key in ('gs', 'tm_proj', 'gather', 'gram')}
    coo = [fl['coo float32'] for fl in flags]
    log('multi-host ranks phase', ranks=MESH_RANKS, wall_s=wall,
        bit_for_bit_whole_x='every problem but coo float32',
        coo_obj_gap_to_whole_x=[c['obj_gap'] for c in coo],
        coo_whole_x_fit_repeats_bits=[c['whole_repeats'] for c in coo],
        checkpoints_on_disk=disk,
        host_plan_s_per_rank={name: [r['plan_s'][name] for r in ranks]
                              for name in ranks[0]['plan_s']},
        note='the ranks share one card and gloo copies through the host: '
        'no scaling reading', **total)
    return total


def main():
    if len(sys.argv) > 1 and sys.argv[1] == '--mesh-rank':
        rank, world, store, out, spec = sys.argv[2:7]
        mesh_rank(int(rank), int(world), store, out, json.loads(spec))
        return
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
