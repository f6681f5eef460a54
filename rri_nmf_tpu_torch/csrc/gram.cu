// The Gram-phase Khatri-Rao contractions Γ and Θ of the sparse-mask sweep,
// straight from the factor rows.
//
// Replaces B5 (rri_nmf_tpu/ops/sparse_mxu.py:298 _make_contract_kernel)
// where the JAX sweep runs it on the Khatri-Rao rows
// w_t ⊙ w_s that XLA materializes first
// (rri_nmf_tpu/ops/sweep_masked_gram.py:367-368,390-391 in panels and
// :476-478,495-497 whole). This kernel fuses that elementwise product into
// the contraction, a departure from the JAX structure: the rows are never
// written, and the same sums come out.
//
// For one direction of the mask plan (ops/sparse_plan.column_layout: the
// output-column CSR colptr, and per nonzero gidx, the row of F^T it
// gathers, and its value v) and F^T's rows Ft (m, ldf):
//
//   out[r][c] = sum over the nonzeros i of column c of
//               v_i * Ft[g_i][a_r] * Ft[g_i][b_r]
//
// with the row pairs (a_r, b_r) either
//   - p == 0: the k(k+1)/2 pairs a <= b in np.triu_indices(k) order, row
//     r(a, b) = a k - a (a - 1) / 2 + (b - a) (Γ/Θ's unique rows); or
//   - p >= 1: a panel, a = t0 + r / k, b = r % k for r < p k.
// out is (rows, ncols) row-major, the layout the gather kernel gives the
// materialized rows, so the callers unpack and all-reduce it unchanged.
//
// Design:
//
// - The (a, b) plane of one output column is cut into TI x TI tiles (8 x 8
//   in float32, 4 x 4 in float64), a-blocks aligned to multiples of TI:
//   the triangle takes the tiles with a-block <= b-block, a panel the
//   a-blocks that meet [t0, t0 + p) against every b-block. A thread holds
//   one tile's TI^2 sums in registers. Per nonzero it reads TI values of
//   the row at a0 and TI at b0 (16-byte loads through the read-only path),
//   scales the a-values by v once, and makes TI^2 FMAs: acc[i][j] +=
//   (v fa[i]) fb[j]. (Not bit for bit the twin's (fa fb) v; within the
//   stated tolerances.)
// - A team of `team` consecutive threads, one a tile, covers every tile of
//   one output column; a block of up to GC_THREADS threads holds
//   GC_THREADS / team teams on consecutive columns (25 at k = 32, 2 for a
//   112-tile panel). Past GC_THREADS tiles the tile set is cut into groups
//   (blockIdx.y), each reading the column's nonzeros again.
// - A team walks its column's nonzeros in layout order, GC_U at a time with
//   their row loads in flight before the first FMA and the next GC_U
//   (g, v) pairs loaded meanwhile (3-6% on the panels). Each sum adds its
//   terms in that order: no atomics, a launch repeats bit for bit. Every
//   output element is written (an empty column writes zeros).
// - The factor (W: 12.8 MB at 100,000 x 32 in float32, 51 MB at k = 128)
//   stays in the 50 MB L2 (or nearly), and a team's threads read one row
//   together, so a row is fetched from L2 once per team and nonzero. The
//   (g, v) pairs stream once per tile group: 8 bytes per nonzero.
//
// What bounds it on the H100: the FMAs. Γ at k = 32 (528 rows) on 24.9M
// nonzeros is 26.3 GFLOP: 0.393 ms at 67 TFLOP/s; a 6656-row panel (p =
// 52, k = 128) 332 GFLOP: 4.955 ms. The bytes (the factor once, 8 bytes a
// nonzero, the output) take 0.15 ms and 0.85 ms. The gather kernel on the
// materialized rows instead reads nnz x rows x 4 bytes of a 0.1-2.7 GB
// operand that misses L2. The design spends ~80 instructions per 64 FMAs
// (loads, the v scaling, addresses), and computes the whole diagonal tiles
// of the triangle (640 sums for 528 at k = 32). Each column's (a, b) sums
// go to `rows` addresses a column apart: the stores are scattered, 4
// bytes each (L2 merges neighbouring columns' sectors).
//
// ptxas -v (CUDA 12.8, sm_90a): 126 registers a thread in float32, 128 in
// float64, no spills, no shared memory: 2 blocks of 256 threads (16 warps)
// an SM. Variants of GC_U, the tile side and the block size were timed on
// an H100 (tools/bench_gram_kernel.py, PERF.md): these settings were the
// fastest; the kernel runs at ~25% of its FMA bound.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef GC_THREADS
#define GC_THREADS 256  // threads per block, at most
#endif
#ifndef GC_U
#define GC_U 2          // nonzeros whose rows are in flight per thread
#endif
#ifndef GC_TI_F32
#define GC_TI_F32 8     // tile side in float32
#endif
#ifndef GC_TI_F64
#define GC_TI_F64 4     // tile side in float64
#endif
#ifndef GC_MIN_BLOCKS
#define GC_MIN_BLOCKS 2  // blocks per SM the registers must allow
#endif

template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int side = GC_TI_F32;
};
template <>
struct Tile<double> {
  static constexpr int side = GC_TI_F64;
};

// TI consecutive values of a row, 16 bytes at a time (p 16-byte aligned)
template <int TI>
__device__ __forceinline__ void load_ti(const float* p, float (&r)[TI]) {
#pragma unroll
  for (int q = 0; q < TI / 4; ++q) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p) + q);
    r[4 * q] = v.x;
    r[4 * q + 1] = v.y;
    r[4 * q + 2] = v.z;
    r[4 * q + 3] = v.w;
  }
}

template <int TI>
__device__ __forceinline__ void load_ti(const double* p, double (&r)[TI]) {
#pragma unroll
  for (int q = 0; q < TI / 2; ++q) {
    const double2 v = __ldg(reinterpret_cast<const double2*>(p) + q);
    r[2 * q] = v.x;
    r[2 * q + 1] = v.y;
  }
}

// the (g, v) pairs of nonzeros j .. j + U - 1
template <typename T, int U>
__device__ __forceinline__ void load_pairs(const int* __restrict__ gidx,
                                           const T* __restrict__ vals, int j,
                                           int (&g)[U], T (&v)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    g[u] = __ldg(gidx + j + u);
    v[u] = __ldg(vals + j + u);
  }
}

// acc += v_u (fa_u ⊗ fb_u) for U nonzeros, fa_u and fb_u the TI values at
// a0 and b0 of row g_u
template <typename T, int TI, int U>
__device__ __forceinline__ void add_rows(const T* __restrict__ Ft, long ldf,
                                         const int (&g)[U], const T (&v)[U],
                                         int a0, int b0, T (&acc)[TI][TI]) {
  T fa[U][TI], fb[U][TI];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const T* row = Ft + (long)g[u] * ldf;
    load_ti<TI>(row + a0, fa[u]);
    load_ti<TI>(row + b0, fb[u]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int i = 0; i < TI; ++i) {
      const T va = v[u] * fa[u][i];
#pragma unroll
      for (int jj = 0; jj < TI; ++jj) {
        acc[i][jj] = fma(va, fb[u][jj], acc[i][jj]);
      }
    }
  }
}

// nbj: b-blocks (ceil(k / TI)); ia0: the panel's first a-block; ntiles:
// tiles of one column; team: threads per team (min(ntiles, GC_THREADS))
template <typename T>
__global__ void __launch_bounds__(GC_THREADS, GC_MIN_BLOCKS)
    gram_kernel(const T* __restrict__ Ft, int ldf,
                const int* __restrict__ colptr, const int* __restrict__ gidx,
                const T* __restrict__ vals, T* __restrict__ out, int ncols,
                int k, int t0, int p, int nbj, int ia0, int ntiles,
                int team) {
  constexpr int TI = Tile<T>::side;
  const int teams = GC_THREADS / team;
  const int tm = threadIdx.x / team;
  const int tile = blockIdx.y * team + (threadIdx.x - tm * team);
  const int c = blockIdx.x * teams + tm;
  if (tm >= teams || tile >= ntiles || c >= ncols) return;

  // the tile's a- and b-block
  int bi, bj;
  if (p == 0) {                 // row bi of the triangle holds nbj - bi tiles
    int r = tile;
    bi = 0;
    while (r >= nbj - bi) {
      r -= nbj - bi;
      ++bi;
    }
    bj = bi + r;
  } else {
    bi = ia0 + tile / nbj;
    bj = tile % nbj;
  }
  const int a0 = bi * TI, b0 = bj * TI;

  T acc[TI][TI];
#pragma unroll
  for (int i = 0; i < TI; ++i) {
#pragma unroll
    for (int jj = 0; jj < TI; ++jj) acc[i][jj] = (T)0;
  }
  // GC_U nonzeros at a time, the next GC_U pairs loaded meanwhile
  const int s = colptr[c], e = colptr[c + 1];
  int j = s;
  int g[GC_U];
  T v[GC_U];
  if (j + GC_U <= e) load_pairs<T, GC_U>(gidx, vals, j, g, v);
  for (; j + GC_U <= e; j += GC_U) {
    int gc[GC_U];
    T vc[GC_U];
#pragma unroll
    for (int u = 0; u < GC_U; ++u) {
      gc[u] = g[u];
      vc[u] = v[u];
    }
    if (j + 2 * GC_U <= e) load_pairs<T, GC_U>(gidx, vals, j + GC_U, g, v);
    add_rows<T, TI, GC_U>(Ft, ldf, gc, vc, a0, b0, acc);
  }
  for (; j < e; ++j) {
    int g1[1];
    T v1[1];
    load_pairs<T, 1>(gidx, vals, j, g1, v1);
    add_rows<T, TI, 1>(Ft, ldf, g1, v1, a0, b0, acc);
  }

  // the tile's rows of column c
  const int a_end = p == 0 ? k : t0 + p;
#pragma unroll
  for (int i = 0; i < TI; ++i) {
    const int a = a0 + i;
    if (a < (p == 0 ? 0 : t0) || a >= a_end) continue;
    const long row0 = p == 0 ? (long)a * k - (long)a * (a - 1) / 2 - a
                             : (long)(a - t0) * k;
#pragma unroll
    for (int jj = 0; jj < TI; ++jj) {
      const int b = b0 + jj;
      if (b < k && (p != 0 || a <= b)) {
        out[(row0 + b) * ncols + c] = acc[i][jj];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launcher
// ---------------------------------------------------------------------------

template <typename T>
static int launch_gram(const T* Ft, int ldf, const int* colptr,
                       const int* gidx, const T* vals, T* out, int k, int t0,
                       int p, int ncols, int device, void* stream) {
  constexpr int TI = Tile<T>::side;
  const int nbj = (k + TI - 1) / TI;
  if (k < 1 || ncols < 1 || ldf < nbj * TI || ldf % TI || p < 0 ||
      (p > 0 && (t0 < 0 || t0 + p > k))) {
    return (int)cudaErrorInvalidValue;
  }
  const int ia0 = p == 0 ? 0 : t0 / TI;
  const int nbi = p == 0 ? 0 : (t0 + p + TI - 1) / TI - ia0;
  const int ntiles = p == 0 ? nbj * (nbj + 1) / 2 : nbi * nbj;
  const int team = ntiles < GC_THREADS ? ntiles : GC_THREADS;
  const int teams = GC_THREADS / team;
  const int threads = (teams * team + 31) / 32 * 32;
  const dim3 grid((ncols + teams - 1) / teams, (ntiles + team - 1) / team);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  gram_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      Ft, ldf, colptr, gidx, vals, out, ncols, k, t0, p, nbj, ia0, ntiles,
      team);
  return (int)cudaGetLastError();
}

#define GRAM_API(SUF, T)                                                     \
  extern "C" int rri_gram_contract_##SUF(                                    \
      const void* Ft, const void* colptr, const void* gidx,                  \
      const void* vals, void* out, int k, int ldf, int t0, int p, int ncols, \
      int device, void* stream) {                                            \
    return launch_gram<T>((const T*)Ft, ldf, (const int*)colptr,             \
                          (const int*)gidx, (const T*)vals, (T*)out, k, t0,  \
                          p, ncols, device, stream);                         \
  }

GRAM_API(f32, float)
GRAM_API(f64, double)
