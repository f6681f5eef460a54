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
// For one direction of the mask plan (ops/sparse_plan.ColumnLayout: per
// nonzero gidx, the row of F^T it gathers, and its value v, in output-
// column order; the kernel reads the columns' ranges from the work list of
// the layout's colptr, below) and F^T's rows Ft (m, ldf):
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
//   terms in that order: no atomic on a value, a launch repeats bit for
//   bit. Every output element is written (an empty column writes zeros).
// - Skewed masks: a team's unit of work is an item of the layout's work
//   list (ops/sparse_plan.gram_work), not a column. A column of more than
//   L nonzeros is cut into ceil(nnz_c / L) chunks of near-equal length,
//   placed first in the list (the heavy work starts in the first wave);
//   the other columns follow whole, in ascending id (neighbouring teams
//   on neighbouring output columns, as without a list). A team on a chunk
//   writes its TI x TI partial to scratch ([chunk][tile][TI*TI], 16-byte
//   stores), fences, and counts its arrival for (split column, tile); the
//   thread that arrives last adds the column's partials in chunk order,
//   writes the output and resets the counter (no memset between
//   launches). So a split column's sum is its chunks' sums added chunk by
//   chunk: a departure in order only from one walk over the column, fixed
//   by the list, so a launch still repeats bit for bit. With no column
//   over L the list is the columns in order, one team a column: the same
//   launch and sums as without a list. L = max(2048, ceil(nnz / (resident
//   teams x 8))): an eighth of a balanced share, the resident teams at
//   this launch's tile count from this build's occupancy (rri_gram_resident below;
//   ops/sparse_kernels.chunk_length). On ML-25M's mask (25.0M nonzeros,
//   the longest movie 85,826, the busiest users 32,202; 528-1320 teams)
//   L is 2368-5919; Γ's 4480-row panel took 36.2 ms whole, 17.8 / 17.0 /
//   16.8 ms with L at a 4th / 8th / 16th of a share, Θ's 26.9, 23.0 /
//   22.9 / 23.1 ms (H100, tools/bench_gram_kernel.py --cell rs-ml25m);
//   the 8th is kept. The uniform 100k x 50k mask (longest column 593)
//   cuts nothing: the same launch and bits as before the list.
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
// fastest; the kernel runs at ~25% of its FMA bound on a uniform mask,
// and with the work list ~20% (Γ) and ~14.5% (Θ) on ML-25M's, where Θ's
// 162,541 output columns make 2.9 GB of scattered stores a panel.

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

// a tile's TI x TI sums to p, 16 bytes a store
template <int TI>
__device__ __forceinline__ void store_tile(float* p,
                                           const float (&acc)[TI][TI]) {
#pragma unroll
  for (int i = 0; i < TI; ++i) {
#pragma unroll
    for (int q = 0; q < TI / 4; ++q) {
      reinterpret_cast<float4*>(p + i * TI)[q] =
          make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2],
                      acc[i][4 * q + 3]);
    }
  }
}

template <int TI>
__device__ __forceinline__ void store_tile(double* p,
                                           const double (&acc)[TI][TI]) {
#pragma unroll
  for (int i = 0; i < TI; ++i) {
#pragma unroll
    for (int q = 0; q < TI / 2; ++q) {
      reinterpret_cast<double2*>(p + i * TI)[q] =
          make_double2(acc[i][2 * q], acc[i][2 * q + 1]);
    }
  }
}

// acc = (add: acc +) the TI x TI sums at p, 16-byte loads past L1 (other
// teams wrote them)
template <int TI>
__device__ __forceinline__ void load_tile(const float* p, float (&acc)[TI][TI],
                                          bool add) {
#pragma unroll
  for (int i = 0; i < TI; ++i) {
#pragma unroll
    for (int q = 0; q < TI / 4; ++q) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(p + i * TI) + q);
      const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[i][4 * q + r] = add ? acc[i][4 * q + r] + w[r] : w[r];
      }
    }
  }
}

template <int TI>
__device__ __forceinline__ void load_tile(const double* p,
                                          double (&acc)[TI][TI], bool add) {
#pragma unroll
  for (int i = 0; i < TI; ++i) {
#pragma unroll
    for (int q = 0; q < TI / 2; ++q) {
      const double2 v =
          __ldcg(reinterpret_cast<const double2*>(p + i * TI) + q);
      acc[i][2 * q] = add ? acc[i][2 * q] + v.x : v.x;
      acc[i][2 * q + 1] = add ? acc[i][2 * q + 1] + v.y : v.y;
    }
  }
}

// nbj: b-blocks (ceil(k / TI)); ia0: the panel's first a-block; ntiles:
// tiles of one column; team: threads per team (min(ntiles, GC_THREADS)).
// items: the work list, (column, start, end, split) an item, split the
// item's split column or -1 for a whole column. split_ptr: split column
// s's chunks are items split_ptr[s] .. split_ptr[s + 1] - 1; scratch:
// [chunk][tile][TI * TI] partials; arrivals: [split column][tile]
// counters, 0 between launches (scratch and arrivals: null where no item
// is split).
template <typename T>
__global__ void __launch_bounds__(GC_THREADS, GC_MIN_BLOCKS)
    gram_kernel(const T* __restrict__ Ft, int ldf,
                const int* __restrict__ gidx, const T* __restrict__ vals,
                T* __restrict__ out, int ncols, int k, int t0, int p, int nbj, int ia0, int ntiles,
                int team, const int4* __restrict__ items, int nitems,
                const int* __restrict__ split_ptr, T* __restrict__ scratch,
                int* __restrict__ arrivals) {
  constexpr int TI = Tile<T>::side;
  const int teams = GC_THREADS / team;
  const int tm = threadIdx.x / team;
  const int tile = blockIdx.y * team + (threadIdx.x - tm * team);
  const int w = blockIdx.x * teams + tm;
  if (tm >= teams || tile >= ntiles || w >= nitems) return;
  const int4 it = __ldg(items + w);
  const int c = it.x, s = it.y, e = it.z, split = it.w;

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

  if (split >= 0) {
    // a chunk: its partial to scratch; the last of the column's chunks to
    // arrive for this tile sums them all, in chunk order
    store_tile<TI>(scratch + ((long)w * ntiles + tile) * (TI * TI), acc);
    __threadfence();
    int* arrived = arrivals + (long)split * ntiles + tile;
    const int q0 = __ldg(split_ptr + split), q1 = __ldg(split_ptr + split + 1);
    if (atomicAdd(arrived, 1) != q1 - q0 - 1) return;
    *arrived = 0;
    __threadfence();
    load_tile<TI>(scratch + ((long)q0 * ntiles + tile) * (TI * TI), acc,
                  false);
    for (int q = q0 + 1; q < q1; ++q) {
      load_tile<TI>(scratch + ((long)q * ntiles + tile) * (TI * TI), acc,
                    true);
    }
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

// a launch's tiling: tiles of a column, threads a team, teams a block,
// threads a block, tile groups (blockIdx.y); false where the shape is
// invalid
template <typename T>
struct GramShape {
  int nbj, ia0, ntiles, team, teams, threads, groups;
  bool init(int k, int t0, int p, int ldf) {
    constexpr int TI = Tile<T>::side;
    nbj = (k + TI - 1) / TI;
    if (k < 1 || ldf < nbj * TI || ldf % TI || p < 0 ||
        (p > 0 && (t0 < 0 || t0 + p > k))) {
      return false;
    }
    ia0 = p == 0 ? 0 : t0 / TI;
    const int nbi = p == 0 ? 0 : (t0 + p + TI - 1) / TI - ia0;
    ntiles = p == 0 ? nbj * (nbj + 1) / 2 : nbi * nbj;
    team = ntiles < GC_THREADS ? ntiles : GC_THREADS;
    teams = GC_THREADS / team;
    threads = (teams * team + 31) / 32 * 32;
    groups = (ntiles + team - 1) / team;
    return groups <= 65535;
  }
};

template <typename T>
static int launch_gram(const T* Ft, int ldf, const int* gidx, const T* vals,
                       T* out, const int4* items, const int* split_ptr,
                       T* scratch, int* arrivals, int k, int t0, int p,
                       int ncols, int nitems, int device, void* stream) {
  GramShape<T> g;
  if (ncols < 1 || nitems < 1 || !items || !split_ptr ||
      !g.init(k, t0, p, ldf)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((nitems + g.teams - 1) / g.teams, g.groups);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  gram_kernel<T><<<grid, g.threads, 0, (cudaStream_t)stream>>>(
      Ft, ldf, gidx, vals, out, ncols, k, t0, p, g.nbj, g.ia0,
      g.ntiles, g.team, items, nitems, split_ptr, scratch, arrivals);
  return (int)cudaGetLastError();
}

// the teams a launch at (k, t0, p) holds at once on the device, per tile
// group: SMs x resident blocks an SM x teams a block / groups (at least
// 1); minus a CUDA error
template <typename T>
static int resident_gram(int k, int t0, int p, int device) {
  constexpr int TI = Tile<T>::side;
  GramShape<T> g;
  if (!g.init(k, t0, p, (k + TI - 1) / TI * TI)) {
    return -(int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  int sms = 0, blocks = 0;
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, gram_kernel<T>, g.threads, 0);
  }
  if (err != cudaSuccess) return -(int)err;
  const long r = (long)sms * blocks * g.teams / g.groups;
  return r < 1 ? 1 : (int)r;
}

#define GRAM_API(SUF, T)                                                     \
  extern "C" int rri_gram_contract_##SUF(                                    \
      const void* Ft, const void* gidx, const void* vals, void* out,         \
      const void* items, const void* split_ptr, void* scratch,               \
      void* arrivals, int k, int ldf, int t0, int p, int ncols, int nitems,  \
      int device, void* stream) {                                            \
    return launch_gram<T>((const T*)Ft, ldf, (const int*)gidx,               \
                          (const T*)vals, (T*)out, (const int4*)items,       \
                          (const int*)split_ptr, (T*)scratch,                \
                          (int*)arrivals, k, t0, p, ncols, nitems, device,   \
                          stream);                                           \
  }                                                                          \
  extern "C" int rri_gram_resident_##SUF(int k, int t0, int p, int device) { \
    return resident_gram<T>(k, t0, p, device);                               \
  }

GRAM_API(f32, float)
GRAM_API(f64, double)
