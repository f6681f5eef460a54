// Sparse contraction out = F @ X by output-column gather: kernels B5 and B6,
// one kernel for both.
//
// Replaces the Pallas kernels
//
//   B5  rri_nmf_tpu/ops/sparse_mxu.py _make_contract_kernel
//       (the grouped chunk plan, one grid step per group of G chunks);
//   B6  rri_nmf_tpu/ops/sparse_dma.py _make_dma_kernel
//       (the CSR-offset chunk plan, factor slabs prefetched by manual DMA).
//
// Both compute out (k, spad) = F (k, m) @ X for one direction of the sparse
// sweep (W^T X with F = W^T, or T X^T with F = T), from the same bucketing
// of X's nonzeros into 128x128 tiles. The TPU has no gather path, so its
// kernels rebuild each chunk's dense tile with one-hot matrix products. The
// card has one, and this kernel gathers.
//
// Input (ops/sparse_plan.column_layout, built once per X on the card from its
// COO): X in output-column CSR, colptr (spad + 1), and per nonzero gidx, the
// row of F^T it gathers, and its value; each column's nonzeros lie in
// ascending gidx, and no value is 0. F arrives as F^T
// (m, ldf) row-major, ldf a multiple of 16 bytes: W itself for W^T X.
//
//   out[r][c] = sum over the nonzeros i of column c of v_i * F^T[g_i][r]
//
// Design:
//
// - A block owns SG_NC consecutive output columns and cuts their nonzeros
//   into SG_WARPS equal runs, one per warp: work is balanced by nonzeros,
//   not by columns, and a long column (the Zipf words of a corpus) is cut
//   into pieces.
// - A warp walks its run 32 (g, v) pairs at a time, loaded coalesced (the
//   next 32 in flight meanwhile) and broadcast by shuffle. L lanes cover a
//   k-slice of a row with 16-byte loads (L = 4..32 by k), so 32/L nonzeros
//   go at once, and each lane has SG_U such loads in flight before its
//   first FMA. The 32/L partial sums of a column meet in a fixed shuffle
//   tree; with L = 32 (k > 64 in float32, k > 32 in float64) a column is
//   summed in layout order.
// - A column inside one warp's run goes to a shared (columns x slice) tile;
//   a column cut between warps leaves one partial per warp, added in warp
//   order. Empty columns are 0. No atomics: a launch repeats bit for bit.
// - The tile is written out row by row, SG_NC consecutive columns at a time
//   (coalesced); every output element is written, so out needs no memset.
// - k above one slice (32 lanes x 16 bytes: 128 floats, 64 doubles) runs
//   slice after slice in the same block, so any k >= 1 works. Shared memory
//   is ~17 KB a block whatever k is; 73 registers a thread at L = 32 in
//   float32 keep 3 blocks (24 warps) on an SM.
//
// SG_NC, SG_WARPS and SG_U were set on an H100 at the sparse fit's shape
// (the variants are in PERF.md): 16 columns a block (8 tie it) beat 32 and
// 64 by 7-20%, 8 warps beat 4, and 8 loads in flight tie 4 and beat 12 and
// 16.
//
// 16-bit factors (bfloat16, float16; JAX's narrow MXU dots): F^T's rows
// and the values are stored in 16 bits, read as 16-byte pieces of 8
// values, multiplied exactly in float32 and summed in float32 in the same
// order; the output is float32 (storage.cuh). A lane keeps its pieces
// packed (a uint4, 4 registers for 8 values) until the FMAs, which widen
// them in pairs (Piece<S, true>). SG_U16 = 4 pieces in flight a lane (64
// bytes) take 60-62 registers: 4 blocks (32 warps, 64 KB of rows in
// flight) an SM, where float32 holds 3 (73 registers, 8 pieces, 128 bytes
// a lane, 96 KB an SM).
//
// What bounds it on the H100: each nonzero reads one k-row of F^T (512 bytes
// at k = 128 in float32), nnz k sizeof(S) bytes gathered from L2 (F^T, 25.6
// MB for W at n = 50,000, stays in the 50 MB L2), plus 8 bytes of (g, v) per
// nonzero streamed from device memory. The DRAM bound (each byte once) is far
// below the L2 gather: the rate the L2 serves scattered rows sets the time,
// as it does for torch.sparse.mm of the CSR X. The 16-bit builds gather half
// the bytes (1.92 GB at 7.48M nonzeros, k = 128): at the float32 build's
// measured ~6.9 TB/s that is a 0.28 ms floor (PERF.md). Tensor cores are no
// lever: the 2 nnz k flop (1.9 GFLOP) take ~0.03 ms on the FMA pipes, a
// tenth of the gather, and an mma would still need every row gathered first.

#include <cuda_runtime.h>
#include <stdint.h>

#include "storage.cuh"

#define SG_NC 16       // output columns per block
#define SG_WARPS 8     // warps per block
#define SG_U 8         // row loads in flight per lane
#ifndef SG_U16
#define SG_U16 4       // row loads in flight per lane, 16-bit builds
#endif

#define FULL_MASK 0xffffffffu

// one 16-byte load of F^T through the read-only path
__device__ __forceinline__ void load16(const float* p, float (&r)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  r[0] = v.x;
  r[1] = v.y;
  r[2] = v.z;
  r[3] = v.w;
}

__device__ __forceinline__ void load16(const double* p, double (&r)[2]) {
  const double2 v = __ldg(reinterpret_cast<const double2*>(p));
  r[0] = v.x;
  r[1] = v.y;
}

// A 16-byte piece of a row of F^T as a lane holds it from its load to its
// FMAs, and U, the pieces a lane has in flight: float and double widened
// as loaded, SG_U deep; the 16-bit types packed until the FMAs, which
// widen them in pairs, SG_U16 deep.
template <typename S, bool = Storage<S>::narrow>
struct Piece;

template <typename S>
struct Piece<S, false> {
  static constexpr int U = SG_U;
  static constexpr int V = 16 / sizeof(S);
  S r[V];
  __device__ __forceinline__ void load(const S* p) { load16(p, r); }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < V; ++i) r[i] = (S)0;
  }
  __device__ __forceinline__ void fma_into(S w, S (&acc)[V]) const {
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = fma(w, r[i], acc[i]);
  }
};

template <typename S>
struct Piece<S, true> {
  static constexpr int U = SG_U16;
  uint4 r;
  __device__ __forceinline__ void load(const S* p) {
    r = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { r = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void fma_into(float w, float (&acc)[8]) const {
    const unsigned int h[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = Storage<S>::load2(h[i]);
      acc[2 * i] = fma(w, f.x, acc[2 * i]);
      acc[2 * i + 1] = fma(w, f.y, acc[2 * i + 1]);
    }
  }
};

// one value of the nonzeros, streamed past the caches
__device__ __forceinline__ float load_val(const float* p) {
  return __ldcs(p);
}
__device__ __forceinline__ double load_val(const double* p) {
  return __ldcs(p);
}
template <typename S>
__device__ __forceinline__ float load_val(const S* p) {
  return Storage<S>::bits(
      __ldcs(reinterpret_cast<const unsigned short*>(p)));
}

// acc += sum over nonzeros s..e-1 of v_i * F^T[g_i][col .. col + V) for
// this lane's group: group grp takes nonzeros j = grp, grp + G, ... of each
// 32; lanes of a group cover consecutive 16-byte pieces of the row. `on`:
// whether this lane's piece lies inside the k values.
template <typename S, typename T, int L>
__device__ __forceinline__ void run_sum(const S* __restrict__ Ft, long ldf,
                                        const int* __restrict__ gidx,
                                        const S* __restrict__ vals, int s,
                                        int e, int col, bool on,
                                        T (&acc)[16 / sizeof(S)]) {
  typedef Piece<S> P;
  constexpr int G = 32 / L;
  const int lane = threadIdx.x & 31;
  const int grp = lane / L;
  int gi = 0;
  T vi = 0;
  if (s + lane < e) {
    gi = __ldcs(gidx + s + lane);
    vi = load_val(vals + s + lane);
  }
  for (int base = s; base < e; base += 32) {
    const int n = min(32, e - base);
    const int g_cur = gi;
    const T v_cur = vi;
    if (base + 32 + lane < e) {       // the next 32 pairs, in flight
      gi = __ldcs(gidx + base + 32 + lane);
      vi = load_val(vals + base + 32 + lane);
    }
    for (int j0 = 0; j0 < n; j0 += G * P::U) {
      P r[P::U];
      T w[P::U];
#pragma unroll
      for (int u = 0; u < P::U; ++u) {
        const int j = j0 + u * G + grp;
        const int g = __shfl_sync(FULL_MASK, g_cur, j & 31);
        const T v = __shfl_sync(FULL_MASK, v_cur, j & 31);
        w[u] = j < n ? v : (T)0;
        if (j < n && on) {
          r[u].load(Ft + (long)g * ldf + col);
        } else {
          r[u].zero();
        }
      }
#pragma unroll
      for (int u = 0; u < P::U; ++u) r[u].fma_into(w[u], acc);
    }
  }
}

// S: the storage type of F^T and the values; T = Storage<S>::Work, that of
// the sums and the output
template <typename S, typename T, int L>
__global__ void __launch_bounds__(SG_WARPS * 32)
    gather_kernel(const S* __restrict__ Ft, long ldf,
                  const int* __restrict__ colptr,
                  const int* __restrict__ gidx, const S* __restrict__ vals,
                  T* __restrict__ out, long ldo, int ncols, int k) {
  constexpr int V = 16 / sizeof(S);   // values per 16-byte load
  constexpr int SW = L * V;           // width of a k-slice
  constexpr int TS = SW + 1;          // tile row stride (odd: no conflicts)
  __shared__ T tile[SG_NC * TS];      // tile[c][r]: column c, slice row r
  __shared__ T piece[SG_WARPS * 2 * SW];  // a warp's first and last piece
  __shared__ int cp[SG_NC + 1];       // colptr of the block's columns

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gl = lane % L;
  const int c0 = blockIdx.x * SG_NC;
  const int cn = min(SG_NC, ncols - c0);
  for (int i = threadIdx.x; i <= cn; i += blockDim.x) cp[i] = colptr[c0 + i];
  __syncthreads();
  // the block's nonzeros lo..hi-1; warp w's run is a_w..b_w-1, q each
  const int lo = cp[0], hi = cp[cn];
  const int q = (hi - lo + SG_WARPS - 1) / SG_WARPS;
  const int a = min(hi, lo + warp * q), b = min(hi, a + q);

  for (int k0 = 0; k0 < k; k0 += SW) {
    const int col = k0 + gl * V;
    const bool on = col < k;
    if (a < b) {
      int c = 0;
      while (cp[c + 1] <= a) ++c;         // the column holding nonzero a
      for (int s = a; s < b;) {
        const int e = min(b, cp[c + 1]);
        T acc[V];
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = (T)0;
        run_sum<S, T, L>(Ft, ldf, gidx, vals, s, e, col, on, acc);
        // the groups' partial sums, in a fixed tree
#pragma unroll
        for (int off = L; off < 32; off <<= 1) {
#pragma unroll
          for (int i = 0; i < V; ++i) {
            acc[i] += __shfl_xor_sync(FULL_MASK, acc[i], off);
          }
        }
        if (lane < L) {
          // whole column: the tile; else piece 0 if the column holds a
          // (the run's first), piece 1 if it holds b - 1 (the run's last)
          T* dst = (cp[c] >= a && cp[c + 1] <= b)
                       ? tile + c * TS
                       : piece + (warp * 2 + (cp[c] <= a ? 0 : 1)) * SW;
#pragma unroll
          for (int i = 0; i < V; ++i) dst[gl * V + i] = acc[i];
        }
        s = e;
        ++c;
        while (c < cn && cp[c + 1] <= s) ++c;   // skip empty columns
      }
    }
    __syncthreads();
    // columns cut between warps: their pieces in warp order; empty: 0
    for (int i = threadIdx.x; i < cn * SW; i += blockDim.x) {
      const int c = i / SW, r = i % SW;
      const int s0 = cp[c], s1 = cp[c + 1];
      if (s0 == s1) {
        tile[c * TS + r] = (T)0;
        continue;
      }
      const int w0 = (s0 - lo) / q, w1 = (s1 - 1 - lo) / q;
      if (w0 == w1) continue;
      T sum = piece[(w0 * 2 + (lo + w0 * q == s0 ? 0 : 1)) * SW + r];
      for (int w = w0 + 1; w <= w1; ++w) sum += piece[w * 2 * SW + r];
      tile[c * TS + r] = sum;
    }
    __syncthreads();
    // out[k0 + r][c0 + c], consecutive threads on consecutive columns
    const int rows = min(SW, k - k0);
    for (int i = threadIdx.x; i < rows * SG_NC; i += blockDim.x) {
      const int r = i / SG_NC, c = i % SG_NC;
      if (c < cn) out[(long)(k0 + r) * ldo + c0 + c] = tile[c * TS + r];
    }
    __syncthreads();                      // tile and pieces are reused
  }
}

// ---------------------------------------------------------------------------
// launcher
// ---------------------------------------------------------------------------

// lanes that cover one k-slice of a row: 4, 8, 16 or 32 (k in 16 bytes)
template <typename S>
static int slice_lanes(int k) {
  constexpr int V = 16 / sizeof(S);
  const int lanes = (k + V - 1) / V;
  return lanes <= 4 ? 4 : lanes <= 8 ? 8 : lanes <= 16 ? 16 : 32;
}

template <typename S, typename T, int L>
static void launch_l(const S* Ft, long ldf, const int* colptr,
                     const int* gidx, const S* vals, T* out, long ldo,
                     int ncols, int k, cudaStream_t stream) {
  const int blocks = (ncols + SG_NC - 1) / SG_NC;
  gather_kernel<S, T, L><<<blocks, SG_WARPS * 32, 0, stream>>>(
      Ft, ldf, colptr, gidx, vals, out, ldo, ncols, k);
}

template <typename S, typename T>
static int launch_gather(const S* Ft, int ldf, const int* colptr,
                         const int* gidx, const S* vals, T* out, int k,
                         int ncols, int ldo, int device, void* stream) {
  constexpr int V = 16 / sizeof(S);
  if (k < 1 || ncols < 1 || ldf < k || ldf % V || ldo < ncols) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (slice_lanes<S>(k)) {
    case 4:
      launch_l<S, T, 4>(Ft, ldf, colptr, gidx, vals, out, ldo, ncols, k, s);
      break;
    case 8:
      launch_l<S, T, 8>(Ft, ldf, colptr, gidx, vals, out, ldo, ncols, k, s);
      break;
    case 16:
      launch_l<S, T, 16>(Ft, ldf, colptr, gidx, vals, out, ldo, ncols, k,
                         s);
      break;
    default:
      launch_l<S, T, 32>(Ft, ldf, colptr, gidx, vals, out, ldo, ncols, k,
                         s);
  }
  return (int)cudaGetLastError();
}

#define SPARSE_API(SUF, S, T)                                                \
  extern "C" int rri_sparse_gather_##SUF(                                    \
      const void* Ft, const void* colptr, const void* gidx,                  \
      const void* vals, void* out, int k, int ldf, int ncols, int ldo,       \
      int device, void* stream) {                                            \
    return launch_gather<S, T>((const S*)Ft, ldf, (const int*)colptr,        \
                               (const int*)gidx, (const S*)vals, (T*)out, k, \
                               ncols, ldo, device, stream);                  \
  }

SPARSE_API(f32, float, float)
SPARSE_API(f64, double, double)
SPARSE_API(bf16, __nv_bfloat16, float)
SPARSE_API(f16, __half, float)
