// Sparse matrix times vector, out = X t, from X's nonzeros in CSR: the W
// side's per-topic product X @ T[t] of the interleaved sweep
// (ops/sweep.py), where X is mostly zeros.
//
// Replaces no TPU kernel. The JAX package (and the port before it) forms
// this product as a dense GEMV (XLA's dot; cuBLAS's gemv2T on the card),
// which reads the whole dense X once per topic: 1.19 GB at the 20
// Newsgroups shape (11,314 x 26,214 float32), k times a sweep, at ~87% of
// HBM's rate. At 0.67% density the nonzeros are 16 MB. This kernel reads
// those and nothing else; the dense X stays for the products that need it
// (W^T X once a sweep, the objective, the reset scan).
//
// Input (ops/spmv.rows_of, built once per X on the card from the dense X,
// so the values are X's own): rowptr (n + 1), per nonzero its column and
// value, in row order; and blocks (nb + 1), the first row of each block's
// share, cut so that each block holds about the same number of nonzeros.
//
//   out[i] = sum over the nonzeros j of row i of v_j * t[col_j]
//
// Its bound is bytes: 8 per nonzero, 4 (n + 1) of row pointers, the
// vector t (4 d, L1/L2-resident: 105 KB here) and the output (4 n): 16.1 MB
// at the 20 Newsgroups shape, 4.8 us at HBM's 3.35 TB/s. The CSR fits the
// 50 MB L2 beside the sweep's other operands, so of the k products a sweep
// only those after a pass over the dense X (W^T X) find it in HBM; the rest
// read it from L2, and the launch's own latency is of the same order.
//
// Design:
//
// - A block owns a range of whole rows holding about ops/spmv.CHUNK
//   nonzeros (the host cuts them; a row longer makes its block longer,
//   never one warp), and cuts its nonzeros into SV_WARPS equal runs, one a
//   warp: work is balanced by nonzeros, not by rows, as TF-IDF rows run
//   from ten to thousands of nonzeros.
// - A warp walks each row's part of its run with one lane a nonzero: the
//   (col, val) pairs load coalesced, SV_U loads in flight a lane, then the
//   gathers of t[col]. Lane j sums nonzeros j, j + 32, ... in order, and
//   the 32 partial sums meet in a fixed shuffle tree.
// - A row inside one warp's run is written by that warp. A row cut between
//   warps leaves one partial per warp in shared memory, which the row's
//   first warp adds up in warp order after a barrier. Empty rows are 0.
//   No atomics: a launch repeats bit for bit, and every output element is
//   written, so out needs no memset.
// - Products and sums are in the storage type (float32, float64), as the
//   GEMV forms them: a skipped zero adds exactly 0; only the order of the
//   sums differs.
//
// On the H100 at the 20 Newsgroups shape (PERF.md §6): 12.4-12.7 us a
// launch replayed in a CUDA graph (the CSR in L2), 18.0 us after L2 is
// flushed, against the GEMV's 0.39-0.40 ms. SV_U 2, 4 or 8, SV_WARPS 4 or 8
// and 1024-4096 nonzeros a block (ops/spmv.CHUNK) tie within 5%: the time
// is the chain of dependent loads a warp walks (its block's row range,
// the row pointers, the pairs, then the gathers), not the bytes.

#include <cuda_runtime.h>

#ifndef SV_WARPS
#define SV_WARPS 8     // warps per block
#endif
#ifndef SV_U
#define SV_U 4         // (col, val) loads in flight per lane
#endif

#define FULL_MASK 0xffffffffu

// this lane's sum over nonzeros s..e-1 (lane j: s + j, s + j + 32, ...),
// then the warp's total in every lane by a fixed tree
template <typename S>
__device__ __forceinline__ S row_sum(const int* __restrict__ cols,
                                     const S* __restrict__ vals,
                                     const S* __restrict__ t, int s, int e,
                                     int lane) {
  S acc = (S)0;
  for (int j0 = s + lane; j0 < e; j0 += 32 * SV_U) {
    int c[SV_U];
    S v[SV_U];
#pragma unroll
    for (int u = 0; u < SV_U; ++u) {
      const int j = j0 + 32 * u;
      c[u] = j < e ? __ldg(cols + j) : 0;
      v[u] = j < e ? __ldg(vals + j) : (S)0;
    }
    S x[SV_U];
#pragma unroll
    for (int u = 0; u < SV_U; ++u) {
      x[u] = j0 + 32 * u < e ? __ldg(t + c[u]) : (S)0;
    }
#pragma unroll
    for (int u = 0; u < SV_U; ++u) {
      if (j0 + 32 * u < e) acc = fma(v[u], x[u], acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(FULL_MASK, acc, off);
  }
  return acc;
}

// the last row r in [lo, hi) with rowptr[r] <= j (rowptr[lo] <= j <
// rowptr[hi]): the row holding nonzero j, never an empty one
__device__ __forceinline__ int row_of(const int* __restrict__ rowptr, int lo,
                                      int hi, int j) {
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (rowptr[mid] <= j) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <typename S>
__global__ void __launch_bounds__(SV_WARPS * 32)
    spmv_kernel(const int* __restrict__ rowptr, const int* __restrict__ cols,
                const S* __restrict__ vals, const int* __restrict__ blocks,
                const S* __restrict__ t, S* __restrict__ out) {
  __shared__ S piece[SV_WARPS * 2];  // a warp's first and last partial
  __shared__ int cut[SV_WARPS];      // the row a warp's run leaves unfinished

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = blocks[blockIdx.x], r1 = blocks[blockIdx.x + 1];
  // the block's nonzeros lo..hi-1; warp w's run is a..b-1, q each
  const int lo = rowptr[r0], hi = rowptr[r1];
  const int q = (hi - lo + SV_WARPS - 1) / SV_WARPS;
  const int a = min(hi, lo + warp * q), b = min(hi, a + q);

  for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    if (rowptr[r] == rowptr[r + 1]) out[r] = (S)0;
  }
  int left = -1;
  if (a < b) {
    int r = row_of(rowptr, r0, r1, a);    // the row holding nonzero a
    for (int s = a; s < b;) {
      const int rs = rowptr[r], re = rowptr[r + 1];
      const int e = min(b, re);
      const S sum = row_sum(cols, vals, t, s, e, lane);
      if (rs >= a && re <= b) {
        if (lane == 0) out[r] = sum;
      } else {
        // cut: piece 0 if the row holds a (the run's first nonzero), else
        // piece 1 (it holds b - 1, the run's last)
        if (lane == 0) piece[warp * 2 + (rs <= a ? 0 : 1)] = sum;
        if (rs >= a) left = r;            // begun here, finished later
      }
      s = e;
      ++r;
      while (r < r1 && rowptr[r + 1] <= s) ++r;
    }
  }
  if (lane == 0) cut[warp] = left;
  __syncthreads();
  // a row cut between warps, by the warp it began in: its pieces in warp
  // order
  if (threadIdx.x < SV_WARPS && cut[threadIdx.x] >= 0) {
    const int w0 = threadIdx.x;
    const int r = cut[w0];
    const int rs = rowptr[r], re = rowptr[r + 1];
    const int w1 = (re - 1 - lo) / q;
    S sum = piece[w0 * 2 + (rs == lo + w0 * q ? 0 : 1)];
    for (int w = w0 + 1; w <= w1; ++w) sum += piece[w * 2];
    out[r] = sum;
  }
}

// ---------------------------------------------------------------------------
// launcher
// ---------------------------------------------------------------------------

template <typename S>
static int launch_spmv(const int* rowptr, const int* cols, const S* vals,
                       const int* blocks, const S* t, S* out, int nblocks,
                       int device, void* stream) {
  if (nblocks < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  spmv_kernel<S><<<nblocks, SV_WARPS * 32, 0, (cudaStream_t)stream>>>(
      rowptr, cols, vals, blocks, t, out);
  return (int)cudaGetLastError();
}

#define SPMV_API(SUF, S)                                                   \
  extern "C" int rri_spmv_##SUF(const void* rowptr, const void* cols,      \
                                const void* vals, const void* blocks,      \
                                const void* t, void* out, int nblocks,     \
                                int device, void* stream) {                \
    return launch_spmv<S>((const int*)rowptr, (const int*)cols,            \
                          (const S*)vals, (const int*)blocks, (const S*)t, \
                          (S*)out, nblocks, device, stream);               \
  }

SPMV_API(f32, float)
SPMV_API(f64, double)
