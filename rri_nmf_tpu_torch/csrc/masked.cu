// Streaming passes of the masked WRRI sweep (kernels B3 and B4).
//
// Replace the Pallas kernels of rri_nmf_tpu/ops/sweep_pallas.py:
//
//   B3  _phase_a_kernel / _phase_a, the T-phase pass of one topic:
//         R += dw t_prev^T                      (in place)
//         wR0 = w^T (M . R),   nw = (w*w)^T M   (column sums, (d,))
//   B4  _phase_b_kernel / _phase_b, the W-phase pass of one topic, and
//       with w_eff = 0 the whole fixed-T (transform) sweep:
//         R += w t_old^T - w_eff t_new^T        (in place)
//         Rt = (M . R) t_new,  mt2 = M (t_new*t_new)   (row sums, (n,))
//
// R (the residual X - W T) and M (the mask) are (n, d) row-major; the
// vectors are contiguous. Nothing is padded: the ragged edge is masked by
// the index checks, so no coordinate outside (n, d) is ever read, written
// or given mass.
//
// What bounds them on the H100: device memory. Each launch reads R and M
// and writes R, 3 n d words (12 n d bytes in float32: 286 MB at the
// MovieLens-1M shape 6040 x 3952, against 4 flop per element). R and M
// together (191 MB) do not fit the 50 MB L2, so every topic streams them
// from device memory twice (once per kernel). The designs aim at full
// coalescing and enough loads in flight to cover the memory latency:
// every thread issues the loads of DEPTH rows (B3) or column steps (B4)
// before it uses any of them, since a warp issues in order and would
// otherwise wait out each load's latency alone.
//
// B3 sums over rows. Neighbouring threads take neighbouring columns, so a
// warp reads 32 consecutive words of one row. A block owns a stripe of
// A_COLS columns and a fixed chunk of rows; 31 stripes at d = 3952 would
// leave most of the 132 SMs idle, so the wrapper splits the rows into
// chunks too (grid.y; 32 rows each, several waves of blocks) and each
// block writes its partial sums to a (2, chunks, d) scratch. A second
// small kernel adds the chunks in order.
//
// B4 sums over columns. One warp owns one row and walks its columns
// (lane j, j + 32, ...), so each step reads 32 consecutive words; a
// fixed shuffle tree then adds the 32 lane sums. 6040 rows are 1510
// blocks of 4 warps: one wave, 11-12 blocks on every SM.
//
// No atomics: every sum is taken in a fixed order, so a fit repeats bit
// for bit. Sums are accumulated in the working dtype (float32 or float64),
// as the TPU kernels' _acc_of does for those dtypes.
//
// Numerics against the plain PyTorch twins (ops/masked_kernels.py): the
// kernels compute the rank-one updates as fused multiply-adds,
// R + dw*t_prev = fma(dw, t_prev, R), where torch rounds the product and
// the sum separately; that is one rounding of difference per update, and
// the reductions add in another order than the twins' GEMVs.

#include <cuda_runtime.h>

#define A_COLS 128    // columns (threads) per B3 block
#define SUM_COLS 32   // columns per block of the chunk sum ...
#define SUM_LANES 8   // ... and threads per column
#define B_ROWS 4      // rows (warps) per B4 block
#ifndef DEPTH
#define DEPTH 8       // loads in flight per thread and array
#endif

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T>
__global__ void phase_a_kernel(T* __restrict__ R, const T* __restrict__ M,
                               const T* __restrict__ dw,
                               const T* __restrict__ tp,
                               const T* __restrict__ w, T* __restrict__ part,
                               int n, int d, int chunks, int rows) {
  const int j = blockIdx.x * A_COLS + threadIdx.x;
  if (j >= d) return;
  const int c = blockIdx.y;
  const int i0 = c * rows;
  const int i1 = min(n, i0 + rows);
  const T tpj = tp[j];
  T s_wr = 0, s_nw = 0;
  int i = i0;
  for (; i + DEPTH <= i1; i += DEPTH) {
    T r[DEPTH], m[DEPTH];
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      const size_t o = (size_t)(i + u) * d + j;
      r[u] = R[o];
      m[u] = M[o];
    }
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      r[u] = fma_(dw[i + u], tpj, r[u]);
      R[(size_t)(i + u) * d + j] = r[u];
      const T wi = w[i + u];
      s_wr = fma_(wi, m[u] * r[u], s_wr);
      s_nw = fma_(wi * wi, m[u], s_nw);
    }
  }
  for (; i < i1; ++i) {
    const size_t o = (size_t)i * d + j;
    const T r = fma_(dw[i], tpj, R[o]);
    R[o] = r;
    const T m = M[o];
    const T wi = w[i];
    s_wr = fma_(wi, m * r, s_wr);
    s_nw = fma_(wi * wi, m, s_nw);
  }
  part[(size_t)c * d + j] = s_wr;
  part[((size_t)chunks + c) * d + j] = s_nw;
}

// Adds the B3 partial sums over the chunks: thread (x, y) of a block sums
// chunks y, y + SUM_LANES, ... of column x, then thread (x, 0) adds the
// SUM_LANES results in order. The order is fixed by the shape alone.
template <typename T>
__global__ void chunk_sum_kernel(const T* __restrict__ part,
                                 T* __restrict__ wR0, T* __restrict__ nw,
                                 int d, int chunks) {
  __shared__ T sa[SUM_LANES][SUM_COLS], sb[SUM_LANES][SUM_COLS];
  const int x = threadIdx.x, y = threadIdx.y;
  const int j = blockIdx.x * SUM_COLS + x;
  T a = 0, b = 0;
  if (j < d) {
    for (int c = y; c < chunks; c += SUM_LANES) {
      a += part[(size_t)c * d + j];
      b += part[((size_t)chunks + c) * d + j];
    }
  }
  sa[y][x] = a;
  sb[y][x] = b;
  __syncthreads();
  if (y == 0 && j < d) {
    for (int l = 1; l < SUM_LANES; ++l) {
      a += sa[l][x];
      b += sb[l][x];
    }
    wR0[j] = a;
    nw[j] = b;
  }
}

template <typename T>
__global__ void phase_b_kernel(T* __restrict__ R, const T* __restrict__ M,
                               const T* __restrict__ w,
                               const T* __restrict__ weff,
                               const T* __restrict__ told,
                               const T* __restrict__ tnew,
                               T* __restrict__ Rt, T* __restrict__ mt2, int n,
                               int d) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * B_ROWS + (threadIdx.x >> 5);
  if (i >= n) return;  // the whole warp leaves together
  const T wi = w[i];
  const T ei = -weff[i];
  T* Ri = R + (size_t)i * d;
  const T* Mi = M + (size_t)i * d;
  T s_rt = 0, s_mt2 = 0;
  int j = lane;
  for (; j + 32 * (DEPTH - 1) < d; j += 32 * DEPTH) {
    T r[DEPTH], m[DEPTH];
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      r[u] = Ri[j + 32 * u];
      m[u] = Mi[j + 32 * u];
    }
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      const int jj = j + 32 * u;
      const T tn = tnew[jj];
      r[u] = fma_(ei, tn, fma_(wi, told[jj], r[u]));
      Ri[jj] = r[u];
      s_rt = fma_(m[u] * r[u], tn, s_rt);
      s_mt2 = fma_(m[u], tn * tn, s_mt2);
    }
  }
  for (; j < d; j += 32) {
    const T tn = tnew[j];
    const T r = fma_(ei, tn, fma_(wi, told[j], Ri[j]));
    Ri[j] = r;
    const T m = Mi[j];
    s_rt = fma_(m * r, tn, s_rt);
    s_mt2 = fma_(m, tn * tn, s_mt2);
  }
  for (int off = 16; off > 0; off >>= 1) {
    s_rt += __shfl_down_sync(0xffffffffu, s_rt, off);
    s_mt2 += __shfl_down_sync(0xffffffffu, s_mt2, off);
  }
  if (lane == 0) {
    Rt[i] = s_rt;
    mt2[i] = s_mt2;
  }
}

template <typename T>
static int launch_phase_a(T* R, const T* M, const T* dw, const T* tp,
                          const T* w, T* part, T* wR0, T* nw, int n, int d,
                          int chunks, int device, void* stream) {
  if (n <= 0 || d <= 0 || chunks <= 0 || chunks > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int rows = (n + chunks - 1) / chunks;
  dim3 grid((d + A_COLS - 1) / A_COLS, chunks);
  phase_a_kernel<T><<<grid, A_COLS, 0, (cudaStream_t)stream>>>(
      R, M, dw, tp, w, part, n, d, chunks, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chunk_sum_kernel<T><<<(d + SUM_COLS - 1) / SUM_COLS,
                        dim3(SUM_COLS, SUM_LANES), 0,
                        (cudaStream_t)stream>>>(part, wR0, nw, d, chunks);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_phase_b(T* R, const T* M, const T* w, const T* weff,
                          const T* told, const T* tnew, T* Rt, T* mt2, int n,
                          int d, int device, void* stream) {
  if (n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  phase_b_kernel<T><<<(n + B_ROWS - 1) / B_ROWS, 32 * B_ROWS, 0,
                      (cudaStream_t)stream>>>(R, M, w, weff, told, tnew, Rt,
                                              mt2, n, d);
  return (int)cudaGetLastError();
}

extern "C" int rri_masked_phase_a_f32(void* R, const void* M, const void* dw,
                                      const void* tp, const void* w,
                                      void* part, void* wR0, void* nw, int n,
                                      int d, int chunks, int device,
                                      void* stream) {
  return launch_phase_a<float>((float*)R, (const float*)M, (const float*)dw,
                               (const float*)tp, (const float*)w,
                               (float*)part, (float*)wR0, (float*)nw, n, d,
                               chunks, device, stream);
}

extern "C" int rri_masked_phase_a_f64(void* R, const void* M, const void* dw,
                                      const void* tp, const void* w,
                                      void* part, void* wR0, void* nw, int n,
                                      int d, int chunks, int device,
                                      void* stream) {
  return launch_phase_a<double>((double*)R, (const double*)M,
                                (const double*)dw, (const double*)tp,
                                (const double*)w, (double*)part,
                                (double*)wR0, (double*)nw, n, d, chunks,
                                device, stream);
}

extern "C" int rri_masked_phase_b_f32(void* R, const void* M, const void* w,
                                      const void* weff, const void* told,
                                      const void* tnew, void* Rt, void* mt2,
                                      int n, int d, int device, void* stream) {
  return launch_phase_b<float>((float*)R, (const float*)M, (const float*)w,
                               (const float*)weff, (const float*)told,
                               (const float*)tnew, (float*)Rt, (float*)mt2, n,
                               d, device, stream);
}

extern "C" int rri_masked_phase_b_f64(void* R, const void* M, const void* w,
                                      const void* weff, const void* told,
                                      const void* tnew, void* Rt, void* mt2,
                                      int n, int d, int device, void* stream) {
  return launch_phase_b<double>((double*)R, (const double*)M,
                                (const double*)w, (const double*)weff,
                                (const double*)told, (const double*)tnew,
                                (double*)Rt, (double*)mt2, n, d, device,
                                stream);
}
