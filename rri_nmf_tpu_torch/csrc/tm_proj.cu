// Projected Gauss-Seidel T-phase of the topic-model fit (kernel B2).
//
// Replaces the Pallas kernel rri_nmf_tpu/ops/dense_pallas.py
// (_make_tm_proj_kernel / _tm_proj_call). For each topic t in order,
// `reps` times, over the whole (k, d) panel:
//
//   numer = N[t] - G[t,:] F + G[t,t] F[t] - l1,   denom = G[t,t] + l2
//   denom > 0:  v = max(numer, 0) / (denom + eps), then the exact
//               projection of v onto {x >= 0, sum x = s}
//   otherwise:  all mass s on the first argmax of numer (the first
//               argmin of -numer)
//   then re-project the row when |sum(row) - s| > 1e-15.
//
// The projection is Michelot's active-set fixpoint, as in the TPU kernel:
// from tau = (sum v - s) / d iterate tau <- (sum_{v>tau} v - s) / |{v>tau}|
// until the active count stops changing (at most d+2 rounds), with the
// already-feasible shortcut (sum v == s and min v >= 0 returns v).
//
// What bounds it on the H100: the simplex threshold couples all d
// columns of a row and the topics run in order, so the whole phase is one
// serial chain of k numerators and projections. It runs in ONE block, on
// one of the 132 SMs: the k*k*d Gram corrections are read by that SM
// from L2 (the (k, d) panel, 5.2 MB at k=50, d=26214 in float32, stays
// L2-resident), and each Michelot round is two block-wide reductions.
//
// Design: 1024 threads; thread i owns columns i, i+1024, ... for every
// pass (numerator, reductions, write-back), so a thread only ever reads
// the columns it wrote itself and the topic loop needs no barrier beyond
// those inside the reductions. The working row v sits in shared memory
// (105 KB at d=26214 in float32), the Gram row of the current topic next
// to it. Splitting the numerator over many blocks, or a thread-block
// cluster sharing the row through distributed shared memory, is left to
// a later change.

#include <cuda_runtime.h>
#include <math_constants.h>

#define TM_THREADS 1024
#define TM_WARPS (TM_THREADS / 32)

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__device__ __forceinline__ T warp_min(T x) {
  for (int o = 16; o > 0; o >>= 1) {
    T y = __shfl_down_sync(0xffffffffu, x, o);
    x = y < x ? y : x;
  }
  return x;
}

// Block-wide sum: every thread gets the total. The leading barrier keeps
// the previous call's broadcast slot alive until all threads read it.
template <typename T>
__device__ T block_sum(T x, T* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  x = warp_sum(x);
  __syncthreads();
  if (lane == 0) red[wid] = x;
  __syncthreads();
  if (wid == 0) {
    x = warp_sum(lane < TM_WARPS ? red[lane] : (T)0);
    if (lane == 0) red[TM_WARPS] = x;
  }
  __syncthreads();
  return red[TM_WARPS];
}

template <typename T>
__device__ T block_min(T x, T* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  x = warp_min(x);
  __syncthreads();
  if (lane == 0) red[wid] = x;
  __syncthreads();
  if (wid == 0) {
    x = warp_min(lane < TM_WARPS ? red[lane] : (T)CUDART_INF);
    if (lane == 0) red[TM_WARPS] = x;
  }
  __syncthreads();
  return red[TM_WARPS];
}

// Block-wide (max value, first index): ties go to the smaller index.
template <typename T>
__device__ int block_argmax(T val, int idx, T* red, int* redi) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    T ov = __shfl_down_sync(0xffffffffu, val, o);
    int oi = __shfl_down_sync(0xffffffffu, idx, o);
    if (ov > val || (ov == val && oi < idx)) { val = ov; idx = oi; }
  }
  __syncthreads();
  if (lane == 0) { red[wid] = val; redi[wid] = idx; }
  __syncthreads();
  if (wid == 0) {
    val = red[lane];
    idx = redi[lane];
    for (int o = 16; o > 0; o >>= 1) {
      T ov = __shfl_down_sync(0xffffffffu, val, o);
      int oi = __shfl_down_sync(0xffffffffu, idx, o);
      if (ov > val || (ov == val && oi < idx)) { val = ov; idx = oi; }
    }
    if (lane == 0) redi[TM_WARPS] = idx;
  }
  __syncthreads();
  return redi[TM_WARPS];
}

// Exact projection of the shared row v (d entries, nonnegative) onto the
// simplex of sum s, in place. Every thread calls it; control flow is
// uniform because every branch reads block-wide totals.
template <typename T>
__device__ void michelot(T* v, int d, T s, T* red, int* redi) {
  const int tid = threadIdx.x;
  T ls = 0, lm = (T)CUDART_INF;
  for (int j = tid; j < d; j += TM_THREADS) {
    ls += v[j];
    lm = v[j] < lm ? v[j] : lm;
  }
  const T sv = block_sum(ls, red);
  const T mn = block_min(lm, red);
  if (sv == s && mn >= 0) return;
  T tau = (sv - s) / (T)d;
  int m_prev = d + 1;
  bool changed = true;
  for (int it = 0; changed && it < d + 2; ++it) {
    T as = 0, ac = 0;
    for (int j = tid; j < d; j += TM_THREADS) {
      if (v[j] > tau) { as += v[j]; ac += 1; }
    }
    const T ssum = block_sum(as, red);
    // counts are exact in T below 2^24 (float) columns
    const int m = (int)block_sum(ac, red);
    tau = (ssum - s) / (T)(m > 1 ? m : 1);
    changed = m != m_prev;
    m_prev = m;
  }
  for (int j = tid; j < d; j += TM_THREADS) v[j] = v[j] > tau ? v[j] - tau : (T)0;
}

template <typename T>
__global__ void __launch_bounds__(TM_THREADS, 1)
tm_proj_kernel(const T* __restrict__ G, const T* __restrict__ N,
               const T* __restrict__ F, T* __restrict__ out, int k, int d,
               T l1, T l2, T s, int reps) {
  extern __shared__ unsigned char smem_raw[];
  T* v = reinterpret_cast<T*>(smem_raw);       // the working row (d)
  T* g = v + d;                                // G[t, :] (k)
  __shared__ T red[TM_WARPS + 1];
  __shared__ int redi[TM_WARPS + 1];
  const int tid = threadIdx.x;
  const T eps = (T)1.7763568394002505e-15;     // np.spacing(10)

  // each thread copies exactly the columns it owns
  for (int t = 0; t < k; ++t)
    for (int j = tid; j < d; j += TM_THREADS)
      out[(long)t * d + j] = F[(long)t * d + j];

  for (int r = 0; r < reps; ++r) {
    for (int t = 0; t < k; ++t) {
      __syncthreads();                         // g is rewritten below
      for (int i = tid; i < k; i += TM_THREADS) g[i] = G[(long)t * k + i];
      __syncthreads();
      const T gtt = g[t];
      const T denom = gtt + l2;
      const T* Nt = N + (long)t * d;
      T* Ft = out + (long)t * d;
      if (denom > 0) {
        for (int j = tid; j < d; j += TM_THREADS) {
          T corr = 0;
          for (int q = 0; q < k; ++q) corr += g[q] * out[(long)q * d + j];
          const T numer = Nt[j] - corr + gtt * Ft[j] - l1;
          v[j] = (numer > 0 ? numer : (T)0) / (denom + eps);
        }
        michelot(v, d, s, red, redi);
      } else {
        T best = -(T)CUDART_INF;
        int bidx = d;
        for (int j = tid; j < d; j += TM_THREADS) {
          T corr = 0;
          for (int q = 0; q < k; ++q) corr += g[q] * out[(long)q * d + j];
          const T numer = Nt[j] - corr + gtt * Ft[j] - l1;
          if (numer > best) { best = numer; bidx = j; }
        }
        const int idx = block_argmax(best, bidx, red, redi);
        for (int j = tid; j < d; j += TM_THREADS) v[j] = j == idx ? s : (T)0;
      }
      // drift re-projection: |sum(row) - s| > 1e-15 (nearly always in
      // float32, as in the TPU kernel)
      T ls = 0;
      for (int j = tid; j < d; j += TM_THREADS) ls += v[j];
      const T rs = block_sum(ls, red);
      if (fabs(rs - s) > (T)1e-15) michelot(v, d, s, red, redi);
      for (int j = tid; j < d; j += TM_THREADS) Ft[j] = v[j];
    }
  }
}

template <typename T>
static int launch_tm_proj(const T* G, const T* N, const T* F, T* out, int k,
                          int d, T l1, T l2, T s, int reps, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  size_t smem = (size_t)(d + k) * sizeof(T);
  err = cudaFuncSetAttribute(tm_proj_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  tm_proj_kernel<T><<<1, TM_THREADS, smem, (cudaStream_t)stream>>>(
      G, N, F, out, k, d, l1, l2, s, reps);
  return (int)cudaGetLastError();
}

extern "C" int rri_tm_proj_f32(const void* G, const void* N, const void* F,
                               void* out, int k, int d, float l1, float l2,
                               float s, int reps, int device, void* stream) {
  return launch_tm_proj<float>((const float*)G, (const float*)N,
                               (const float*)F, (float*)out, k, d, l1, l2, s,
                               reps, device, stream);
}

extern "C" int rri_tm_proj_f64(const void* G, const void* N, const void* F,
                               void* out, int k, int d, double l1, double l2,
                               double s, int reps, int device, void* stream) {
  return launch_tm_proj<double>((const double*)G, (const double*)N,
                                (const double*)F, (double*)out, k, d, l1, l2,
                                s, reps, device, stream);
}
