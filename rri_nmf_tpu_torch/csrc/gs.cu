// Gauss-Seidel topic loop of the dense phase sweep (kernel B1).
//
// Replaces the Pallas kernel rri_nmf_tpu/ops/dense_pallas.py
// (_make_gs_kernel / _gs_call). Given the frozen factor's Gram G (k, k),
// the numerator panel N (k, m) (W^T X for the T-phase, T X^T for the
// W-phase on W^T) and the factor F (k, m), it updates the k rows of F in
// topic order, `reps` times:
//
//   numer = N[t] - G[t,:] F + G[t,t] F[t] - l1,   denom = G[t,t] + l2
//   F[t]  = max(numer, 0) / (denom + eps)               if denom > 0
//   F[t]  = (denom - numer < 0) ? ub : 0                otherwise
//
// (the scalar-curvature branches of rri_nmf_tpu/optimization.py
// qf_min_scalar_c with s = None). Rows before t already hold their new
// values, rows after t the old ones, and +G[t,t] F[t] removes the self
// term with the old value: that is the Gauss-Seidel order.
//
// What bounds it on the H100: the k*k*m fused multiply-adds of the
// Gram corrections (2 k^2 m flop per pass), each reading G[t,s] and
// F[s, column]; the factor itself crosses device memory once in and once
// out (plus one read of N per topic). At k=128, m=16384 that is 0.5
// GFLOP against 25 MB.
//
// Design: the columns are independent, so one thread owns one column
// and runs the whole topic loop on it — no synchronisation inside the
// loop. A block of GS_COLS threads keeps its (k, GS_COLS) strip of F in
// shared memory (each thread reads only its own column: consecutive
// threads hit consecutive banks) and, when it fits beside the strip, the
// whole Gram (every thread reads the same G[t,s]: a broadcast). A Gram
// too large for shared memory is read from device memory instead, where
// all threads of a warp read the same address and L1/L2 serve it. Two
// partial sums per dot product halve the dependent-add chain.

#include <cuda_runtime.h>

#define GS_COLS 64

template <typename T>
__global__ void gs_kernel(const T* __restrict__ G, const T* __restrict__ N,
                          const T* __restrict__ F, const T* __restrict__ ub,
                          T* __restrict__ out, int k, int m, T l1, T l2,
                          T bound, int reps, int g_in_smem) {
  extern __shared__ unsigned char smem_raw[];
  T* Fs = reinterpret_cast<T*>(smem_raw);      // (k, GS_COLS) strip
  T* Gs = Fs + (size_t)k * GS_COLS;            // (k, k) when it fits
  const int tid = threadIdx.x;
  const long j = (long)blockIdx.x * GS_COLS + tid;
  const bool valid = j < m;

  if (g_in_smem) {
    for (int i = tid; i < k * k; i += blockDim.x) Gs[i] = G[i];
  }
  if (valid) {
    for (int s = 0; s < k; ++s) Fs[s * GS_COLS + tid] = F[(long)s * m + j];
  }
  __syncthreads();
  if (!valid) return;

  const T* Gp = g_in_smem ? Gs : G;
  const T ubj = ub ? ub[j] : bound;
  const T eps = (T)1.7763568394002505e-15;     // np.spacing(10)
  for (int r = 0; r < reps; ++r) {
    for (int t = 0; t < k; ++t) {
      const T* g = Gp + (long)t * k;
      T c0 = 0, c1 = 0;
      int s = 0;
      for (; s + 1 < k; s += 2) {
        c0 += g[s] * Fs[s * GS_COLS + tid];
        c1 += g[s + 1] * Fs[(s + 1) * GS_COLS + tid];
      }
      if (s < k) c0 += g[s] * Fs[s * GS_COLS + tid];
      const T gtt = g[t];
      const T fold = Fs[t * GS_COLS + tid];
      const T numer = N[(long)t * m + j] - (c0 + c1) + gtt * fold - l1;
      const T denom = gtt + l2;
      T v;
      if (denom > 0) {
        v = (numer > 0 ? numer : (T)0) / (denom + eps);
      } else {
        v = (denom - numer < 0) ? ubj : (T)0;
      }
      Fs[t * GS_COLS + tid] = v;
    }
  }
  for (int s = 0; s < k; ++s) out[(long)s * m + j] = Fs[s * GS_COLS + tid];
}

template <typename T>
static int launch_gs(const T* G, const T* N, const T* F, const T* ub, T* out,
                     int k, int m, T l1, T l2, T bound, int reps, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  size_t strip = (size_t)k * GS_COLS * sizeof(T);
  size_t gram = (size_t)k * k * sizeof(T);
  int g_in_smem = strip + gram <= (size_t)max_smem;
  size_t smem = strip + (g_in_smem ? gram : 0);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(gs_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((m + GS_COLS - 1) / GS_COLS);
  gs_kernel<T><<<grid, GS_COLS, smem, (cudaStream_t)stream>>>(
      G, N, F, ub, out, k, m, l1, l2, bound, reps, g_in_smem);
  return (int)cudaGetLastError();
}

extern "C" int rri_gs_f32(const void* G, const void* N, const void* F,
                          const void* ub, void* out, int k, int m, float l1,
                          float l2, float bound, int reps, int device,
                          void* stream) {
  return launch_gs<float>((const float*)G, (const float*)N, (const float*)F,
                          (const float*)ub, (float*)out, k, m, l1, l2, bound,
                          reps, device, stream);
}

extern "C" int rri_gs_f64(const void* G, const void* N, const void* F,
                          const void* ub, void* out, int k, int m, double l1,
                          double l2, double bound, int reps, int device,
                          void* stream) {
  return launch_gs<double>((const double*)G, (const double*)N,
                           (const double*)F, (const double*)ub, (double*)out,
                           k, m, l1, l2, bound, reps, device, stream);
}
