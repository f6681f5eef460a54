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
// What bounds it on the H100: 2 k^2 m flop per pass (268 MFLOP at k=128,
// m=8192: 4.0 us at the 67 TFLOP/s of the CUDA cores) against 3 k m + k^2
// words crossing device memory (12.6 MB: 3.8 us at 3.35 TB/s), so the
// bound is the FMA rate. But every column is one dependent chain: topic t
// needs the rows before it. One thread per column would walk k^2 = 16,384
// dependent FMAs, and m=8192 columns would give 2 warps per SM: latency,
// not the FMA rate, would set the time.
//
// Design: topics in blocks of GS_LANES (16), the decomposition of the JAX
// package's plain path (rri_nmf_tpu/ops/sweep_xla.py, _gram_block_size),
// with GS_LANES threads (lanes) per column:
//
//   1. corrections: lane p computes C_p = G[t0+p, :] . F[:, col] for topic
//      t0+p against the factor at the topic block's start: an independent
//      k-term dot product per lane, from 16-byte shared-memory loads into
//      four accumulators;
//   2. the chain: for i = 0 .. GS_LANES-1, lane i finishes topic t0+i,
//      numer = N - C_i + G[t,t] F_old - l1 and the branches above, writes
//      the new value and broadcasts D = F_new - F_old by a shuffle; every
//      lane p adds G[t0+p, t0+i] * D to its C_p.
//
// So the k^2 FMAs run GS_LANES wide with many independent loads, and the
// serial chain of a column is k short steps. A block is GS_COLS (32)
// columns x 16 lanes = 512 threads, the lanes of a column in one half
// warp (the chain needs no barrier beyond __syncwarp). The block's factor
// strip sits in shared memory transposed (column c's k values contiguous,
// row stride kp = k rounded up to 128 bytes plus 16, so a quarter warp's
// 16-byte loads of 8 Gram rows hit 32 distinct banks), and the whole Gram
// beside it when both fit: at k=128 in float32 that is 16.9 + 67.6 KB, two
// blocks and 32 warps per SM at m=8192 (256 blocks over 132 SMs). When
// the whole Gram does not fit (large k, or float64 past ~k=150), each
// topic block stages its own GS_LANES Gram rows between two barriers.
// Ragged edges: columns past m compute on zeros and store nothing; topics
// past k (k not a multiple of 16) have zero Gram rows and never write.
// f32 math on the CUDA cores (no TF32), f64 on FMA; no atomics, so a
// launch repeats bit for bit.
//
// 16-bit factors (bfloat16, float16): F and the output are stored in 16
// bits and the strip is worked in float32 in shared memory, against
// float32 G, N and ub, as the TPU kernel works a 16-bit tile in a float32
// VMEM scratch: the strip is widened on the way in and rounded once, on
// the way out. Its layout is the float32 kernel's (storage.cuh).
//
// ptxas (-Xptxas -v, sm_90a): 64 registers
// (the cap of two 512-thread blocks per SM), no spills in float32, 8
// bytes of stack in float64; dynamic shared memory (32 + 128) x 132 x 4
// = 84.5 KB at k=128 in float32, two blocks and 32 warps per SM.

#include <cuda_runtime.h>

#include "storage.cuh"

// lanes per column = topics per block: a half warp, so the chain's
// shuffles stay inside one warp, and 16 x 32 columns = 512 threads
#define GS_LANES 16
#define GS_COLS 32                     // columns per block
#define GS_THREADS (GS_LANES * GS_COLS)

// fused multiply-add in the working type
__device__ __forceinline__ float fmx(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmx(double a, double b, double c) {
  return fma(a, b, c);
}

// four FMAs (float) or two (double) from one 16-byte load of each operand
__device__ __forceinline__ void fma_vec(const float* g, const float* f,
                                        float* a) {
  const float4 x = *reinterpret_cast<const float4*>(g);
  const float4 y = *reinterpret_cast<const float4*>(f);
  a[0] = fmaf(x.x, y.x, a[0]);
  a[1] = fmaf(x.y, y.y, a[1]);
  a[2] = fmaf(x.z, y.z, a[2]);
  a[3] = fmaf(x.w, y.w, a[3]);
}

__device__ __forceinline__ void fma_vec(const double* g, const double* f,
                                        double* a) {
  const double2 x = *reinterpret_cast<const double2*>(g);
  const double2 y = *reinterpret_cast<const double2*>(f);
  a[0] = fma(x.x, y.x, a[0]);
  a[1] = fma(x.y, y.y, a[1]);
}

// row stride of the shared-memory tiles, in elements: k rounded up to 128
// bytes, plus 16 bytes
template <typename T>
static __host__ __device__ int gs_kp(int k) {
  const int line = 128 / (int)sizeof(T);
  return (k + line - 1) / line * line + 16 / (int)sizeof(T);
}

// rows r0 .. r0+nrows-1 of G into Gs (row stride kp), zero past k
template <typename T>
__device__ void load_gram_rows(T* Gs, const T* __restrict__ G, int k, int kp,
                               int r0, int nrows) {
  for (int i = threadIdx.x; i < nrows * kp; i += GS_THREADS) {
    const int r = r0 + i / kp, q = i % kp;
    Gs[i] = (r < k && q < k) ? G[(long)r * k + q] : (T)0;
  }
}

// S: F's storage type; T = Storage<S>::Work, that of G, N, ub and the strip
template <typename S, typename T>
__global__ void __launch_bounds__(GS_THREADS, 2)
gs_kernel(const T* __restrict__ G, const T* __restrict__ N,
          const S* __restrict__ F, const T* __restrict__ ub,
          S* __restrict__ out, int k, int m, int grows, T l1, T l2, T bound,
          int reps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int VEC = 16 / sizeof(T);
  const int kp = gs_kp<T>(k);
  const int kr = (k + GS_LANES - 1) / GS_LANES * GS_LANES;
  const bool whole = grows == kr;      // the whole Gram stays resident
  T* Fs = reinterpret_cast<T*>(smem_raw);      // (GS_COLS, kp) strip
  T* Gs = Fs + (size_t)GS_COLS * kp;           // (grows, kp) Gram rows
  const int tid = threadIdx.x;
  const int p = tid % GS_LANES;                // lane: topic t0 + p
  const int c = tid / GS_LANES;                // column in the strip
  const long j0 = (long)blockIdx.x * GS_COLS;
  const long j = j0 + c;
  const bool valid = j < m;

  // the strip, transposed on the way in (coalesced along F's rows)
  for (int i = tid; i < kp * GS_COLS; i += GS_THREADS) {
    const int q = i / GS_COLS, cc = i % GS_COLS;
    Fs[cc * kp + q] = (q < k && j0 + cc < m)
                          ? Storage<S>::load(F[(long)q * m + j0 + cc])
                          : (T)0;
  }
  if (whole) load_gram_rows(Gs, G, k, kp, 0, kr);
  __syncthreads();

  T* Fc = Fs + c * kp;                         // this column's k values
  const T ubj = valid ? (ub ? ub[j] : bound) : (T)0;
  const T eps = (T)1.7763568394002505e-15;     // np.spacing(10)
  const int kv = (k + VEC - 1) / VEC * VEC;
  for (int r = 0; r < reps; ++r) {
    for (int t0 = 0; t0 < k; t0 += GS_LANES) {
      if (!whole) {
        __syncthreads();                       // the last block's rows
        load_gram_rows(Gs, G, k, kp, t0, GS_LANES);
        __syncthreads();
      }
      const int t = t0 + p;
      const T* g = Gs + (size_t)((whole ? t0 : 0) + p) * kp;   // G[t, :]
      const T nv = (t < k && valid) ? N[(long)t * m + j] : (T)0;
      // 1. C_p = G[t, :] . F[:, col] at the topic block's start
      T a[4] = {0, 0, 0, 0};
      for (int q = 0; q < kv; q += VEC) fma_vec(g + q, Fc + q, a);
      T acc = (a[0] + a[1]) + (a[2] + a[3]);
      const T gtt = g[t];
      const T fold = Fc[t];
      const T denom = gtt + l2;
      // every lane has read the whole strip before the chain writes to it
      __syncwarp();
      // 2. the chain: lane i finishes topic t0+i, the others fold in its
      // change
      const int bb = min(GS_LANES, k - t0);
      for (int i = 0; i < bb; ++i) {
        T dlt = 0;
        if (p == i) {
          const T numer = nv - acc + gtt * fold - l1;
          T v;
          if (denom > 0) {
            v = (numer > 0 ? numer : (T)0) / (denom + eps);
          } else {
            v = (denom - numer < 0) ? ubj : (T)0;
          }
          Fc[t] = v;
          dlt = v - fold;
        }
        dlt = __shfl_sync(0xffffffffu, dlt, i, GS_LANES);
        acc = fmx(g[t0 + i], dlt, acc);
      }
      __syncwarp();                            // Fc is read by every lane
    }
  }
  __syncthreads();
  for (int i = tid; i < k * GS_COLS; i += GS_THREADS) {
    const int q = i / GS_COLS, cc = i % GS_COLS;
    if (j0 + cc < m)
      out[(long)q * m + j0 + cc] = Storage<S>::store(Fs[cc * kp + q]);
  }
}

// The block's shared memory at k on `device`: the strip and the whole Gram
// beside it when both fit, else one topic block's Gram rows at a time
// (*grows rows); *fits says whether even that fits. The launcher and
// rri_gs_fits (which ops/dense_kernels.gs_fits calls) both read it.
template <typename T>
static cudaError_t gs_layout(int k, int device, int* grows, size_t* smem,
                             bool* fits) {
  int max_smem = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t row = (size_t)gs_kp<T>(k) * sizeof(T);
  const int kr = (k + GS_LANES - 1) / GS_LANES * GS_LANES;
  *grows = kr;
  if ((GS_COLS + (size_t)kr) * row > (size_t)max_smem) *grows = GS_LANES;
  *smem = (GS_COLS + (size_t)*grows) * row;
  *fits = *smem <= (size_t)max_smem;
  return cudaSuccess;
}

template <typename S, typename T>
static int launch_gs(const T* G, const T* N, const S* F, const T* ub, S* out,
                     int k, int m, T l1, T l2, T bound, int reps, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int grows = 0;
  size_t smem = 0;
  bool fits = false;
  err = gs_layout<T>(k, device, &grows, &smem, &fits);
  if (err != cudaSuccess) return (int)err;
  if (!fits) return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(gs_kernel<S, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(gs_kernel<S, T>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((m + GS_COLS - 1) / GS_COLS);
  gs_kernel<S, T><<<grid, GS_THREADS, smem, (cudaStream_t)stream>>>(
      G, N, F, ub, out, k, m, grows, l1, l2, bound, reps);
  return (int)cudaGetLastError();
}

// 1 when B1 can run at k on `device`, 0 when not; a negative CUDA error
// code when the device cannot be asked.
template <typename T>
static int gs_fits(int k, int device) {
  int grows = 0;
  size_t smem = 0;
  bool fits = false;
  const cudaError_t err = gs_layout<T>(k, device, &grows, &smem, &fits);
  if (err != cudaSuccess) return -(int)err;
  return fits ? 1 : 0;
}

extern "C" int rri_gs_fits_f32(int k, int device) {
  return gs_fits<float>(k, device);
}

extern "C" int rri_gs_fits_f64(int k, int device) {
  return gs_fits<double>(k, device);
}

// the 16-bit launchers work their strip in float32: the float32 layout
extern "C" int rri_gs_fits_bf16(int k, int device) {
  return gs_fits<float>(k, device);
}

extern "C" int rri_gs_fits_f16(int k, int device) {
  return gs_fits<float>(k, device);
}

extern "C" int rri_gs_f32(const void* G, const void* N, const void* F,
                          const void* ub, void* out, int k, int m, float l1,
                          float l2, float bound, int reps, int device,
                          void* stream) {
  return launch_gs<float, float>((const float*)G, (const float*)N,
                                 (const float*)F, (const float*)ub,
                                 (float*)out, k, m, l1, l2, bound, reps,
                                 device, stream);
}

extern "C" int rri_gs_f64(const void* G, const void* N, const void* F,
                          const void* ub, void* out, int k, int m, double l1,
                          double l2, double bound, int reps, int device,
                          void* stream) {
  return launch_gs<double, double>((const double*)G, (const double*)N,
                                   (const double*)F, (const double*)ub,
                                   (double*)out, k, m, l1, l2, bound, reps,
                                   device, stream);
}

#define GS_API16(SUF, S)                                                     \
  extern "C" int rri_gs_##SUF(const void* G, const void* N, const void* F,   \
                              const void* ub, void* out, int k, int m,       \
                              float l1, float l2, float bound, int reps,     \
                              int device, void* stream) {                    \
    return launch_gs<S, float>((const float*)G, (const float*)N,             \
                               (const S*)F, (const float*)ub, (S*)out, k, m, \
                               l1, l2, bound, reps, device, stream);         \
  }

GS_API16(bf16, __nv_bfloat16)
GS_API16(f16, __half)
