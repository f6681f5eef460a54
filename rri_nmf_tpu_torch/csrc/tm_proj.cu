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
// What bounds it on the H100: the bytes are N and F read and the output
// written (3 k d words: 15.7 MB at k=50, d=26214 in float32, 4.7 us at
// 3.35 TB/s), the flop 2 k^2 d (2.0 us). But the simplex threshold couples
// all d columns of a row and the topics run in order: per topic, one
// numerator pass and then a chain of dependent row-wide reductions (the
// (sum, min) of the shortcut, one per Michelot round r, one per round r2
// of the drift re-projection). So the floor is latency: k (1 + r + r2)
// reductions, each a round trip through L2 between the blocks; r ~ 8.3
// and r2 = 2 at the TM fit's shape on synthetic data.
//
// Design: a persistent cooperative grid of TM_BLOCKS (32) blocks of
// TM_THREADS (512) threads (cudaLaunchCooperativeKernel: all blocks
// co-resident, checked with the occupancy query first). Fewer blocks make
// each reduction cheaper (fewer slots to gather and poll) and give each
// thread more columns; 32 blocks of 512 measured best at the TM shape
// among grids of 24 to 132 blocks (PERF.md, section 6). Block b owns the
// contiguous column
// slice [b*cols, (b+1)*cols) for the whole phase, and a thread only ever
// reads columns it wrote itself. The slice of F sits in shared memory
// when it fits (k x cols: 160 KB at k=50, d=26214 in float32, beside the
// 10 KB Gram), so the Gram corrections read nothing from L2; a larger
// slice (float64 there) is worked in place in the output, through L1/L2.
// The whole Gram joins the slice when it fits, else one row of it per
// topic. The numerators of a thread's first two columns are loaded one
// topic ahead. A row-wide reduction is one grid barrier without a central
// counter: each block reduces its threads' partials (through shared
// memory in thread order, then a butterfly) and warp 0 writes the block's
// partial to its slot, as 64-bit words that each carry a 32-bit piece of
// the partial and the reduction's number; then warp 0 of every block
// loads all slots at once, polls until every word carries that number,
// and combines them in block order, so every block holds the same total
// bit for bit and the control flow stays uniform across the grid. The
// slots alternate between two banks (a block can run at most one
// reduction ahead of the slowest reader). Each reduction carries a
// triple: (sum, min) for the shortcut, (sum, count, sum of v - tau) per
// Michelot round (the last round's shifted sum is the projected row's sum
// when the threshold did not move, which it cannot once the count
// repeats: that saves the drift check's own reduction), and (max, first
// index) for the concave branch, ties to the smaller column across blocks
// too. No floating-point atomics, so two launches give the same bits.
// ptxas (-Xptxas -v, sm_90a): 115 registers, 6,160 bytes of static shared
// memory in float32; 128 registers, 128 bytes of stack, 12,320 bytes in
// float64.
//
// 16-bit factors (bfloat16, float16): F and the output are stored in 16
// bits, G and N are float32, and the panel is worked in float32, as the
// TPU kernel works a 16-bit panel in a float32 VMEM scratch: the slice is
// widened into shared memory (or, when it does not fit there, into a
// float32 work panel in device memory that the wrapper allocates) and
// rounded once when it is written out. The layout and the co-residency
// check are computed for the 16-bit kernel itself (storage.cuh).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "storage.cuh"

// most blocks of the grid, and threads per block (32 x 512 measured best
// at the TM shape, see the note above)
#define TM_BLOCKS 32
#define TM_THREADS 512
#define TM_MIN_COLS 32                 // fewest columns a block takes
// most columns: the per-row counts and column indices are carried in the
// working type, exact in float32 below 2^24
#define TM_MAX_COLS (1 << 24)
#define TM_MAX_BLOCKS 160              // slots the scratch holds, per bank
// scratch: two banks of TM_MAX_BLOCKS slots of up to six 64-bit words
#define TM_SCRATCH_BYTES (2 * TM_MAX_BLOCKS * 6 * 8)

template <typename T>
struct Tri {
  T a, b, c;
};

// The combine rules. Each is commutative bit for bit, so a butterfly
// leaves every lane with the same total.
template <typename T>
struct SumMin {                        // (sum, min)
  __device__ static Tri<T> id() { return {(T)0, (T)CUDART_INF, (T)0}; }
  __device__ static Tri<T> op(const Tri<T>& x, const Tri<T>& y) {
    return {x.a + y.a, y.b < x.b ? y.b : x.b, (T)0};
  }
};

template <typename T>
struct Sum3 {                          // (sum, count, shifted sum)
  __device__ static Tri<T> id() { return {(T)0, (T)0, (T)0}; }
  __device__ static Tri<T> op(const Tri<T>& x, const Tri<T>& y) {
    return {x.a + y.a, x.b + y.b, x.c + y.c};
  }
};

template <typename T>
struct ArgMax {                        // (max, first index)
  __device__ static Tri<T> id() {
    return {-(T)CUDART_INF, (T)CUDART_INF, (T)0};
  }
  __device__ static Tri<T> op(const Tri<T>& x, const Tri<T>& y) {
    return (y.a > x.a || (y.a == x.a && y.b < x.b)) ? y : x;
  }
};

template <class Op, typename T>
__device__ __forceinline__ Tri<T> warp_all(Tri<T> x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Tri<T> y;
    y.a = __shfl_xor_sync(0xffffffffu, x.a, o);
    y.b = __shfl_xor_sync(0xffffffffu, x.b, o);
    y.c = __shfl_xor_sync(0xffffffffu, x.c, o);
    x = Op::op(x, y);
  }
  return x;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

// A slot holds one block's partial as 64-bit words, each a 32-bit piece
// of the (a, b, c) triple beside the number of the reduction that wrote
// it: a reader takes a word only when it carries the number it waits for,
// and a 64-bit access is single-copy atomic, so no fence or counter is
// needed between writer and readers. A bank stores word i of every block
// together (bank[i * TM_MAX_BLOCKS + b]), so a warp's poll is coalesced.
template <typename T>
struct Slot {
  static constexpr int WORDS = 3 * sizeof(T) / 4;
};

template <typename T>
__device__ __forceinline__ void put_slot(unsigned long long* bank, int b,
                                         const Tri<T>& x, unsigned int gen) {
  const T v[3] = {x.a, x.b, x.c};
  const unsigned int* u = reinterpret_cast<const unsigned int*>(v);
#pragma unroll
  for (int i = 0; i < Slot<T>::WORDS; ++i)
    st_relaxed(bank + i * TM_MAX_BLOCKS + b,
               ((unsigned long long)gen << 32) | u[i]);
}

// The combination, in block order, of the slots this lane reads: blocks
// lane, lane+32, ... All their words are loaded at once and polled again
// until every one carries `gen`; the warp leaves together.
template <class Op, typename T>
__device__ __forceinline__ Tri<T> gather_slots(const unsigned long long* bank,
                                               unsigned int gen, int nblk) {
  constexpr int W = Slot<T>::WORDS, PER = TM_MAX_BLOCKS / 32;
  const int lane = threadIdx.x & 31;
  unsigned long long w[PER][W];
  for (unsigned int spin = 0;; ++spin) {
    bool ready = true;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int b = lane + 32 * i;
      if (b < nblk) {
#pragma unroll
        for (int u = 0; u < W; ++u) {
          w[i][u] = ld_relaxed(bank + u * TM_MAX_BLOCKS + b);
          ready = ready && (unsigned int)(w[i][u] >> 32) == gen;
        }
      }
    }
    if (__all_sync(0xffffffffu, ready)) break;
    // a block that never writes is a fault: trap (the launch then fails)
    // after 2^26 polls (tens of seconds) rather than hang
    if (spin == (1u << 26)) __trap();
  }
  Tri<T> acc = Op::id();
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (lane + 32 * i < nblk) {
      T v[3];
      unsigned int* u = reinterpret_cast<unsigned int*>(v);
#pragma unroll
      for (int q = 0; q < W; ++q) u[q] = (unsigned int)w[i][q];
      acc = Op::op(acc, Tri<T>{v[0], v[1], v[2]});
    }
  }
  return acc;
}

// what a block needs for its grid-wide reductions
template <typename T>
struct Grid {
  Tri<T>* part;                        // shared: a partial per thread, total
  unsigned long long* slots;           // global: 2 banks of slots
  unsigned int nred;                   // reductions so far (uniform)
};

// The grid-wide reduction of every thread's partial x: returned to every
// thread of every block, the same bits everywhere.
template <class Op, typename T>
__device__ Tri<T> grid_all(Tri<T> x, Grid<T>& gr) {
  constexpr int PER = TM_THREADS / 32;
  const int lane = threadIdx.x & 31;
  const unsigned int gen = ++gr.nred;
  // a block reaches reduction r+2 only after every block has read r
  unsigned long long* bank =
      gr.slots + (size_t)(gen & 1) * Slot<T>::WORDS * TM_MAX_BLOCKS;
  gr.part[threadIdx.x] = x;
  __syncthreads();
  if (threadIdx.x < 32) {
    // the block's partial: lane l takes threads PER*l .. PER*l+PER-1 in
    // order, then a butterfly
    Tri<T> y = Op::id();
#pragma unroll
    for (int i = 0; i < PER; ++i) y = Op::op(y, gr.part[lane * PER + i]);
    y = warp_all<Op>(y);
    if (lane == 0) put_slot(bank, blockIdx.x, y, gen);
    // the blocks' partials in block order: lane l takes blocks l, l+32, ..
    y = warp_all<Op>(gather_slots<Op, T>(bank, gen, (int)gridDim.x));
    if (lane == 0) gr.part[TM_THREADS] = y;
  }
  __syncthreads();
  return gr.part[TM_THREADS];
}

// fused multiply-add in the working type
__device__ __forceinline__ float fmx(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmx(double a, double b, double c) {
  return fma(a, b, c);
}

// G[t,:] . F[:, c] over the k rows of the slice (row stride fs)
template <typename T>
__device__ __forceinline__ T gram_dot(const T* g, const T* Fw, long fs,
                                      int c, int k) {
  T a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  int q = 0;
  for (; q + 3 < k; q += 4) {
    a0 = fmx(g[q], Fw[q * fs + c], a0);
    a1 = fmx(g[q + 1], Fw[(q + 1) * fs + c], a1);
    a2 = fmx(g[q + 2], Fw[(q + 2) * fs + c], a2);
    a3 = fmx(g[q + 3], Fw[(q + 3) * fs + c], a3);
  }
  for (; q < k; ++q) a0 = fmx(g[q], Fw[q * fs + c], a0);
  return (a0 + a1) + (a2 + a3);
}

// Michelot's fixpoint on the block's slice v (w columns of the d-column
// row) from the row sum sv: thresholds v in place and returns the sum of
// the projected row.
template <typename T>
__device__ T project(T* v, int w, int d, T s, T sv, Grid<T>& gr) {
  const int tid = threadIdx.x;
  T tau = (sv - s) / (T)d, tau_prev = tau, shifted = 0;
  int m_prev = d + 1;
  bool changed = true;
  for (int it = 0; changed && it < d + 2; ++it) {
    Tri<T> x = {0, 0, 0};
    for (int c = tid; c < w; c += TM_THREADS) {
      const T vc = v[c];
      if (vc > tau) {
        x.a += vc;
        x.b += 1;                      // exact below 2^24 columns
        x.c += vc - tau;
      }
    }
    const Tri<T> r = grid_all<Sum3<T>>(x, gr);
    const int m = (int)r.b;
    tau_prev = tau;
    shifted = r.c;
    tau = (r.a - s) / (T)(m > 1 ? m : 1);
    changed = m != m_prev;
    m_prev = m;
  }
  for (int c = tid; c < w; c += TM_THREADS) v[c] = v[c] > tau ? v[c] - tau
                                                               : (T)0;
  // the last round summed exactly these values unless tau moved in it
  if (tau == tau_prev) return shifted;
  Tri<T> x = {0, 0, 0};
  for (int c = tid; c < w; c += TM_THREADS) x.a += v[c];
  return grid_all<Sum3<T>>(x, gr).a;
}

// S: F's storage type; T = Storage<S>::Work, that of G, N and the work
// panel. `work` is the (k, d) work panel used when the slice does not fit
// shared memory: `out` itself when S is T.
template <typename S, typename T>
__global__ void __launch_bounds__(TM_THREADS, 1)
tm_proj_kernel(const T* __restrict__ G, const T* __restrict__ N,
               const S* __restrict__ F, S* __restrict__ out,
               T* __restrict__ work, int k, int d, int cols, int gwhole,
               int resident, T l1, T l2, T s, int reps,
               unsigned long long* slots) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Tri<T> part[TM_THREADS + 1];
  // the Gram (k, k) when it fits, else one row of it; then the slice:
  // (k, cols) in shared memory, else in place in the output
  T* Gs = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const long j0 = (long)blockIdx.x * cols;
  const int w = (int)(d - j0 < cols ? d - j0 : cols);  // >= 1
  T* Fw = resident ? Gs + (gwhole ? (size_t)k * k : k) : work + j0;
  const long fs = resident ? cols : d;
  Grid<T> gr = {part, slots, 0};
  const T eps = (T)1.7763568394002505e-15;     // np.spacing(10)

  // each thread copies exactly the columns it owns
  for (int q = 0; q < k; ++q)
    for (int c = tid; c < w; c += TM_THREADS)
      Fw[q * fs + c] = Storage<S>::load(F[(long)q * d + j0 + c]);
  if (gwhole)
    for (int i = tid; i < k * k; i += TM_THREADS) Gs[i] = G[i];
  __syncthreads();

  // the numerators of a thread's first two columns come from registers,
  // loaded one topic ahead
  T npre[2];
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * TM_THREADS;
    npre[i] = c < w ? N[j0 + c] : (T)0;
  }
  for (int r = 0; r < reps; ++r) {
    for (int t = 0; t < k; ++t) {
      const T* Nt = N + (long)t * d + j0;
      const T nt0 = npre[0], nt1 = npre[1];
      const T* g = Gs;                         // G[t, :]
      if (gwhole) {
        g += (size_t)t * k;
      } else {
        __syncthreads();                       // the last row is read
        for (int i = tid; i < k; i += TM_THREADS) Gs[i] = G[(long)t * k + i];
        __syncthreads();
      }
      const T gtt = g[t];
      const T denom = gtt + l2;
      T* v = Fw + t * fs;                      // the working row's slice
      {
        const T* Nn = N + (long)(t + 1 < k ? t + 1 : 0) * d + j0;
        for (int i = 0; i < 2; ++i) {
          const int c = tid + i * TM_THREADS;
          if (c < w) npre[i] = Nn[c];
        }
      }
      if (denom > 0) {
        Tri<T> x = SumMin<T>::id();
        for (int c = tid; c < w; c += TM_THREADS) {
          const T nv = c == tid ? nt0 : c == tid + TM_THREADS ? nt1 : Nt[c];
          const T numer = nv - gram_dot(g, Fw, fs, c, k) + gtt * v[c] - l1;
          const T vc = (numer > 0 ? numer : (T)0) / (denom + eps);
          v[c] = vc;
          x.a += vc;
          x.b = vc < x.b ? vc : x.b;
        }
        const Tri<T> sm = grid_all<SumMin<T>>(x, gr);
        T rs = sm.a;
        if (!(sm.a == s && sm.b >= 0)) rs = project(v, w, d, s, sm.a, gr);
        // drift re-projection (nearly always in float32, as in the TPU
        // kernel); |rs - s| > 1e-15 also rules out the shortcut there
        if (rs - s > (T)1e-15 || s - rs > (T)1e-15) project(v, w, d, s, rs, gr);
      } else {
        Tri<T> x = ArgMax<T>::id();
        for (int c = tid; c < w; c += TM_THREADS) {
          const T nv = c == tid ? nt0 : c == tid + TM_THREADS ? nt1 : Nt[c];
          const T numer = nv - gram_dot(g, Fw, fs, c, k) + gtt * v[c] - l1;
          if (numer > x.a) {
            x.a = numer;
            x.b = (T)(j0 + c);
          }
        }
        const Tri<T> am = grid_all<ArgMax<T>>(x, gr);
        // one nonzero: the row sums to s exactly, no drift
        for (int c = tid; c < w; c += TM_THREADS)
          v[c] = (T)(j0 + c) == am.b ? s : (T)0;
      }
    }
  }
  // the panel out of shared memory, or out of a work panel that is not
  // the output itself
  if (resident || (const void*)work != (const void*)out)
    for (int q = 0; q < k; ++q)
      for (int c = tid; c < w; c += TM_THREADS)
        out[(long)q * d + j0 + c] = Storage<S>::store(Fw[q * fs + c]);
}

// The grid: one block per SM (fewer when d < TM_MIN_COLS per SM), each
// with cols = ceil(d / blocks) columns, no block empty. Shared memory
// holds a Gram row and the slice of F when they fit, and the whole Gram
// instead of the row when that fits too.
struct TmLayout {
  int nblk, cols, gwhole, resident;
  size_t smem;
  bool fits;                           // the launcher accepts (k, d)
};

// The layout at (k, d) on `device`, with the kernel's shared-memory limit
// set to it and the cooperative grid checked to be co-resident (a larger
// one is refused). The launcher and rri_tm_proj_fits (which
// ops/dense_kernels.tm_proj_fits calls) both read it.
template <typename S, typename T>
static cudaError_t tm_proj_layout(int k, int d, int device, TmLayout* L) {
  int sms = 0, max_smem = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(
      &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  *L = TmLayout{0, 0, 0, 0, 0, false};
  const size_t avail = (size_t)max_smem - (TM_THREADS + 1) * sizeof(Tri<T>);
  const size_t row = (size_t)k * sizeof(T);
  if (d < 1 || d > TM_MAX_COLS || row > avail) return cudaSuccess;
  int nb = (d + TM_MIN_COLS - 1) / TM_MIN_COLS;
  nb = nb < sms ? nb : sms;
  nb = nb < TM_BLOCKS ? nb : TM_BLOCKS;
  nb = nb < TM_MAX_BLOCKS ? nb : TM_MAX_BLOCKS;
  const int cl = (d + nb - 1) / nb;
  L->nblk = (d + cl - 1) / cl;
  L->cols = cl;
  const size_t slice = (size_t)k * cl * sizeof(T);
  L->resident = row + slice <= avail;
  const size_t fslice = L->resident ? slice : 0;
  L->gwhole = row * k + fslice <= avail;
  L->smem = (L->gwhole ? row * k : row) + fslice;
  err = cudaFuncSetAttribute(tm_proj_kernel<S, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L->smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, tm_proj_kernel<S, T>, TM_THREADS, L->smem);
  if (err != cudaSuccess) return err;
  L->fits = per_sm * sms >= L->nblk;
  return cudaSuccess;
}

template <typename S, typename T>
static int launch_tm_proj(const T* G, const T* N, const S* F, S* out,
                          T* work, void* scratch, int k, int d, T l1, T l2,
                          T s, int reps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  TmLayout L;
  err = tm_proj_layout<S, T>(k, d, device, &L);
  if (err != cudaSuccess) return (int)err;
  if (!L.fits) return (int)cudaErrorInvalidConfiguration;
  // no slot may carry a reduction number before its block writes it
  unsigned long long* slots = (unsigned long long*)scratch;
  err = cudaMemsetAsync(slots, 0, TM_SCRATCH_BYTES, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&G,          (void*)&N,        (void*)&F,
                  (void*)&out,        (void*)&work,
                  (void*)&k,          (void*)&d,
                  (void*)&L.cols,     (void*)&L.gwhole, (void*)&L.resident,
                  (void*)&l1,         (void*)&l2,       (void*)&s,
                  (void*)&reps,       (void*)&slots};
  err = cudaLaunchCooperativeKernel((const void*)tm_proj_kernel<S, T>,
                                    dim3(L.nblk), dim3(TM_THREADS), args,
                                    L.smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// 1 when B2 can run at (k, d) on `device`, 0 when not; a negative CUDA
// error code when the device cannot be asked.
template <typename S, typename T>
static int tm_proj_fits(int k, int d, int device) {
  TmLayout L;
  const cudaError_t err = tm_proj_layout<S, T>(k, d, device, &L);
  if (err != cudaSuccess) return -(int)err;
  return L.fits ? 1 : 0;
}

extern "C" int rri_tm_proj_fits_f32(int k, int d, int device) {
  return tm_proj_fits<float, float>(k, d, device);
}

extern "C" int rri_tm_proj_fits_f64(int k, int d, int device) {
  return tm_proj_fits<double, double>(k, d, device);
}

extern "C" int rri_tm_proj_fits_bf16(int k, int d, int device) {
  return tm_proj_fits<__nv_bfloat16, float>(k, d, device);
}

extern "C" int rri_tm_proj_fits_f16(int k, int d, int device) {
  return tm_proj_fits<__half, float>(k, d, device);
}

// bytes of scratch the launcher needs (the wrapper allocates it)
extern "C" int rri_tm_proj_scratch_bytes(void) { return TM_SCRATCH_BYTES; }

#define TM_API(SUF, S, T)                                                    \
  extern "C" int rri_tm_proj_##SUF(const void* G, const void* N,             \
                                   const void* F, void* out, void* work,     \
                                   void* scratch, int k, int d, T l1, T l2,  \
                                   T s, int reps, int device,                \
                                   void* stream) {                           \
    return launch_tm_proj<S, T>((const T*)G, (const T*)N, (const S*)F,       \
                                (S*)out, (T*)work, scratch, k, d, l1, l2, s, \
                                reps, device, stream);                       \
  }

// float32 and float64 take `out` as their work panel
TM_API(f32, float, float)
TM_API(f64, double, double)
TM_API(bf16, __nv_bfloat16, float)
TM_API(f16, __half, float)
