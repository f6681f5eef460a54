// Sparse contractions out = F @ X over a chunk plan (kernels B5 and B6).
//
// Replace the Pallas kernels
//
//   B5  rri_nmf_tpu/ops/sparse_mxu.py _make_contract_kernel / mxu_contract
//       (the grouped chunk plan, one grid step per group of G chunks);
//   B6  rri_nmf_tpu/ops/sparse_dma.py _make_dma_kernel / dma_contract
//       (one grid step per used output tile, CSR offsets `ostart`, factor
//       tiles pre-cut into (n_gtiles, k, 128) slabs, prefetched by manual
//       DMA while the current chunk computes).
//
// Both compute out (k, spad) = F (k, gpad) @ X for one direction of the
// sparse sweep (W^T X with F = W^T, or T X^T with F = T). X arrives as the
// host plan of rri_nmf_tpu_torch/ops/sparse_plan.py: its nonzeros bucketed
// by (128, 128) tile, output-tile-major, in chunks of C slots; slot i of a
// chunk holds a value v_i, the position g_i of its row of F within the
// chunk's factor tile and the position s_i of its output column within the
// chunk's output tile. Padding slots and dummy chunks carry v = 0.
//
// The TPU kernels rebuild each chunk's dense 128x128 X tile with two
// one-hot matrix products, because the TPU has no gather path. The card
// has one, so these kernels gather-FMA directly:
//
//   Out[s_i][r] += v_i * F[r][g_i]     for every row r of F (k rows)
//
// Design: one block per output tile. The (k, 128) accumulator lives in
// shared memory as acc[s][r] (row stride k|1) and thread r owns output row
// r (rows r, r + blockDim, ... when k is larger than the block). Each
// thread walks the chunk's slots in plan order, so duplicate coordinates
// sum, padding slots add zero, nothing races and no atomics are needed:
// a run repeats bit for bit. The chunk's factor tile is staged in shared
// memory as Fs[r][g] with row stride 129; with the odd strides the 32
// threads of a warp (consecutive r) touch 32 banks both when they stage a
// tile (consecutive g) and when they gather (consecutive r), and the
// write-out (consecutive s) does too.
//
// Shared-memory gate: acc takes 128 (k|1) words and a staged tile k * 129
// more: 132 KB at k = 128 in float32 with both, 264 KB in float64, over
// the 227 KB a block may opt into. When acc and the tile(s) do not fit,
// the kernel reads F from device memory instead (stride gpad or 128 across
// the threads of a warp: uncoalesced, served by L1/L2); when acc alone
// does not fit the launch is refused. mxu_smem and dma_smem below are the
// one statement of each layout's size: the launchers and rri_sparse_fits
// (which ops/sparse_kernels.sparse_fits calls) both read them.
//
// B5 walks the chunks of its output tile, tstart[o]:tstart[o+1] (derived
// from the plan's per-group otile runs), loading each chunk's metadata and
// factor tile before computing it (the tile's copies all in flight at
// once through cp.async, then one wait; nothing overlaps the compute).
// Every output tile gets a block, so a tile no chunk visits is written as
// zeros (the TPU version selects against `mask` because its unvisited
// tiles held undefined VMEM).
//
// B6 keeps what defines its TPU kernel: one block per used output tile
// (uotile, ostart), the (n_gtiles, k, 128) factor slabs, and copies that
// run ahead of the compute: cp.async brings the next chunk's slab into the
// other of two shared buffers, and the next metadata block of SP_MBLK
// chunks (plan pad MBLK_MAX = 16 >= SP_MBLK covers the over-read at the
// end) into the other of two metadata buffers, while the current chunk
// computes.
//
// What bounds them on the H100: per chunk, staging one (k, 128) factor
// tile (64 KB at k = 128 float32; the factors, 25.6 MB for W at n = 50000,
// stay in the 50 MB L2) and C k shared-memory read-modify-writes of acc.
// The gather-FMA does C k flops where the one-hot form does 2 C 128^2 +
// 2 k 128^2 on tensor cores; at ~80 nonzeros per tile (0.5% density) the
// direct form moves the least data. Tensor cores (wgmma on a one-hot
// tile) and TMA are left for a later version.

#include <cuda_runtime.h>
#include <stdint.h>

#define SP_TILE 128
#define SP_FSTRIDE (SP_TILE + 1)   // row stride of a staged factor tile
#define SP_MBLK 8                  // chunks per B6 metadata block
#define SP_THREADS 128             // threads per block (at most)

static __host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// One chunk: acc[s_i][r] += v_i * F(r, g_i) for this thread's rows r, the
// slots in plan order. F(r, g) = fr[r * fstride + g].
//
// The slots go in batches of SP_BATCH: all of a batch's loads (indices,
// values, factor entries) go out before its first accumulator update,
// since the compiler may not move a load above a store to shared memory
// that could alias it; the updates then run in slot order (two slots of a
// batch may hit the same accumulator element, a duplicate).
constexpr int SP_BATCH = 8;

template <typename T>
__device__ __forceinline__ void chunk_fma(T* acc, int kp, const T* fr,
                                          long fstride, const T* v,
                                          const uint8_t* gl,
                                          const uint8_t* sl, int C, int k) {
  for (int r = threadIdx.x; r < k; r += blockDim.x) {
    const T* f = fr + (long)r * fstride;
    T* a = acc + r;
    int i = 0;
    for (; i + SP_BATCH <= C; i += SP_BATCH) {
      int s[SP_BATCH];
      T p[SP_BATCH];
#pragma unroll
      for (int j = 0; j < SP_BATCH; ++j) {
        s[j] = sl[i + j] * kp;
        p[j] = v[i + j] * f[gl[i + j]];
      }
#pragma unroll
      for (int j = 0; j < SP_BATCH; ++j) a[s[j]] += p[j];
    }
    for (; i < C; ++i) a[sl[i] * kp] += v[i] * f[gl[i]];
  }
}

template <typename T>
__device__ __forceinline__ void zero_acc(T* acc, int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) acc[e] = (T)0;
}

// out[r][col0 + s] = acc[s][r] for the k x 128 tile (consecutive threads on
// consecutive s: coalesced stores, conflict-free shared reads).
template <typename T>
__device__ __forceinline__ void write_tile(const T* acc, int kp, T* out,
                                           int k, long spad, long col0) {
  for (int e = threadIdx.x; e < k * SP_TILE; e += blockDim.x) {
    const int r = e / SP_TILE, s = e % SP_TILE;
    out[(long)r * spad + col0 + s] = acc[s * kp + r];
  }
}

// cp.async: copies from device to shared memory that run in the background
// until a wait_group.

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "n"(BYTES));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16-byte copies of `bytes` (a multiple of 16) contiguous bytes.
__device__ __forceinline__ void cp_async_bytes(void* dst, const void* src,
                                               int bytes) {
  for (int e = threadIdx.x; e < bytes / 16; e += blockDim.x) {
    cp_async<16>(static_cast<char*>(dst) + 16 * e,
                 static_cast<const char*>(src) + 16 * e);
  }
}

// ---------------------------------------------------------------------------
// B5: grouped chunk plan, one block per output tile
// ---------------------------------------------------------------------------

template <typename T>
__global__ void mxu_kernel(const T* __restrict__ F, const T* __restrict__ vals,
                           const uint8_t* __restrict__ gloc,
                           const uint8_t* __restrict__ sloc,
                           const int* __restrict__ ftile,
                           const int* __restrict__ tstart, T* __restrict__ out,
                           int k, long gpad, long spad, int C, int stage_f) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kp = k | 1;
  T* acc = reinterpret_cast<T*>(smem_raw);
  T* Fs = acc + SP_TILE * kp;
  T* vs = Fs + (stage_f ? k * SP_FSTRIDE : 0);
  uint8_t* gs = reinterpret_cast<uint8_t*>(vs + C);
  uint8_t* ss = gs + C;
  const int o = blockIdx.x;
  const int c0 = tstart[o], c1 = tstart[o + 1];

  zero_acc(acc, SP_TILE * kp);
  for (int c = c0; c < c1; ++c) {
    __syncthreads();            // the previous chunk is done with the tiles
    const long base = (long)c * C;
    const T* Fg = F + (long)ftile[c] * SP_TILE;
    if (stage_f) {
      // all of the tile's copies in flight at once, then one wait
      for (int e = threadIdx.x; e < k * SP_TILE; e += blockDim.x) {
        const int r = e / SP_TILE, g = e % SP_TILE;
        cp_async<sizeof(T)>(Fs + r * SP_FSTRIDE + g, Fg + (long)r * gpad + g);
      }
      cp_async_commit();
    }
    for (int i = threadIdx.x; i < C; i += blockDim.x) {
      vs[i] = vals[base + i];
      gs[i] = gloc[base + i];
      ss[i] = sloc[base + i];
    }
    if (stage_f) cp_async_wait<0>();
    __syncthreads();
    if (stage_f) {
      chunk_fma(acc, kp, Fs, SP_FSTRIDE, vs, gs, ss, C, k);
    } else {
      chunk_fma(acc, kp, Fg, gpad, vs, gs, ss, C, k);
    }
  }
  __syncthreads();
  write_tile(acc, kp, out, k, spad, (long)o * SP_TILE);
}

// ---------------------------------------------------------------------------
// B6: one block per used output tile, cp.async prefetch
// ---------------------------------------------------------------------------

template <typename T>
__global__ void dma_kernel(const T* __restrict__ F3, const T* __restrict__ vals,
                           const uint8_t* __restrict__ idx,
                           const int* __restrict__ ftile,
                           const int* __restrict__ uotile,
                           const int* __restrict__ ostart, T* __restrict__ out,
                           int k, long spad, int C, long idx_stride,
                           int stage_f) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kp = k | 1;
  const int mblk = SP_MBLK * C;                // slots per metadata block
  const size_t tile_elems = (size_t)k * SP_FSTRIDE;
  unsigned char* p = smem_raw;
  T* acc = reinterpret_cast<T*>(p);
  p += align16(sizeof(T) * SP_TILE * kp);
  T* Fb = reinterpret_cast<T*>(p);             // 2 staged slabs
  p += stage_f ? align16(sizeof(T) * 2 * tile_elems) : 0;
  T* vb = reinterpret_cast<T*>(p);             // 2 value blocks
  p += align16(sizeof(T) * 2 * mblk);
  uint8_t* gb = p;                             // 2 gather-index blocks
  uint8_t* sb = gb + 2 * mblk;                 // 2 scatter-index blocks

  const int i = blockIdx.x;
  const long cs = ostart[i];
  const int cnt = ostart[i + 1] - ostart[i];
  const long slab = (long)k * SP_TILE;

  // copies for chunk j of this tile: its factor slab into buffer j & 1 and,
  // at a metadata-block boundary, the block's values and indices
  auto prefetch = [&](int j) {
    if (stage_f) {
      const T* src = F3 + (long)ftile[cs + j] * slab;
      T* dst = Fb + (j & 1) * tile_elems;
      for (int e = threadIdx.x; e < k * SP_TILE; e += blockDim.x) {
        cp_async<sizeof(T)>(dst + (e / SP_TILE) * SP_FSTRIDE + e % SP_TILE,
                            src + e);
      }
    }
    if (j % SP_MBLK == 0) {
      const int m = (j / SP_MBLK) & 1;
      const long s0 = (cs + j) * C;
      cp_async_bytes(vb + m * mblk, vals + s0, (int)sizeof(T) * mblk);
      cp_async_bytes(gb + m * mblk, idx + s0, mblk);
      cp_async_bytes(sb + m * mblk, idx + idx_stride + s0, mblk);
    }
    cp_async_commit();
  };

  zero_acc(acc, SP_TILE * kp);
  if (cnt > 0) prefetch(0);
  for (int j = 0; j < cnt; ++j) {
    if (j + 1 < cnt) {
      prefetch(j + 1);
      cp_async_wait<1>();       // chunk j's group has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int m = (j / SP_MBLK) & 1;
    const int off = m * mblk + (j % SP_MBLK) * C;
    if (stage_f) {
      chunk_fma(acc, kp, Fb + (j & 1) * tile_elems, SP_FSTRIDE, vb + off,
                gb + off, sb + off, C, k);
    } else {
      chunk_fma(acc, kp, F3 + (long)ftile[cs + j] * slab, SP_TILE, vb + off,
                gb + off, sb + off, C, k);
    }
    __syncthreads();            // buffers of chunk j are free again
  }
  __syncthreads();
  write_tile(acc, kp, out, k, spad, (long)uotile[i] * SP_TILE);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

static int block_threads(int k) {
  int t = (k + 31) / 32 * 32;
  return t < SP_THREADS ? t : SP_THREADS;
}

static cudaError_t max_smem(int device, int* bytes) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(bytes,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                device);
}

// Dynamic shared memory of a block, with the factor tile(s) staged or not:
// the layouts that mxu_kernel and dma_kernel carve out of smem_raw.
template <typename T>
static size_t mxu_smem(int k, int C, int stage_f) {
  const size_t acc = sizeof(T) * SP_TILE * (size_t)(k | 1);
  const size_t tile = sizeof(T) * (size_t)k * SP_FSTRIDE;
  const size_t meta = (sizeof(T) + 2) * (size_t)C;
  return acc + (stage_f ? tile : 0) + meta;
}

template <typename T>
static size_t dma_smem(int k, int C, int stage_f) {
  const size_t acc = align16(sizeof(T) * SP_TILE * (size_t)(k | 1));
  const size_t tiles = align16(sizeof(T) * 2 * (size_t)k * SP_FSTRIDE);
  const size_t meta = align16(sizeof(T) * 2 * SP_MBLK * (size_t)C) +
                      4 * SP_MBLK * (size_t)C;
  return acc + (stage_f ? tiles : 0) + meta;
}

// 1 when both kernels can run at (k, C) on `device` (with F read from
// device memory if the staged tiles do not fit), 0 when not; a negative
// CUDA error code when the device cannot be asked.
template <typename T>
static int sparse_fits(int k, int C, int device) {
  int cap = 0;
  cudaError_t err = max_smem(device, &cap);
  if (err != cudaSuccess) return -(int)err;
  return mxu_smem<T>(k, C, 0) <= (size_t)cap &&
         dma_smem<T>(k, C, 0) <= (size_t)cap;
}

template <typename T>
static int launch_mxu(const T* F, const T* vals, const uint8_t* gloc,
                      const uint8_t* sloc, const int* ftile,
                      const int* tstart, T* out, int k, int gpad, int n_otiles,
                      int C, int device, void* stream) {
  int cap = 0;
  cudaError_t err = max_smem(device, &cap);
  if (err != cudaSuccess) return (int)err;
  const int stage_f = mxu_smem<T>(k, C, 1) <= (size_t)cap;
  const size_t smem = mxu_smem<T>(k, C, stage_f);
  if (smem > (size_t)cap) return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(mxu_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  mxu_kernel<T><<<n_otiles, block_threads(k), smem, (cudaStream_t)stream>>>(
      F, vals, gloc, sloc, ftile, tstart, out, k, gpad,
      (long)n_otiles * SP_TILE, C, stage_f);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_dma(const T* F3, const T* vals, const uint8_t* idx,
                      const int* ftile, const int* uotile, const int* ostart,
                      T* out, int k, int n_used, int spad, int C,
                      int idx_stride, int device, void* stream) {
  if (C % 16 != 0) return (int)cudaErrorInvalidValue;
  int cap = 0;
  cudaError_t err = max_smem(device, &cap);
  if (err != cudaSuccess) return (int)err;
  const int stage_f = dma_smem<T>(k, C, 1) <= (size_t)cap;
  const size_t smem = dma_smem<T>(k, C, stage_f);
  if (smem > (size_t)cap) return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(dma_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  dma_kernel<T><<<n_used, block_threads(k), smem, (cudaStream_t)stream>>>(
      F3, vals, idx, ftile, uotile, ostart, out, k, (long)spad, C,
      (long)idx_stride, stage_f);
  return (int)cudaGetLastError();
}

#define SPARSE_API(SUF, T)                                                    \
  extern "C" int rri_sparse_mxu_##SUF(                                        \
      const void* F, const void* vals, const void* gloc, const void* sloc,    \
      const void* ftile, const void* tstart, void* out, int k, int gpad,      \
      int n_otiles, int C, int device, void* stream) {                        \
    return launch_mxu<T>((const T*)F, (const T*)vals, (const uint8_t*)gloc,   \
                         (const uint8_t*)sloc, (const int*)ftile,             \
                         (const int*)tstart, (T*)out, k, gpad, n_otiles, C,   \
                         device, stream);                                     \
  }                                                                           \
  extern "C" int rri_sparse_dma_##SUF(                                        \
      const void* F3, const void* vals, const void* idx, const void* ftile,   \
      const void* uotile, const void* ostart, void* out, int k, int n_used,   \
      int spad, int C, int idx_stride, int device, void* stream) {            \
    return launch_dma<T>((const T*)F3, (const T*)vals, (const uint8_t*)idx,   \
                         (const int*)ftile, (const int*)uotile,               \
                         (const int*)ostart, (T*)out, k, n_used, spad, C,     \
                         idx_stride, device, stream);                         \
  }                                                                           \
  extern "C" int rri_sparse_fits_##SUF(int k, int C, int device) {            \
    return sparse_fits<T>(k, C, device);                                      \
  }

SPARSE_API(f32, float)
SPARSE_API(f64, double)
