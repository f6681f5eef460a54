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
// and writes R, 3 n d words (12 n d bytes in float32: 286.6 MB at the
// MovieLens-1M shape 6040 x 3952, 0.0855 ms at 3.35 TB/s, against 4 flop
// per element). R and M together (191 MB) do not fit the 50 MB L2, so
// every topic streams them from device memory twice (once per kernel).
// Both designs aim at full coalescing and enough loads in flight to cover
// the memory latency: every thread issues the loads of several rows (B3)
// or column steps (B4) before it uses any of them, since a warp issues in
// order and would otherwise wait out each load's latency alone.
//
// B3 sums over rows: one launch, no scratch in device memory, no second
// kernel. A stripe of 32 lanes x 16 bytes of columns (128 in float32, 64
// in float64) is owned by one thread-block cluster of
// `cluster` blocks (at most 8, the portable size) along the rows. The
// rows are cut into tiles of A_TILE = 32; cluster rank r takes the tiles
// [r per, (r + 1) per), per = ceil(tiles / cluster), and deals them to its
// A_WARPS warps in turn (tile r per + w, + A_WARPS, ... to warp w). A warp
// stages its tile's dw, w and w*w in shared memory once (one coalesced
// load, lane l row l), then streams the tile A_DEPTH rows at a time: every
// lane issues 2 A_DEPTH 16-byte loads (R and M) before it uses them, and
// writes R back with 16-byte stores. At 6040 x 3952 float32 that is 31
// stripes x 8 = 248 blocks of 8 warps, 4 KB in flight per warp, in one
// wave: at 80 registers a thread three blocks fit an SM, and an H100
// places the clusters on 124 of its 132 SMs, two blocks on most. It runs
// at ~74% of the byte bound, where one PyTorch elementwise kernel moving
// the same bytes reaches ~86%; more loads in flight (deeper rows, more
// warps, a software pipeline, an L2 prefetch) measured slower, and more
// registers or shared memory a block push part of the grid into a second
// wave (PERF.md).
//
// Each lane keeps its columns' partial sums over its rows; the warps
// combine theirs in shared memory in warp order, then the cluster's
// blocks combine theirs through distributed shared memory in rank order,
// and rank 0 writes wR0 and nw. The cluster size comes from the caller
// (ops/masked_kernels.py phase_a_layout, a function of the shape alone),
// so every sum has a fixed order: no atomics, and a repeat launch gives
// the same bits. Shape rule: 16-byte loads need d % (16 / sizeof(T)) == 0
// and R, M 16-byte aligned; otherwise (e.g. 517 x 1030 in float32) the
// launcher takes the scalar-load form of the same kernel, where lane l
// owns the stripe's columns l, l + 32, ... (coalesced 4- or 8-byte loads)
// and the sums keep the same order.
//
// B4 sums over columns. One warp owns one row and walks its columns
// (lane j, j + 32, ...), so each step reads 32 consecutive words; a
// fixed shuffle tree then adds the 32 lane sums. 6040 rows are 1510
// blocks of 4 warps: one wave, 11-12 blocks on every SM.
//
// Sums are accumulated in the working dtype (float32 or float64), as the
// TPU kernels' _acc_of does for those dtypes.
//
// Numerics against the plain PyTorch twins (ops/masked_kernels.py): the
// kernels compute the rank-one updates as fused multiply-adds,
// R + dw*t_prev = fma(dw, t_prev, R), where torch rounds the product and
// the sum separately; that is one rounding of difference per update, and
// the reductions add in another order than the twins' GEMVs.
//
// 16-bit storage (bfloat16, float16): R, M and the vectors are stored in
// 16 bits and the sums are float32 (storage.cuh). The elementwise steps
// round to 16 bits where the TPU kernels compute in 16 bits: each product
// and each sum of the rank-one updates, M . R, and w*w (t_new*t_new);
// each 16-bit product then enters its float32 sum exactly, as the TPU
// kernels' float32 dots take it. Both kernels have a 16-byte form for
// 16 bits (d % 8 == 0, R and M 16-byte aligned, for B4 t_old and t_new
// too; the scalar forms otherwise), in which a lane moves 8 consecutive
// values of a row as one 16-byte word and keeps them packed until used,
// widening, stepping and rounding them in pairs (Storage::load2, store2):
// the same steps as the scalar forms, so R is the same bits.
// - B3: lane l owns columns 8l .. 8l + 7 of its 256-column stripe, whose
//   sums keep the scalar form's order (the same stripes, warps and
//   ranks: phase_a_layout for 2-byte words is unchanged), so wR0 and nw
//   are the same bits too. The stripes give 16 x 8 = 128 blocks at 6040 x
//   3952, one an SM; a warp loads the next A16_DEPTH = 4 rows (of its tile
//   or its next tile) while it works the current ones, which keeps ~64 KB
//   of loads in flight an SM. 0.064 ms, 66% of the 16-bit byte bound
//   (0.0428 ms; R.add_(M) on the same bytes 0.054-0.057 ms); 2, 6 or 8
//   rows in flight measured slower (tools/bench_masked_kernels.py
//   --variants; PERF.md).
// - B4: lane l owns columns 8l .. 8l + 7 of each 256-column step and adds
//   them in order before the shuffle tree, so the row sums take another
//   order than the scalar form's (and their bits differ from it). One
//   step in flight keeps 40 registers and the 1510 blocks in one wave
//   (two steps: 48 registers, two waves, 16% slower). 0.056 ms, 76%.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "storage.cuh"

namespace cg = cooperative_groups;

#define A_WARPS 8         // warps per B3 block
#define A_TILE 32         // rows per B3 tile (one per lane when staged)
#define A_DEPTH 4         // rows in flight per B3 thread and array
#define A_MAX_CLUSTER 8   // the portable cluster size
#define B_ROWS 4          // rows (warps) per B4 block
#ifndef DEPTH
#define DEPTH 8           // loads in flight per B4 thread and array
#endif
#ifndef A16_DEPTH
#define A16_DEPTH 4       // rows in flight per thread and array, B3 packed
#endif
#ifndef B16_DEPTH
#define B16_DEPTH 1       // 256-column steps in flight per warp, B4 packed
#endif

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return fma(a, b, c);
}

// 16-byte loads and stores of a lane's VEC consecutive words
__device__ __forceinline__ void ld16(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void ld16(const double* p, double (&x)[2]) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  x[0] = v.x;
  x[1] = v.y;
}
__device__ __forceinline__ void st16(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void st16(double* p, const double (&x)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(x[0], x[1]);
}

// B3; see the header. Launched as a grid of (stripes, cluster) blocks of
// A_WARPS warps in clusters of (1, cluster, 1). S: the storage type of R,
// M and the vectors; T = Storage<S>::Work, that of the sums.
template <typename S, typename T, bool VECTOR>
__global__ void __launch_bounds__(A_WARPS * 32)
    phase_a_kernel(S* __restrict__ R, const S* __restrict__ M,
                   const S* __restrict__ dw, const S* __restrict__ tp,
                   const S* __restrict__ w, T* __restrict__ wR0,
                   T* __restrict__ nw, int n, int d) {
  typedef Storage<S> St;
  constexpr int VEC = 16 / sizeof(S);
  constexpr int COLS = 32 * VEC;
  constexpr bool PACKED = St::narrow && VECTOR;
  __shared__ T stage[A_WARPS][3][A_TILE];  // a warp's tile: dw, w, w*w
  __shared__ T part[A_WARPS][2][COLS];     // the warps' sums
  __shared__ T sums[2][COLS];              // the block's sums
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = blockIdx.x * COLS;

  // this lane's columns: j0 + VEC lane + v (16-byte form; all VEC in
  // range or none, as d % VEC == 0) or j0 + lane + 32 v (scalar form)
  bool ok[VEC];
  T tpj[VEC], s_wr[VEC], s_nw[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const int j = VECTOR ? j0 + VEC * lane + v : j0 + lane + 32 * v;
    ok[v] = j < d;
    tpj[v] = ok[v] ? St::load(tp[j]) : T(0);
    s_wr[v] = T(0);
    s_nw[v] = T(0);
  }
  const int jl = VECTOR ? j0 + VEC * lane : j0 + lane;

  // this rank's tiles, dealt to its warps in turn
  const int tiles = (n + A_TILE - 1) / A_TILE;
  const int per = (tiles + csize - 1) / csize;
  const int t_end = min(tiles, (rank + 1) * per);
  // 16 bits, 16-byte form: a row's 8 values a lane stay packed in one
  // 16-byte word of R and one of M until used; each pair is widened,
  // stepped as the scalar form steps each value, and rounded at once. The
  // warp's next A16_DEPTH rows (of this tile or of its next) are loaded
  // into xn, mn while the current ones are worked.
  uint4 xn[A16_DEPTH], mn[A16_DEPTH];
  auto fetch = [&](int t, int r) {  // rows r, r + 1, ... of tile t
    const int i0 = t * A_TILE, rows = min(A_TILE, n - i0);
#pragma unroll
    for (int u = 0; u < A16_DEPTH; ++u) {
      const size_t o = (size_t)(i0 + r + u) * d + jl;
      if (r + u < rows && ok[0]) {
        xn[u] = *reinterpret_cast<const uint4*>(R + o);
        mn[u] = *reinterpret_cast<const uint4*>(M + o);
      } else {
        xn[u] = mn[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  if constexpr (PACKED) {
    if (rank * per + warp < t_end) fetch(rank * per + warp, 0);
  }
  // lane l holds dw, w of row l of the warp's next tile, loaded a tile
  // ahead so that staging never waits on memory
  T a_next = T(0), b_next = T(0);
  {
    const int t = rank * per + warp, i = t * A_TILE + lane;
    if (t < t_end && i < n) {
      a_next = St::load(dw[i]);
      b_next = St::load(w[i]);
    }
  }
  for (int t = rank * per + warp; t < t_end; t += A_WARPS) {
    const int i0 = t * A_TILE;
    const int rows = min(A_TILE, n - i0);
    __syncwarp();  // the previous tile's stage is read by every lane
    stage[warp][0][lane] = a_next;
    stage[warp][1][lane] = b_next;
    stage[warp][2][lane] =
        St::narrow ? rnd<S>(b_next * b_next) : b_next * b_next;
    __syncwarp();
    {
      const int i = (t + A_WARPS) * A_TILE + lane;
      const bool more = t + A_WARPS < t_end && i < n;
      a_next = more ? St::load(dw[i]) : T(0);
      b_next = more ? St::load(w[i]) : T(0);
    }
    if constexpr (PACKED) {
      for (int r = 0; r < rows; r += A16_DEPTH) {
        uint4 x[A16_DEPTH], m[A16_DEPTH];
#pragma unroll
        for (int u = 0; u < A16_DEPTH; ++u) {
          x[u] = xn[u];
          m[u] = mn[u];
        }
        if (r + A16_DEPTH < rows)
          fetch(t, r + A16_DEPTH);
        else if (t + A_WARPS < t_end)
          fetch(t + A_WARPS, 0);
#pragma unroll
        for (int u = 0; u < A16_DEPTH; ++u) {
          if (r + u < rows) {
            const T dwi = stage[warp][0][r + u];
            const T wi = stage[warp][1][r + u];
            const T w2i = stage[warp][2][r + u];
            unsigned int xw[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
            const unsigned int mw[4] = {m[u].x, m[u].y, m[u].z, m[u].w};
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              const float2 xv = St::load2(xw[p]), mv = St::load2(mw[p]);
              const float2 step = rnd2<S>(
                  make_float2(dwi * tpj[2 * p], dwi * tpj[2 * p + 1]));
              xw[p] = St::store2(make_float2(xv.x + step.x, xv.y + step.y));
              const float2 xs = St::load2(xw[p]);
              const float2 mx =
                  rnd2<S>(make_float2(mv.x * xs.x, mv.y * xs.y));
              s_wr[2 * p] = fma_(wi, mx.x, s_wr[2 * p]);
              s_wr[2 * p + 1] = fma_(wi, mx.y, s_wr[2 * p + 1]);
              s_nw[2 * p] = fma_(w2i, mv.x, s_nw[2 * p]);
              s_nw[2 * p + 1] = fma_(w2i, mv.y, s_nw[2 * p + 1]);
            }
            if (ok[0])
              *reinterpret_cast<uint4*>(R + (size_t)(i0 + r + u) * d + jl) =
                  make_uint4(xw[0], xw[1], xw[2], xw[3]);
          }
        }
      }
    } else {
      for (int r = 0; r < rows; r += A_DEPTH) {
        T x[A_DEPTH][VEC], m[A_DEPTH][VEC];
#pragma unroll
        for (int u = 0; u < A_DEPTH; ++u) {
          const bool live = r + u < rows;  // the same for the whole warp
          const size_t o = (size_t)(i0 + r + u) * d + jl;
          if constexpr (VECTOR) {
            if (live && ok[0]) {
              ld16(R + o, x[u]);
              ld16(M + o, m[u]);
            } else {
#pragma unroll
              for (int v = 0; v < VEC; ++v) x[u][v] = m[u][v] = T(0);
            }
          } else {
#pragma unroll
            for (int v = 0; v < VEC; ++v) {
              const bool in = live && ok[v];
              x[u][v] = in ? St::load(R[o + 32 * v]) : T(0);
              m[u][v] = in ? St::load(M[o + 32 * v]) : T(0);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < A_DEPTH; ++u) {
          if (r + u < rows) {
            const T dwi = stage[warp][0][r + u];
            const T wi = stage[warp][1][r + u];
            const T w2i = stage[warp][2][r + u];
#pragma unroll
            for (int v = 0; v < VEC; ++v) {
              if constexpr (St::narrow) {
                x[u][v] = rnd<S>(x[u][v] + rnd<S>(dwi * tpj[v]));
                s_wr[v] = fma_(wi, rnd<S>(m[u][v] * x[u][v]), s_wr[v]);
              } else {
                x[u][v] = fma_(dwi, tpj[v], x[u][v]);
                s_wr[v] = fma_(wi, m[u][v] * x[u][v], s_wr[v]);
              }
              s_nw[v] = fma_(w2i, m[u][v], s_nw[v]);
            }
            const size_t o = (size_t)(i0 + r + u) * d + jl;
            if constexpr (VECTOR) {
              if (ok[0]) st16(R + o, x[u]);
            } else {
#pragma unroll
              for (int v = 0; v < VEC; ++v)
                if (ok[v]) R[o + 32 * v] = St::store(x[u][v]);
            }
          }
        }
      }
    }
  }

  // warps in order, then cluster ranks in order
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const int c = VECTOR ? VEC * lane + v : lane + 32 * v;
    part[warp][0][c] = s_wr[v];
    part[warp][1][c] = s_nw[v];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * COLS; e += A_WARPS * 32) {
    const int kind = e / COLS, c = e % COLS;
    T s = part[0][kind][c];
#pragma unroll
    for (int q = 1; q < A_WARPS; ++q) s += part[q][kind][c];
    sums[kind][c] = s;
  }
  cluster.sync();  // every rank's sums are written
  if (rank == 0) {
    for (int e = threadIdx.x; e < 2 * COLS; e += A_WARPS * 32) {
      T s = (&sums[0][0])[e];
      for (int q = 1; q < csize; ++q)
        s += cluster.map_shared_rank(&sums[0][0], q)[e];
      const int kind = e / COLS, j = j0 + e % COLS;
      if (j < d) (kind ? nw : wR0)[j] = s;
    }
  }
  cluster.sync();  // no rank leaves before rank 0 has read its sums
}

// B4's element step: the rank-one updates of r (R's element), stored to
// *out before its terms of the two row sums are added (with the store
// after the sums, nvcc's schedule ran B4 markedly slower on the card)
template <typename S, typename T>
__device__ __forceinline__ void b_step(S* out, T r, T m, T wi, T ei, T to,
                                       T tn, T& s_rt, T& s_mt2) {
  if constexpr (Storage<S>::narrow) {
    // ((R + w t_old) - w_eff t_new), each product and sum in 16 bits
    r = rnd<S>(rnd<S>(r + rnd<S>(wi * to)) - rnd<S>(-ei * tn));
    *out = Storage<S>::store(r);
    s_rt = fma_(rnd<S>(m * r), tn, s_rt);
    s_mt2 = fma_(m, rnd<S>(tn * tn), s_mt2);
  } else {
    r = fma_(ei, tn, fma_(wi, to, r));
    *out = r;
    s_rt = fma_(m * r, tn, s_rt);
    s_mt2 = fma_(m, tn * tn, s_mt2);
  }
}

template <typename S, typename T>
__global__ void phase_b_kernel(S* __restrict__ R, const S* __restrict__ M,
                               const S* __restrict__ w,
                               const S* __restrict__ weff,
                               const S* __restrict__ told,
                               const S* __restrict__ tnew,
                               T* __restrict__ Rt, T* __restrict__ mt2, int n,
                               int d) {
  typedef Storage<S> St;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * B_ROWS + (threadIdx.x >> 5);
  if (i >= n) return;  // the whole warp leaves together
  const T wi = St::load(w[i]);
  const T ei = -St::load(weff[i]);
  S* Ri = R + (size_t)i * d;
  const S* Mi = M + (size_t)i * d;
  T s_rt = 0, s_mt2 = 0;
  int j = lane;
  for (; j + 32 * (DEPTH - 1) < d; j += 32 * DEPTH) {
    T r[DEPTH], m[DEPTH];
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      r[u] = St::load(Ri[j + 32 * u]);
      m[u] = St::load(Mi[j + 32 * u]);
    }
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      const int jj = j + 32 * u;
      const T tn = St::load(tnew[jj]);
      b_step<S>(Ri + jj, r[u], m[u], wi, ei, St::load(told[jj]), tn, s_rt,
                s_mt2);
    }
  }
  for (; j < d; j += 32) {
    const T tn = St::load(tnew[j]);
    b_step<S>(Ri + j, St::load(Ri[j]), St::load(Mi[j]), wi, ei,
              St::load(told[j]), tn, s_rt, s_mt2);
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

// B4's element step on a packed 16-byte word of 8 16-bit values: the
// rank-one updates of each pair as b_step does them, R's new word stored
// to *out before the sums take the 8 columns in order
template <typename S>
__device__ __forceinline__ void b_step_packed(uint4* out, uint4 r, uint4 m,
                                              float wi, float ei, uint4 to,
                                              uint4 tn, float& s_rt,
                                              float& s_mt2) {
  typedef Storage<S> St;
  const unsigned int rw[4] = {r.x, r.y, r.z, r.w};
  const unsigned int mw[4] = {m.x, m.y, m.z, m.w};
  const unsigned int ow[4] = {to.x, to.y, to.z, to.w};
  const unsigned int nw[4] = {tn.x, tn.y, tn.z, tn.w};
  unsigned int yw[4];
  float2 tv[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float2 rv = St::load2(rw[p]), ov = St::load2(ow[p]);
    tv[p] = St::load2(nw[p]);
    const float2 a = rnd2<S>(make_float2(wi * ov.x, wi * ov.y));
    const float2 b = rnd2<S>(make_float2(rv.x + a.x, rv.y + a.y));
    const float2 c = rnd2<S>(make_float2(-ei * tv[p].x, -ei * tv[p].y));
    yw[p] = St::store2(make_float2(b.x - c.x, b.y - c.y));
  }
  *out = make_uint4(yw[0], yw[1], yw[2], yw[3]);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float2 rv = St::load2(yw[p]), mv = St::load2(mw[p]);
    const float2 mr = rnd2<S>(make_float2(mv.x * rv.x, mv.y * rv.y));
    const float2 t2 = rnd2<S>(make_float2(tv[p].x * tv[p].x,
                                          tv[p].y * tv[p].y));
    s_rt = fmaf(mr.x, tv[p].x, s_rt);
    s_rt = fmaf(mr.y, tv[p].y, s_rt);
    s_mt2 = fmaf(mv.x, t2.x, s_mt2);
    s_mt2 = fmaf(mv.y, t2.y, s_mt2);
  }
}

// B4 in the 16-bit 16-byte form (d % 8 == 0, R, M, t_old, t_new 16-byte
// aligned): one warp a row as in phase_b_kernel, but lane l owns the 8
// columns j + 8l ... j + 8l + 7 of each 256-column step j and moves them
// in 16-byte words, B16_DEPTH steps of R and M in flight. Each lane adds
// its columns in order, then the same shuffle tree adds the lanes.
template <typename S>
__global__ void phase_b_packed_kernel(
    S* __restrict__ R, const S* __restrict__ M, const S* __restrict__ w,
    const S* __restrict__ weff, const S* __restrict__ told,
    const S* __restrict__ tnew, float* __restrict__ Rt,
    float* __restrict__ mt2, int n, int d) {
  typedef Storage<S> St;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * B_ROWS + (threadIdx.x >> 5);
  if (i >= n) return;  // the whole warp leaves together
  const float wi = St::load(w[i]);
  const float ei = -St::load(weff[i]);
  S* Ri = R + (size_t)i * d;
  const S* Mi = M + (size_t)i * d;
  float s_rt = 0.f, s_mt2 = 0.f;
  for (int j = 8 * lane; j < d; j += 256 * B16_DEPTH) {
    uint4 r[B16_DEPTH], m[B16_DEPTH];
#pragma unroll
    for (int u = 0; u < B16_DEPTH; ++u) {
      const int jj = j + 256 * u;
      if (jj < d) {
        r[u] = *reinterpret_cast<const uint4*>(Ri + jj);
        m[u] = *reinterpret_cast<const uint4*>(Mi + jj);
      } else {
        r[u] = m[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int u = 0; u < B16_DEPTH; ++u) {
      const int jj = j + 256 * u;
      if (jj < d)
        b_step_packed<S>(reinterpret_cast<uint4*>(Ri + jj), r[u], m[u], wi,
                         ei, *reinterpret_cast<const uint4*>(told + jj),
                         *reinterpret_cast<const uint4*>(tnew + jj), s_rt,
                         s_mt2);
    }
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

template <typename S, typename T, bool VECTOR>
static cudaError_t launch_a(S* R, const S* M, const S* dw, const S* tp,
                            const S* w, T* wR0, T* nw, int n, int d,
                            int cluster, cudaStream_t stream) {
  constexpr int COLS = 32 * (16 / sizeof(S));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((d + COLS - 1) / COLS, cluster, 1);
  cfg.blockDim = dim3(A_WARPS * 32, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, phase_a_kernel<S, T, VECTOR>, R, M, dw,
                            tp, w, wR0, nw, n, d);
}

// One B3 launch in clusters of `cluster` blocks (1..8); returns the CUDA
// error, the launch's own if the cluster launch is refused. The 16-byte
// form where the shape and alignment allow it, else the scalar form.
template <typename S, typename T>
static int launch_phase_a(S* R, const S* M, const S* dw, const S* tp,
                          const S* w, T* wR0, T* nw, int n, int d,
                          int cluster, int device, void* stream) {
  if (n <= 0 || d <= 0 || cluster < 1 || cluster > A_MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool vector = d % (16 / sizeof(S)) == 0 &&
                      ((uintptr_t)R | (uintptr_t)M) % 16 == 0;
  err = vector ? launch_a<S, T, true>(R, M, dw, tp, w, wR0, nw, n, d,
                                      cluster, (cudaStream_t)stream)
               : launch_a<S, T, false>(R, M, dw, tp, w, wR0, nw, n, d,
                                       cluster, (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();  // clears a launch error
  return (int)(err != cudaSuccess ? err : last);
}

template <typename S, typename T>
static int launch_phase_b(S* R, const S* M, const S* w, const S* weff,
                          const S* told, const S* tnew, T* Rt, T* mt2, int n,
                          int d, int device, void* stream) {
  if (n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + B_ROWS - 1) / B_ROWS;
  if constexpr (Storage<S>::narrow) {
    if (d % 8 == 0 && ((uintptr_t)R | (uintptr_t)M | (uintptr_t)told |
                       (uintptr_t)tnew) % 16 == 0) {
      phase_b_packed_kernel<S><<<blocks, 32 * B_ROWS, 0,
                                 (cudaStream_t)stream>>>(
          R, M, w, weff, told, tnew, Rt, mt2, n, d);
      return (int)cudaGetLastError();
    }
  }
  phase_b_kernel<S, T><<<blocks, 32 * B_ROWS, 0, (cudaStream_t)stream>>>(
      R, M, w, weff, told, tnew, Rt, mt2, n, d);
  return (int)cudaGetLastError();
}

#define MASKED_API(SUF, S, T)                                                \
  extern "C" int rri_masked_phase_a_##SUF(                                   \
      void* R, const void* M, const void* dw, const void* tp, const void* w, \
      void* wR0, void* nw, int n, int d, int cluster, int device,            \
      void* stream) {                                                        \
    return launch_phase_a<S, T>((S*)R, (const S*)M, (const S*)dw,            \
                                (const S*)tp, (const S*)w, (T*)wR0, (T*)nw,  \
                                n, d, cluster, device, stream);              \
  }                                                                          \
  extern "C" int rri_masked_phase_b_##SUF(                                   \
      void* R, const void* M, const void* w, const void* weff,               \
      const void* told, const void* tnew, void* Rt, void* mt2, int n, int d, \
      int device, void* stream) {                                            \
    return launch_phase_b<S, T>((S*)R, (const S*)M, (const S*)w,             \
                                (const S*)weff, (const S*)told,              \
                                (const S*)tnew, (T*)Rt, (T*)mt2, n, d,       \
                                device, stream);                             \
  }

MASKED_API(f32, float, float)
MASKED_API(f64, double, double)
MASKED_API(bf16, __nv_bfloat16, float)
MASKED_API(f16, __half, float)
