// Storage types of the kernels and their work types.
//
// A kernel reads and writes its factor (and, for the masked passes, its
// residual and mask) in a storage type S and computes in the work type
// Storage<S>::Work: float32 and float64 are their own work type; bfloat16
// and float16 are stored in 16 bits and worked in float32, as the JAX
// package's kernels work a 16-bit tile in a float32 copy. load() widens a
// stored value exactly; store() rounds a work value to nearest even, as
// XLA's and PyTorch's casts do; rnd() is the round trip, a work value
// rounded to what storage holds (where JAX computes in 16 bits).
//
// The 16-bit types also work in packed pairs, two values of one 32-bit
// word (the lower address in the low half): load2() widens both, store2()
// rounds two work values to nearest even at once, each as store() does.
//
// bfloat16's store() rounds through the paired conversion
// (cvt.rn.bf16x2.f32, one F2FP.BF16.F32.PACK_AB) with a zero beside it:
// ptxas compiles the single cvt.rn.bf16.f32 for sm_90a to F2F.BF16.F32 on
// the SM's slower conversion pipe, where float16's cvt.rn.f16.f32 becomes
// an F2FP.F16.F32.PACK_AB, and in a pass that rounds several times per
// element that held bfloat16 at 1.7x float16 (B4's scalar form; PERF.md).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

template <typename S>
struct Storage;

template <>
struct Storage<float> {
  typedef float Work;
  static constexpr bool narrow = false;
  __device__ __forceinline__ static float load(float x) { return x; }
  __device__ __forceinline__ static float store(float x) { return x; }
};

template <>
struct Storage<double> {
  typedef double Work;
  static constexpr bool narrow = false;
  __device__ __forceinline__ static double load(double x) { return x; }
  __device__ __forceinline__ static double store(double x) { return x; }
};

template <>
struct Storage<__nv_bfloat16> {
  typedef float Work;
  static constexpr bool narrow = true;
  __device__ __forceinline__ static float load(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ __forceinline__ static __nv_bfloat16 store(float x) {
    return __low2bfloat16(__floats2bfloat162_rn(x, 0.f));
  }
  // the value whose 16 bits are `bits`
  __device__ __forceinline__ static float bits(unsigned short u) {
    return __bfloat162float(__ushort_as_bfloat16(u));
  }
  __device__ __forceinline__ static float2 load2(unsigned int u) {
    return make_float2(__uint_as_float(u << 16),
                       __uint_as_float(u & 0xffff0000u));
  }
  __device__ __forceinline__ static unsigned int store2(float2 x) {
    const __nv_bfloat162 h = __float22bfloat162_rn(x);
    return *reinterpret_cast<const unsigned int*>(&h);
  }
};

template <>
struct Storage<__half> {
  typedef float Work;
  static constexpr bool narrow = true;
  __device__ __forceinline__ static float load(__half x) {
    return __half2float(x);
  }
  __device__ __forceinline__ static __half store(float x) {
    return __float2half_rn(x);
  }
  __device__ __forceinline__ static float bits(unsigned short u) {
    return __half2float(__ushort_as_half(u));
  }
  __device__ __forceinline__ static float2 load2(unsigned int u) {
    return __half22float2(*reinterpret_cast<const __half2*>(&u));
  }
  __device__ __forceinline__ static unsigned int store2(float2 x) {
    const __half2 h = __float22half2_rn(x);
    return *reinterpret_cast<const unsigned int*>(&h);
  }
};

// a work value rounded to storage and back
template <typename S>
__device__ __forceinline__ typename Storage<S>::Work rnd(
    typename Storage<S>::Work x) {
  return Storage<S>::load(Storage<S>::store(x));
}

// a pair of work values rounded to storage and back
template <typename S>
__device__ __forceinline__ float2 rnd2(float2 x) {
  return Storage<S>::load2(Storage<S>::store2(x));
}
