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
    return __float2bfloat16_rn(x);
  }
  // the value whose 16 bits are `bits`
  __device__ __forceinline__ static float bits(unsigned short u) {
    return __bfloat162float(__ushort_as_bfloat16(u));
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
};

// a work value rounded to storage and back
template <typename S>
__device__ __forceinline__ typename Storage<S>::Work rnd(
    typename Storage<S>::Work x) {
  return Storage<S>::load(Storage<S>::store(x));
}
