// Per-dtype arithmetic of the port's min-sum kernels (layered_minsum.cu,
// flooding_minsum.cu), so that one kernel template serves float32, bfloat16,
// int8 and int16 LLRs with the roundings and saturation points of the plain
// versions (ops/qc_minsum.py layered_minsum_plain, flooding_minsum_plain).
//
//   * float32 computes in float32 and spells out every rounding
//     (__fadd_rn/__fsub_rn/__fmul_rn; the build also has --fmad=false);
//   * bfloat16 stores in bfloat16 and computes in float32, as the TPU
//     kernels' bf16 form does (pallas_qc.py:38-41): the arithmetic is
//     float32's, and a value is rounded to bfloat16 (round to nearest even)
//     where a kernel stores it: the posterior after each update
//     (bf16(va + bf16(d))), and |t| as the two-min sees it (|bf16(t)|);
//   * int8/int16 compute in int32: a message (an extrinsic t or v, a
//     posterior of the flooding schedule) saturates to the storage type's
//     range, and |x| saturates at its max (|-128| -> 127), as the reference's
//     DecodeFrom does (decoder.rs:42-55).
//
// Besides the compute type A, each Arith has ld/st (storage T <-> A) and two
// hooks: post(va, d), the posterior update, and sat_abs(x), |x| of a message
// as the two-min sees it.
#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>

namespace ms {

template <typename T>
struct Arith;

struct FloatArith {
  using A = float;  // compute type
  __device__ static __forceinline__ float big() { return FLT_MAX; }  // two-min seed
  __device__ static __forceinline__ float sat(float x) { return x; }
  __device__ static __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  __device__ static __forceinline__ float abs(float x) { return fabsf(x); }
  __device__ static __forceinline__ float min(float a, float b) { return fminf(a, b); }
  __device__ static __forceinline__ float scale(float alpha, float m) { return __fmul_rn(alpha, m); }
};

template <>
struct Arith<float> : FloatArith {
  __device__ static __forceinline__ float ld(float x) { return x; }
  __device__ static __forceinline__ float st(float x) { return x; }
  __device__ static __forceinline__ float post(float va, float d) { return __fadd_rn(va, d); }
  __device__ static __forceinline__ float sat_abs(float x) { return fabsf(x); }
};

template <>
struct Arith<__nv_bfloat16> : FloatArith {
  __device__ static __forceinline__ float ld(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __forceinline__ __nv_bfloat16 st(float x) { return __float2bfloat16_rn(x); }
  // x rounded to bfloat16 and back: what a bf16 store and load give
  __device__ static __forceinline__ float rnd(float x) { return ld(st(x)); }
  __device__ static __forceinline__ float post(float va, float d) {
    return rnd(__fadd_rn(va, rnd(d)));
  }
  __device__ static __forceinline__ float sat_abs(float x) { return fabsf(rnd(x)); }
};

template <typename T, int LO, int HI>
struct IntArith {
  using A = int;
  __device__ static __forceinline__ int ld(T x) { return static_cast<int>(x); }
  __device__ static __forceinline__ T st(int x) { return static_cast<T>(x); }
  __device__ static __forceinline__ int big() { return HI; }
  __device__ static __forceinline__ int sat(int x) { return ::min(::max(x, LO), HI); }
  // the operands are within (1 + degree) * 32767 < 2^24: no int32 overflow
  __device__ static __forceinline__ int add(int a, int b) { return a + b; }
  __device__ static __forceinline__ int sub(int a, int b) { return a - b; }
  // the layered posterior stays wide (never clipped); the flooding kernel
  // clips it with sat() after each update
  __device__ static __forceinline__ int post(int va, int d) { return va + d; }
  __device__ static __forceinline__ int abs(int x) { return ::abs(x); }
  __device__ static __forceinline__ int sat_abs(int x) { return ::min(::abs(x), HI); }
  __device__ static __forceinline__ int min(int a, int b) { return ::min(a, b); }
  __device__ static __forceinline__ int scale(float, int m) { return m; }  // alpha: float only
};

template <>
struct Arith<int8_t> : IntArith<int8_t, -128, 127> {};
template <>
struct Arith<int16_t> : IntArith<int16_t, -32768, 32767> {};

}  // namespace ms
