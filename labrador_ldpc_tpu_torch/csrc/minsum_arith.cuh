// Per-dtype arithmetic of the port's min-sum kernels (layered_minsum.cu,
// flooding_minsum.cu), so that one kernel template serves float32, int8 and
// int16 LLRs with the roundings and saturation points of the plain versions
// (ops/qc_minsum.py layered_minsum_plain, flooding_minsum_plain).
//
//   * float32 computes in float32 and spells out every rounding
//     (__fadd_rn/__fsub_rn/__fmul_rn; the build also has --fmad=false);
//   * int8/int16 compute in int32: a message (an extrinsic t or v, a
//     posterior of the flooding schedule) saturates to the storage type's
//     range, and |x| saturates at its max (|-128| -> 127), as the reference's
//     DecodeFrom does (decoder.rs:42-55).
#pragma once

#include <cfloat>
#include <cstdint>

namespace ms {

template <typename T>
struct Arith;

template <>
struct Arith<float> {
  using A = float;  // compute type
  __device__ static __forceinline__ float big() { return FLT_MAX; }  // two-min seed
  __device__ static __forceinline__ float sat(float x) { return x; }
  __device__ static __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  __device__ static __forceinline__ float abs(float x) { return fabsf(x); }
  // |x| of a message as the two-min sees it
  __device__ static __forceinline__ float sat_abs(float x) { return fabsf(x); }
  __device__ static __forceinline__ float min(float a, float b) { return fminf(a, b); }
  __device__ static __forceinline__ float scale(float alpha, float m) { return __fmul_rn(alpha, m); }
};

template <int LO, int HI>
struct IntArith {
  using A = int;
  __device__ static __forceinline__ int big() { return HI; }
  __device__ static __forceinline__ int sat(int x) { return ::min(::max(x, LO), HI); }
  // the operands are within (1 + degree) * 32767 < 2^24: no int32 overflow
  __device__ static __forceinline__ int add(int a, int b) { return a + b; }
  __device__ static __forceinline__ int sub(int a, int b) { return a - b; }
  __device__ static __forceinline__ int abs(int x) { return ::abs(x); }
  __device__ static __forceinline__ int sat_abs(int x) { return ::min(::abs(x), HI); }
  __device__ static __forceinline__ int min(int a, int b) { return ::min(a, b); }
  __device__ static __forceinline__ int scale(float, int m) { return m; }  // alpha: float only
};

template <>
struct Arith<int8_t> : IntArith<-128, 127> {};
template <>
struct Arith<int16_t> : IntArith<-32768, 32767> {};

}  // namespace ms
