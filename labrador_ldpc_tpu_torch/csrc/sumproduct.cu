// Row-layered sum-product (belief propagation) LDPC decoder for Hopper
// (sm_90a), float32.
//
// Replaces the TPU kernel labrador_ldpc_tpu/ops/pallas_sp.py:48
// make_sp_decoder_pallas (lane-major, M >= 512), pinned bit-exact there to the
// XLA twin labrador_ldpc_tpu/ops/sumproduct.py:132 make_sp_decoder_layered,
// which the JAX package serves itself for the M <= 256 codes
// (pallas_sp.py:63-68). One kernel covers all nine codes through the
// per-addend QC table of qc_addend.cuh. The plain version, the same function
// in the same float32 operations, is labrador_ldpc_tpu_torch/ops/sumproduct.py
// layered_sp_plain.
//
// Per layer, for each check i of the block row (a thread per check, looping
// over the row's addends):
//   pass 1: t = perm(va[col]) - u_old, ph = phi(|t|); the layer's phi sum,
//     accumulated from the first addend in addend order, and its sign product
//     (t < 0: -0.0 counts as positive);
//   pass 2, addend by addend: u = +-phi(phi_sum - ph), the sign being the
//     product without this addend's, and va[col] += perm_inv(u - u_old).
// phi(x) = log((1 + e^-x) / (1 - e^-x)) with x clamped to [PHI_EPS, PHI_CLIP]:
// the exp/log form of -ln tanh(x/2), as the plain version writes it. After the
// last layer the syndrome is taken on the signs of va; a codeword that
// satisfies every check stops there with those bits.
//
// Design. One CTA decodes one codeword (grid = B), and its whole state lives
// in dynamic shared memory: the posteriors va (V floats), the check messages u
// (sumA*M, zeroed, so iteration 0 needs no peel: g - 0 is g), the layer's
// phi(|t|) (widest row * M; t's sign rides on the sign bit, and a zero phi of
// a negative t is stored as -0.0, so no sign is lost), its phi sums (M floats)
// and sign products (M bytes). TM8192 takes 223,232 B, under the 232,448 B a
// block can address. Unlike the layered min-sum kernel there is no t' plane,
// so u fits on chip: nothing but the input and the result touches device
// memory, and there is no scratch.
//
// What bounds it: operations. Each edge takes two phi per iteration, each an
// expf, a logf and an IEEE division besides the clamp and two adds, and the
// index arithmetic of perm_index twice (three times with the syndrome), on
// shared memory. A TM8192 CTA fills an SM's shared memory, so one CTA of 512
// threads runs per SM there.
//
// Exactness against the plain version:
//   * every pass-1 read of va for a layer precedes any write (__syncthreads),
//     and the writes va += du run addend by addend in the plain version's
//     order with a __syncthreads between addends: every row of every code has
//     two addends on one block column (the I+Pi plane sums), so two addends
//     write the same variable within one layer;
//   * the posterior update is va + (u - u_old), never (va - u_old) + u;
//   * roundings spelled out (__fadd_rn/__fsub_rn/__fdiv_rn), and the build has
//     --fmad=false, so nothing is contracted into an FMA;
//   * expf and logf, the CUDA math library's functions, never __expf/__logf
//     and no --use_fast_math: PyTorch's exp and log on the card call the same
//     functions, so the plain version on the card computes the same phi.

#include <cstdint>
#include <cuda_runtime.h>

#include "qc_addend.cuh"

namespace {

using qc::kTableCols;
using qc::perm_index;

constexpr int kMaxThreads = 512;
constexpr float kPhiEps = 1e-6f;   // ops/sumproduct.py PHI_EPS
constexpr float kPhiClip = 25.0f;  // ops/sumproduct.py PHI_CLIP

// -ln tanh(x/2) of x clamped into [PHI_EPS, PHI_CLIP]; its own inverse
__device__ __forceinline__ float phi(float x) {
  x = fminf(fmaxf(x, kPhiEps), kPhiClip);
  const float em = expf(-x);
  return logf(__fdiv_rn(__fadd_rn(1.0f, em), __fsub_rn(1.0f, em)));
}

__global__ void __launch_bounds__(kMaxThreads) sumproduct_kernel(
    const float* __restrict__ llrs,        // (B, n) true channel LLRs
    uint8_t* __restrict__ bits,            // (B, V) out: hard bits 0/1
    uint8_t* __restrict__ success,         // (B,) out: 0/1
    int32_t* __restrict__ iterations,      // (B,) out
    const int* __restrict__ table,         // (sumA, 9)
    const int* __restrict__ row_off,       // (R + 1,) first addend of each block row
    int n, int M, int R, int Cc, int sumA, int max_row, int maxiters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int V = Cc * M;
  float* va = reinterpret_cast<float*>(smem_raw);             // (V,) posteriors
  float* us = va + V;                                         // (sumA*M,) check messages u
  float* phs = us + static_cast<size_t>(sumA) * M;            // (max_row*M,) signed phi(|t|)
  float* psum = phs + static_cast<size_t>(max_row) * M;       // (M,) the layer's phi sums
  uint8_t* sgs = reinterpret_cast<uint8_t*>(psum + M);        // (M,) the layer's sign products

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float* llr = llrs + static_cast<size_t>(b) * n;

  // posteriors start at the channel LLRs (punctured tail = 0), u at 0
  for (int v = tid; v < V; v += nt) va[v] = v < n ? llr[v] : 0.0f;
  for (int x = tid; x < sumA * M; x += nt) us[x] = 0.0f;
  __syncthreads();

  int converged = 0;
  int it_done = maxiters;
  for (int it = 0; it < maxiters; ++it) {
    for (int r = 0; r < R; ++r) {
      const int e0 = row_off[r], e1 = row_off[r + 1];
      // pass 1: extrinsics, their phi, the phi sum and the sign product
      for (int i = tid; i < M; i += nt) {
        float sum = 0.0f;
        int sg = 0;
        for (int e = e0; e < e1; ++e) {
          const int* a = table + e * kTableCols;
          const float t = __fsub_rn(va[a[1] * M + perm_index(a, i, M)], us[e * M + i]);
          const float ph = phi(fabsf(t));
          const bool neg = t < 0.0f;
          sum = e == e0 ? ph : __fadd_rn(sum, ph);
          sg ^= neg ? 1 : 0;
          phs[(e - e0) * M + i] = neg ? -ph : ph;  // read back by this thread only
        }
        psum[i] = sum;
        sgs[i] = static_cast<uint8_t>(sg);
      }
      __syncthreads();  // every read of va for this layer precedes any write
      // pass 2: new u; va[col] += perm_inv(u - u_old), addend by addend
      for (int e = e0; e < e1; ++e) {
        const int* a = table + e * kTableCols;
        float* vcol = va + a[1] * M;
        for (int i = tid; i < M; i += nt) {
          const float sph = phs[(e - e0) * M + i];
          const float mag = phi(__fsub_rn(psum[i], fabsf(sph)));
          const bool neg = (sgs[i] != 0) != ((__float_as_uint(sph) >> 31) != 0);  // sign bit
          const float u = neg ? -mag : mag;
          const int v = perm_index(a, i, M);
          vcol[v] = __fadd_rn(vcol[v], __fsub_rn(u, us[e * M + i]));
          us[e * M + i] = u;
        }
        __syncthreads();  // two addends of a layer may share a column
      }
    }
    // end-of-iteration syndrome over the final posteriors
    int bad = 0;
    for (int c = tid; c < R * M; c += nt) {
      const int r = c / M, i = c - r * M;
      int par = 0;
      for (int e = row_off[r]; e < row_off[r + 1]; ++e) {
        const int* a = table + e * kTableCols;
        par ^= va[a[1] * M + perm_index(a, i, M)] < 0.0f ? 1 : 0;
      }
      bad |= par;
    }
    if (!__syncthreads_or(bad)) {  // uniform across the block
      converged = 1;
      it_done = it;
      break;  // the bits of this iteration are the frozen result
    }
  }

  // a converged codeword reports the signs of its convergence iteration, a
  // failed one those of its last; no iteration at all (maxiters = 0) gives 0
  uint8_t* out = bits + static_cast<size_t>(b) * V;
  for (int v = tid; v < V; v += nt) out[v] = (maxiters > 0 && va[v] < 0.0f) ? 1 : 0;
  if (tid == 0) {
    success[b] = static_cast<uint8_t>(converged);
    iterations[b] = it_done;
  }
}

struct Config {
  int threads;
  size_t smem;
};

Config config(int M, int Cc, int sumA, int max_row) {
  int threads = M < kMaxThreads ? M : kMaxThreads;
  threads = (threads + 31) / 32 * 32;
  // va, u, the layer's phi(|t|) and phi sums (floats), then the sign bytes
  const size_t floats = static_cast<size_t>(Cc) * M + static_cast<size_t>(sumA) * M +
                        static_cast<size_t>(max_row) * M + M;
  return Config{threads, floats * 4 + static_cast<size_t>(M)};
}

}  // namespace

// Plain C interface, loaded with ctypes. sumproduct_f32 launches on `stream`,
// does not synchronise, allocates nothing, and returns the cudaError_t of the
// launch. sumproduct_f32_config reports the launch shape of a code: threads
// per CTA, dynamic shared bytes per CTA, and CTAs that fit on one SM.
extern "C" int sumproduct_f32(const float* llrs, uint8_t* bits, uint8_t* success,
                              int32_t* iterations, const int* table, const int* row_off, int B,
                              int n, int M, int R, int Cc, int sumA, int max_row, int maxiters,
                              void* stream) {
  const Config cfg = config(M, Cc, sumA, max_row);
  cudaError_t err = cudaFuncSetAttribute(
      sumproduct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(cfg.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sumproduct_kernel<<<B, cfg.threads, cfg.smem, static_cast<cudaStream_t>(stream)>>>(
      llrs, bits, success, iterations, table, row_off, n, M, R, Cc, sumA, max_row, maxiters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sumproduct_f32_config(int M, int Cc, int sumA, int max_row, int* threads,
                                     int* smem, int* ctas_per_sm) {
  const Config cfg = config(M, Cc, sumA, max_row);
  *threads = cfg.threads;
  *smem = static_cast<int>(cfg.smem);
  cudaError_t err = cudaFuncSetAttribute(
      sumproduct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(cfg.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, sumproduct_kernel, cfg.threads, cfg.smem));
}
