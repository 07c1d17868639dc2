// Row-layered self-corrected min-sum LDPC decoder, float32, for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package, both pinned bit-exact to the
// XLA twin labrador_ldpc_tpu/ops/qc_minsum.py:223 make_ms_decoder_layered:
//   * labrador_ldpc_tpu/ops/pallas_qc.py:728 make_ms_decoder_pallas_layered
//     (lane-major, M >= 512: TM2048/5120/6144/8192), and
//   * labrador_ldpc_tpu/ops/pallas_tc.py:268 make_ms_decoder_pallas_tc_layered
//     (node-major, M <= 256: TC128/256/512, TM1280/1536).
// One kernel covers all nine codes: the QC structure (codes/expand.py
// qc_structure) arrives as a small int32 table per addend, so a block
// permutation is index arithmetic instead of the TPU kernels' static rolls.
// The plain version, bit for bit the same function, is
// labrador_ldpc_tpu_torch/ops/qc_minsum.py layered_minsum_plain.
//
// Design. One CTA decodes one codeword (grid = B); its threads loop over the
// M check nodes of a layer. The posteriors va (V floats) and the layer's
// two-min/sign statistics (3*M) live in dynamic shared memory (TM8192:
// 40,960 + 24,576 B). The per-edge check messages u and previous extrinsics
// t' (sumA*M floats each, 245,760 B per TM8192 codeword) do not fit in the
// 227 KB a block can address, so they live in a global scratch (B, sumA, M)
// that the wrapper allocates; iteration 0 is peeled (u = t' = 0 are not read),
// so the scratch needs no zeroing. Each codeword stops at its own
// convergence; the branch is uniform across the block (__syncthreads_or).
//
// What bounds it: the state traffic. Each iteration reads and writes u and t'
// for every edge, about 4*sumA*M*4 B per codeword (TM8192: 491,520 B), plus
// 4n + V B of input and output once. The 50 MB L2 holds the state of only
// about 170 TM8192 codewords, so at serving batches the state streams from
// device memory. (Pass 2 reads u and t' again; those second reads are of the
// layer just touched by pass 1 and mostly hit L2.)
//
// Exactness against the plain version:
//   * all pass-1 reads of va for a layer complete before any write
//     (__syncthreads), and the writes va += du run addend by addend in the
//     twin's order with a __syncthreads between addends: every row of every
//     code has two addends on one block column (the I+Pi plane sums), so two
//     addends write the same variable within one layer;
//   * the posterior update is va + (u - u_old), never (va - u_old) + u;
//   * no FMA contraction: built with --fmad=false, and the roundings are
//     spelled out with __fadd_rn/__fsub_rn/__fmul_rn besides.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#include "qc_addend.cuh"

namespace {

using qc::kTableCols;
using qc::perm_index;

__global__ void layered_minsum_f32_kernel(
    const float* __restrict__ llrs,        // (B, n)
    uint8_t* __restrict__ bits,            // (B, V) out: hard bits 0/1
    uint8_t* __restrict__ success,         // (B,) out: 0/1
    int32_t* __restrict__ iterations,      // (B,) out
    float* __restrict__ u_all,             // (B, sumA, M) scratch: check->var messages
    float* __restrict__ tp_all,            // (B, sumA, M) scratch: self-corrected extrinsics
    const int* __restrict__ table,         // (sumA, 9)
    const int* __restrict__ row_off,       // (R + 1,)
    int n, int M, int R, int Cc, int sumA, int maxiters, int use_alpha, float alpha) {
  extern __shared__ float smem[];
  const int V = Cc * M;
  float* va = smem;                                  // (V,) posteriors
  float* m1s = va + V;                               // (M,) smallest |t| of the layer
  float* m2s = m1s + M;                              // (M,) second smallest |t|
  int* sgs = reinterpret_cast<int*>(m2s + M);        // (M,) sign product

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float* llr = llrs + static_cast<size_t>(b) * n;
  float* U = u_all + static_cast<size_t>(b) * sumA * M;
  float* TP = tp_all + static_cast<size_t>(b) * sumA * M;

  // posteriors start at the channel LLRs; punctured tail = 0
  for (int v = tid; v < V; v += nt) va[v] = v < n ? llr[v] : 0.0f;
  __syncthreads();

  int converged = 0;
  int it_done = maxiters;
  for (int it = 0; it < maxiters; ++it) {
    const bool first = it == 0;  // u = t' = 0: peeled, scratch not read
    for (int r = 0; r < R; ++r) {
      const int e0 = row_off[r], e1 = row_off[r + 1];
      // pass 1: extrinsics t = perm(va) - u_old with self-correction; t goes
      // to the t' slot (read back by this same thread in pass 2)
      for (int i = tid; i < M; i += nt) {
        float m1 = FLT_MAX, m2 = FLT_MAX;
        int sg = 0;
        for (int e = e0; e < e1; ++e) {
          const int* a = table + e * kTableCols;
          const float g = va[a[1] * M + perm_index(a, i, M)];
          const float u_old = first ? 0.0f : U[e * M + i];
          const float tp = first ? 0.0f : TP[e * M + i];
          float t = __fsub_rn(g, u_old);
          const bool keep = ((t < 0.0f) == (tp < 0.0f)) || (tp == 0.0f);
          t = keep ? t : 0.0f;
          TP[e * M + i] = t;
          const float a1 = fabsf(t);
          m2 = a1 < m1 ? m1 : fminf(m2, a1);
          m1 = fminf(m1, a1);
          sg ^= t < 0.0f ? 1 : 0;
        }
        m1s[i] = m1;
        m2s[i] = m2;
        sgs[i] = sg;
      }
      __syncthreads();  // every read of va for this layer precedes any write
      // pass 2: new u; va[col] += perm_inv(u - u_old), addend by addend
      for (int e = e0; e < e1; ++e) {
        const int* a = table + e * kTableCols;
        float* vcol = va + a[1] * M;
        for (int i = tid; i < M; i += nt) {
          const float t = TP[e * M + i];
          const float u_old = first ? 0.0f : U[e * M + i];
          const float m1 = m1s[i];
          float mag = fabsf(t) == m1 ? m2s[i] : m1;  // equality tie rule
          if (use_alpha) mag = __fmul_rn(alpha, mag);
          const bool neg = (sgs[i] != 0) != (t < 0.0f);
          const float u = neg ? -mag : mag;
          const int v = perm_index(a, i, M);
          vcol[v] = __fadd_rn(vcol[v], __fsub_rn(u, u_old));
          U[e * M + i] = u;
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

}  // namespace

// Plain C interface, loaded with ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launch.
extern "C" int layered_minsum_f32(
    const float* llrs, uint8_t* bits, uint8_t* success, int32_t* iterations,
    float* u_scratch, float* tp_scratch, const int* table, const int* row_off,
    int B, int n, int M, int R, int Cc, int sumA, int maxiters, int use_alpha,
    float alpha, void* stream) {
  int threads = M < 256 ? M : 256;
  threads = (threads + 31) / 32 * 32;
  const size_t smem = (static_cast<size_t>(Cc) * M + 3 * static_cast<size_t>(M)) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      layered_minsum_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  layered_minsum_f32_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      llrs, bits, success, iterations, u_scratch, tp_scratch, table, row_off, n, M, R,
      Cc, sumA, maxiters, use_alpha, alpha);
  return static_cast<int>(cudaGetLastError());
}
