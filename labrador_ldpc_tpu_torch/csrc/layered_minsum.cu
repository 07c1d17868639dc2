// Row-layered self-corrected min-sum LDPC decoder for Hopper (sm_90a), in
// float32, in the TPU kernels' bfloat16 form and in the saturating int8/int16
// forms.
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
// The int8/int16 forms (B1/B2 with int LLRs; twin make_ms_decoder_layered with
// an int dtype, qc_minsum.py:283-357) are the same template over the storage
// type T of the LLRs and of u/t' (minsum_arith.cuh): t = sat(g - u_old), the
// self-correction against the stored (saturated) t', a1 = min(|t|, HI) with
// the two-min seeded at HI, u and t' stored in T, and the posterior va kept
// WIDE in int32 and never clipped (its bound, (1 + degree) * 32767, is below
// 2^24). Float32 keeps every rounding of the plain version: Arith<float>
// spells each one out.
//
// The bfloat16 form (B1/B2 with bf16 LLRs, pallas_qc.py:880-1006,
// pallas_tc.py:339-410) stores the LLRs and u/t' in bfloat16 and computes in
// float32: t = g - u_old stays float32 (the self-correction and the sign
// product read it), the two-min takes |bf16(t)| (Ar::sat_abs), u = +-mag is
// float32 (alpha * mag a float32 product), the posterior update rounds twice,
// va <- bf16(va + bf16(u - u_old)) (Ar::post), and u and t' are stored as
// bf16. va stays in shared memory as float holding bfloat16 values. The sign
// of bf16(t), which pass 2 reads back, is the sign of t: t is a difference
// of two bfloat16 values, so it is zero only where bf16(t) is.
//
// Design. One CTA decodes one codeword (grid = B); its threads loop over the
// M check nodes of a layer. The posteriors va (V values of 4 bytes) and the
// layer's two-min/sign statistics (3*M) live in dynamic shared memory (TM8192:
// 40,960 + 24,576 B). The per-edge check messages u and previous extrinsics
// t' (sumA*M values each, 245,760 B per TM8192 codeword in float32) do not
// fit in the 227 KB a block can address, so they live in a global scratch
// (B, sumA, M) of T that the wrapper allocates (TM8192, B=16384: 4.03 GB in
// float32, 2.01 GB in bfloat16 or int16); iteration 0 is peeled
// (u = t' = 0 are not read), so the scratch needs no zeroing. Each codeword stops at its own
// convergence; the branch is uniform across the block (__syncthreads_or).
//
// What bounds it: the state traffic. Each iteration reads and writes u and t'
// for every edge, about 4*sumA*M*sizeof(T) B per codeword (TM8192 float32:
// 491,520 B; int8 a quarter, int16 a half), plus n*sizeof(T) + V B of input
// and output once. The 50 MB L2 holds the state of only
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

#include <cstdint>
#include <cuda_runtime.h>

#include "minsum_arith.cuh"
#include "qc_addend.cuh"

namespace {

using qc::kTableCols;
using qc::perm_index;

template <typename T>
__global__ void layered_minsum_kernel(
    const T* __restrict__ llrs,            // (B, n)
    uint8_t* __restrict__ bits,            // (B, V) out: hard bits 0/1
    uint8_t* __restrict__ success,         // (B,) out: 0/1
    int32_t* __restrict__ iterations,      // (B,) out
    T* __restrict__ u_all,                 // (B, sumA, M) scratch: check->var messages
    T* __restrict__ tp_all,                // (B, sumA, M) scratch: self-corrected extrinsics
    const int* __restrict__ table,         // (sumA, 9)
    const int* __restrict__ row_off,       // (R + 1,)
    int n, int M, int R, int Cc, int sumA, int maxiters, int use_alpha, float alpha) {
  using Ar = ms::Arith<T>;
  using A = typename Ar::A;  // float for float32/bfloat16, int (wide) for int8/int16
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int V = Cc * M;
  A* va = reinterpret_cast<A*>(smem_raw);            // (V,) posteriors
  A* m1s = va + V;                                   // (M,) smallest |t| of the layer
  A* m2s = m1s + M;                                  // (M,) second smallest |t|
  int* sgs = reinterpret_cast<int*>(m2s + M);        // (M,) sign product

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const T* llr = llrs + static_cast<size_t>(b) * n;
  T* U = u_all + static_cast<size_t>(b) * sumA * M;
  T* TP = tp_all + static_cast<size_t>(b) * sumA * M;

  // posteriors start at the channel LLRs; punctured tail = 0
  for (int v = tid; v < V; v += nt) va[v] = v < n ? Ar::ld(llr[v]) : A(0);
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
        A m1 = Ar::big(), m2 = Ar::big();
        int sg = 0;
        for (int e = e0; e < e1; ++e) {
          const int* a = table + e * kTableCols;
          const A g = va[a[1] * M + perm_index(a, i, M)];
          const A u_old = first ? A(0) : Ar::ld(U[e * M + i]);
          const A tp = first ? A(0) : Ar::ld(TP[e * M + i]);
          A t = Ar::sat(Ar::sub(g, u_old));
          const bool keep = ((t < A(0)) == (tp < A(0))) || (tp == A(0));
          t = keep ? t : A(0);
          TP[e * M + i] = Ar::st(t);
          const A a1 = Ar::sat_abs(t);
          m2 = a1 < m1 ? m1 : Ar::min(m2, a1);
          m1 = Ar::min(m1, a1);
          sg ^= t < A(0) ? 1 : 0;
        }
        m1s[i] = m1;
        m2s[i] = m2;
        sgs[i] = sg;
      }
      __syncthreads();  // every read of va for this layer precedes any write
      // pass 2: new u; va[col] += perm_inv(u - u_old), addend by addend
      for (int e = e0; e < e1; ++e) {
        const int* a = table + e * kTableCols;
        A* vcol = va + a[1] * M;
        for (int i = tid; i < M; i += nt) {
          const A t = Ar::ld(TP[e * M + i]);
          const A u_old = first ? A(0) : Ar::ld(U[e * M + i]);
          const A m1 = m1s[i];
          A mag = Ar::sat_abs(t) == m1 ? m2s[i] : m1;  // equality tie rule
          if (use_alpha) mag = Ar::scale(alpha, mag);
          const bool neg = (sgs[i] != 0) != (t < A(0));
          const A u = neg ? -mag : mag;
          const int v = perm_index(a, i, M);
          vcol[v] = Ar::post(vcol[v], Ar::sub(u, u_old));  // int: wide, never clipped
          U[e * M + i] = Ar::st(u);
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
        par ^= va[a[1] * M + perm_index(a, i, M)] < A(0) ? 1 : 0;
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
  for (int v = tid; v < V; v += nt) out[v] = (maxiters > 0 && va[v] < A(0)) ? 1 : 0;
  if (tid == 0) {
    success[b] = static_cast<uint8_t>(converged);
    iterations[b] = it_done;
  }
}

template <typename T>
int launch(const T* llrs, uint8_t* bits, uint8_t* success, int32_t* iterations,
           T* u_scratch, T* tp_scratch, const int* table, const int* row_off, int B, int n,
           int M, int R, int Cc, int sumA, int maxiters, int use_alpha, float alpha,
           void* stream) {
  int threads = M < 256 ? M : 256;
  threads = (threads + 31) / 32 * 32;
  // va, m1s, m2s (4-byte compute type) and sgs (int)
  const size_t smem = (static_cast<size_t>(Cc) * M + 3 * static_cast<size_t>(M)) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      layered_minsum_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  layered_minsum_kernel<T><<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      llrs, bits, success, iterations, u_scratch, tp_scratch, table, row_off, n, M, R, Cc,
      sumA, maxiters, use_alpha, alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes, one entry point per LLR dtype; the
// scratch u/t' is of the LLRs' type (bfloat16 as __nv_bfloat16, the bits of
// a torch.bfloat16). Each launches on `stream`, does not
// synchronise, allocates nothing, and returns the cudaError_t of the launch.
#define LAYERED_ENTRY(NAME, T)                                                             \
  extern "C" int NAME(const T* llrs, uint8_t* bits, uint8_t* success, int32_t* iterations, \
                      T* u_scratch, T* tp_scratch, const int* table, const int* row_off,   \
                      int B, int n, int M, int R, int Cc, int sumA, int maxiters,          \
                      int use_alpha, float alpha, void* stream) {                          \
    return launch<T>(llrs, bits, success, iterations, u_scratch, tp_scratch, table,        \
                     row_off, B, n, M, R, Cc, sumA, maxiters, use_alpha, alpha, stream);   \
  }

LAYERED_ENTRY(layered_minsum_f32, float)
LAYERED_ENTRY(layered_minsum_bf16, __nv_bfloat16)
LAYERED_ENTRY(layered_minsum_i8, int8_t)
LAYERED_ENTRY(layered_minsum_i16, int16_t)
