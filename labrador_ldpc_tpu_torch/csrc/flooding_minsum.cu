// Flooding self-corrected min-sum LDPC decoder (the reference's schedule) for
// Hopper (sm_90a), in float32, in the TPU kernels' bfloat16 form and in the
// saturating int8/int16 forms.
//
// Replaces two TPU kernels of the JAX package, both pinned bit-exact to the
// XLA twins labrador_ldpc_tpu/ops/qc_minsum.py:75 make_ms_decoder_qc (float)
// and :415 make_ms_decoder_qc_int (int8/int16):
//   * labrador_ldpc_tpu/ops/pallas_qc.py:265 make_ms_decoder_pallas_qc
//     (lane-major, M >= 512: TM2048/5120/6144/8192), and
//   * labrador_ldpc_tpu/ops/pallas_tc.py:506 make_ms_decoder_pallas_tc_qc
//     (node-major, M <= 256: TC128/256/512, TM1280/1536).
// One kernel template covers all nine codes and the four dtypes through the
// per-addend QC table of qc_addend.cuh and the arithmetic of minsum_arith.cuh.
// The bfloat16 form (B3/B4 with bf16 LLRs, pallas_qc.py:405-455,
// pallas_tc.py:611, 658) stores every state value in bfloat16 and computes
// in float32: va <- bf16(va + bf16(u)) addend by addend (Ar::post), nv = g - u
// in float32 with the self-correction against the stored v, the two-min over
// |bf16(nv)| (Ar::sat_abs), the sign product and parity from the float32
// values, and v, m1, m2 stored in bfloat16.
// The plain version, bit for bit the same function, is
// labrador_ldpc_tpu_torch/ops/qc_minsum.py flooding_minsum_plain.
//
// Design. One CTA decodes one codeword (grid = B), and its whole state lives
// in dynamic shared memory, in the LLRs' type T: the posteriors va (V), the
// checks' two smallest |v| m1/m2 (R*M each), the per-addend self-corrected
// messages v (sumA*M) and the sign products as bytes (R*M). TM8192 takes
// 219,136 B in float32 (59,392 B in int8, 112,640 B in int16 or bfloat16:
// two CTAs per SM), under the
// 232,448 B a block can address, so nothing but the input and the result
// touches device memory. Per iteration:
//   sweep 1, a thread per variable: va = llr + the u of every addend of the
//     variable's block column, in the twin's order (rows in order, then
//     addends: the addend index), u recomputed from the check's v, m1, m2 and
//     sign. A gather through perm_inverse, so no two threads write one
//     variable: every TM row has two addends on one block column (the I+Pi
//     sums), which a thread per check would race on. The int form saturates
//     after every add;
//   sweep 2, a thread per check: for each addend of its row, u from the old
//     stats, g = va gathered through perm_index, v = g - u (saturated in the
//     int form) with the self-correction, the new two-min (seeded at FLT_MAX,
//     or at the int max), the sign product, and the parity of g;
//   the codeword has converged when every parity is 0 (__syncthreads_or,
//     uniform across the block): its bits are the signs of this iteration's
//     sweep-1 posteriors, as the twin's are.
// maxiters = 0 runs no iteration and returns zero bits, success 0 and
// iteration 0, as the twins do (the TPU kernel B3 runs its peeled iteration
// anyway, pallas_qc.py:641).
//
// What bounds it: shared-memory latency and integer index arithmetic, not
// bytes. Input and output are n*sizeof(T) + V + 5 B per codeword; each
// iteration visits every edge twice (sweep 1 through perm_inverse, sweep 2
// through perm_index) with about a dozen operations a visit, on shared memory.
// With all of its state on chip, a float32 TM8192 CTA fills one SM's shared
// memory, so only one CTA (512 threads) runs per SM in that form.

#include <cstdint>
#include <cuda_runtime.h>

#include "minsum_arith.cuh"
#include "qc_addend.cuh"

namespace {

using qc::kTableCols;
using qc::perm_index;
using qc::perm_inverse;

constexpr int kMaxThreads = 512;

// check -> variable message from the check's stats (decoder.rs:388-405); |v|
// is not saturated here, as in the twin (|-128| == 128 matches no stored min)
template <typename Ar, typename A>
__device__ __forceinline__ A u_msg(A v, A m1, A m2, bool sg, int use_alpha, float alpha) {
  A mag = Ar::abs(v) == m1 ? m2 : m1;
  if (use_alpha) mag = Ar::scale(alpha, mag);
  return (sg != (v < A(0))) ? -mag : mag;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) flooding_minsum_kernel(
    const T* __restrict__ llrs,            // (B, n)
    uint8_t* __restrict__ bits,            // (B, V) out: hard bits 0/1
    uint8_t* __restrict__ success,         // (B,) out: 0/1
    int32_t* __restrict__ iterations,      // (B,) out
    const int* __restrict__ table,         // (sumA, 9)
    const int* __restrict__ row_off,       // (R + 1,) first addend of each block row
    const int* __restrict__ col_edges,     // (sumA,) addend indices grouped by block column
    const int* __restrict__ col_off,       // (Cc + 1,) first entry of each column in col_edges
    int n, int M, int R, int Cc, int sumA, int maxiters, int use_alpha, float alpha) {
  using Ar = ms::Arith<T>;
  using A = typename Ar::A;  // float for float32/bfloat16, int for int8/int16
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int V = Cc * M, RM = R * M;
  T* va = reinterpret_cast<T*>(smem_raw);  // (V,) posteriors of this iteration
  T* m1s = va + V;                         // (R*M,) smallest |v| of each check
  T* m2s = m1s + RM;                       // (R*M,) second smallest
  T* vs = m2s + RM;                        // (sumA*M,) self-corrected var->check messages
  uint8_t* sgs = reinterpret_cast<uint8_t*>(vs + static_cast<size_t>(sumA) * M);  // (R*M,)

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const T* llr = llrs + static_cast<size_t>(b) * n;

  // the reference zeroes its working area (decoder.rs:374): v, m1, m2, sign
  for (int x = tid; x < RM; x += nt) {
    m1s[x] = Ar::st(A(0));
    m2s[x] = Ar::st(A(0));
    sgs[x] = 0;
  }
  for (int x = tid; x < sumA * M; x += nt) vs[x] = Ar::st(A(0));
  __syncthreads();

  int converged = 0;
  int it_done = maxiters;
  for (int it = 0; it < maxiters; ++it) {
    // sweep 1: posteriors from the channel LLRs, in the twin's addend order
    for (int v = tid; v < V; v += nt) {
      const int c = v / M, o = v - c * M;
      A acc = v < n ? Ar::ld(llr[v]) : A(0);  // punctured tail = 0
      for (int k = col_off[c]; k < col_off[c + 1]; ++k) {
        const int e = col_edges[k];
        const int* a = table + e * kTableCols;
        const int i = perm_inverse(a, o, M);
        const int ci = a[0] * M + i;
        const A u = u_msg<Ar, A>(Ar::ld(vs[e * M + i]), Ar::ld(m1s[ci]), Ar::ld(m2s[ci]),
                                 sgs[ci] != 0, use_alpha, alpha);
        acc = Ar::sat(Ar::post(acc, u));
      }
      va[v] = Ar::st(acc);
    }
    __syncthreads();  // every posterior precedes sweep 2's gathers

    // sweep 2: self-corrected v, the checks' new stats and the parity of g
    int bad = 0;
    for (int c = tid; c < RM; c += nt) {
      const int r = c / M, i = c - r * M;
      const A m1o = Ar::ld(m1s[c]), m2o = Ar::ld(m2s[c]);
      const bool sgo = sgs[c] != 0;
      A m1 = Ar::big(), m2 = Ar::big();
      int sg = 0, par = 0;
      for (int e = row_off[r]; e < row_off[r + 1]; ++e) {
        const int* a = table + e * kTableCols;
        const A v_old = Ar::ld(vs[e * M + i]);
        const A u = u_msg<Ar, A>(v_old, m1o, m2o, sgo, use_alpha, alpha);
        const A g = Ar::ld(va[a[1] * M + perm_index(a, i, M)]);
        A nv = Ar::sat(Ar::sub(g, u));
        const bool keep = ((nv < A(0)) == (v_old < A(0))) || (v_old == A(0));
        nv = keep ? nv : A(0);  // decoder.rs:420-426
        par ^= g < A(0) ? 1 : 0;
        const A a1 = Ar::sat_abs(nv);
        m2 = a1 < m1 ? m1 : Ar::min(m2, a1);
        m1 = Ar::min(m1, a1);
        sg ^= nv < A(0) ? 1 : 0;
        vs[e * M + i] = Ar::st(nv);  // this thread's own slot
      }
      m1s[c] = Ar::st(m1);  // exact: mins of bfloat16 values in the bf16 form
      m2s[c] = Ar::st(m2);
      sgs[c] = static_cast<uint8_t>(sg);
      bad |= par;
    }
    if (!__syncthreads_or(bad)) {  // uniform across the block; also the barrier
      converged = 1;               // before the next sweep 1 reads v and stats
      it_done = it;
      break;  // the bits of this iteration are the frozen result
    }
  }

  // a converged codeword reports the signs of its convergence iteration, a
  // failed one those of its last; no iteration at all (maxiters = 0) gives 0
  uint8_t* out = bits + static_cast<size_t>(b) * V;
  for (int v = tid; v < V; v += nt) out[v] = (maxiters > 0 && Ar::ld(va[v]) < A(0)) ? 1 : 0;
  if (tid == 0) {
    success[b] = static_cast<uint8_t>(converged);
    iterations[b] = it_done;
  }
}

template <typename T>
int launch(const T* llrs, uint8_t* bits, uint8_t* success, int32_t* iterations,
           const int* table, const int* row_off, const int* col_edges, const int* col_off,
           int B, int n, int M, int R, int Cc, int sumA, int maxiters, int use_alpha,
           float alpha, void* stream) {
  const size_t V = static_cast<size_t>(Cc) * M, RM = static_cast<size_t>(R) * M;
  const size_t smem = (V + 2 * RM + static_cast<size_t>(sumA) * M) * sizeof(T) + RM;
  const size_t work = V > RM ? V : RM;
  int threads = static_cast<int>(work < kMaxThreads ? work : kMaxThreads);
  threads = (threads + 31) / 32 * 32;
  cudaError_t err = cudaFuncSetAttribute(
      flooding_minsum_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flooding_minsum_kernel<T><<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      llrs, bits, success, iterations, table, row_off, col_edges, col_off, n, M, R, Cc, sumA,
      maxiters, use_alpha, alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes, one entry point per LLR dtype
// (bfloat16 as __nv_bfloat16, the bits of a torch.bfloat16). Each
// launches on `stream`, does not synchronise, allocates nothing, and returns
// the cudaError_t of the launch.
#define FLOODING_ENTRY(NAME, T)                                                             \
  extern "C" int NAME(const T* llrs, uint8_t* bits, uint8_t* success, int32_t* iterations,  \
                      const int* table, const int* row_off, const int* col_edges,           \
                      const int* col_off, int B, int n, int M, int R, int Cc, int sumA,     \
                      int maxiters, int use_alpha, float alpha, void* stream) {             \
    return launch<T>(llrs, bits, success, iterations, table, row_off, col_edges, col_off, \
                     B, n, M, R, Cc, sumA, maxiters, use_alpha, alpha, stream);             \
  }

FLOODING_ENTRY(flooding_minsum_f32, float)
FLOODING_ENTRY(flooding_minsum_bf16, __nv_bfloat16)
FLOODING_ENTRY(flooding_minsum_i8, int8_t)
FLOODING_ENTRY(flooding_minsum_i16, int16_t)
